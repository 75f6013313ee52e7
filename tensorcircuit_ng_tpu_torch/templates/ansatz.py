"""Variational ansätze on the port's ``Circuit``: QAOA for an Ising
objective and the hardware-efficient ry-rz ansatz.  Angles are a tensor
(kept with its autograd) or anything numpy takes; ``**kws`` go to
``Circuit`` (``device=``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["QAOA_ansatz_for_Ising", "hea_ansatz"]


def _reshape(params: Any, shape: Sequence[int]) -> Any:
    if isinstance(params, torch.Tensor):
        return torch.reshape(params, tuple(shape))
    return np.reshape(np.asarray(params), tuple(shape))


def QAOA_ansatz_for_Ising(
    params: Any,
    nlayers: int,
    pauli_terms: Sequence[Sequence[int]],
    weights: Sequence[float],
    full_coupling: bool = False,
    mixer: str = "X",
    **kws: Any,
) -> Any:
    """The QAOA circuit of an Ising objective: h on every qubit, then a
    layer l: each 0/3 structure of ``pauli_terms`` as rz (one Z), rzz (two)
    or exp1 of its Z string (more), angle 2·gamma·w (gamma·w for exp1),
    then the mixer (``"X"``: rx(2·beta) a qubit; ``"XY"``: rxx and ryy,
    ``"ZZ"``: rzz on each neighbouring pair).  ``params``: [2·nlayers],
    gamma and beta interleaved."""
    from ..models.circuit import Circuit

    n = len(pauli_terms[0])
    params = _reshape(params, (-1,))
    c = Circuit(n, **kws)
    for i in range(n):
        c.h(i)
    for l in range(nlayers):
        gamma = params[2 * l]
        beta = params[2 * l + 1]
        for term, w in zip(pauli_terms, weights):
            sites = [i for i, v in enumerate(term) if v == 3]
            if len(sites) == 1:
                c.rz(sites[0], theta=2.0 * gamma * w)
            elif len(sites) == 2:
                c.rzz(sites[0], sites[1], theta=2.0 * gamma * w)
            elif len(sites) > 2:
                zdiag = np.array([1.0 - 2.0 * (bin(k).count("1") % 2) for k in range(2 ** len(sites))])
                c.exp1(*sites, theta=gamma * w, unitary=np.diag(zdiag))
        for i in range(n):
            if mixer == "X":
                c.rx(i, theta=2.0 * beta)
            elif mixer == "XY":
                if i < n - 1:
                    c.rxx(i, i + 1, theta=2.0 * beta)
                    c.ryy(i, i + 1, theta=2.0 * beta)
            elif mixer == "ZZ":
                if i < n - 1:
                    c.rzz(i, i + 1, theta=2.0 * beta)
    return c


def hea_ansatz(params: Any, n: int, nlayers: int, inputs: Optional[Any] = None, **kws: Any) -> Any:
    """The hardware-efficient ansatz: ry and rz on every qubit, then
    ``nlayers`` times a CNOT ladder and ry, rz again; ``params``
    [(nlayers + 1), 2, n]."""
    from ..models.circuit import Circuit

    params = _reshape(params, (nlayers + 1, 2, n))
    c = Circuit(n, inputs=inputs, **kws)
    for i in range(n):
        c.ry(i, theta=params[0, 0, i])
        c.rz(i, theta=params[0, 1, i])
    for l in range(nlayers):
        for i in range(n - 1):
            c.cnot(i, i + 1)
        for i in range(n):
            c.ry(i, theta=params[l + 1, 0, i])
            c.rz(i, theta=params[l + 1, 1, i])
    return c
