"""Expectation templates on the port's circuits.

:func:`operator_expectation` takes a dense matrix, a sparse one (a torch
COO or compressed tensor), a matrix-free product (a callable, e.g.
``quantum.PauliStringSum2MVP``) or a QuOperator, on the circuit's device;
the spin-model helpers sum ``expectation_ps`` term by term; the
parameterized ones take the Pauli structure as a tensor."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..backend import backend as K
from ..core import statevec
from ..quantum import QuOperator, _tensor

__all__ = [
    "any_measurements",
    "any_local_measurements",
    "operator_expectation",
    "sparse_expectation",
    "mpo_expectation",
    "spin_glass_measurements",
    "heisenberg_measurements",
    "parameterized_measurements",
    "parameterized_local_measurements",
]

_PAULIS_NP = np.stack(
    [np.eye(2), np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]])]
)


def operator_expectation(c: Any, hamiltonian: Any) -> torch.Tensor:
    """Re ⟨psi|H|psi⟩ of a circuit's state (or a state), H dense, sparse, a
    matrix-free product or a QuOperator."""
    psi = torch.reshape(c.state() if hasattr(c, "state") else _tensor(c), (-1,))
    if callable(hamiltonian) and not hasattr(hamiltonian, "shape"):
        hpsi = hamiltonian(psi)
    elif K.is_sparse(hamiltonian):
        hpsi = K.sparse_dense_matmul(hamiltonian, psi)
    else:
        h = hamiltonian.eval_matrix() if isinstance(hamiltonian, QuOperator) else _tensor(hamiltonian)
        dt = torch.promote_types(h.dtype, psi.dtype)
        psi, hpsi = psi.to(dt), h.to(dt) @ psi.to(dt)
    return torch.real(torch.vdot(psi.to(hpsi.dtype), hpsi))


def sparse_expectation(c: Any, hamiltonian: Any) -> torch.Tensor:
    return operator_expectation(c, hamiltonian)


def mpo_expectation(c: Any, mpo: Any) -> torch.Tensor:
    return operator_expectation(c, mpo)


def _real(e: Any) -> Any:
    return torch.real(e) if isinstance(e, torch.Tensor) else e


def any_measurements(c: Any, structures: Any, onehot: bool = False) -> torch.Tensor:
    """⟨P⟩ of one Pauli structure [n] (0: I, 1: X, 2: Y, 3: Z)."""
    structures = np.asarray(structures.cpu() if isinstance(structures, torch.Tensor) else structures)
    x, y, z = ([int(i) for i in np.nonzero(structures == k)[0]] for k in (1, 2, 3))
    return c.expectation_ps(x=x, y=y, z=z)


def any_local_measurements(c: Any, structures: Any, wires: Sequence[int]) -> torch.Tensor:
    """⟨P⟩ of the Paulis ``structures`` on ``wires``."""
    xyz: dict = {1: [], 2: [], 3: []}
    for s, w in zip(np.asarray(structures), wires):
        if int(s) in xyz:
            xyz[int(s)].append(int(w))
    return c.expectation_ps(x=xyz[1], y=xyz[2], z=xyz[3])


def heisenberg_measurements(
    c: Any,
    g: Any,
    hzz: float = 1.0,
    hxx: float = 1.0,
    hyy: float = 1.0,
    hz: float = 0.0,
    hx: float = 0.0,
    hy: float = 0.0,
    reuse: bool = True,
) -> Any:
    """⟨H⟩ of the Heisenberg Hamiltonian of a graph (or an edge list), term
    by term: hzz ZZ, hxx XX and hyy YY on each edge, hz Z, hx X and hy Y on
    each qubit."""
    e = 0.0
    try:
        edges = list(g.edges)
    except AttributeError:
        edges = list(g)
    for a, b in edges:
        for h, key in ((hzz, "z"), (hxx, "x"), (hyy, "y")):
            if h != 0:
                e = e + h * c.expectation_ps(**{key: [a, b]}, reuse=reuse)
    for i in range(c.nqubits):
        for h, key in ((hz, "z"), (hx, "x"), (hy, "y")):
            if h != 0:
                e = e + h * c.expectation_ps(**{key: [i]}, reuse=reuse)
    return _real(e)


def spin_glass_measurements(c: Any, g: Any, reuse: bool = True) -> Any:
    """The Ising energy Σ w_ij ⟨Z_i Z_j⟩ + Σ w_i ⟨Z_i⟩ of a graph's edge
    and node weights (edge weight 1, node weight 0 by default)."""
    e = 0.0
    for a, b, data in g.edges(data=True):
        e = e + data.get("weight", 1.0) * c.expectation_ps(z=[a, b], reuse=reuse)
    for node, data in g.nodes(data=True):
        w = data.get("weight", 0.0)
        if w != 0:
            e = e + w * c.expectation_ps(z=[node], reuse=reuse)
    return _real(e)


def pauli_term_expectation(psi: torch.Tensor, code: Any) -> torch.Tensor:
    """Re ⟨psi|P(code)|psi⟩ of per-qubit Pauli codes [n] (0..3, a tensor or
    a sequence), each qubit's Pauli picked from the stack by its code."""
    n = statevec.num_slots(psi)
    paulis = torch.as_tensor(_PAULIS_NP, device=psi.device).to(psi.dtype)
    code = torch.as_tensor(code, device=psi.device).to(torch.int64)
    phi = psi
    for q in range(n):
        phi = statevec.apply_unitary(phi, paulis[code[q]], [q])
    return torch.real(torch.vdot(psi, phi))


def parameterized_measurements(c: Any, structures: Any, onehot: bool = False, reuse: bool = True) -> torch.Tensor:
    """⟨P⟩ of the Pauli structure [n] given as a tensor of codes, on the
    circuit's state (:func:`pauli_term_expectation`)."""
    return pauli_term_expectation(c.state(), structures)


def parameterized_local_measurements(
    c: Any, structures: Any, onehot: bool = False, reuse: bool = True
) -> torch.Tensor:
    """The real [nwires] stack of ⟨Σ_k s[i, k] σ_k⟩ on wire i, ``structures``
    [nwires, 4] Pauli weights (I, X, Y, Z) or, with ``onehot``, [nwires]
    integer codes; differentiable in the weights.  Each wire's operator is
    built in complex64, as the JAX package builds it."""
    s = _tensor(structures)
    if onehot:
        s = torch.nn.functional.one_hot(s.to(torch.int64), 4).to(torch.float32)
    paulis = torch.as_tensor(_PAULIS_NP.astype(np.complex64), device=s.device)
    outs = []
    for i in range(s.shape[0]):
        m = torch.tensordot(s[i].to(torch.complex64), paulis, dims=1)
        outs.append(torch.real(c.expectation((m, [i]), reuse=reuse)))
    return torch.stack(outs)
