"""``QuditCircuit``: the d-level statevector simulator (2 <= d <= 36).

Counterpart of ``tensorcircuit_ng_tpu/models/quditcircuit.py``: the port's
``Circuit`` with ``dim=d``, its named gates from :mod:`ops.quditgates`.
The dense engine is d-generic, so amplitudes, sampling and measurement are
``Circuit``'s, with base-d digit strings 0-9A-Z.  A tensor angle keeps
autograd: ``rxx`` exponentiates its generator by ``torch.linalg.matrix_exp``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import config
from ..ops import quditgates as qg
from .circuit import Circuit

__all__ = ["QuditCircuit"]


class QuditCircuit(Circuit):
    """Qudit circuit: ``Circuit``'s engine with d-level gate factories."""

    def __init__(
        self,
        nqudits: int,
        dim: int = 3,
        inputs: Optional[Any] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        if not 2 <= dim <= 36:
            raise ValueError("dim must be within [2, 36] (base-36 digit strings)")
        super().__init__(nqudits, inputs=inputs, dim=dim, device=device)

    def _copy_params(self) -> Dict[str, Any]:
        return {"nqudits": self._nqubits, "dim": self._d, "inputs": self._inputs, "device": self._device}

    @property
    def dim(self) -> int:
        return self._d

    @property
    def nqudits(self) -> int:
        return self._nqubits

    def i(self, *index: int) -> None:
        self.any(*index, unitary=qg.i_matrix_func(self._d), name="i")

    def x(self, *index: int) -> None:
        for q in index:
            self.any(q, unitary=qg.x_matrix_func(self._d), name="x")

    def z(self, *index: int) -> None:
        for q in index:
            self.any(q, unitary=qg.z_matrix_func(self._d), name="z")

    def h(self, *index: int) -> None:
        for q in index:
            self.any(q, unitary=qg.h_matrix_func(self._d), name="h")

    def rx(self, index: int, theta: Any = 0, j: int = 0, k: int = 1) -> None:
        self.any(index, unitary=qg.rx_matrix_func(self._d, theta, j, k), name="rx")

    def ry(self, index: int, theta: Any = 0, j: int = 0, k: int = 1) -> None:
        self.any(index, unitary=qg.ry_matrix_func(self._d, theta, j, k), name="ry")

    def rz(self, index: int, theta: Any = 0, j: int = 0, k: int = 1) -> None:
        self.any(index, unitary=qg.rz_matrix_func(self._d, theta, j, k), name="rz")

    def phase(self, index: int, theta: Any = 0, j: int = 1) -> None:
        self.any(index, unitary=qg.phase_matrix_func(self._d, theta, j), name="phase")

    def u8(self, index: int, gamma: Any = 0, z: Any = 0, eps: Any = 0) -> None:
        self.any(index, unitary=qg.u8_matrix_func(self._d, gamma, z, eps), name="u8")

    def cphase(self, *index: int, cv: Optional[int] = None, theta: Any = None) -> None:
        self.any(*index, unitary=qg.cphase_matrix_func(self._d, cv, theta), name="cphase")

    def csum(self, *index: int) -> None:
        self.any(*index, unitary=qg.csum_matrix_func(self._d), name="csum")

    cnot = csum

    def swap(self, *index: int) -> None:
        self.any(*index, unitary=qg.swap_matrix_func(self._d), name="swap")

    def _theta(self, theta: Any) -> Any:
        """The angle in the complex dtype: a tensor (on its device) or numpy."""
        if isinstance(theta, torch.Tensor):
            return theta.to(config.torch_dtype())
        return np.asarray(theta).astype(config.np_dtype())

    def rzz(self, *index: int, theta: Any = 0) -> None:
        """exp(-i theta G ⊗ G) with the centred clock generator
        G = diag(j - (d-1)/2): a diagonal two-qudit rotation."""
        d = self._d
        zgen = np.arange(d) - (d - 1) / 2.0
        gen = np.diagonal(np.kron(np.diag(zgen), np.diag(zgen))).copy()
        theta = self._theta(theta)
        if isinstance(theta, torch.Tensor):
            g = torch.as_tensor(gen, device=theta.device).to(theta.dtype)
            u = torch.diag(torch.exp(-1j * theta * g))
        else:
            u = np.diag(np.exp(-1j * theta * gen.astype(theta.dtype)))
        self.any(*index, unitary=u, name="rzz")

    def rxx(self, *index: int, theta: Any = 0, j1: int = 0, k1: int = 1, j2: int = 0, k2: int = 1) -> None:
        """exp(-i theta σx^{(j1,k1)} ⊗ σx^{(j2,k2)}), σx^{(j,k)} the X of
        levels (j, k), by ``torch.linalg.matrix_exp`` (with its gradient)."""
        d = self._d
        sx1 = np.zeros((d, d))
        sx1[j1, k1] = sx1[k1, j1] = 1.0
        sx2 = np.zeros((d, d))
        sx2[j2, k2] = sx2[k2, j2] = 1.0
        gen = np.kron(sx1, sx2)
        theta = self._theta(theta)
        if isinstance(theta, torch.Tensor):
            u = torch.linalg.matrix_exp(-1j * theta * torch.as_tensor(gen, device=theta.device).to(theta.dtype))
        else:
            t = torch.as_tensor(theta)
            u = torch.linalg.matrix_exp(-1j * t * torch.as_tensor(gen).to(t.dtype)).numpy()
        self.any(*index, unitary=u, name="rxx")

    def expectation_ps(self, *args: Any, **kws: Any) -> torch.Tensor:
        """Pauli strings are qubit words: d > 2 raises (use ``expectation``
        with a d-level operator)."""
        if self._d != 2:
            raise NotImplementedError("expectation_ps is qubit-specific; use expectation((op, wires))")
        return super().expectation_ps(*args, **kws)
