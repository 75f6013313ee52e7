"""``Circuit``: the exact statevector simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/circuit.py`` without the
multi-chip ``mesh=`` engine: post-selection, the circuit unitary
(``matrix``) and the free function :func:`expectation`.  ``device``
defaults to the configured device (``"cuda"`` unless
:func:`config.set_device` says otherwise); a CUDA device without a card
raises.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..core import statevec
from ..ops.gates import Gate
from .basecircuit import BaseCircuit

__all__ = ["Circuit", "expectation"]


class Circuit(BaseCircuit):
    """Exact statevector circuit simulator (dense engine)."""

    def __init__(
        self,
        nqubits: int,
        inputs: Optional[Any] = None,
        dim: int = 2,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        super().__init__(nqubits, inputs=inputs, dim=dim, device=device)

    def mid_measurement(self, index: int, keep: Union[int, torch.Tensor] = 0) -> None:
        """Post-select qubit ``index`` onto outcome ``keep``, without
        renormalization."""
        if isinstance(keep, torch.Tensor):
            sel = torch.nn.functional.one_hot(keep.to(torch.int64), self._d)
            m = torch.diag(sel.to(device=self._device, dtype=config.torch_dtype()))
        else:
            m = np.diag(np.eye(self._d)[int(keep)]).astype(config.np_dtype())
        self.apply_general_gate(Gate(m, name="mid_measurement"), index, name="mid_measurement")

    post_select = mid_measurement
    mid_measure = mid_measurement

    def matrix(self) -> torch.Tensor:
        """The circuit unitary, (d^n, d^n), on the circuit's device: the
        expanded QIR applied to the identity held as a state of 2n slots,
        the gates on the first n (the row index)."""
        dim = self._d**self._nqubits
        psi = torch.reshape(torch.eye(dim, dtype=config.torch_dtype(), device=self._device), (-1,))
        for item in self._expanded_qir():
            psi = statevec.apply_unitary(psi, item["gate"].tensor, item["index"], self._d)
        return torch.reshape(psi, (dim, dim))

    def get_unitary(self) -> torch.Tensor:
        return self.matrix()

    def is_valid(self) -> bool:
        """Whether the state computes, with d^n finite amplitudes."""
        try:
            psi = self.state()
        except (RuntimeError, ValueError, AssertionError):
            return False
        return psi.numel() == self._d**self._nqubits and bool(torch.isfinite(psi).all())


def expectation(
    *ops: Tuple[Any, Sequence[int]],
    ket: Any,
    bra: Optional[Any] = None,
    conj: bool = True,
    normalization: bool = False,
) -> torch.Tensor:
    """⟨bra| O_1 O_2 ... |ket⟩ on dense qubit states, ``O_i = (operator,
    [wires])``; ``bra`` defaults to ``ket``, ``conj=False`` skips its
    conjugation and ``normalization`` divides by both norms.  A tensor ket
    keeps its device, anything else goes to the configured device; a real
    ket takes the configured complex dtype."""
    if isinstance(ket, torch.Tensor):
        psi = torch.reshape(ket, (-1,))
    else:
        psi = torch.reshape(torch.as_tensor(np.asarray(ket), device=config.resolve_device()), (-1,))
    if not psi.is_complex():
        psi = psi.to(config.torch_dtype())
    bra_t = psi if bra is None else torch.reshape(torch.as_tensor(bra), (-1,)).to(device=psi.device, dtype=psi.dtype)
    phi = psi
    for op, wires in ops:
        if isinstance(op, Gate):
            op = op.tensor
        if not hasattr(wires, "__len__"):
            wires = [wires]
        phi = statevec.apply_unitary(phi, op, list(wires))
    val = torch.sum((torch.conj(bra_t) if conj else bra_t) * phi)
    if normalization:
        nrm = torch.sqrt(torch.real(torch.vdot(psi, psi)) * torch.real(torch.vdot(bra_t, bra_t)))
        val = val / nrm.to(val.dtype)
    return val
