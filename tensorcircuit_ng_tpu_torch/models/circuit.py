"""``Circuit``: the exact statevector simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/circuit.py`` without the
multi-chip ``mesh=`` engine and the noise channels: post-selection, the
measurement with collapse (``cond_measurement``) on one trajectory of a
general Kraus channel (``general_kraus``), the circuit unitary (``matrix``)
and the free function :func:`expectation`.  ``device``
defaults to the configured device (``"cuda"`` unless
:func:`config.set_device` says otherwise); a CUDA device without a card
raises.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..backend import device_tensor
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

    def cond_measurement(self, index: int, status: Optional[Any] = None) -> torch.Tensor:
        """Projective measurement of qubit ``index`` with the state collapsed
        and renormalized: :meth:`general_kraus` on the d projectors.
        Returns the outcome, a 0-d int32 tensor on the circuit's device."""
        projs = []
        for v in range(self._d):
            m = np.zeros((self._d, self._d))
            m[v, v] = 1.0
            projs.append(m)
        return self.general_kraus(projs, index, status=status, name="cond_measurement")

    cond_measure = cond_measurement

    def general_kraus(
        self,
        kraus: Sequence[Any],
        *index: int,
        status: Optional[Any] = None,
        with_prob: bool = False,
        name: Optional[str] = None,
    ) -> Any:
        """One trajectory of the channel with Kraus operators ``kraus`` on
        ``index``: branch i has probability ⟨ψ|K_i†K_i|ψ⟩ on the state at
        this point (computed now), is picked by the uniform ``status`` (or
        one drawn on the circuit's device) and applied renormalized, so the
        state stays normalized.  Returns the branch (and the branch
        probabilities with ``with_prob``)."""
        mats = self._kraus_mats(kraus, index)
        psi = self.state()
        nrm2 = torch.real(torch.vdot(psi, psi))
        probs = []
        for m in mats:
            phi = statevec.apply_unitary(psi, m, index, self._d)
            probs.append(torch.real(torch.vdot(phi, phi)) / nrm2)
        p = torch.stack(probs)
        p = p / torch.sum(p)
        new_mats = [m / torch.sqrt(pi.to(m.dtype) + 1e-30) for m, pi in zip(mats, p)]
        idx = self._apply_selected_kraus(new_mats, p, index, status=status, name=name or "general_kraus",
                                         orig_mats=mats)
        if with_prob:
            return idx, p
        return idx

    apply_general_kraus = general_kraus

    def _apply_selected_kraus(
        self,
        mats: List[torch.Tensor],
        p: torch.Tensor,
        index: Sequence[int],
        status: Optional[Any] = None,
        name: str = "kraus",
        orig_mats: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Pick branch i where the cdf of ``p`` first reaches ``status`` +
        the measurement tie-break, on the device, and append the one-hot sum
        of ``mats`` as a channel item (the Kraus set and the status kept for
        the QIR replay)."""
        status = self._uniforms([], None) if status is None else device_tensor(status, self._device)
        cdf = torch.cumsum(p, 0)
        r = torch.reshape(status, (1,)).to(cdf.dtype) + self._MEASURE_EPS
        idx = torch.clamp(torch.searchsorted(cdf, r, side="left")[0], 0, len(mats) - 1)
        onehot = torch.nn.functional.one_hot(idx, len(mats)).to(mats[0].dtype)
        op = sum(onehot[i] * mats[i] for i in range(len(mats)))
        g = Gate(op, name=name)
        ir_dict = {
            "gatef": None,
            "gate": g,
            "index": tuple(int(i) for i in index),
            "name": name,
            "split": None,
            "mpo": False,
            "is_channel": True,
            "channel_kraus": orig_mats if orig_mats is not None else mats,
            "channel_status": status,
        }
        self.apply_general_gate(g, *index, name=name, ir_dict=ir_dict)
        return idx.to(torch.int32)

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
