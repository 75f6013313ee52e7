"""``AnalogCircuit``: digital gate segments interleaved with analog blocks.

Counterpart of ``tensorcircuit_ng_tpu/models/analogcircuit.py``.  Each
digital segment is a port :class:`Circuit` on the circuit's device (the
fused layers run their kernels there); each analog block evolves the state
under a time-dependent Hamiltonian ``hamiltonian_func(t)`` (a dense or
sparse matrix or a matrix-vector product, on the whole register or a 2^k
matrix on ``index``) by :func:`timeevol.ode_evol_global` /
:func:`ode_evol_local`, the time a 0-d tensor on the state's device.
``state()`` folds segment, block, segment, ...; the result is kept for the
next call only when it carries no autograd graph and no ``torch.func``
transform is active (a kept graph would break a second backward), and any
change to the circuit drops it.  Unknown attributes (the gate methods)
go to the current digital segment.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import config
from .circuit import Circuit

__all__ = ["AnalogCircuit", "AnalogBlock"]


class AnalogBlock:
    """``hamiltonian_func`` evolved over ``time`` (a duration T, from 0, or a
    [t0, t1] pair) on ``index`` (None: the whole register)."""

    def __init__(
        self,
        hamiltonian_func: Callable[..., Any],
        time: Union[float, Sequence[float]],
        index: Optional[Sequence[int]] = None,
        solver_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.hamiltonian_func = hamiltonian_func
        if np.ndim(time) == 0:
            self.t0, self.t1 = 0.0, float(np.asarray(time))
        else:
            t = np.asarray(time).reshape(-1)
            self.t0, self.t1 = float(t[0]), float(t[1])
        self.index = list(index) if index is not None else None
        self.solver_options = solver_options or {}


def _transform_active() -> bool:
    return torch._C._functorch.maybe_current_level() is not None


class AnalogCircuit:
    """Alternating digital circuits and analog evolution blocks, on
    ``device`` (default: the configured device, which needs a card when it
    is CUDA)."""

    def __init__(
        self, nqubits: int, inputs: Optional[Any] = None, device: Union[None, str, torch.device] = None
    ) -> None:
        self._nqubits = nqubits
        self._inputs = inputs
        self._device = config.resolve_device(device)
        self.digital_circuits: List[Circuit] = [Circuit(nqubits, inputs=inputs, device=self._device)]
        self.analog_blocks: List[AnalogBlock] = []
        self._state_cache: Optional[torch.Tensor] = None

    @property
    def nqubits(self) -> int:
        return self._nqubits

    @property
    def device(self) -> torch.device:
        return self._device

    def add_analog_block(
        self,
        hamiltonian_func: Callable[..., Any],
        time: Union[float, Sequence[float]],
        index: Optional[Sequence[int]] = None,
        **solver_options: Any,
    ) -> None:
        """Append an evolution under ``hamiltonian_func(t)``, t a 0-d real
        tensor on the state's device; a new digital segment follows it."""
        self.analog_blocks.append(AnalogBlock(hamiltonian_func, time, index, solver_options))
        self.digital_circuits.append(Circuit(self._nqubits, device=self._device))
        self._state_cache = None

    def _evolve(self, blk: AnalogBlock, psi: torch.Tensor) -> torch.Tensor:
        from .. import timeevol

        hf, t0 = blk.hamiltonian_func, blk.t0

        def shifted(t: torch.Tensor) -> Any:
            return hf(t + t0)

        rdt = torch.float64 if psi.dtype == torch.complex128 else torch.float32
        duration = torch.tensor(blk.t1 - blk.t0, dtype=rdt, device=psi.device)
        if blk.index is None:
            return timeevol.ode_evol_global(shifted, psi, duration, **blk.solver_options)
        return timeevol.ode_evol_local(shifted, psi, duration, blk.index, **blk.solver_options)

    def state(self, form: str = "default") -> torch.Tensor:
        """The output state: digital segment, analog block, digital segment, ..."""
        if self._state_cache is not None and not _transform_active():
            return self._state_cache
        psi = None
        for seg, c in enumerate(self.digital_circuits):
            if psi is not None:
                c = Circuit(self._nqubits, inputs=psi, device=self._device)
                c.append_from_qir(self.digital_circuits[seg].to_qir())
            psi = c.state(reuse=False)
            if seg < len(self.analog_blocks):
                psi = self._evolve(self.analog_blocks[seg], psi)
        if not psi.requires_grad and not _transform_active():
            self._state_cache = psi
        return psi

    wavefunction = state

    def _output_circuit(self) -> Circuit:
        return Circuit(self._nqubits, inputs=self.state(), device=self._device)

    def expectation_ps(self, **kws: Any) -> torch.Tensor:
        return self._output_circuit().expectation_ps(**kws)

    def expectation(self, *ops: Any, **kws: Any) -> torch.Tensor:
        return self._output_circuit().expectation(*ops, **kws)

    def sample(self, *args: Any, **kws: Any) -> Any:
        return self._output_circuit().sample(*args, **kws)

    def amplitude(self, l: Any) -> torch.Tensor:
        return self._output_circuit().amplitude(l)

    def probability(self) -> torch.Tensor:
        return self._output_circuit().probability()

    def measure_jit(self, *index: int, **kws: Any) -> Any:
        return self._output_circuit().measure_jit(*index, **kws)

    measure = measure_jit

    def effective_circuit(self) -> Circuit:
        """A plain ``Circuit`` that starts from the output state."""
        return self._output_circuit()

    def current_digital_circuit(self) -> Circuit:
        """The digital segment gates are appended to."""
        return self.digital_circuits[-1]

    def set_solver_options(self, **solver_options: Any) -> None:
        """Default ODE options for the blocks (a block's own options win)."""
        self._solver_defaults = dict(solver_options)
        for blk in self.analog_blocks:
            blk.solver_options = {**solver_options, **blk.solver_options}
        self._state_cache = None

    def append(self, other: Any) -> "AnalogCircuit":
        """Append another circuit's gates to the current digital segment."""
        self.digital_circuits[-1].append_from_qir(other.to_qir())
        self._state_cache = None
        return self

    def inverse(self) -> "AnalogCircuit":
        """The inverse: the segments inverted in reverse order, each block
        evolved under -H(t1 - t) over the same duration."""
        inv = AnalogCircuit(self._nqubits, device=self._device)
        segs = [c.inverse() for c in self.digital_circuits[::-1]]
        inv.digital_circuits = [segs[0]]
        for blk, seg in zip(self.analog_blocks[::-1], segs[1:]):

            def neg_h(t: Any, _hf: Callable[..., Any] = blk.hamiltonian_func, _t1: float = blk.t1) -> Any:
                return _negate(_hf(_t1 - t))

            inv.analog_blocks.append(AnalogBlock(neg_h, blk.t1 - blk.t0, blk.index, blk.solver_options))
            inv.digital_circuits.append(seg)
        return inv

    def __getattr__(self, name: str) -> Any:
        """The current digital segment's attribute; a method call drops the
        kept state."""
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self.digital_circuits[-1], name)
        if callable(attr):

            def wrapper(*args: Any, **kws: Any) -> Any:
                self._state_cache = None
                return attr(*args, **kws)

            return wrapper
        return attr


def _negate(h: Any) -> Any:
    """-H for a matrix, a sparse tensor or a matrix-vector product."""
    if callable(h) and not hasattr(h, "shape"):
        return lambda v: -h(v)
    return -h
