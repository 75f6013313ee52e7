"""Node-free circuit IR: the QIR instruction list is the circuit.

Counterpart of ``tensorcircuit_ng_tpu/models/abstractcircuit.py``, the
subset the port's engine needs: QIR storage and append.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["AbstractCircuit"]


class AbstractCircuit:
    """Gate bookkeeping shared by the port's simulators."""

    _nqubits: int
    _d: int

    def __init__(self) -> None:
        self._qir: List[Dict[str, Any]] = []

    def apply_general_gate(
        self,
        gate: Any,
        *index: int,
        name: Optional[str] = None,
        split: Optional[Dict[str, Any]] = None,
        mpo: bool = False,
        ir_dict: Optional[Dict[str, Any]] = None,
    ) -> None:
        raise NotImplementedError  # engine-specific
