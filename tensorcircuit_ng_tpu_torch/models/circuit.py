"""``Circuit``: the exact statevector simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/circuit.py`` without the
multi-chip ``mesh=`` engine.  ``device`` defaults to the configured device
(``"cuda"`` unless :func:`config.set_device` says otherwise); a CUDA
device without a card raises.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from .basecircuit import BaseCircuit

__all__ = ["Circuit"]


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
