"""``Circuit``: the exact statevector simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/circuit.py`` without the
multi-chip ``mesh=`` engine.  ``device`` defaults to the configured device
(``"cuda"`` unless :func:`config.set_device` says otherwise); a CUDA
device without a card raises.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .. import config
from ..ops.gates import Gate
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
