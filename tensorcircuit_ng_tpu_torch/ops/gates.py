"""Gates of the port, the subset its circuit path needs.

Counterpart of ``tensorcircuit_ng_tpu/ops/gates.py``: ``Gate`` holds a
dense matrix; concrete gates stay numpy (the registry builds them from
numpy constants) and are moved to the state's device where they are
applied.  ``rx_matrix`` builds torch matrices from torch angles so that
autograd reaches the angles.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import config

__all__ = ["Gate", "GATES", "rx_matrix"]


class Gate:
    """A dense gate tensor with a name; shape ``(d,)*2k`` or matrix form."""

    def __init__(self, tensor: Any, name: str = "any") -> None:
        if not hasattr(tensor, "ndim"):
            tensor = np.asarray(tensor)
        self.tensor = tensor
        self.name = name

    def matrix(self) -> Any:
        t = self.tensor
        dim = int(math.isqrt(int(np.prod(t.shape))))
        return t.reshape(dim, dim)


_h_matrix = np.array([[1, 1], [1, -1]]) / math.sqrt(2.0)


def _fixed(m: np.ndarray, name: str) -> Callable[..., Gate]:
    def make(dtype: Optional[str] = None) -> Gate:
        return Gate(m.astype(config.np_dtype(dtype)), name=name)

    return make


#: fixed-gate factories: ``GATES["h"]()`` -> Gate
GATES: Dict[str, Callable[..., Gate]] = {"h": _fixed(_h_matrix, "h")}


def rx_matrix(theta: Any, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 X)``: numpy for a number, torch for a tensor.

    A tensor ``theta`` of any shape gives ``theta.shape + (2, 2)``."""
    if isinstance(theta, torch.Tensor):
        cdt = config.torch_dtype(dtype)
        t = theta.to(torch.float64 if cdt == torch.complex128 else torch.float32)
        c = torch.cos(t / 2).to(cdt)
        s = (-1j * torch.sin(t / 2)).to(cdt)
        return torch.stack(
            [torch.stack([c, s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
        )
    d = config.np_dtype(dtype)
    t = float(theta)
    c, s = math.cos(t / 2), -1j * math.sin(t / 2)
    return np.array([[c, s], [s, c]]).astype(d)
