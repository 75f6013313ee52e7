"""Runtime configuration of the PyTorch port: default dtype and device.

Counterpart of ``tensorcircuit_ng_tpu/config.py`` (dtype state read by the
circuit engine) plus the default device, which the JAX package leaves to
JAX.  Entry points run on the CUDA card unless the caller asks for the CPU;
nothing falls back to the CPU silently.

``set_dtype`` / ``set_device`` change the process default and return a scope
object: used as a context manager it restores the previous value on exit.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = [
    "set_dtype",
    "dtypestr",
    "torch_dtype",
    "np_dtype",
    "set_device",
    "get_device",
    "resolve_device",
]

_COMPLEX_TO_REAL = {"complex64": "float32", "complex128": "float64"}
_REAL_TO_COMPLEX = {"float32": "complex64", "float64": "complex128"}

_dtype = "complex64"
_device = "cuda"


class _Scope:
    """Returned by the setters; ``with`` restores the previous value."""

    def __init__(self, restore: Any, value: Any) -> None:
        self._restore = restore
        self.value = value

    def __enter__(self) -> Any:
        return self.value

    def __exit__(self, *exc: Any) -> None:
        self._restore()

    def __iter__(self):  # ``c, r = set_dtype(...)`` as in the JAX package
        return iter(self.value)


def _normalize_dtype(dtype: Any) -> str:
    dtype = str(dtype).replace("torch.", "")
    if dtype in _REAL_TO_COMPLEX:
        dtype = _REAL_TO_COMPLEX[dtype]
    if dtype in ("64",):
        dtype = "complex64"
    if dtype in ("128",):
        dtype = "complex128"
    if dtype not in _COMPLEX_TO_REAL:
        raise ValueError(
            f"unsupported dtype {dtype!r}: use complex64/complex128 "
            "(float32/float64 aliases accepted)"
        )
    return dtype


def set_dtype(dtype: Any = "complex64") -> _Scope:
    """Set the default complex dtype; the scope's value is
    ``(complex_dtype_str, real_dtype_str)``."""
    global _dtype
    prev = _dtype
    _dtype = _normalize_dtype(dtype)

    def restore() -> None:
        global _dtype
        _dtype = prev

    return _Scope(restore, (_dtype, _COMPLEX_TO_REAL[_dtype]))


def dtypestr() -> str:
    return _dtype


def torch_dtype(dtype: Optional[str] = None) -> torch.dtype:
    return getattr(torch, _normalize_dtype(dtype or _dtype))


def np_dtype(dtype: Optional[str] = None) -> np.dtype:
    return np.dtype(_normalize_dtype(dtype or _dtype))


def set_device(device: Union[str, torch.device] = "cuda") -> _Scope:
    """Set the default device of new circuits ("cuda" or "cpu")."""
    global _device
    prev = _device
    _device = str(torch.device(device))

    def restore() -> None:
        global _device
        _device = prev

    return _Scope(restore, _device)


def get_device() -> str:
    return _device


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The explicit device, else the default; a CUDA device needs a card."""
    dev = torch.device(_device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tensorcircuit_ng_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (or use config.set_device('cpu')) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
