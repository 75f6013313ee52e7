"""The numpy interface: a port function called with numpy arrays.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/numpy.py``: numpy arrays
in, torch tensors on the configured device for the function, numpy out.
"""

from __future__ import annotations

from typing import Any, Callable

from ..backend import backend as K
from .tensortrans import general_args_to_numpy, numpy_args_to_backend

__all__ = ["numpy_interface", "np_interface"]


def numpy_interface(fun: Callable[..., Any], jit: bool = False) -> Callable[..., Any]:
    """``fun`` taking and returning numpy arrays; ``jit=True`` runs it under
    ``backend.jit``."""
    if jit:
        fun = K.jit(fun)

    def wrapper(*args: Any, **kws: Any) -> Any:
        out = fun(*numpy_args_to_backend(general_args_to_numpy(args)), **kws)
        return general_args_to_numpy(out)

    return wrapper


np_interface = numpy_interface
