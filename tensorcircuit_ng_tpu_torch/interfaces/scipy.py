"""The scipy interface: a port function as a ``scipy.optimize`` objective.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/scipy.py``.  The objective
takes a flat float64 numpy vector, evaluates the function on float32
tensors on the configured device, and returns the value and the flat
float64 gradient from ``torch.autograd`` (``backend.value_and_grad``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..backend import backend as K

__all__ = ["scipy_interface", "scipy_optimize_interface"]


def scipy_optimize_interface(
    fun: Callable[..., Any],
    shape: Optional[Sequence[int]] = None,
    jit: bool = True,
    gradient: bool = True,
) -> Callable[..., Any]:
    """``f(x, *args) -> (value, grad)`` (``gradient=True``, for
    ``scipy.optimize.minimize(..., jac=True)``) or ``f(x, *args) -> value``
    of the real scalar ``fun``: ``x`` flat float64, reshaped to ``shape``
    and cast to float32 on the configured device; ``jit=True`` runs the
    function (and its gradient) under ``backend.jit``."""
    run = K.value_and_grad(fun) if gradient else fun
    if jit:
        run = K.jit(run)

    def tensor(x: np.ndarray) -> torch.Tensor:
        xt = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(config.resolve_device())
        return torch.reshape(xt, tuple(shape)) if shape is not None else xt

    if gradient:

        def f(x: np.ndarray, *args: Any) -> Tuple[float, np.ndarray]:
            v, g = run(tensor(x), *args)
            return float(torch.real(v)), g.detach().cpu().numpy().astype(np.float64).reshape(-1)

        return f

    def f_only(x: np.ndarray, *args: Any) -> float:
        return float(torch.real(run(tensor(x), *args)))

    return f_only


scipy_interface = scipy_optimize_interface
