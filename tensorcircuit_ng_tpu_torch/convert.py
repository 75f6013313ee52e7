"""Carry inputs of the JAX package (numpy arrays) over to the port.

Both packages then compute the same thing on the same numbers.  Like every
entry point of the port, these put their tensors on the default device
(CUDA, see :func:`config.resolve_device`) unless the caller names another:


- :func:`params` — a parameter grid such as the ``(L, 2, n)`` float32 array
  of the TFIM benchmark (``rng.normal(size=(L, 2, n)) * 0.1``);
- :func:`state` — a flat complex state, and :func:`planes` its ``(r,
  lanes)`` float32 (real, imag) planes in the kernels' layout (128 lanes,
  or the whole-block kernels' 128-1024);
- :func:`readout_spec` — an Ising readout spec ``(diag_terms, x_terms)``
  with plain ints and floats, hashable as the port's readout caches need;
- :func:`tebd_state` — a ``ParallelTEBD`` engine's Vidal tensors, for
  ``ParallelTEBD.from_state``.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import numpy as np
import torch

from .config import resolve_device

__all__ = ["params", "state", "planes", "readout_spec", "tebd_state", "to_numpy"]

Device = Union[None, str, torch.device]


def params(p: Any, device: Device = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A real parameter array as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(np.asarray(p), device=resolve_device(device)).to(dtype)


def state(psi: Any, device: Device = None, dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """A complex state (any shape) as a flat complex tensor on ``device``."""
    return torch.as_tensor(np.asarray(psi).reshape(-1), device=resolve_device(device)).to(dtype)


def planes(psi: Any, device: Device = None, lanes: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex state of ``2^n >= lanes`` amplitudes as contiguous
    ``(2^n / lanes, lanes)`` float32 (real, imag) planes on ``device``."""
    a = np.asarray(psi).reshape(-1, lanes)
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)
    return f(a.real), f(a.imag)


def readout_spec(spec: Any) -> Tuple[Any, Any]:
    """``(diag_terms, x_terms)`` with ints and floats only."""
    diag, xs = spec
    return (
        tuple((tuple(int(q) for q in qs), float(w)) for qs, w in diag),
        tuple((int(q), float(w)) for q, w in xs),
    )


def tebd_state(gammas: Any, lambdas: Any, device: Device = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A JAX engine's ``(n, χ, d, χ)`` complex Γ (its dtype kept) and
    ``(n+1, χ)`` λ (float32, as the engines keep it) on ``device``."""
    device = resolve_device(device)
    g = torch.as_tensor(np.ascontiguousarray(np.asarray(gammas)), device=device)
    lam = torch.as_tensor(np.asarray(lambdas, dtype=np.float32), device=device)
    return g, lam


def to_numpy(t: Any) -> np.ndarray:
    """A tensor (any device, with or without grad) as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
