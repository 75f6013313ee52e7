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
  ``ParallelTEBD.from_state``;
- :func:`param_dict` — a dict of named parameter arrays (VQNHE's model
  dicts ``w1``, ``b1``, ... ``pw``, ``Linear``'s ``wr``/``wi``/``br``/``bi``);
- :func:`van_params` — a flax parameter tree of ``applications.van``'s
  ``MADE``, ``PixelCNN`` or ``NMF`` (numpy arrays) into the port's module.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import numpy as np
import torch

from .config import resolve_device

__all__ = ["params", "state", "planes", "readout_spec", "tebd_state", "param_dict", "van_params", "to_numpy"]

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


def param_dict(d: Any, device: Device = None, dtype: torch.dtype = torch.float32) -> dict:
    """``{name: array}`` as ``{name: tensor of dtype on device}``."""
    return {k: params(v, device, dtype) for k, v in d.items()}


def _flat_tree(tree: Any, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat_tree(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def van_params(module: torch.nn.Module, tree: Any) -> torch.nn.Module:
    """Load a flax parameter tree (``{"params": ...}`` or its inside, numpy
    arrays) into ``module``, a ``MADE``, ``PixelCNN`` or ``NMF`` of the same
    sizes, in place; returns it.

    A flax Dense kernel ``(in, out)`` becomes a ``(out, in)`` weight, a
    conv kernel HWIO an OIHW weight (the masks lie on the same axes of
    each), ``blocks_i``/``layers_j`` the module lists' entries and
    "meanfield-parameter" ``meanfield``.  A name or shape that does not
    match raises."""
    tree = tree.get("params", tree)
    own = dict(module.named_parameters())
    seen = set()
    for key, a in _flat_tree(tree).items():
        parts = []
        for part in key.split("."):
            head, _, idx = part.rpartition("_")
            parts.append(f"{head}.{idx}" if head in ("blocks", "layers") and idx.isdigit() else part)
        name = ".".join(parts).replace("meanfield-parameter", "meanfield")
        if name.endswith(".kernel"):
            name = name[: -len("kernel")] + "weight"
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        if name not in own or tuple(own[name].shape) != a.shape:
            raise ValueError(f"flax parameter {key} {a.shape} has no counterpart in {type(module).__name__}")
        with torch.no_grad():
            own[name].copy_(torch.as_tensor(np.array(a, copy=True), dtype=own[name].dtype))
        seen.add(name)
    if seen != set(own):
        raise ValueError(f"the flax tree leaves {sorted(set(own) - seen)} of {type(module).__name__} unset")
    return module


def to_numpy(t: Any) -> np.ndarray:
    """A tensor (any device, with or without grad) as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
