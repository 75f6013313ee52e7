"""Tensor conversion between frameworks, into the port.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/tensortrans.py``.  The
port's functions take torch tensors, so the default target is ``"torch"``
on the configured device (``config.get_device()``); ``"numpy"`` and
``"tensorflow"`` are the other targets.  A jax array comes in through its
``__dlpack__`` or ``__array__`` protocol: the port never imports jax, and a
``"jax"`` target raises ValueError.  Frameworks are told apart by the
module name of a tensor's type (:func:`which_backend`).  Pytrees are
torch's (``torch.utils._pytree``): lists, tuples and dicts of leaves.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import config

Tensor = Any

__all__ = [
    "general_args_to_numpy",
    "numpy_args_to_backend",
    "which_backend",
    "which_dtype",
    "tensor_to_numpy",
    "tensor_to_backend_jittable",
    "numpy_to_tensor",
    "tensor_to_dlpack",
    "general_args_to_backend",
    "gate_to_matrix",
    "qop_to_matrix",
    "args_to_tensor",
]

_MODULES = {
    "jax": "jax",
    "jaxlib": "jax",
    "numpy": "numpy",
    "builtins": "numpy",
    "torch": "torch",
    "tensorflow": "tensorflow",
}

_NO_JAX = "the PyTorch port does not import jax: convert into 'torch' (the default), 'numpy' or 'tensorflow'"


def _torch_dtype(dtype: Any) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)))


def _to_torch(x: Any, dtype: Any = None, device: Any = None) -> torch.Tensor:
    """``x`` as a torch tensor on ``device`` (the configured one by
    default): a torch tensor is moved, an object with ``__dlpack__`` (a jax
    array) is taken without a copy first, anything else through numpy."""
    dev = config.resolve_device(device)
    if not isinstance(x, torch.Tensor):
        if hasattr(x, "__dlpack__") and not isinstance(x, np.ndarray):
            try:
                x = torch.from_dlpack(x)
            except (RuntimeError, TypeError, BufferError):
                x = torch.as_tensor(np.asarray(x))
        else:
            x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=_torch_dtype(dtype))


def _to_numpy(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    if hasattr(x, "numpy") and which_backend(x, return_backend=False) == "tensorflow":
        return x.numpy()
    if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        return np.asarray(x)
    return x


def general_args_to_numpy(args: Any) -> Any:
    """Every tensor leaf of a pytree (torch on any device, tensorflow, jax)
    as a numpy array; other leaves as they are."""
    return pytree.tree_map(_to_numpy, args)


def numpy_args_to_backend(args: Any, dtype: Any = None, target: str = "torch") -> Any:
    """Every leaf of a numpy pytree as a tensor of ``target``: torch on the
    configured device (default), ``"numpy"`` or ``"tensorflow"``."""
    return pytree.tree_map(lambda x: numpy_to_tensor(np.asarray(x) if dtype is None
                                                     else np.asarray(x, dtype=dtype), target), args)


def which_dtype(x: Any) -> str:
    """The dtype name of a tensor of any framework (``"float32"``, ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def which_backend(a: Any, return_backend: bool = True) -> Any:
    """The framework of ``a``: ``"torch"``, ``"numpy"``, ``"tensorflow"`` or
    ``"jax"``, by the module of its type; with ``return_backend`` an object
    with ``numpy``, ``convert_to_tensor``, ``to_dlpack`` and
    ``from_dlpack``."""
    name = _MODULES.get(type(a).__module__.split(".")[0], "numpy")
    return _MiniBackend(name) if return_backend else name


class _MiniBackend:
    """The conversions of one framework."""

    def __init__(self, name: str) -> None:
        if name == "pytorch":
            name = "torch"
        if name not in ("torch", "numpy", "tensorflow", "jax"):
            raise ValueError(f"unknown backend {name!r}")
        self.name = name

    def numpy(self, t: Any) -> Any:
        return _to_numpy(t)

    def convert_to_tensor(self, t: Any) -> Any:
        if self.name == "torch":
            return _to_torch(t)
        if self.name == "numpy":
            return np.asarray(t)
        if self.name == "tensorflow":
            import tensorflow as tf

            return tf.convert_to_tensor(t)
        raise ValueError(_NO_JAX)

    def to_dlpack(self, t: Any) -> Any:
        if self.name == "torch":
            return torch.utils.dlpack.to_dlpack(t)
        if self.name == "tensorflow":
            import tensorflow as tf

            return tf.experimental.dlpack.to_dlpack(t)
        return t  # numpy and jax arrays carry the protocol themselves

    def from_dlpack(self, cap: Any) -> Any:
        if self.name == "torch":
            return torch.from_dlpack(cap)
        if self.name == "tensorflow":
            import tensorflow as tf

            return tf.experimental.dlpack.from_dlpack(cap)
        if self.name == "numpy":
            return np.from_dlpack(cap)
        raise ValueError(_NO_JAX)


def _backend_of(backend: Any) -> _MiniBackend:
    if backend is None:
        return _MiniBackend("torch")
    if isinstance(backend, _MiniBackend):
        return backend
    return _MiniBackend(getattr(backend, "name", backend))


def tensor_to_numpy(t: Any) -> Any:
    """A tensor of any framework as numpy; Python numbers and None as they
    are."""
    if isinstance(t, (int, float)) or t is None:
        return t
    return _to_numpy(t)


def tensor_to_backend_jittable(t: Any) -> Any:
    """A torch tensor as it is; a foreign one as a torch tensor on the
    configured device (a jax array through DLPack)."""
    if isinstance(t, (int, float)) or isinstance(t, torch.Tensor):
        return t
    if which_backend(t, return_backend=False) == "tensorflow":
        t = t.numpy()
    return _to_torch(t)


def numpy_to_tensor(t: Any, backend: Any = None) -> Any:
    """numpy into ``backend`` (torch on the configured device by default);
    Python numbers as they are."""
    if isinstance(t, (int, float)):
        return t
    return _backend_of(backend).convert_to_tensor(t)


def tensor_to_dlpack(t: Any) -> Any:
    """A tensor's DLPack capsule (numpy and jax arrays: the array itself,
    which carries ``__dlpack__``)."""
    return which_backend(t).to_dlpack(t)


def general_args_to_backend(
    args: Any, dtype: Any = None, target_backend: Any = None, enable_dlpack: bool = True
) -> Any:
    """Every tensor leaf of ``args`` into ``target_backend`` (torch by
    default).  With ``enable_dlpack`` the leaves cross by DLPack first, so a
    CUDA tensor into torch shares its memory (no copy), and then move to the
    configured device and ``dtype`` (no copy where they already are); where
    DLPack fails they go through numpy."""
    target = _backend_of(target_backend)
    if target.name == "jax":
        raise ValueError(_NO_JAX)
    if enable_dlpack:
        try:
            out = pytree.tree_map(lambda x: target.from_dlpack(tensor_to_dlpack(x)), args)
        except (RuntimeError, TypeError, BufferError, ValueError, AttributeError):
            out = None
        if out is not None:
            if target.name == "torch":
                return pytree.tree_map(lambda x: _to_torch(x, dtype), out)
            return out if dtype is None else general_args_to_backend(out, dtype, target, enable_dlpack=False)
    args = general_args_to_numpy(args)
    return pytree.tree_map(
        lambda x: numpy_to_tensor(np.asarray(x, dtype=dtype) if dtype is not None else x, target), args)


def gate_to_matrix(t: Any, is_reshapem: bool = True) -> Any:
    """A port ``Gate`` as its matrix (or its ``(2,)*2k`` tensor); anything
    else as it is."""
    from ..ops.gates import Gate

    if isinstance(t, Gate):
        return t.matrix() if is_reshapem else t.tensor
    return t


def qop_to_matrix(t: Any, is_reshapem: bool = True) -> Any:
    """A port ``QuOperator`` as its dense matrix; anything else as it is."""
    from ..quantum import QuOperator

    if isinstance(t, QuOperator):
        return t.eval_matrix()
    return t


def args_to_tensor(
    f: Callable[..., Any],
    argnums: Union[int, Sequence[int]] = 0,
    tensor_as_matrix: bool = False,
    gate_to_tensor: bool = False,
    gate_as_matrix: bool = True,
    qop_to_tensor: bool = False,
    qop_as_matrix: bool = True,
    cast_dtype: bool = True,
) -> Callable[..., Any]:
    """Decorate ``f`` so that its arguments ``argnums`` arrive as torch
    tensors on the configured device: gates and QuOperators densified when
    asked, foreign tensors moved, and everything cast to the configured
    complex dtype with ``cast_dtype``."""
    from ..ops.gates import Gate
    from ..quantum import QuOperator

    if isinstance(argnums, int):
        argnums = (argnums,)

    def convert(x: Any) -> Any:
        if gate_to_tensor and isinstance(x, Gate):
            x = gate_to_matrix(x, gate_as_matrix)
        if qop_to_tensor and isinstance(x, QuOperator):
            x = qop_to_matrix(x, qop_as_matrix)
        if isinstance(x, (list, tuple)) and x and not np.isscalar(x[0]):
            return type(x)(convert(e) for e in x)
        if isinstance(x, torch.Tensor) or hasattr(x, "__array__") or hasattr(x, "__dlpack__"):
            x = _to_torch(tensor_to_backend_jittable(x), device=x.device if isinstance(x, torch.Tensor) else None)
            if cast_dtype:
                x = x.to(config.torch_dtype())
        return x

    @functools.wraps(f)
    def wrapper(*args: Any, **kws: Any) -> Any:
        nargs = list(args)
        for i in argnums:
            if i < len(nargs):
                nargs[i] = convert(nargs[i])
        return f(*nargs, **kws)

    return wrapper
