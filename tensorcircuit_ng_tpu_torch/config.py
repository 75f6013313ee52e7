"""Runtime configuration of the PyTorch port: default dtype, device and
contractor.

Counterpart of ``tensorcircuit_ng_tpu/config.py`` (the dtype and the
contraction-path strategy read by the engines) plus the default device,
which the JAX package leaves to JAX.  Entry points run on the CUDA card unless the caller asks for the CPU;
nothing falls back to the CPU silently.

``set_dtype`` / ``set_device`` change the process default and return a scope
object: used as a context manager it restores the previous value on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "set_dtype",
    "get_dtype",
    "runtime_dtype",
    "set_function_dtype",
    "dtypestr",
    "rdtypestr",
    "npdtype",
    "torch_dtype",
    "np_dtype",
    "set_device",
    "get_device",
    "resolve_device",
    "full_float32",
    "device_constant",
    "normalize_backend",
    "set_backend",
    "get_backend",
    "runtime_backend",
    "set_function_backend",
    "set_contractor",
    "get_contractor",
    "contractor_options",
    "runtime_contractor",
    "set_function_contractor",
    "Config",
    "current",
    "get_backend_name",
]

_COMPLEX_TO_REAL = {"complex64": "float32", "complex128": "float64"}
_REAL_TO_COMPLEX = {"float32": "complex64", "float64": "complex128"}

_dtype = "complex64"
_device = "cuda"
_backend = "pytorch"
#: the contraction-path strategy of the einsum IR and its options
_contractor = "auto"
_contractor_options: Optional[dict] = None
_BACKEND_ALIASES = {"pytorch": "pytorch", "torch": "pytorch"}


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


get_dtype = dtypestr


def rdtypestr() -> str:
    """The real dtype paired with the default complex dtype."""
    return _COMPLEX_TO_REAL[_dtype]


def npdtype() -> np.dtype:
    return np.dtype(_dtype)


@contextlib.contextmanager
def runtime_dtype(dtype: Any) -> Iterator[Tuple[str, str]]:
    """The default dtype is ``dtype`` inside the scope; yields
    ``(complex_dtype_str, real_dtype_str)``."""
    with set_dtype(dtype) as value:
        yield value


def set_function_dtype(dtype: Any) -> Callable[[Callable], Callable]:
    """Decorator: run the wrapped function under ``runtime_dtype(dtype)``."""

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            with runtime_dtype(dtype):
                return f(*args, **kws)

        return wrapper

    return deco


def torch_dtype(dtype: Optional[str] = None) -> torch.dtype:
    return getattr(torch, _normalize_dtype(dtype or _dtype))


def np_dtype(dtype: Optional[str] = None) -> np.dtype:
    return np.dtype(_normalize_dtype(dtype or _dtype))


@dataclasses.dataclass(frozen=True)
class Config:
    """A snapshot of the runtime configuration (:func:`current`), with the
    JAX package's ``Config`` fields and properties, and the device."""

    dtype: str = "complex64"
    backend: str = "pytorch"
    contractor: str = "auto"
    contractor_options: Optional[dict] = None
    device: str = "cuda"

    @property
    def rdtype(self) -> str:
        """The real dtype paired with :attr:`dtype`."""
        return _COMPLEX_TO_REAL[self.dtype]

    @property
    def idtype(self) -> str:
        """The integer dtype paired with :attr:`dtype`."""
        return "int64" if self.dtype == "complex128" else "int32"

    @property
    def npdtype(self) -> np.dtype:
        return np.dtype(self.dtype)


def current() -> Config:
    """The active configuration as a :class:`Config`."""
    return Config(_dtype, _backend, _contractor, _contractor_options, _device)


def get_backend_name() -> str:
    """The configured backend's name (``"pytorch"``)."""
    return _backend


def normalize_backend(name: Any) -> str:
    """``"pytorch"`` (alias ``"torch"``), the port's one backend; anything
    else is a ValueError."""
    if name not in _BACKEND_ALIASES:
        raise ValueError(
            f"backend {name!r} not supported: the port's backend is 'pytorch' (alias 'torch')"
        )
    return _BACKEND_ALIASES[name]


def set_backend(backend: str = "pytorch") -> Any:
    """Select the backend by name and return it (``tct.backend``); the
    port has one, ``"pytorch"``."""
    global _backend
    _backend = normalize_backend(backend)
    return get_backend()


def get_backend() -> Any:
    """The configured backend object (the port's ``TorchBackend``)."""
    from .backend import get_backend as _get

    return _get(_backend)


@contextlib.contextmanager
def runtime_backend(backend: str) -> Iterator[Any]:
    """The backend is ``backend`` inside the scope; yields it."""
    global _backend
    prev = _backend
    _backend = normalize_backend(backend)
    try:
        yield get_backend()
    finally:
        _backend = prev


def set_function_backend(backend: str) -> Callable[[Callable], Callable]:
    """Decorator: run the wrapped function under ``runtime_backend(backend)``."""

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            with runtime_backend(backend):
                return f(*args, **kws)

        return wrapper

    return deco


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


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 and complex64 matmuls in full float32 (no TF32) inside the
    scope, whatever the caller set; the previous setting is restored."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


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


#: numpy constants up to this many elements are kept on their device
_CONSTANT_MAX_ELEMS = 4096


def tracing() -> bool:
    """Whether a tracer is active: a fake mode (``torch.export``), another
    dispatch mode, or ``torch.compile``."""
    from torch._guards import detect_fake_mode
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return (
        detect_fake_mode() is not None
        or _get_current_dispatch_mode() is not None
        or torch.compiler.is_compiling()
    )


def tensor_cache(maxsize: int) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """``functools.lru_cache`` for a function that returns tensors, bypassed
    while :func:`tracing`: a traced (fake) tensor kept in the cache would
    come back to every later eager call."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args: Any) -> Any:
            return fn(*args) if tracing() else cached(*args)

        wrapper.cache_clear = cached.cache_clear  # type: ignore[attr-defined]
        return wrapper

    return deco


@tensor_cache(maxsize=512)
def _cached_constant(data: bytes, shape: tuple, np_dtype: str, device: str, dtype: torch.dtype) -> torch.Tensor:
    a = np.frombuffer(data, dtype=np.dtype(np_dtype)).reshape(shape)
    # made outside any torch.func transform: a constant kept past the
    # transform that first asked for it must not carry its level
    with torch._C._DisableFuncTorch():
        return torch.as_tensor(a.copy()).to(device=device, dtype=dtype)


def device_constant(a: Any, device: Union[str, torch.device], dtype: torch.dtype) -> torch.Tensor:
    """A numpy operand (a gate matrix, a Pauli) as a tensor of ``dtype`` on
    ``device``.  A small one is copied to the card once and kept, keyed by
    its bytes: a copy from pageable host memory waits for the card, so a
    CNOT ladder that copied its gate each time would stall the stream at
    every gate.  Callers never write to the result.  Under a tracer the
    constant is built uncached (:func:`tensor_cache`)."""
    a = np.asarray(a)
    if a.size > _CONSTANT_MAX_ELEMS:
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    return _cached_constant(a.tobytes(), a.shape, a.dtype.str, str(device), dtype)


def set_contractor(method: str = "auto", optimizer: Any = None, **options: Any) -> str:
    """Set the default contraction-path strategy of the einsum IR.

    Methods: ``"auto"`` (opt_einsum's auto), ``"greedy"``, ``"optimal"``,
    ``"branch-2"``, ``"plain"`` (left to right), ``"treesa"`` (the native
    annealer), ``"custom"`` (an opt_einsum-compatible ``optimizer=``).
    The options ``contraction_info=True`` (print each network's cost once)
    and ``debug_level=2`` (contract nothing: zeros of the output shape) are
    read by the contractor itself."""
    global _contractor, _contractor_options
    opts = dict(options)
    if optimizer is not None:
        opts["optimizer"] = optimizer
        method = "custom"
    _contractor, _contractor_options = method, opts or None
    return method


def get_contractor() -> str:
    return _contractor


def contractor_options() -> dict:
    """A copy of the contractor's options ({} when none are set)."""
    return dict(_contractor_options or {})


@contextlib.contextmanager
def runtime_contractor(method: str = "auto", **options: Any) -> Iterator[str]:
    """The contractor is ``method`` with ``options`` inside the scope."""
    global _contractor, _contractor_options
    prev = (_contractor, _contractor_options)
    _contractor, _contractor_options = method, options or None
    try:
        yield method
    finally:
        _contractor, _contractor_options = prev


def set_function_contractor(method: str = "auto", **options: Any) -> Callable[[Callable], Callable]:
    """Decorator: run the wrapped function under ``runtime_contractor``."""

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            with runtime_contractor(method, **options):
                return f(*args, **kws)

        return wrapper

    return deco


def __getattr__(name: str) -> Any:
    """The contractor helpers on the config module too (``tct.cons.plain_contractor``,
    ``tct.cons.get_symbol``), as the JAX package forwards them."""
    from .core import contractor as _contractor_mod

    if hasattr(_contractor_mod, name):
        return getattr(_contractor_mod, name)
    raise AttributeError(f"module 'tensorcircuit_ng_tpu_torch.config' has no attribute {name!r}")
