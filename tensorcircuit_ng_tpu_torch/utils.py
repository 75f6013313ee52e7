"""Small helpers: timing, a cost count, argument aliases, output picking.

Counterpart of ``tensorcircuit_ng_tpu/utils.py``.  ``benchmark`` waits for
the card with ``torch.cuda.synchronize`` where the JAX package blocks on
its arrays; ``cost_analysis`` counts the FLOPs and bytes of one eager call
itself (by torch's dispatch), since XLA's compiled cost analysis has no
torch counterpart.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["benchmark", "arg_alias", "return_partial", "append", "cost_analysis"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def cost_analysis(f: Callable[..., Any], *args: Any, **kws: Any) -> dict:
    """Run ``f(*args, **kws)`` once, eagerly, and count its cost: ``flops``
    (torch's flop formulas for the matrix products, einsums and
    convolutions it runs) and ``bytes accessed`` (each dispatched op's
    tensor inputs read once and outputs written once).  A hand-written
    kernel launched through its library is not a dispatched op, so its work
    is not counted; on the CPU its plain version is."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
            return out

    flops = FlopCounterMode(display=False)
    nbytes = _Bytes()
    with flops, nbytes:
        f(*args, **kws)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(nbytes.total)}


def benchmark(f: Callable[..., Any], *args: Any, tries: int = 5, verbose: bool = True) -> Tuple[Any, float, float]:
    """(the result, the first call's time, the mean time of ``tries`` more
    calls) in seconds, each waited for on the card
    (``torch.cuda.synchronize``)."""
    _sync()
    t0 = time.time()
    out = f(*args)
    _sync()
    staging = time.time() - t0
    t0 = time.time()
    for _ in range(tries):
        out = f(*args)
    _sync()
    running = (time.time() - t0) / tries
    if verbose:
        print(f"staging time: {staging:.6f}s, running time: {running:.6f}s")
    return out, staging, running


def arg_alias(
    f: Optional[Callable[..., Any]] = None,
    alias_dict: Optional[dict] = None,
    fix_doc: bool = True,
) -> Callable[..., Any]:
    """A decorator that maps other names of keyword arguments onto theirs:
    ``@arg_alias(alias_dict={"theta": ["angle"]})``."""

    def deco(func: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(func)
        def wrapper(*args: Any, **kws: Any) -> Any:
            for canonical, aliases in (alias_dict or {}).items():
                for a in aliases:
                    if a in kws and canonical not in kws:
                        kws[canonical] = kws.pop(a)
            return func(*args, **kws)

        return wrapper

    if f is not None:
        return deco(f)
    return deco


def return_partial(f: Callable[..., Any], return_argnums: Any = 0) -> Callable[..., Any]:
    """``f`` returning only the outputs at ``return_argnums``."""
    if isinstance(return_argnums, int):
        return_argnums = (return_argnums,)

    @functools.wraps(f)
    def wrapper(*args: Any, **kws: Any) -> Any:
        out = f(*args, **kws)
        picked = tuple(out[i] for i in return_argnums)
        return picked[0] if len(picked) == 1 else picked

    return wrapper


def append(f: Callable[..., Any], *post: Callable[..., Any]) -> Callable[..., Any]:
    """``f`` followed by each of ``post`` on its output."""

    @functools.wraps(f)
    def wrapper(*args: Any, **kws: Any) -> Any:
        out = f(*args, **kws)
        for p in post:
            out = p(out)
        return out

    return wrapper


def is_sequence(x: Any) -> bool:
    """True for a list or a tuple."""
    return isinstance(x, (list, tuple))


def is_number(x: Any) -> bool:
    """True for a Python or numpy scalar number."""
    import numbers

    import numpy as np

    return isinstance(x, (numbers.Number, np.number))


def is_m1mac() -> bool:
    """True on Apple-silicon macOS."""
    import platform

    return platform.system() == "Darwin" and platform.processor() == "arm"
