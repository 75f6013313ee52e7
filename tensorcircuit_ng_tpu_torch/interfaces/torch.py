"""The torch interface: a port function called from torch.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/torch.py``.  There, a jax
function is wrapped as a ``torch.autograd.Function`` that crosses into jax
and back.  The port's functions are torch already, so
:func:`torch_interface` is the function itself (autograd flows through it),
its foreign inputs (numpy, jax, tensorflow) moved into torch on the
configured device first.  With ``jit=True`` the function runs under
``backend.jit`` (a captured CUDA graph a signature on the card) and stays
trainable: a call whose tensors need a gradient goes through
:func:`trainable_jit`.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..backend import backend as K
from .tensortrans import general_args_to_backend

Tensor = Any

__all__ = ["torch_interface", "torch_interface_kws", "pytorch_interface", "trainable_jit"]


def _differentiable(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())


def _jax_conj(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """torch's gradient of a complex leaf is the conjugate of the JAX
    package's (``ROADMAP.md``, port rules); real ones are the same."""
    return torch.conj(x).resolve_conj() if x is not None and x.is_complex() else x


def vjp_of(fun: Callable[..., Tensor]) -> Callable[..., Tuple[Optional[Tensor], ...]]:
    """``g(*args, dy)``: the vector-Jacobian product of the tensor-valued
    ``fun`` at ``args`` with the cotangent ``dy``, one entry an argument
    (None for an argument that is no float or complex tensor), in torch's
    convention (``dy`` and the result conjugate Wirtinger derivatives)."""

    def vjp(*args_dy: Any) -> Tuple[Optional[Tensor], ...]:
        *args, dy = args_dy
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(True) if _differentiable(a) else a for a in args]
            y = fun(*xs)
            wrt = [x for x in xs if _differentiable(x)]
            gs = torch.autograd.grad(y, wrt, dy.to(y.dtype), allow_unused=True)
        it = iter(gs)
        return tuple((lambda g, x: torch.zeros_like(x) if g is None else g)(next(it), x) if _differentiable(x)
                     else None for x in xs)

    return vjp


def trainable_jit(fun: Callable[..., Tensor]) -> Callable[..., Tensor]:
    """``backend.jit(fun)`` that autograd can go through.

    ``fun`` takes tensors (and Python values) and returns one tensor.
    Where no argument needs a gradient it is ``backend.jit(fun)``.
    Otherwise it is a ``torch.autograd.Function``: for a real scalar output
    one jitted call computes the value and the gradients together (on the
    main path a step launches K2 and K4 once, replayed from one CUDA
    graph), and the backward pass scales them by the cotangent; for any
    other output the forward pass is ``backend.jit(fun)`` and the backward
    pass a jitted vector-Jacobian product (:func:`vjp_of`)."""
    plain = K.jit(fun)
    vjp = K.jit(vjp_of(fun))

    def value_and_grads(*args: Any) -> Tuple[Tensor, Optional[List[Tensor]]]:
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(True) if _differentiable(a) else a for a in args]
            y = fun(*xs)
            if y.numel() != 1 or y.is_complex():
                return y.detach(), None
            wrt = [x for x in xs if _differentiable(x)]
            gs = torch.autograd.grad(y, wrt, allow_unused=True)
        return y.detach(), [torch.zeros_like(x) if g is None else g for g, x in zip(gs, wrt)]

    fused = K.jit(value_and_grads)

    class _Jitted(torch.autograd.Function):
        @staticmethod
        def forward(ctx: Any, *args: Any) -> Tensor:
            y, grads = fused(*args)
            ctx.grads = grads
            ctx.kinds = [_differentiable(a) for a in args]
            ctx.args = args if grads is None else None
            return y

        @staticmethod
        def backward(ctx: Any, dy: Tensor) -> Tuple[Optional[Tensor], ...]:
            if ctx.grads is None:
                return vjp(*ctx.args, dy)
            it = iter(ctx.grads)
            return tuple(dy.reshape(()) * next(it) if kind else None for kind in ctx.kinds)

    def call(*args: Any) -> Tensor:
        needs = torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                                for a in pytree.tree_leaves(args))
        return _Jitted.apply(*args) if needs else plain(*args)

    functools.update_wrapper(call, fun)
    call.fused = fused  # type: ignore[attr-defined]  # its ``replays`` count the captured steps
    return call


def torch_interface(fun: Callable[..., Any], jit: bool = False, enable_dlpack: bool = False) -> Callable[..., Any]:
    """``fun`` for torch callers: its foreign tensor inputs (numpy, jax,
    tensorflow) moved into torch on the configured device (by DLPack with
    ``enable_dlpack``), torch tensors passed as they are; autograd flows
    through.  ``jit=True``: :func:`trainable_jit` of ``fun``."""
    f = trainable_jit(fun) if jit else fun

    @functools.wraps(fun)
    def wrapper(*args: Any, **kws: Any) -> Any:
        args = pytree.tree_map(lambda a: general_args_to_backend(a, enable_dlpack=enable_dlpack)
                               if _foreign(a) else a, args)
        return f(*args, **kws)

    return wrapper


def _foreign(x: Any) -> bool:
    """A tensor of another framework (numpy, jax, tensorflow)."""
    return not isinstance(x, torch.Tensor) and (hasattr(x, "__array__") or hasattr(x, "__dlpack__"))


pytorch_interface = torch_interface


def torch_interface_kws(f: Callable[..., Any], jit: bool = False, enable_dlpack: bool = False,
                        **kws: Any) -> Callable[..., Any]:
    """:func:`torch_interface` of ``f`` with the keyword arguments ``kws``
    bound."""
    return torch_interface(functools.partial(f, **kws), jit=jit, enable_dlpack=enable_dlpack)
