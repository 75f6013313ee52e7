"""What makes the port's ``torch.autograd.Function``s transformable by
``torch.func`` (``grad``, ``vmap``, ``vmap(grad)``, ``jacrev``).

Each Function of the port is written in the ``forward(...)`` +
``setup_context(ctx, inputs, output)`` form with a ``vmap`` staticmethod:

- a kernel Function's ``vmap`` is :func:`loop_vmap`: the batch goes
  through the same Function one element at a time, so on a CUDA tensor the
  same Hopper kernel launches once an element (on a CPU tensor its plain
  version runs); inputs that carry no batch are shared by every element;
- a linear-algebra Function, batched already, takes :func:`front_vmap`:
  the batch axis moves to the front and the Function runs once.

Residuals that a backward needs and that are neither inputs nor the
result (a kernel's output planes, the layer stack's per-layer states) are
extra outputs of ``forward``, marked non-differentiable in
``setup_context``.  A backward runs its kernels through :func:`each`, one
more Function with the loop rule: under ``vmap(grad(f))`` torch vmaps the
backward too, and a kernel takes plain tensors (a pointer a plane), never
a transform's wrapped ones.  None of them defines ``jvp``: forward mode
through a kernel raises, as ``jax.jvp`` of the JAX package's
``jax.custom_vjp`` counterparts does.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

__all__ = ["loop_vmap", "front_vmap", "each"]


def _slice(a: Any, d: Any, b: int) -> Any:
    """Element ``b`` of ``a`` batched on ``d`` (a pytree of dims for a
    tuple or list argument)."""
    if d is None:
        return a
    if isinstance(a, (tuple, list)):
        return type(a)(_slice(x, dx, b) for x, dx in zip(a, d))
    return a.movedim(d, 0)[b]


def _unbatched(d: Any) -> bool:
    if isinstance(d, (tuple, list)):
        return all(_unbatched(x) for x in d)
    return d is None


def _stack_outputs(outs: Sequence[Any]) -> Tuple[Any, Any]:
    first = outs[0]
    if isinstance(first, tuple):
        cols = list(zip(*outs))
        return (
            tuple(None if c[0] is None else torch.stack(c) for c in cols),
            tuple(None if c[0] is None else 0 for c in cols),
        )
    return torch.stack(outs), 0


def loop_vmap(info: Any, in_dims: Sequence[Any], call: Callable[..., Any], args: Sequence[Any]) -> Tuple[Any, Any]:
    """The vmap rule of a kernel Function: ``call`` (the Function's
    ``apply``) on each element of the batch, the outputs stacked on a new
    front axis.  With no batched input the one result is shared."""
    if _unbatched(in_dims):
        out = call(*args)
        return out, (tuple(None for _ in out) if isinstance(out, tuple) else None)
    outs = [call(*(_slice(a, d, b) for a, d in zip(args, in_dims))) for b in range(info.batch_size)]
    return _stack_outputs(outs)


def front_vmap(info: Any, in_dims: Sequence[Any], call: Callable[..., Any], args: Sequence[Any]) -> Tuple[Any, Any]:
    """The vmap rule of a batched linear-algebra Function: its tensor
    inputs with the batch axis moved to the front (an unbatched one
    expanded), then one call."""
    moved = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = a.movedim(d, 0) if d is not None else a.expand((info.batch_size,) + tuple(a.shape))
        moved.append(a)
    out = call(*moved)
    return out, (tuple(0 for _ in out) if isinstance(out, tuple) else 0)


class _Each(torch.autograd.Function):
    """``fn(*tensors)`` in one call, a loop over the batch under vmap."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a kernel's backward has no derivative of its own (no second order through a kernel)")

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        return loop_vmap(info, in_dims[1:], lambda *a: _Each.apply(fn, *a), args)


def each(fn: Callable[..., Any], *tensors: Any) -> Any:
    """``fn(*tensors)`` with plain tensors under every transform: a
    backward's kernel calls go through here (``fn`` closes over everything
    that is not a tensor and returns a tensor or a flat tuple of them)."""
    return _Each.apply(fn, *tensors)
