"""torch ``nn.Module``s around the port's quantum functions.

Counterpart of ``tensorcircuit_ng_tpu/torchnn.py``.  There the modules wrap
a jax function behind the torch interface; the port's functions are torch,
so :class:`QuantumNet` calls ``f`` directly (autograd flows through it, on
the card through the kernels' autograd Functions), and :class:`HardwareNet`
differentiates by parameter shift alone, as hardware would.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config

__all__ = ["QuantumNet", "TorchLayer", "TorchHardwareLayer", "HardwareNet"]

Shapes = Union[Tuple[int, ...], Sequence[Tuple[int, ...]]]


def _shapes(weights_shape: Shapes) -> List[Tuple[int, ...]]:
    if weights_shape and isinstance(weights_shape[0], int):
        return [tuple(weights_shape)]  # type: ignore[arg-type]
    return [tuple(s) for s in weights_shape]  # type: ignore[union-attr]


def _parameters(weights_shape: Shapes, initializer: Optional[Callable[..., Any]]) -> torch.nn.ParameterList:
    """float32 parameters on the configured device: ``initializer(shape)``
    each (an array of any framework), else 0.1 times a standard normal."""
    dev = config.resolve_device()
    ws = torch.nn.ParameterList()
    for s in _shapes(weights_shape):
        if initializer is not None:
            w0 = initializer(s)
            w0 = w0.detach() if isinstance(w0, torch.Tensor) else torch.as_tensor(np.asarray(w0))
            w0 = w0.to(device=dev, dtype=torch.float32).reshape(s).clone()
        else:
            w0 = 0.1 * torch.randn(*s, device=dev)
        ws.append(torch.nn.Parameter(w0))
    return ws


class QuantumNet(torch.nn.Module):
    """``f(*weights, *inputs)`` as a module whose weights are trained.

    ``weights_shape``: one shape or a list of shapes; ``initializer(shape)``
    gives each weight's start (default 0.1 times a standard normal).
    ``use_jit=True`` runs ``f`` under ``backend.jit`` (a captured CUDA graph
    a signature on the card), kept trainable by
    ``interfaces.torch.trainable_jit``: one replay computes the value and
    the gradients.  ``use_interface(f, jit=use_jit)`` wraps ``f`` when
    given (e.g. ``interfaces.torch_interface`` for numpy or jax inputs);
    by default ``f`` is called directly.  ``enable_dlpack`` is kept for the
    JAX package's signature (which ignores it too)."""

    def __init__(
        self,
        f: Callable[..., Any],
        weights_shape: Shapes,
        initializer: Optional[Callable[..., Any]] = None,
        use_jit: bool = False,
        enable_dlpack: bool = False,
        use_interface: Optional[Callable[..., Any]] = None,
    ) -> None:
        super().__init__()
        if use_interface is not None:
            self.f = use_interface(f, jit=use_jit)
        elif use_jit:
            from .interfaces.torch import trainable_jit

            self.f = trainable_jit(f)
        else:
            self.f = f
        self.ws = _parameters(weights_shape, initializer)

    def forward(self, *inputs: Any) -> Any:
        return self.f(*self.ws, *inputs)


TorchLayer = QuantumNet


class _ParameterShift(torch.autograd.Function):
    """``f(*ws)`` with no autograd inside: the backward pass is
    ``experimental.parameter_shift_grad`` of ⟨dy, f⟩ (the shifted
    evaluations vmapped)."""

    @staticmethod
    def forward(ctx: Any, f: Callable[..., Any], *ws: torch.Tensor) -> torch.Tensor:
        ctx.f = f
        ctx.save_for_backward(*ws)
        with torch.no_grad():
            return f(*ws)

    @staticmethod
    def backward(ctx: Any, dy: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        from .experimental import parameter_shift_grad

        ws = ctx.saved_tensors
        f = ctx.f

        def weighted(*w: torch.Tensor) -> torch.Tensor:
            return torch.sum(dy * torch.real(f(*w)))

        with torch.no_grad():
            grads = parameter_shift_grad(weighted, argnums=tuple(range(len(ws))))(*ws)
        return (None,) + tuple(grads)


class HardwareNet(torch.nn.Module):
    """``f(*weights)`` trained by parameter-shift gradients, as on a QPU.

    The forward pass runs ``f`` without autograd; the backward pass is the
    two-term shift rule (``experimental.parameter_shift_grad``) of the
    cotangent-weighted output, so ``f`` may be anything that evaluates
    (Pauli-generated gates in its weights for the rule to be exact)."""

    def __init__(self, f: Callable[..., Any], weights_shape: Shapes,
                 initializer: Optional[Callable[..., Any]] = None, **kws: Any) -> None:
        super().__init__()
        self.f = f
        self.ws = _parameters(weights_shape, initializer)

    def forward(self) -> Any:
        return _ParameterShift.apply(self.f, *self.ws)


TorchHardwareLayer = HardwareNet
