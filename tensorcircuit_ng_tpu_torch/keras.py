"""tf.keras layers around the port's quantum functions.

Counterpart of ``tensorcircuit_ng_tpu/keras.py``.  :func:`KerasLayer` runs
``f(*weights, x)`` for each row of the keras batch through the tensorflow
bridge (``interfaces.tensorflow_interface``), the rows mapped by
``torch.func.vmap`` as the JAX package maps them by ``jax.vmap``.
:func:`KerasHardwareLayer` differentiates by parameter shift.  The JAX
package's flax ``QuantumLayer`` is left out (the port never imports jax;
its layer is ``torchnn.QuantumNet``): ``QuantumLayer`` is None and
``HardwareLayer`` the keras hardware layer, the JAX package's own branch
where flax is missing.  TensorFlow is imported when a layer is built.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = [
    "QuantumLayer",
    "KerasLayer",
    "KerasHardwareLayer",
    "HardwareLayer",
    "output_asis_loss",
    "save_func",
    "load_func",
]

#: the flax layer of the JAX package, left out (see the module docstring)
QuantumLayer = None


def save_func(f: Callable[..., Any], path: str, *args: Any, **kws: Any) -> None:
    """Export ``f`` at the example inputs (``torch.export``,
    ``experimental.jax_jitted_function_save``)."""
    from .experimental import jax_jitted_function_save

    jax_jitted_function_save(path, f, *args, **kws)


def load_func(path: str) -> Callable[..., Any]:
    """The function :func:`save_func` wrote."""
    from .experimental import jax_jitted_function_load

    return jax_jitted_function_load(path)


def _shapes(weights_shape: Any) -> List[Tuple[int, ...]]:
    if weights_shape and isinstance(weights_shape[0], int):
        return [tuple(weights_shape)]
    return [tuple(s) for s in weights_shape]


def _batched(f: Callable[..., Any], nw: int) -> Callable[..., Any]:
    """``f(*ws, x)`` over the rows of x (keras feeds (batch, features);
    the weights are shared)."""

    def run(*a: Any) -> Any:
        return torch.func.vmap(lambda x: f(*a[:nw], x))(a[nw])

    return run


def _layer(f: Callable[..., Any], weights_shape: Any, hardware: bool, **kws: Any) -> Any:
    import tensorflow as tf

    from .interfaces.tensorflow import tensorflow_interface
    from .interfaces.tensortrans import numpy_args_to_backend

    shapes = _shapes(weights_shape)

    class _Layer(tf.keras.layers.Layer):  # type: ignore[misc]
        def build(self, input_shape: Any) -> None:
            self.ws = [
                self.add_weight(name=f"w{i}", shape=s,
                                initializer=tf.keras.initializers.RandomNormal(stddev=0.1), trainable=True)
                for i, s in enumerate(shapes)
            ]

        def call(self, inputs: Any) -> Any:
            run = _batched(f, len(self.ws))
            # plain tensors, not the Variables: tf.custom_gradient over raw
            # Variables wants the ``variables=`` protocol; reading them first
            # lets the gradients reach the Variables through the read
            args = [tf.convert_to_tensor(w) for w in self.ws] + [tf.convert_to_tensor(inputs)]
            if not hardware:
                return tensorflow_interface(run)(*args)
            return _shift_call(tf, run, numpy_args_to_backend)(*args)

    return _Layer(**kws)


def _shift_call(tf: Any, run: Callable[..., Any], to_torch: Callable[..., Any]) -> Callable[..., Any]:
    """``run`` for TensorFlow with every argument's gradient by parameter
    shift (``experimental.parameter_shift_grad`` of ⟨dy, run⟩)."""
    from .experimental import parameter_shift_grad

    @tf.custom_gradient
    def call(*tf_args: Any) -> Any:
        xs = to_torch([a.numpy() for a in tf_args])
        with torch.no_grad():
            y = run(*xs)

        def grad(dy: Any, variables: Any = None) -> Any:
            cot = torch.as_tensor(np.asarray(dy)).to(device=y.device, dtype=y.dtype)
            with torch.no_grad():
                gs = parameter_shift_grad(lambda *a: torch.sum(cot * torch.real(run(*a))),
                                          argnums=tuple(range(len(xs))))(*xs)
            out = [tf.convert_to_tensor(g.cpu().numpy()) for g in gs]
            return (out, []) if variables is not None else out

        return tf.convert_to_tensor(y.cpu().numpy()), grad

    return call


def KerasLayer(f: Callable[..., Any], weights_shape: Any, **kws: Any) -> Any:
    """A ``tf.keras.layers.Layer`` of ``f(*weights, x)`` over the rows of
    its input, gradients by ``torch.autograd``; ``kws`` go to the layer."""
    return _layer(f, weights_shape, hardware=False, **kws)


def KerasHardwareLayer(f: Callable[..., Any], weights_shape: Any, **kws: Any) -> Any:
    """:func:`KerasLayer` whose gradients (in the weights and the inputs)
    are parameter-shift ones, as on a QPU.  (The JAX package builds the
    shift rule and drops it: its layer's gradients are jax's own, Queue 3
    F23 of ``ROADMAP.md``.)"""
    return _layer(f, weights_shape, hardware=True, **kws)


def HardwareLayer(f: Callable[..., Any], weights_shape: Any, **kws: Any) -> Any:
    """The QPU-backed layer: :func:`KerasHardwareLayer`."""
    return KerasHardwareLayer(f, weights_shape, **kws)


def output_asis_loss(y_true: Any, y_pred: Any) -> Any:
    """The loss that is the model's output."""
    return y_pred
