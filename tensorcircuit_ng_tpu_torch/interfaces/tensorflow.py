"""The tensorflow interface: a port function in a TensorFlow program.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/tensorflow.py``.  The
function is exposed through ``tf.custom_gradient``: the forward pass runs
it on torch tensors on the configured device, the backward pass is
``torch.autograd.grad`` with the incoming cotangent.  A complex input's
gradient is handed to TensorFlow in the JAX package's convention (the
conjugate of torch's, ``ROADMAP.md``'s port rules), so both packages'
bridges give TensorFlow the same numbers.  TensorFlow is imported when a
wrapper is built.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..backend import backend as K
from .tensortrans import general_args_to_numpy, numpy_args_to_backend
from .torch import _jax_conj, vjp_of

__all__ = ["tensorflow_interface", "tf_interface", "tf_dtype", "tf_wrapper"]


def tensorflow_interface(fun: Callable[..., Any], ydtype: Any = None, jit: bool = False) -> Callable[..., Any]:
    """``fun`` (tensors in, one tensor out) for TensorFlow callers, with
    gradients; ``ydtype`` casts the output (a dtype name or a
    ``tf.DType``); ``jit=True`` runs the forward pass and the
    vector-Jacobian product under ``backend.jit``."""
    import tensorflow as tf

    forward = K.jit(fun) if jit else fun
    backward = vjp_of(fun)
    if jit:
        backward = K.jit(backward)

    def wrapper(*args: Any) -> Any:
        @tf.custom_gradient
        def run(*tf_args: Any) -> Any:
            xs = numpy_args_to_backend([a.numpy() if hasattr(a, "numpy") else np.asarray(a) for a in tf_args])
            with torch.no_grad():
                y = forward(*xs)

            def grad(dy: Any, variables: Any = None) -> Any:
                cot = _jax_conj(torch.as_tensor(np.asarray(dy)).to(device=y.device, dtype=y.dtype))
                gs = backward(*xs, cot)
                out = [tf.convert_to_tensor(_jax_conj(g).detach().cpu().numpy()) for g in gs]
                return (out, []) if variables is not None else out

            y_np = y.detach().resolve_conj().cpu().numpy()
            return tf.convert_to_tensor(y_np if ydtype is None else y_np.astype(tf_dtype(ydtype).as_numpy_dtype)), grad

        return run(*args)

    return wrapper


tf_interface = tensorflow_interface


def tf_dtype(dtype: Any) -> Any:
    """A dtype name, numpy dtype or ``tf.DType`` as a ``tf.DType``."""
    import tensorflow as tf

    if isinstance(dtype, tf.DType):
        return dtype
    return tf.as_dtype(dtype if isinstance(dtype, str) else str(np.dtype(dtype)))


def tf_wrapper(fun: Callable[..., Any]) -> Callable[..., Any]:
    """``fun`` taking and returning TensorFlow tensors (no gradient): numpy
    in between, torch on the configured device inside."""

    def wrapped(*args: Any, **kws: Any) -> Any:
        import tensorflow as tf

        out = fun(*numpy_args_to_backend(general_args_to_numpy(args)), **kws)
        return pytree.tree_map(lambda x: tf.convert_to_tensor(np.asarray(x)), general_args_to_numpy(out))

    return wrapped
