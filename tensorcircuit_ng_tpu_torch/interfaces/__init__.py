"""Bridges from other frameworks into the port.

Counterpart of ``tensorcircuit_ng_tpu/interfaces/``.  The port's functions
are torch, so the bridges run the other way round from the JAX package's:
they carry numpy, scipy and tensorflow callers into torch, with gradients
through each (a torch caller needs none: :func:`torch_interface` is the
function itself).  The JAX package's ``jax_interface``, ``jax_wrapper`` and
``create_jax_function`` are left out: there they are the identity on the
package's own framework, and the port never imports jax.
"""

from .numpy import np_interface, numpy_interface
from .scipy import scipy_interface, scipy_optimize_interface
from .tensorflow import tensorflow_interface, tf_interface
from .tensortrans import general_args_to_numpy, numpy_args_to_backend
from .torch import pytorch_interface, torch_interface, torch_interface_kws

__all__ = [
    "tensorflow_interface",
    "tf_interface",
    "torch_interface",
    "torch_interface_kws",
    "pytorch_interface",
    "scipy_interface",
    "scipy_optimize_interface",
    "numpy_interface",
    "np_interface",
    "general_args_to_numpy",
    "numpy_args_to_backend",
]
