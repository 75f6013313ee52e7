"""Application-level research workflows (reference ``applications/``).

Counterpart of ``tensorcircuit_ng_tpu/applications/``: QUBO/CVaR
optimization, DQAS differentiable architecture search, the autoregressive
models (MADE, PixelCNN, mean field) and VQNHE, the layer generators and
graph datasets, on the port's circuits.  The training loops are
``torch.optim``; random draws keep numpy wherever the JAX package uses
numpy, and take a ``torch.Generator`` where it draws from ``jax.random``.
As in the JAX package, eight modules are imported and four listed in
``__all__``; ``van`` and ``vags`` load as submodules.
"""

from . import optimization
from . import dqas
from . import layers
from . import graphdata
from . import finance
from . import physics
from . import ensemble
from . import vqes

__all__ = ["optimization", "dqas", "layers", "graphdata"]
