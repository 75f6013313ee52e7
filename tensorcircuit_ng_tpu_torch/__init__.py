"""tensorcircuit_ng_tpu_torch: the PyTorch/CUDA port of tensorcircuit_ng_tpu.

A second package beside the JAX one.  It imports torch, numpy and scipy,
never JAX and nothing of ``tensorcircuit_ng_tpu``.  Circuits run on the
CUDA card unless the caller asks for the CPU::

    import tensorcircuit_ng_tpu_torch as tct
    c = tct.Circuit(20)                    # device="cuda" by default
    c.h_layer()
    for l in range(4):
        c.zzrx_layer(pairs, zz[l], rx[l])
    e = c.expectation_zzx_energy(pairs, 1.0, -1.0)

On the card the fused TFIM layers run hand-written Hopper kernels
(``core/csrc/``, built by nvcc at first use into ``build/kernels/``); on
the CPU (``device="cpu"`` or ``set_device("cpu")``) they run their plain
torch versions.
"""

from . import config, convert
from .config import dtypestr, get_device, set_device, set_dtype
from .models.circuit import Circuit

__all__ = ["Circuit", "config", "convert", "dtypestr", "get_device", "set_device", "set_dtype"]
