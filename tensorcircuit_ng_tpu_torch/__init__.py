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

Time evolution of a matrix product state in Vidal form::

    eng = tct.ParallelTEBD(60, 64, initial="neel")   # on the card
    for _ in range(10):
        eng.trotter_step(gates)                      # (nb, 4, 4) or (4, 4)

Copies, composition, remapping and the inverse (a Loschmidt echo), the
circuit unitary and Pauli-string expectations::

    c = tct.Circuit(8, device="cpu")
    c.h_layer()
    c.zzrx_layer(pairs, zz, rx)
    echo = c.copy().append(c.inverse())           # back to |0...0>
    u = c.matrix()                                # (256, 256)
    e = c.expectation_ps(ps=[3, 3, 0, 0, 0, 0, 0, 0])

Shots, counts and feed-forward (uniforms from ``status``, or from a
``torch.Generator`` on the circuit's device, or from ``tct.backend``'s
implicit generator, seeded by ``tct.backend.set_random_state(seed)``)::

    counts = c.sample(batch=8192, allow_state=True, format="count_dict_bin")
    bits, prob = c.sample(allow_state=False, status=np.random.rand(1, 8))
    e = c.sample_expectation_ps(z=[0, 1], shots=8192)
    m = c.cond_measurement(0)                     # collapse, outcome on the device
    c.conditional_gate(m, [np.eye(2), x_matrix], 1)

Noise: Monte-Carlo trajectories on a ``Circuit`` (one uniform a channel
site chooses each branch), the exact channels on a ``DMCircuit``::

    nc = tct.NoiseConf()
    nc.add_noise("zzrx_layer", tct.channels.depolarizingchannel(0.005, 0.005, 0.005))
    e = c.expectation_ps(z=[0, 1], noise_conf=nc, nmc=64)       # trajectory mean
    exact = tct.circuit_with_noise(c.to_dm_circuit(), nc).expectation_ps(z=[0, 1])
    c.amplitudedamping(3, gamma=0.02, p=1.0)        # one trajectory, in place

On the card the fused TFIM layers and the TEBD truncation SVD run
hand-written Hopper kernels (``core/csrc/``, built by nvcc at first use
into ``build/kernels/``); on the CPU (``device="cpu"`` or
``set_device("cpu")``) they run their plain torch versions.
"""

from . import config, convert, noisemodel, quantum
from .backend import TorchBackend, backend
from .config import (
    dtypestr,
    get_backend,
    get_device,
    get_dtype,
    runtime_backend,
    runtime_dtype,
    set_backend,
    set_device,
    set_dtype,
    set_function_backend,
    set_function_dtype,
)
from .models.circuit import Circuit, expectation
from .models.densitymatrix import DMCircuit, DMCircuit2, DensityMatrixCircuit
from .noisemodel import NoiseConf, circuit_with_noise
from .models.tebd import ParallelTEBD
from .ops import channels, gates
from .ops.gates import Gate, array_to_tensor, num_to_tensor

__all__ = [
    "Circuit",
    "DMCircuit",
    "DMCircuit2",
    "DensityMatrixCircuit",
    "Gate",
    "NoiseConf",
    "ParallelTEBD",
    "TorchBackend",
    "array_to_tensor",
    "backend",
    "channels",
    "circuit_with_noise",
    "config",
    "convert",
    "dtypestr",
    "expectation",
    "gates",
    "get_backend",
    "get_device",
    "get_dtype",
    "num_to_tensor",
    "quantum",
    "runtime_backend",
    "runtime_dtype",
    "set_backend",
    "set_device",
    "set_dtype",
    "set_function_backend",
    "set_function_dtype",
]
