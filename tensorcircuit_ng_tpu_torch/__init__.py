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

Past the dense cliff (above 30 qubits; a ``DMCircuit2`` above 14) the
readouts contract the circuit's einsum IR, planned by opt_einsum and, for
networks above 10^10 FLOPs, the native TreeSA annealer (``native/treesa.cpp``,
built by g++ at first use into ``build/native/``)::

    c = tct.Circuit(49)                           # a 7x7 grid, say
    ...
    a = c.amplitude("0" * 49)                     # no 2^49 state
    e = c.expectation((tct.gates.z(), [24]))      # light-cone pruned
    ir = c.amplitude_before("0" * 49)
    tct.contraction_info(ir)                      # FLOPs, largest intermediate
    sl = tct.cons.choose_slices(ir, 2**26)
    a = tct.cons.sliced_contract_ir(ir, sl)

Matrix product states: ``MPSCircuit`` takes the gate methods with a bond
cap, ``FiniteMPS`` measures local operators and correlators on its
tensors, and ``dmrg`` finds ground states (complex128 sweeps) whose tensors
feed both and ``Circuit(mps_inputs=...)``::

    m = tct.MPSCircuit(60, split={"max_singular_values": 64})   # on the card
    m.h(0); m.rzz(0, 1, theta=0.3)
    e = m.expectation_ps(z=[0, 1])
    shots = m.sample(1024, format="sample_bin")
    energy, tensors = tct.dmrg.dmrg(tct.dmrg.xxz_mpo(12, 1.0), chi=16, sweeps=6)
    c = tct.Circuit(12, mps_inputs=tensors)
    zz = tct.FiniteMPS(tensors).measure_two_body_correlator(z, z, 5, range(12))

Operators as dense QuOperators (``@``, ``|``, ``adjoint``,
``partial_trace``)::

    qv = c.get_quvector(); qo = c.get_quoperator()
    rho = tct.DMCircuit(4, mps_inputs=m4).get_dm_as_quoperator()

Hamiltonians as a COO tensor (built and coalesced on the device), a dense
matrix or a matrix-free product, the quantum-information toolbox, and the
templates (lattices, graphs, Hamiltonians, blocks, ansätze, measurements)::

    h = tct.templates.hamiltonians.tfim_hamiltonian(20)     # COO, on the card
    e = tct.templates.measurements.operator_expectation(c, h)
    mvp = tct.PauliStringSum2MVP([[3, 3, 0], [1, 0, 0]], [1.0, -1.0])
    s = tct.quantum.entanglement_entropy(c.state(), 10)     # differentiable
    with tct.set_device("cpu"):
        hc = tct.PauliStringSum2COO([[3, 3, 0], [1, 0, 0]], [1.0, -1.0])

Clifford circuits on the stabilizer tableau (host C++, built by g++ at first
use into ``build/native/``), QEC detectors on the dense circuit (the shots as
one ``[shots, 2^n]`` state on the card), qudits and one U(1) sector::

    s = tct.StabilizerCircuit(49)                 # state(), readouts on the card
    s.h(0); s.cnot(0, 1)
    shots = s.sample(8192, format="sample_bin")
    c = tct.Circuit(17)
    c.depolarizing(3, px=0.01 / 3, py=0.01 / 3, pz=0.01 / 3)
    c.measure_instruction(3); c.detector(-1)
    det = c.sample_detector(1024)                 # [1024, n_det] int32
    p = c.detector_probabilities_exact()          # by density matrices
    q = tct.QuditCircuit(12, dim=3); q.csum(0, 1)
    u = tct.U1Circuit(24, k=12); u.rzz(0, 1, theta=0.3)

Free fermions (the 2L x L Bogoliubov matrix on the card), hybrid
digital-analog circuits (ODE blocks between digital segments), Pauli
propagation (the truncated observable on the card) and sympy circuits (the
algebra on the host, bound to numbers for the card)::

    f = tct.FGSSimulator(512, filled=range(0, 512, 2))
    f.evol_hp(0, 1, 0.3); f.cond_measure(7, status=0.4)
    s = f.entropy(range(256))
    a = tct.AnalogCircuit(18); a.h_layer()
    a.add_analog_block(lambda t: h_of(t), 0.5)    # a matrix, COO or mvp of t
    e = a.expectation_ps(z=[0, 1])
    zz = tct.pauli_propagation(c, [3, 3] + [0] * 38, k=3)
    theta = sympy.Symbol("theta")
    sc = tct.SymbolCircuit(4); sc.rx(0, theta=theta)
    c = sc.to_circuit({theta: 0.3})              # the port's Circuit

On the card the fused TFIM layers and the TEBD truncation SVD run
hand-written Hopper kernels (``core/csrc/``, built by nvcc at first use
into ``build/kernels/``); on the CPU (``device="cpu"`` or
``set_device("cpu")``) they run their plain torch versions.
"""

from typing import Any

__version__ = "0.1.0"

from . import (
    asciiart,
    compiler,
    config,
    convert,
    dmrg,
    experimental,
    noisemodel,
    quantum,
    shadows,
    simplify,
    templates,
    timeevol,
    translation,
    utils,
    vis,
)
from .about import about, cite
from .backend import TorchBackend, backend
from .config import (
    dtypestr,
    get_backend,
    get_contractor,
    get_device,
    get_dtype,
    runtime_backend,
    runtime_contractor,
    runtime_dtype,
    set_backend,
    set_contractor,
    set_device,
    set_dtype,
    set_function_backend,
    set_function_contractor,
    set_function_dtype,
)
from .core.contractor import contraction_info, get_tn_info
from .models import fgs
from .models.analogcircuit import AnalogBlock, AnalogCircuit
from .models.circuit import Circuit, expectation
from .models.fgs import FGSCircuit, FGSSimulator, FGSTestSimulator
from .models.pauliprop import PauliPropagationEngine, SparsePauliPropagationEngine, pauli_propagation
from .models.symbolcircuit import SymbolCircuit
from .models.densitymatrix import DMCircuit, DMCircuit2, DensityMatrixCircuit
from .models.mps_base import FiniteMPS
from .models.mpscircuit import MPSCircuit
from .noisemodel import NoiseConf, circuit_with_noise
from .models.quditcircuit import QuditCircuit
from .models.stabilizercircuit import StabilizerCircuit
from .models.tebd import ParallelTEBD
from .models.u1circuit import U1Circuit, U1Operator
from .ops import channels, gates, quditgates, symbolgates
from .ops.gates import Gate, array_to_tensor, num_to_tensor
from .quantum import (
    LinearOperator,
    PauliStringSum2COO,
    PauliStringSum2Dense,
    PauliStringSum2MVP,
    QuAdjointVector,
    QuOperator,
    QuScalar,
    QuVector,
    aslinearoperator,
)

CliffordCircuit = StabCircuit = StabilizerCircuit


def __getattr__(name: str) -> Any:
    """``parallel``, ``DistributedContractor``, ``results``, ``cloud``, the
    ML bridges (``interfaces``, ``torchnn``, ``keras`` and their layers),
    ``zx`` and ``applications``, imported at first use, as the JAX package
    exports them."""
    import importlib

    lazy = {
        "parallel": (".parallel", None),
        "DistributedContractor": (".parallel.distributed", "DistributedContractor"),
        "results": (".results", None),
        "cloud": (".cloud", None),
        "zx": (".zx", None),
        "applications": (".applications", None),
        "interfaces": (".interfaces", None),
        "keras": (".keras", None),
        "torchnn": (".torchnn", None),
        "QuantumNet": (".torchnn", "QuantumNet"),
        "TorchLayer": (".torchnn", "TorchLayer"),
        "HardwareNet": (".torchnn", "HardwareNet"),
        "TorchHardwareLayer": (".torchnn", "TorchHardwareLayer"),
        "KerasLayer": (".keras", "KerasLayer"),
        "KerasHardwareLayer": (".keras", "KerasHardwareLayer"),
        "QuantumLayer": (".keras", "QuantumLayer"),
    }
    if name not in lazy:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod, attr = lazy[name]
    m = importlib.import_module(mod, __name__)
    return m if attr is None else getattr(m, attr)

#: the runtime configuration, with the contractor's helpers on it, as the
#: JAX package names it
cons = config

__all__ = [
    "AnalogBlock",
    "AnalogCircuit",
    "Circuit",
    "CliffordCircuit",
    "DMCircuit",
    "DMCircuit2",
    "DensityMatrixCircuit",
    "FGSCircuit",
    "FGSSimulator",
    "FGSTestSimulator",
    "FiniteMPS",
    "Gate",
    "LinearOperator",
    "MPSCircuit",
    "NoiseConf",
    "PauliPropagationEngine",
    "ParallelTEBD",
    "PauliStringSum2COO",
    "PauliStringSum2Dense",
    "PauliStringSum2MVP",
    "QuAdjointVector",
    "QuOperator",
    "QuScalar",
    "QuVector",
    "QuditCircuit",
    "SparsePauliPropagationEngine",
    "StabCircuit",
    "StabilizerCircuit",
    "SymbolCircuit",
    "TorchBackend",
    "about",
    "asciiart",
    "cite",
    "compiler",
    "U1Circuit",
    "U1Operator",
    "array_to_tensor",
    "aslinearoperator",
    "backend",
    "channels",
    "circuit_with_noise",
    "config",
    "cons",
    "contraction_info",
    "convert",
    "dmrg",
    "dtypestr",
    "experimental",
    "fgs",
    "expectation",
    "gates",
    "get_backend",
    "get_contractor",
    "get_device",
    "get_dtype",
    "get_tn_info",
    "num_to_tensor",
    "pauli_propagation",
    "quantum",
    "quditgates",
    "runtime_backend",
    "runtime_contractor",
    "runtime_dtype",
    "set_backend",
    "set_contractor",
    "set_device",
    "set_dtype",
    "set_function_backend",
    "set_function_contractor",
    "set_function_dtype",
    "shadows",
    "simplify",
    "symbolgates",
    "templates",
    "timeevol",
    "translation",
    "utils",
    "vis",
]
