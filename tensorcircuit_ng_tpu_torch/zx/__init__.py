"""ZX-calculus subsystem.

Counterpart of ``tensorcircuit_ng_tpu/zx/``: a self-contained ZX graph
(:mod:`graph`, :mod:`graph_s`; no pyzx), circuit-to-ZX conversion and the
noisy sampling-graph construction (:mod:`converter`), spider-fusion
simplification, tensor evaluation through the port's einsum IR and
contractor on the device, exact scalar arithmetic on int32 tensors
(:class:`~tensorcircuit_ng_tpu_torch.zx.evaluator.ExactScalarArray`),
Pauli-noise channel algebra (:mod:`noise_model`), compiled sampling
programs on one batched dense state (:mod:`scalar_graph`), and the
stabilizer+T circuit with exact conditional outcome sampling
(:class:`~tensorcircuit_ng_tpu_torch.zx.stabilizertcircuit.StabilizerTCircuit`).
"""

from .graph import ZXGraph, Spider
from .graph_s import GraphS, VertexType, EdgeType, Scalar
from .converter import (
    circuit_to_zx,
    build_amplitude_graph,
    prepare_graph,
    SamplingGraph,
    GraphRepresentation,
)
from .evaluator import ExactScalarArray, gf2_matmul, gf2_rank, evaluate
from .simplifier import simplify, remove_identities, color_change
from .noise_model import Channel, ChannelSampler
from .scalar_graph import (
    CompiledComponent,
    CompiledProgram,
    CompiledScalarGraphs,
    compile_program,
    find_stab,
)
from .stabilizertcircuit import StabilizerTCircuit, sample_component, sample_program
from .utils import connected_components, ConnectedComponent, find_basis

__all__ = [
    "ZXGraph",
    "Spider",
    "circuit_to_zx",
    "build_amplitude_graph",
    "prepare_graph",
    "SamplingGraph",
    "ExactScalarArray",
    "gf2_matmul",
    "gf2_rank",
    "evaluate",
    "simplify",
    "remove_identities",
    "color_change",
    "Channel",
    "ChannelSampler",
    "CompiledComponent",
    "CompiledProgram",
    "CompiledScalarGraphs",
    "compile_program",
    "find_stab",
    "StabilizerTCircuit",
    "sample_component",
    "sample_program",
    "connected_components",
    "ConnectedComponent",
    "find_basis",
]
