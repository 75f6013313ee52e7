"""Circuit to ZX-graph conversion and the sampling graphs of noisy programs.

Counterpart of ``tensorcircuit_ng_tpu/zx/converter.py``: host Python over
the port's QIR (a gate's angle read once from its device) and the
``StabilizerTCircuit`` tape.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .graph import ZXGraph

__all__ = ["circuit_to_zx"]


def _angle(theta: Any) -> float:
    """A gate parameter (a number, numpy or a tensor on any device) as a
    real float."""
    if theta is None:
        return 0.0
    if isinstance(theta, torch.Tensor):
        return float(torch.real(theta.detach()).reshape(()).cpu())
    return float(np.real(np.asarray(theta)))


def circuit_to_zx(c: Any) -> ZXGraph:
    """Convert a circuit's QIR into a ZX diagram.

    Supported gates: h, x, y, z, s, sd, t, td, rz, rx, cz, cnot, swap,
    cphase, rzz (phase gadget).  The diagram's open legs are the circuit's
    input and output wires.
    """
    n = c.nqubits
    g = ZXGraph()
    frontier: List[int] = []
    for q in range(n):
        b = g.add_spider("B")
        g.inputs.append(b)
        frontier.append(b)
    # frontier edges are "pending": we connect as we append spiders
    pending_had = [False] * n  # a pending hadamard on the wire

    def attach(q: int, sid: int) -> None:
        g.add_edge(frontier[q], sid, hadamard=pending_had[q])
        pending_had[q] = False
        frontier[q] = sid

    for item in c.to_qir():
        name = (item.get("name") or "").lower()
        idx = item["index"]
        params = item.get("parameters", {})
        tval = _angle(params.get("theta"))
        if name == "h":
            pending_had[idx[0]] = not pending_had[idx[0]]
        elif name in ("z", "s", "sd", "t", "td", "rz", "phase"):
            phase = {
                "z": math.pi,
                "s": math.pi / 2,
                "sd": -math.pi / 2,
                "t": math.pi / 4,
                "td": -math.pi / 4,
            }.get(name, tval)
            if name == "rz":
                phase = tval
                # rz = e^{-iθ/2} Z-phase(θ): global phase tracked separately
            s = g.add_spider("Z", phase)
            attach(idx[0], s)
        elif name in ("x", "rx"):
            phase = math.pi if name == "x" else tval
            s = g.add_spider("X", phase)
            attach(idx[0], s)
        elif name == "y":
            s1 = g.add_spider("Z", math.pi)
            attach(idx[0], s1)
            s2 = g.add_spider("X", math.pi)
            attach(idx[0], s2)
        elif name in ("cnot", "cx"):
            cq, tq = idx
            zc = g.add_spider("Z", 0.0)
            xt = g.add_spider("X", 0.0)
            attach(cq, zc)
            attach(tq, xt)
            g.add_edge(zc, xt)
            g.scalar_power2 += 1  # cnot normalization: sqrt(2)
        elif name == "cz":
            a, b = idx
            za = g.add_spider("Z", 0.0)
            zb = g.add_spider("Z", 0.0)
            attach(a, za)
            attach(b, zb)
            g.add_edge(za, zb, hadamard=True)
            g.scalar_power2 += 1
        elif name == "swap":
            a, b = idx
            frontier[a], frontier[b] = frontier[b], frontier[a]
            pending_had[a], pending_had[b] = pending_had[b], pending_had[a]
        elif name == "rzz":
            # phase gadget: Z spiders on both wires linked to an X hub with a
            # phase-θ Z head
            a, b = idx
            za = g.add_spider("Z", 0.0)
            zb = g.add_spider("Z", 0.0)
            attach(a, za)
            attach(b, zb)
            hub = g.add_spider("X", 0.0)
            head = g.add_spider("Z", tval)
            g.add_edge(za, hub)
            g.add_edge(zb, hub)
            g.add_edge(hub, head)
            g.scalar_power2 += 0
        elif name == "cphase":
            # cphase(θ) = exp(iθ/4) rz(θ/2)⊗rz(θ/2) · rzz(-θ/2)-style gadget
            a, b = idx
            za = g.add_spider("Z", tval / 2)
            zb = g.add_spider("Z", tval / 2)
            attach(a, za)
            attach(b, zb)
            hub = g.add_spider("X", 0.0)
            head = g.add_spider("Z", -tval / 2)
            g.add_edge(za, hub)
            g.add_edge(zb, hub)
            g.add_edge(hub, head)
        else:
            raise ValueError(f"gate {name!r} has no ZX conversion yet")
    for q in range(n):
        b = g.add_spider("B")
        g.add_edge(frontier[q], b, hadamard=pending_had[q])
        pending_had[q] = False
        g.outputs.append(b)
        frontier[q] = b
    return g


# ======================================================================
# stabilizer+T sampling pipeline (tsim-derived)
# ======================================================================

from dataclasses import dataclass, field


def is_pauli(name: str) -> bool:
    """True for single Pauli gate names (reference helper)."""
    return name.lower() in ("i", "x", "y", "z")


class SamplingGraph:
    """ZX graph under construction for a noisy Clifford(+T) program.

    Tracks a per-qubit frontier on a :class:`ZXGraph` plus symbolic phase
    parameters (error bits); the reference builds pyzx graphs with lanes —
    here "lanes" are frontier slots (reference ``zx/converter.py`` role).
    """

    def __init__(self, nqubits: int):
        self.n = nqubits
        self.g = ZXGraph()
        self.g.phase_vars = {}
        self.frontier: List[int] = []
        self.pending_had = [False] * nqubits
        for _q in range(nqubits):
            b = self.g.add_spider("B")
            self.g.inputs.append(b)
            self.frontier.append(b)

    # -- lane management (reference: last_row/last_edge/add_lane/...) --

    def last_row(self, q: int) -> int:
        """Frontier spider id of wire q."""
        return self.frontier[q]

    def last_edge(self, q: int) -> Optional[tuple]:
        """Most recent edge touching wire q's frontier spider."""
        sid = self.frontier[q]
        for e in reversed(self.g.edges):
            if sid in (e[0], e[1]):
                return e
        return None

    def ensure_lane(self, q: int) -> int:
        if q >= self.n:
            for extra in range(self.n, q + 1):
                self.add_lane()
        return self.frontier[q]

    def add_lane(self) -> int:
        b = self.g.add_spider("B")
        self.g.inputs.append(b)
        self.frontier.append(b)
        self.pending_had.append(False)
        self.n += 1
        return self.n - 1

    def add_dummy(self, q: int) -> int:
        """Insert a phase-free Z spider on wire q (wire marker)."""
        s = self.g.add_spider("Z", 0.0)
        self.attach(q, s)
        return s

    def attach(self, q: int, sid: int) -> None:
        self.g.add_edge(self.frontier[q], sid, hadamard=self.pending_had[q])
        self.pending_had[q] = False
        self.frontier[q] = sid

    def add_param_spider(self, q: int, kind: str, var: str) -> int:
        """Spider with phase π·var (an error-bit-controlled Pauli)."""
        s = self.g.add_spider(kind, math.pi)
        self.g.phase_vars[s] = [var]
        self.attach(q, s)
        return s

    def finalize(self) -> ZXGraph:
        for q in range(self.n):
            b = self.g.add_spider("B")
            self.g.add_edge(self.frontier[q], b, hadamard=self.pending_had[q])
            self.pending_had[q] = False
            self.g.outputs.append(b)
            self.frontier[q] = b
        return self.g


# -- single-wire graph insertions (reference zx/converter.py gate fns) --


def z_phase(sg: SamplingGraph, q: int, phase: float) -> None:
    s = sg.g.add_spider("Z", phase)
    sg.attach(q, s)


def x_phase(sg: SamplingGraph, q: int, phase: float) -> None:
    s = sg.g.add_spider("X", phase)
    sg.attach(q, s)


def y_phase(sg: SamplingGraph, q: int, phase: float) -> None:
    # Y(θ) = S X(θ) S†: conjugate an X phase by S
    z_phase(sg, q, -math.pi / 2)
    x_phase(sg, q, phase)
    z_phase(sg, q, math.pi / 2)


def x_gate(sg: SamplingGraph, q: int) -> None:
    x_phase(sg, q, math.pi)


def y_gate(sg: SamplingGraph, q: int) -> None:
    z_phase(sg, q, math.pi)
    x_phase(sg, q, math.pi)


def z_gate(sg: SamplingGraph, q: int) -> None:
    z_phase(sg, q, math.pi)


def h_gate(sg: SamplingGraph, q: int) -> None:
    sg.pending_had[q] = not sg.pending_had[q]


def sqrt_z(sg: SamplingGraph, q: int) -> None:
    z_phase(sg, q, math.pi / 2)


def sqrt_z_dag(sg: SamplingGraph, q: int) -> None:
    z_phase(sg, q, -math.pi / 2)


def sqrt_x(sg: SamplingGraph, q: int) -> None:
    x_phase(sg, q, math.pi / 2)


def sqrt_x_dag(sg: SamplingGraph, q: int) -> None:
    x_phase(sg, q, -math.pi / 2)


def sqrt_y(sg: SamplingGraph, q: int) -> None:
    y_phase(sg, q, math.pi / 2)


def sqrt_y_dag(sg: SamplingGraph, q: int) -> None:
    y_phase(sg, q, -math.pi / 2)


def h_xy(sg: SamplingGraph, q: int) -> None:
    """Hadamard-like swap of the X and Y axes: S X(π)? — canonical H_XY."""
    z_phase(sg, q, math.pi / 2)
    x_gate(sg, q)


def h_yz(sg: SamplingGraph, q: int) -> None:
    """H_YZ axis swap."""
    x_phase(sg, q, math.pi / 2)
    z_gate(sg, q)


def r_z(sg: SamplingGraph, q: int, theta: float) -> None:
    z_phase(sg, q, theta)


def r_x(sg: SamplingGraph, q: int, theta: float) -> None:
    x_phase(sg, q, theta)


def r_y(sg: SamplingGraph, q: int, theta: float) -> None:
    y_phase(sg, q, theta)


def u3(sg: SamplingGraph, q: int, theta: float, phi: float, lam: float) -> None:
    z_phase(sg, q, lam)
    y_phase(sg, q, theta)
    z_phase(sg, q, phi)


# -- error insertions as parameterized spiders --


def x_error(sg: SamplingGraph, q: int, var: str) -> None:
    sg.add_param_spider(q, "X", var)


def z_error(sg: SamplingGraph, q: int, var: str) -> None:
    sg.add_param_spider(q, "Z", var)


def y_error(sg: SamplingGraph, q: int, var: str) -> None:
    sg.add_param_spider(q, "Z", var)
    sg.add_param_spider(q, "X", var)


def depolarize1(sg: SamplingGraph, q: int, var_z: str, var_x: str) -> None:
    sg.add_param_spider(q, "Z", var_z)
    sg.add_param_spider(q, "X", var_x)


def depolarize2(sg: SamplingGraph, q1: int, q2: int, vars4: List[str]) -> None:
    depolarize1(sg, q1, vars4[0], vars4[1])
    depolarize1(sg, q2, vars4[2], vars4[3])


def pauli_channel_1(sg: SamplingGraph, q: int, var_z: str, var_x: str) -> None:
    depolarize1(sg, q, var_z, var_x)


def pauli_channel_2(sg: SamplingGraph, q1: int, q2: int, vars4: List[str]) -> None:
    depolarize2(sg, q1, q2, vars4)


def transform_error_basis(sg: SamplingGraph, q: int, basis: str) -> None:
    """Rotate the wire so a Z-basis effect measures the given Pauli basis."""
    if basis == "x":
        h_gate(sg, q)
    elif basis == "y":
        sqrt_x(sg, q)


# -- measurement / reset effects on the graph --


def m(sg: SamplingGraph, q: int, var: Optional[str] = None) -> None:
    """Computational-basis destructive measurement effect + fresh state."""
    eff = sg.g.add_spider("X", 0.0)  # outcome-parameterized in the tape
    if var is not None:
        sg.g.phase_vars[eff] = [var]
    sg.attach(q, eff)
    fresh = sg.g.add_spider("X", 0.0)
    sg.frontier[q] = fresh


def mx(sg: SamplingGraph, q: int, var: Optional[str] = None) -> None:
    transform_error_basis(sg, q, "x")
    m(sg, q, var)


def my(sg: SamplingGraph, q: int, var: Optional[str] = None) -> None:
    transform_error_basis(sg, q, "y")
    m(sg, q, var)


def mr(sg: SamplingGraph, q: int, var: Optional[str] = None) -> None:
    m(sg, q, var)


mrx, mry, mrz = mx, my, mr


def reset_z(sg: SamplingGraph, q: int) -> None:
    m(sg, q)


def reset_x(sg: SamplingGraph, q: int) -> None:
    m(sg, q)
    h_gate(sg, q)


def reset_y(sg: SamplingGraph, q: int) -> None:
    m(sg, q)
    sqrt_x_dag(sg, q)


def mpp(sg: SamplingGraph, paulis: List[tuple], var: Optional[str] = None) -> None:
    """Pauli-product measurement: rotate each wire, parity onto an ancilla."""
    anc = sg.add_lane()
    for q, p in paulis:
        transform_error_basis(sg, q, p.lower())
        zc = sg.g.add_spider("Z", 0.0)
        sg.attach(q, zc)
        xa = sg.g.add_spider("X", 0.0)
        sg.attach(anc, xa)
        sg.g.add_edge(zc, xa)
        transform_error_basis(sg, q, p.lower())  # rotate back (self-inverse for x)
    m(sg, anc, var)


def detector(sg: SamplingGraph, records: List[int]) -> None:
    """Recorded on the tape, not the graph (parities are classical)."""


def observable_include(sg: SamplingGraph, records: List[int], idx: int = 0) -> None:
    """Recorded on the tape, not the graph."""


GATE_TABLE: Dict[str, Any] = {
    "x": x_gate, "y": y_gate, "z": z_gate, "h": h_gate,
    "s": sqrt_z, "sd": sqrt_z_dag, "sdg": sqrt_z_dag,
    "sx": sqrt_x, "sxdg": sqrt_x_dag,
    "t": lambda sg, q: z_phase(sg, q, math.pi / 4),
    "td": lambda sg, q: z_phase(sg, q, -math.pi / 4),
    "tdg": lambda sg, q: z_phase(sg, q, -math.pi / 4),
    "rz": r_z, "rx": r_x, "ry": r_y, "u3": u3,
    "h_xy": h_xy, "h_yz": h_yz,
}


def squash_graph(g: ZXGraph) -> ZXGraph:
    """Fuse adjacent same-color spiders (graph shrink before evaluation)."""
    g.fuse_spiders()
    return g


def build_sampling_graph(circuit: Any) -> ZXGraph:
    """Full noisy-circuit ZX diagram with parameterized error spiders.

    Error bit ``e{k}`` is f-bit k of :func:`prepare_graph` (the same slot
    order: a Pauli channel's (z, x) bits a qubit, a one-bit channel's bit,
    a correlated chain's bit a target, a noisy measurement's flip bit,
    which stays on the tape).  A gate the table lacks raises ValueError.
    (The JAX package reads ``num_bits``/``slots`` keys that its tape items
    do not have, and a tape rotation's angle that it does not record:
    Queue 3 F24 of ``ROADMAP.md``.)"""
    sg = SamplingGraph(circuit._nqubits)
    slot = 0

    def new_slots(k: int) -> List[str]:
        nonlocal slot
        slot += k
        return [f"e{s}" for s in range(slot - k, slot)]

    for item in getattr(circuit, "_tape", None) or circuit.to_qir():
        kind = item.get("kind", "gate")
        name = (item.get("name") or "").lower()
        idx = item.get("index", ())
        if kind == "gate" and name in GATE_TABLE:
            args = (item.get("parameters") or {}).get("theta")
            if args is None:
                GATE_TABLE[name](sg, *idx)
            else:
                GATE_TABLE[name](sg, *idx, _angle(args))
        elif kind == "gate" and name in ("cx", "cnot"):
            cq, tq = idx
            zc = sg.g.add_spider("Z", 0.0)
            xt = sg.g.add_spider("X", 0.0)
            sg.attach(cq, zc)
            sg.attach(tq, xt)
            sg.g.add_edge(zc, xt)
            sg.g.scalar_power2 += 1
        elif kind == "gate" and name == "cz":
            a, b = idx
            za = sg.g.add_spider("Z", 0.0)
            zb = sg.g.add_spider("Z", 0.0)
            sg.attach(a, za)
            sg.attach(b, zb)
            sg.g.add_edge(za, zb, hadamard=True)
            sg.g.scalar_power2 += 1
        elif kind == "gate" and name == "swap":
            a, b = idx
            sg.frontier[a], sg.frontier[b] = sg.frontier[b], sg.frontier[a]
        elif kind == "gate":
            raise ValueError(f"gate {name!r} has no ZX conversion yet")
        elif kind == "channel":
            ch = item["channel"]
            if ch == "pauli1":
                depolarize1(sg, idx[0], *new_slots(2))
            elif ch == "pauli2":
                depolarize2(sg, idx[0], idx[1], new_slots(4))
            elif ch in ("x", "y", "z"):
                {"x": x_error, "y": y_error, "z": z_error}[ch](sg, idx[0], new_slots(1)[0])
            elif ch == "correlated":
                for var, (q, pauli) in zip(new_slots(len(item["params"])), item["targets"]):
                    {"x": x_error, "y": y_error, "z": z_error}[pauli](sg, q, var)
            else:
                raise ValueError(f"unknown channel kind {ch!r}")
        elif kind in ("measure", "reset"):
            if kind == "measure" and not item.get("hidden", False) and float(item.get("p", 0.0) or 0.0) > 0:
                new_slots(1)  # the record's flip: classical, on the tape
            basis = item.get("basis", "z")
            {"z": m, "x": mx, "y": my}[basis](sg, idx[0])
    return sg.finalize()


def build_amplitude_graph(circuit: Any, state: Any) -> ZXGraph:
    """⟨state|C|0…0⟩ as a closed ZX diagram (reference parity).

    Basis effects are X spiders with phase bπ; the diagram's scalar is the
    amplitude (validated against the dense engine in tests).
    """
    g = circuit_to_zx(circuit) if not isinstance(circuit, ZXGraph) else circuit
    bits = [int(b) for b in (state if not isinstance(state, str) else [int(ch) for ch in state])]
    # inputs: |0> kets (X spider phase 0 / sqrt 2); outputs: <b| effects
    for q, b_in in enumerate(g.inputs):
        sp = g.spiders[b_in]
        sp.kind = "X"
        sp.phase = 0.0
        g.scalar_power2 -= 1
    for q, b_out in enumerate(g.outputs):
        sp = g.spiders[b_out]
        sp.kind = "X"
        sp.phase = math.pi * bits[q]
        g.scalar_power2 -= 1
    g.inputs = []
    g.outputs = []
    return g


@dataclass
class PreparedGraph:
    """Dense-engine compile spec + noise metadata (converter output)."""

    n: int
    steps: List[tuple]
    num_f: int
    channel_probs: List[Any]
    error_transform: Any
    num_records: int
    visible_pos: List[Optional[int]]
    step_cut: List[int]
    detectors: List[List[int]]
    observables: List[List[int]]
    num_detectors: int = 0

    def __post_init__(self) -> None:
        self.num_detectors = len(self.detectors)


def prepare_graph(
    circuit: Any,
    sample_detectors: bool = False,
    force_measure_all: bool = False,
) -> PreparedGraph:
    """Lower a StabilizerTCircuit tape into the dense compile spec:
    collects noise
    channels (channel_probs + error transform), measurement/reset order,
    detector/observable parities; the unitary part becomes a step tape the
    scalar-graph compiler closes over.
    """
    tape = list(circuit._tape)
    if force_measure_all:
        for q in range(circuit._nqubits):
            tape.append({"kind": "measure", "index": (q,), "basis": "z", "reset": False, "p": 0.0, "hidden": False})
    steps: List[tuple] = []
    channel_probs: List[Any] = []
    slot = 0
    raw_records = 0
    visible_pos: List[Optional[int]] = []
    step_cut: List[int] = []
    detectors: List[List[int]] = []
    observables_map: Dict[int, List[int]] = {}
    visible_count = 0

    def new_slots(k: int) -> List[int]:
        nonlocal slot
        out = list(range(slot, slot + k))
        slot += k
        return out

    from . import noise_model as nm

    for item in tape:
        kind = item["kind"]
        idx = item.get("index", ())
        if kind == "gate":
            steps.append(("gate", item["matrix"], tuple(idx)))
        elif kind == "channel":
            ch = item["channel"]
            if ch == "pauli1":
                s = new_slots(2)
                channel_probs.append(nm.pauli_channel_1_probs(*item["params"]))
                steps.append(("pauli_zx", idx[0], s[0], s[1]))
            elif ch == "pauli2":
                s = new_slots(4)
                channel_probs.append(nm.pauli_channel_2_probs(*item["params"]))
                steps.append(("pauli_zx", idx[0], s[0], s[1]))
                steps.append(("pauli_zx", idx[1], s[2], s[3]))
            elif ch == "x":
                s = new_slots(1)
                channel_probs.append(nm.error_probs(item["params"][0]))
                steps.append(("pauli_zx", idx[0], None, s[0]))
            elif ch == "z":
                s = new_slots(1)
                channel_probs.append(nm.error_probs(item["params"][0]))
                steps.append(("pauli_zx", idx[0], s[0], None))
            elif ch == "y":
                s = new_slots(1)
                channel_probs.append(nm.error_probs(item["params"][0]))
                steps.append(("pauli_zx", idx[0], s[0], s[0]))
            elif ch == "correlated":
                s = new_slots(len(item["params"]))
                channel_probs.append(nm.correlated_error_probs(item["params"]))
                for b, (q, pauli) in zip(s, item["targets"]):
                    if pauli in ("x", "y"):
                        steps.append(("pauli_zx", q, None, b))
                    if pauli in ("z", "y"):
                        steps.append(("pauli_zx", q, b, None))
            else:
                raise ValueError(f"unknown channel kind {ch!r}")
        elif kind in ("measure", "reset"):
            hidden = kind == "reset" or item.get("hidden", False)
            flip_slot = None
            p = float(item.get("p", 0.0) or 0.0)
            if p > 0 and not hidden:
                flip_slot = new_slots(1)[0]
                channel_probs.append(nm.error_probs(p))
            basis = item.get("basis", "z")
            reset = kind == "reset" or item.get("reset", False)
            steps.append(("measure", idx[0], basis, reset, flip_slot, hidden))
            if hidden:
                visible_pos.append(None)
            else:
                visible_pos.append(visible_count)
                visible_count += 1
                step_cut.append(len(steps))
            raw_records += 1
        elif kind == "detector":
            recs = [r if r >= 0 else visible_count + r for r in item["records"]]
            if any(r < 0 or r >= visible_count for r in recs):
                raise ValueError(
                    f"detector references record(s) {item['records']} but only "
                    f"{visible_count} measurement record(s) exist at this point"
                )
            detectors.append(recs)
        elif kind == "observable":
            recs = [r if r >= 0 else visible_count + r for r in item["records"]]
            if any(r < 0 or r >= visible_count for r in recs):
                raise ValueError(
                    f"observable references record(s) {item['records']} but only "
                    f"{visible_count} measurement record(s) exist at this point"
                )
            observables_map.setdefault(int(item.get("idx", 0)), []).extend(recs)
        elif kind in ("tick", "coords"):
            continue
        else:
            raise ValueError(f"unknown tape item {kind!r}")

    observables = [observables_map[k] for k in sorted(observables_map)]
    return PreparedGraph(
        n=circuit._nqubits,
        steps=steps,
        num_f=slot,
        channel_probs=channel_probs,
        error_transform=np.eye(max(slot, 1), dtype=np.uint8)[: slot or 1, : slot or 1],
        num_records=visible_count,
        visible_pos=visible_pos,
        step_cut=step_cut,
        detectors=detectors,
        observables=observables,
    )


# ======================================================================
# GraphRepresentation: mutable pyzx-style graph + measurement bookkeeping
# (reference zx/converter.py:57-320 wraps pyzx Multigraph; ours wraps the
# standalone GraphS from graph_s.py)
# ======================================================================

from .graph_s import EdgeType, GraphS, VertexType  # noqa: E402


@dataclass
class GraphRepresentation:
    """Mutable ZX graph plus record/detector/observable bookkeeping.

    Thin stateful wrapper over :class:`GraphS`; graph mutators forward to
    the wrapped graph, while ``rec``/``detectors``/``observables_dict``/
    ``channel_probs`` track the sampling metadata the compiled pipeline
    consumes (reference ``zx/converter.py`` GraphRepresentation role).
    """

    graph: GraphS = field(default_factory=GraphS)
    rec: List[int] = field(default_factory=list)
    silent_rec: List[int] = field(default_factory=list)
    detectors: List[int] = field(default_factory=list)
    observables_dict: Dict[int, int] = field(default_factory=dict)
    first_vertex: Dict[int, int] = field(default_factory=dict)
    last_vertex: Dict[int, int] = field(default_factory=dict)
    channel_probs: List[Any] = field(default_factory=list)
    correlated_error_probs: List[float] = field(default_factory=list)
    num_error_bits: int = 0
    num_correlated_error_bits: int = 0

    @property
    def observables(self) -> List[int]:
        """Observable vertices in observable-index order."""
        return [self.observables_dict[i] for i in sorted(self.observables_dict)]

    # -- graph mutators with added behavior --------------------------------

    def add_vertex(
        self, t: Any = VertexType.Z, qubit: int = -1, row: float = -1, phase: Any = 0
    ) -> int:
        v = self.graph.add_vertex(t, qubit, row)
        self.graph.set_phase(v, phase)
        return v

    def remove_isolated_vertices(self) -> None:
        self.graph.remove_vertices(
            [v for v in list(self.graph.vertices()) if self.graph.vertex_degree(v) == 0]
        )

    def add_edge_table(self, etab: Dict[Any, List[int]]) -> None:
        for (v1, v2), ets in etab.items():
            for et in ets:
                if et != 0:
                    self.graph.add_edge((v1, v2), et)

    def copy(self) -> "GraphRepresentation":
        new_b = GraphRepresentation(
            graph=self.graph.copy(),
            rec=list(self.rec),
            silent_rec=list(self.silent_rec),
            detectors=list(self.detectors),
            observables_dict=dict(self.observables_dict),
            first_vertex=dict(self.first_vertex),
            last_vertex=dict(self.last_vertex),
            channel_probs=list(self.channel_probs),
            correlated_error_probs=list(self.correlated_error_probs),
        )
        new_b.num_error_bits = self.num_error_bits
        new_b.num_correlated_error_bits = self.num_correlated_error_bits
        return new_b

    # -- pure forwards ------------------------------------------------------
    # generated thin forwards: everything below delegates verbatim to GraphS

    def __getattr__(self, name: str) -> Any:
        # dataclass fields resolve normally; anything else forwards to the
        # wrapped graph (add_edge, neighbors, phase, set_phase, to_tensor, ...)
        graph = object.__getattribute__(self, "graph")
        try:
            return getattr(graph, name)
        except AttributeError:
            raise AttributeError(
                f"GraphRepresentation has no attribute {name!r} "
                "(not a bookkeeping field, and the wrapped GraphS lacks it)"
            ) from None

    @property
    def scalar(self) -> Any:
        return self.graph.scalar

    @scalar.setter
    def scalar(self, v: Any) -> None:
        self.graph.scalar = v

    @property
    def track_phases(self) -> bool:
        return self.graph.track_phases

    @track_phases.setter
    def track_phases(self, v: bool) -> None:
        self.graph.track_phases = v

    @property
    def merge_vdata(self) -> Any:
        return self.graph.merge_vdata

    @merge_vdata.setter
    def merge_vdata(self, v: Any) -> None:
        self.graph.merge_vdata = v


def _graphs_forward(name: str) -> Any:
    def fwd(self: "GraphRepresentation", *args: Any, **kws: Any) -> Any:
        return getattr(self.graph, name)(*args, **kws)

    fwd.__name__ = name
    fwd.__qualname__ = f"GraphRepresentation.{name}"
    fwd.__doc__ = f"Forward of GraphS.{name} (see zx/graph_s.py)."
    return fwd


for _name in (
    "add_edge add_edges remove_edge remove_edges remove_vertex remove_vertices "
    "vertex_set edge_set num_vertices num_edges incident_edges qubit set_qubit "
    "row rows set_row is_ground set_ground vertex_degree get_params edges edge "
    "edge_st edge_type set_edge_type set_inputs set_outputs inputs outputs "
    "phase phases set_phase add_to_phase update_phase_index fuse_phases "
    "neighbors to_tensor types qubits vdata vdata_keys set_vdata type set_type "
    "get_auto_simplify set_auto_simplify is_multigraph vertices"
).split():
    setattr(GraphRepresentation, _name, _graphs_forward(_name))
del _name


# -- module-level lane helpers (reference converter exposes these free) --


def last_row(sg: SamplingGraph, q: int) -> int:
    """Frontier spider of wire q (reference free function)."""
    return sg.last_row(q)


def last_edge(sg: SamplingGraph, q: int) -> Optional[tuple]:
    return sg.last_edge(q)


def add_dummy(sg: SamplingGraph, q: int) -> int:
    return sg.add_dummy(q)


def add_lane(sg: SamplingGraph) -> int:
    return sg.add_lane()


def ensure_lane(sg: SamplingGraph, q: int) -> int:
    return sg.ensure_lane(q)
