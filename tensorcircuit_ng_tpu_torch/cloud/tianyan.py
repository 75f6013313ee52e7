"""The Tianyan provider: QCIS translation, native lowering, topology checks.

Counterpart of ``tensorcircuit_ng_tpu/cloud/tianyan.py``, with no SDK:

- :func:`circuit_to_qcis` — QIR -> QCIS text (cx/cy/swap/iswap/ccx/cswap
  lowered to the H/S/T/CZ family);
- :func:`lower_to_native` — mnemonic QCIS -> the hardware-native
  {X2P, X2M, Y2P, Y2M, RZ, CZ} set, numerically validated in tests;
- :func:`simulate_qcis` — a QCIS text interpreter on the port's dense
  circuit (the execution of a mock platform's submit -> counts round trip);
- the device topology checks and the parsing of results;
- :func:`submit_task` against an injected platform object
  (:func:`set_platform`), so the whole flow runs against a mock.
"""

from __future__ import annotations

import math
import uuid
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..translation import _host
from .abstraction import Device, Provider, Task

__all__ = [
    "circuit_to_qcis",
    "qir2qcis",
    "lower_to_native",
    "simulate_qcis",
    "validate_topology",
    "set_platform",
    "list_devices",
    "list_properties",
    "get_device_properties",
    "submit_task",
    "resubmit_task",
    "remove_task",
    "list_tasks",
    "get_task_details",
]

#: devices that skip topology validation
SIMULATOR_DEVICES = {"tianyan_sim", "tianyan176-sim"}

_PLATFORM: Optional[Any] = None

_QCIS_1Q = {
    "x": "X", "y": "Y", "z": "Z", "h": "H", "s": "S", "sd": "SD",
    "t": "T", "td": "TD", "i": "I", "sx": "X2P",
}


def set_platform(pf: Optional[Any]) -> None:
    """Inject the TianYan platform object (a mock in tests).

    The platform protocol: ``query_machine_list() -> [dict]``,
    ``download_config(machine) -> dict``,
    ``submit_experiment(qcis, machine, shots, exp_name) -> task_id``,
    ``query_experiment(task_id) -> [result_item]``.
    """
    global _PLATFORM
    _PLATFORM = pf


def _get_platform(token: Optional[str] = None, machine_name: Optional[str] = None) -> Any:
    if _PLATFORM is not None:
        return _PLATFORM
    raise RuntimeError(
        "tianyan requires a platform connection (no network egress here); "
        "inject one with cloud.tianyan.set_platform(mock) or use the "
        "'local' provider"
    )


# ---------------------------------------------------------------------------
# circuit -> QCIS
# ---------------------------------------------------------------------------


def _emit_gate(lines: List[str], name: str, idx: Sequence[int], params: Dict[str, Any]) -> None:
    def f(v: Any) -> float:
        v = params.get(v, 0)
        try:
            return float(np.real(np.asarray(v)))
        except Exception:
            return float(v)

    if name in _QCIS_1Q:
        lines.append(f"{_QCIS_1Q[name]} Q{idx[0]}")
    elif name in ("rx", "ry", "rz"):
        lines.append(f"{name.upper()} Q{idx[0]} {f('theta'):.10f}")
    elif name == "phase":
        lines.append(f"RZ Q{idx[0]} {f('theta'):.10f}")
    elif name == "cz":
        lines.append(f"CZ Q{idx[0]} Q{idx[1]}")
    elif name in ("cnot", "cx"):
        c, t = idx
        _emit_gate(lines, "h", [t], {})
        lines.append(f"CZ Q{c} Q{t}")
        _emit_gate(lines, "h", [t], {})
    elif name == "cy":
        c, t = idx
        _emit_gate(lines, "sd", [t], {})
        _emit_gate(lines, "cnot", [c, t], {})
        _emit_gate(lines, "s", [t], {})
    elif name == "swap":
        a, b = idx
        _emit_gate(lines, "cnot", [a, b], {})
        _emit_gate(lines, "cnot", [b, a], {})
        _emit_gate(lines, "cnot", [a, b], {})
    elif name == "iswap":
        theta = params.get("theta", 1.0)
        if abs(float(np.real(np.asarray(theta))) - 1.0) > 1e-6:
            raise ValueError(
                "partial iSwap has no QCIS decomposition here; only the "
                f"theta=1.0 point is emitted (requested theta={theta!r})"
            )
        a, b = idx
        # iswap = swap . (s (x) s) . cz
        lines.append(f"CZ Q{a} Q{b}")
        _emit_gate(lines, "s", [a], {})
        _emit_gate(lines, "s", [b], {})
        _emit_gate(lines, "swap", [a, b], {})
    elif name in ("toffoli", "ccx", "ccnot"):
        a, b, c = idx
        # standard T-count-7 decomposition
        _emit_gate(lines, "h", [c], {})
        _emit_gate(lines, "cnot", [b, c], {})
        _emit_gate(lines, "td", [c], {})
        _emit_gate(lines, "cnot", [a, c], {})
        _emit_gate(lines, "t", [c], {})
        _emit_gate(lines, "cnot", [b, c], {})
        _emit_gate(lines, "td", [c], {})
        _emit_gate(lines, "cnot", [a, c], {})
        _emit_gate(lines, "t", [b], {})
        _emit_gate(lines, "t", [c], {})
        _emit_gate(lines, "h", [c], {})
        _emit_gate(lines, "cnot", [a, b], {})
        _emit_gate(lines, "t", [a], {})
        _emit_gate(lines, "td", [b], {})
        _emit_gate(lines, "cnot", [a, b], {})
    elif name in ("fredkin", "cswap"):
        a, b, c = idx
        _emit_gate(lines, "cnot", [c, b], {})
        _emit_gate(lines, "toffoli", [a, b, c], {})
        _emit_gate(lines, "cnot", [c, b], {})
    elif name == "barrier":
        lines.append("B " + " ".join(f"Q{q}" for q in idx))
    else:
        raise ValueError(f"gate {name!r} has no QCIS translation; compile first")


def qir2qcis(
    qir: Sequence[Dict[str, Any]],
    n: int,
    measure: Optional[Sequence[int]] = None,
) -> str:
    """Translate QIR into QCIS instructions (terminal measurements only)."""
    lines: List[str] = []
    for item in qir:
        name = (item.get("name") or "").lower()
        _emit_gate(lines, name, list(item["index"]), item.get("parameters", {}) or {})
    for q in measure if measure is not None else range(n):
        lines.append(f"M Q{q}")
    return "\n".join(lines) + "\n"


def circuit_to_qcis(circuit: Any) -> str:
    """The QCIS text of a circuit.

    Measurement instructions recorded on the circuit (``extra_qir``) are
    emitted as terminal measurements in record order; without any, every
    qubit is measured.
    """
    qir = circuit.to_qir()
    measures: List[int] = []
    for inst in getattr(circuit, "_extra_qir", []) or []:
        if inst.get("name") == "measure":
            measures.append(int(inst["index"][0]))
    return qir2qcis(qir, circuit._nqubits, measure=measures or None)


def _qasm_to_qcis(qasm: str) -> str:
    from .. import translation

    c = translation.qasm2tc(qasm)
    return circuit_to_qcis(c)


#: source-language dispatch: canonical name -> per-string converter
_LANG_CONVERTERS = {
    "QCIS": lambda s: s,
    "QASM": lambda s: _qasm_to_qcis(s),
    "OPENQASM": lambda s: _qasm_to_qcis(s),
    "OPENQASM2": lambda s: _qasm_to_qcis(s),
}


def _source_to_qcis(source: Union[str, Sequence[str]], lang: str) -> Any:
    convert = _LANG_CONVERTERS.get(lang.strip().upper())
    if convert is None:
        raise ValueError(
            f"tianyan cannot ingest {lang!r} sources (accepted: QCIS, OpenQASM2)"
        )
    if isinstance(source, str):
        return convert(source)
    return [convert(s) for s in source]


# ---------------------------------------------------------------------------
# native lowering: mnemonics -> {X2P, X2M, Y2P, Y2M, RZ, CZ}
# ---------------------------------------------------------------------------

_PI = math.pi

#: per-mnemonic native expansions, validated numerically in the tests
_NATIVE_1Q: Dict[str, List[Tuple[str, Optional[float]]]] = {
    "X": [("X2P", None), ("X2P", None)],
    "Y": [("Y2P", None), ("Y2P", None)],
    "Z": [("RZ", _PI)],
    "S": [("RZ", _PI / 2)],
    "SD": [("RZ", -_PI / 2)],
    "T": [("RZ", _PI / 4)],
    "TD": [("RZ", -_PI / 4)],
    "H": [("Y2P", None), ("X2P", None), ("X2P", None)],  # H = X . Ry(pi/2)
    "I": [],
}


def lower_to_native(qcis: str) -> str:
    """Rewrite mnemonic QCIS into the hardware-native gate set."""
    out: List[str] = []
    for line in qcis.splitlines():
        parts = line.split()
        if not parts:
            continue
        op = parts[0].upper()
        if op in ("X2P", "X2M", "Y2P", "Y2M", "RZ", "CZ", "M", "B", "I"):
            if op != "I":
                out.append(line)
        elif op in _NATIVE_1Q:
            q = parts[1]
            for g, angle in _NATIVE_1Q[op]:
                out.append(f"{g} {q}" if angle is None else f"{g} {q} {angle:.10f}")
        elif op == "RX":
            q, th = parts[1], float(parts[2])
            # RX(t) = Y2P . RZ(t) . Y2M
            out.append(f"Y2M {q}")
            out.append(f"RZ {q} {th:.10f}")
            out.append(f"Y2P {q}")
        elif op == "RY":
            q, th = parts[1], float(parts[2])
            # RY(t) = X2M . RZ(t) . X2P
            out.append(f"X2P {q}")
            out.append(f"RZ {q} {th:.10f}")
            out.append(f"X2M {q}")
        else:
            raise ValueError(f"cannot lower QCIS op {op!r} to the native set")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# QCIS interpreter (offline simulation / mock execution backend)
# ---------------------------------------------------------------------------

_SQ2 = 1.0 / math.sqrt(2.0)
_FIXED_1Q = {
    "X": np.array([[0, 1], [1, 0]], complex),
    "Y": np.array([[0, -1j], [1j, 0]], complex),
    "Z": np.diag([1.0, -1.0]).astype(complex),
    "H": _SQ2 * np.array([[1, 1], [1, -1]], complex),
    "S": np.diag([1.0, 1j]),
    "SD": np.diag([1.0, -1j]),
    "T": np.diag([1.0, np.exp(1j * _PI / 4)]),
    "TD": np.diag([1.0, np.exp(-1j * _PI / 4)]),
    "I": np.eye(2, dtype=complex),
    "X2P": None,  # filled below
}


def _rot(axis: str, theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    if axis == "x":
        return np.array([[c, -1j * s], [-1j * s, c]])
    if axis == "y":
        return np.array([[c, -s], [s, c]], complex)
    return np.diag([np.exp(-1j * theta / 2), np.exp(1j * theta / 2)])


_FIXED_1Q["X2P"] = _rot("x", _PI / 2)
_FIXED_1Q["X2M"] = _rot("x", -_PI / 2)
_FIXED_1Q["Y2P"] = _rot("y", _PI / 2)
_FIXED_1Q["Y2M"] = _rot("y", -_PI / 2)


def parse_qcis(qcis: str, device: Any = None) -> Tuple[Any, List[int]]:
    """QCIS text -> (a ``Circuit`` on ``device``, the measured qubits)."""
    from ..models.circuit import Circuit

    ops: List[Tuple[str, List[int], Optional[float]]] = []
    measured: List[int] = []
    maxq = -1
    for line in qcis.splitlines():
        parts = line.split()
        if not parts:
            continue
        op = parts[0].upper()
        qs = [int(p[1:]) for p in parts[1:] if p.upper().startswith("Q")]
        maxq = max(maxq, *(qs or [-1]))
        if op == "M":
            measured.extend(qs)
        elif op == "B":
            continue
        elif op in ("RX", "RY", "RZ"):
            ops.append((op, qs, float(parts[-1])))
        else:
            ops.append((op, qs, None))
    c = Circuit(maxq + 1, device=device)
    for op, qs, theta in ops:
        if op == "CZ":
            c.cz(qs[0], qs[1])
        elif op in ("RX", "RY", "RZ"):
            getattr(c, op.lower())(qs[0], theta=theta)
        elif op in _FIXED_1Q:
            c.unitary(qs[0], unitary=_FIXED_1Q[op], name=op.lower())
        else:
            raise ValueError(f"unknown QCIS op {op!r}")
    return c, measured


def simulate_qcis(
    qcis: str, shots: int = 1024, seed: Optional[int] = None, device: Any = None
) -> Dict[str, int]:
    """Run QCIS text on the port's circuit (on ``device``): counts over
    the measured qubits, drawn by a numpy generator of ``seed``."""
    c, measured = parse_qcis(qcis, device=device)
    if not measured:
        measured = list(range(c._nqubits))
    rng = np.random.default_rng(seed)
    p = np.abs(np.asarray(_host(c.state()))) ** 2
    p = p / p.sum()
    samples = rng.choice(len(p), size=shots, p=p)
    n = c._nqubits
    cnt: Counter = Counter()
    for s in samples:
        bits = format(int(s), f"0{n}b")
        cnt["".join(bits[q] for q in measured)] += 1
    return dict(cnt)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def validate_topology(
    qir: Sequence[Dict[str, Any]], coupling_map: Sequence[Tuple[int, int]]
) -> List[Tuple[str, Tuple[int, ...]]]:
    """Return two-qubit instructions violating the device coupling map."""
    allowed = {tuple(sorted(e)) for e in coupling_map}
    bad = []
    for item in qir:
        if len(item["index"]) == 2:
            if tuple(sorted(item["index"])) not in allowed:
                bad.append((item.get("name", "?"), tuple(item["index"])))
    return bad


class DeviceTopology:
    """Undirected device connectivity held as an edge set.

    Couplers are a frozenset of sorted ``(lo, hi)`` pairs and live qubits a frozenset,
    so compatibility checks are pure set lookups and the object is hashable.
    """

    __slots__ = ("edges", "live")

    def __init__(self, edges: Any, live: Any) -> None:
        self.edges = frozenset(tuple(sorted(e)) for e in edges)
        self.live = frozenset(live)

    def check(self, circuit: Any) -> None:
        """Raise ``ValueError`` listing *every* placement violation at once."""
        problems: List[str] = []
        for inst in circuit.to_qir():
            wires = tuple(inst.get("index", ()))
            label = inst.get("name", "?")
            dead = [q for q in wires if q not in self.live]
            if dead:
                problems.append(f"{label}{wires}: qubit(s) {dead} not usable")
                continue
            from itertools import combinations

            for pair in combinations(sorted(set(wires)), 2):
                if pair not in self.edges:
                    problems.append(f"{label}{wires}: no coupler for pair {pair}")
        if problems:
            raise ValueError(
                "circuit does not fit this device's topology — route/transpile "
                "it first:\n  " + "\n  ".join(problems)
            )

    @property
    def adjacency(self) -> Dict[int, Set[int]]:
        adj: Dict[int, Set[int]] = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)
        return adj


def _qubit_label_to_int(label: str) -> Optional[int]:
    """``"Q12"`` -> 12; anything unparseable -> None."""
    label = label.strip()
    if label[:1].upper() != "Q":
        return None
    try:
        return int(label[1:])
    except ValueError:
        return None


def _get_device_topology(pf: Any, device_name: str) -> DeviceTopology:
    """The :class:`DeviceTopology` of the platform's device config."""
    overview = (pf.download_config(machine=device_name) or {}).get("overview", {})
    pairs = [
        ids
        for ends in (overview.get("coupler_map", {}) or {}).values()
        if len(ids := [q for q in map(_qubit_label_to_int, ends) if q is not None]) == 2
    ]
    declared = {
        q for q in map(_qubit_label_to_int, overview.get("qubits", []) or []) if q is not None
    }
    off = {
        q
        for q in map(_qubit_label_to_int, (overview.get("disabledQubits") or "").split(","))
        if q is not None
    }
    return DeviceTopology(pairs, declared - off)


def _validate_circuit_topology(circuit: Any, topo: DeviceTopology) -> None:
    topo.check(circuit)


# ---------------------------------------------------------------------------
# task state / result parsing
# ---------------------------------------------------------------------------

_STATE_MAP = {
    "completed": "completed", "success": "completed", "finished": "completed",
    "done": "completed", "ok": "completed",
    "failed": "failed", "error": "failed", "fail": "failed",
    "pending": "pending", "queued": "pending", "waiting": "pending",
    "running": "pending", "processing": "pending", "in_progress": "pending",
}


def _normalize_task_state(state: Any) -> Optional[str]:
    if state is None:
        return None
    return _STATE_MAP.get(str(state).strip().lower())


def _parse_result(result_item: Dict[str, Any], device: Device) -> Dict[str, Any]:
    """One query_experiment item -> task details."""
    task_id = result_item.get("experimentTaskId", "")
    result_status = result_item.get("resultStatus") or []
    probability = result_item.get("probability")
    raw_state = next(
        (
            result_item[k]
            for k in ("state", "status", "taskStatus", "experimentStatus", "runStatus")
            if result_item.get(k) is not None
        ),
        None,
    )
    error = next(
        (
            str(result_item[k])
            for k in ("err", "error", "errorMessage", "failReason")
            if result_item.get(k)
        ),
        "",
    )
    state = _normalize_task_state(raw_state)
    if state is None:
        if error:
            state = "failed"
        elif raw_state is not None:
            state = "failed"
            error = f"Unknown TianYan task status: {raw_state}"
        else:
            # the result endpoint only returns items in a terminal state
            state = "completed"
    if result_status and len(result_status) > 1:
        measure_order = result_status[0]
        shots_data = result_status[1:]
        counts: Counter = Counter()
        for shot in shots_data:
            counts["".join(str(b) for b in shot)] += 1
        counts_dict = dict(counts)
        total_shots = len(shots_data)
    else:
        counts_dict = {}
        total_shots = 0
        measure_order = []
    details = {
        "id": task_id,
        "state": state,
        "results": counts_dict,
        "shots": total_shots,
        "measure_order": measure_order,
        "probability": probability,
        "device": str(device),
    }
    if error:
        details["err"] = error
    return details


# ---------------------------------------------------------------------------
# provider surface
# ---------------------------------------------------------------------------


def list_devices(token: Optional[str] = None, **kws: Any) -> List[Device]:
    provider = Provider.from_name("tianyan")
    if _PLATFORM is None:
        return [Device("tianyan_sim", provider)]
    machines = _PLATFORM.query_machine_list()
    return [Device(m.get("name", m.get("code", "?")), provider) for m in machines]


def get_device_properties(device: Device, token: Optional[str] = None) -> Dict[str, Any]:
    if _PLATFORM is None:
        return {"name": device.name, "native_gates": ["X2P", "X2M", "Y2P", "Y2M", "RZ", "CZ"], "offline": True}
    config = _PLATFORM.download_config(machine=device.name) or {}
    overview = config.get("overview", {})
    topo = _get_device_topology(_PLATFORM, device.name)
    return {
        "name": device.name,
        "qubits": sorted(topo.live),
        "coupling_map": sorted(topo.edges),
        "native_gates": overview.get("native_gates", ["X2P", "X2M", "Y2P", "Y2M", "RZ", "CZ"]),
    }


def list_properties(device: Device, token: Optional[str] = None) -> Dict[str, Any]:
    return get_device_properties(device, token)


def submit_task(
    device: Device,
    token: Optional[str] = None,
    lang: str = "QCIS",
    shots: Union[int, Sequence[int]] = 1024,
    circuit: Any = None,
    source: Optional[Union[str, Sequence[str]]] = None,
    exp_name: Optional[str] = None,
    **kws: Any,
) -> Union[Task, List[Task]]:
    """Submit circuit(s)/source to the (injected) platform.

    Source normalization, device
    topology validation for TC circuits on hardware devices, QCIS emission,
    one platform submission per circuit.
    """
    pf = _get_platform(token, machine_name=device.name)
    if source is not None:
        source = _source_to_qcis(source, lang)
    if source is None:
        if circuit is None:
            raise ValueError("Either `circuit` or `source` must be provided.")
        circuits = circuit if isinstance(circuit, (list, tuple)) else [circuit]
        topology = None
        if device.name not in SIMULATOR_DEVICES:
            topology = _get_device_topology(pf, device.name)
        sources = []
        for c in circuits:
            if topology is not None and hasattr(c, "to_qir"):
                topology.check(c)
            sources.append(circuit_to_qcis(c))
        source = sources if isinstance(circuit, (list, tuple)) else sources[0]
    single = isinstance(source, str)
    sources = [source] if single else list(source)
    if isinstance(shots, (list, tuple)):
        if len(shots) != len(sources):
            raise ValueError(
                f"per-circuit shots list has length {len(shots)} for {len(sources)} circuits"
            )
        shots_list = [int(s) for s in shots]
    else:
        shots_list = [int(shots)] * len(sources)
    tasks = []
    for src, nshots in zip(sources, shots_list):
        tid = pf.submit_experiment(
            qcis=src,
            machine=device.name,
            shots=nshots,
            exp_name=exp_name or f"tc_exp_{uuid.uuid4().hex[:8]}",
        )
        t = Task(str(tid), device)
        t._source = src  # for resubmission
        t._shots = nshots
        tasks.append(t)
    return tasks[0] if single else tasks


def resubmit_task(task: Task, token: Optional[str] = None, **kws: Any) -> Task:
    """Submit the task's stored QCIS source as a fresh experiment."""
    src = getattr(task, "_source", None)
    if src is None:
        raise ValueError("task has no stored source to resubmit")
    kws.setdefault("shots", getattr(task, "_shots", 1024))
    return submit_task(task.device, token=token, source=src, **kws)


def remove_task(task: Task, token: Optional[str] = None, **kws: Any) -> None:
    pf = _get_platform(token)
    if hasattr(pf, "remove_experiment"):
        pf.remove_experiment(task.id_)
        return
    raise NotImplementedError("this TianYan platform does not support task removal")


def list_tasks(device: Optional[Device] = None, token: Optional[str] = None, **filters: Any) -> List[Task]:
    pf = _get_platform(token)
    if hasattr(pf, "query_task_list"):
        return [
            Task(str(t), device or Device("tianyan_sim", Provider.from_name("tianyan")))
            for t in pf.query_task_list()
        ]
    from . import apis

    return [
        t
        for t in apis._tasks.values()
        if getattr(t.device, "provider", None) and t.device.provider.name == "tianyan"
    ]


def get_task_details(task: Task, token: Optional[str] = None, **kws: Any) -> Dict[str, Any]:
    pf = _get_platform(token)
    items = pf.query_experiment(task.id_)
    if not items:
        return {"id": task.id_, "state": "pending"}
    details = _parse_result(items[0] if isinstance(items, list) else items, task.device)
    if details["state"] == "completed" and details["results"]:
        task._set_results({k: int(v) for k, v in details["results"].items()})
    return details
