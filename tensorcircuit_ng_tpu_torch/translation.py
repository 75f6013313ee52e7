"""Circuit translation: OpenQASM 2, JSON, stim text, qiskit and cirq.

Counterpart of ``tensorcircuit_ng_tpu/translation.py``:

- the JSON codec of the QIR (``qir2json``/``json2qir``, ``circuit_to_json``/
  ``circuit_from_json``, ``tensor_to_json``/``json_to_tensor``);
- an OpenQASM 2 emitter and parser of its own (``qir2qasm``,
  ``circuit_to_qasm``, ``qasm2tc`` with a sanitized expression evaluator),
  so no qiskit is needed;
- the qexe/eqasm reader ``eqasm2tc``, ``perm_matrix`` and
  ``ctrl_str2ctrl_state``;
- stim program text (``tc2stim``/``stim2tc``);
- the qiskit and cirq converters, which import their package when called.

The exporters read the per-gate view of a circuit (``_expanded_qir``), so a
fused layer comes out as its gates.  Gate tensors are written from the host
(a tensor on the card is copied once); the importers build their circuit on
``device=`` (the configured device by default), and a gate tensor read from
JSON lands on that circuit's device.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config

__all__ = [
    "perm_matrix",
    "qir2json",
    "json2qir",
    "circuit_to_json",
    "circuit_from_json",
    "tensor_to_json",
    "json_to_tensor",
    "qir2qasm",
    "qasm2tc",
    "circuit_to_qasm",
    "circuit_from_qasm",
    "ctrl_str2ctrl_state",
    "eqasm2tc",
    "qir2qiskit",
    "qiskit2tc",
    "get_qiskit_qasm",
    "qiskit_from_qasm_str_ordered_measure",
    "qir2cirq",
    "cirq2tc",
    "tc2stim",
    "stim2tc",
]


def _host(v: Any) -> Any:
    """A torch tensor as a numpy array on the host (detached); anything
    else as it is."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def perm_matrix(n: int) -> np.ndarray:
    """The bit-reversal permutation matrix of n qubits (little- against
    big-endian wire order)."""
    dim = 2**n
    p = np.zeros((dim, dim))
    for i in range(dim):
        rev = int(format(i, f"0{n}b")[::-1], 2)
        p[rev, i] = 1.0
    return p


# ------------------------------------------------------------------
# JSON codec
# ------------------------------------------------------------------


def tensor_to_json(t: Any) -> Dict[str, Any]:
    """A tensor as a JSON-safe dict: shape, dtype, real and imaginary parts."""
    a = np.asarray(_host(t))
    return {
        "shape": list(a.shape),
        "dtype": str(a.dtype),
        "real": np.real(a).reshape(-1).tolist(),
        "imag": np.imag(a).reshape(-1).tolist(),
    }


def json_to_tensor(d: Dict[str, Any]) -> np.ndarray:
    """The complex128 numpy array of a :func:`tensor_to_json` dict."""
    re_ = np.asarray(d["real"], dtype=np.float64)
    im = np.asarray(d["imag"], dtype=np.float64)
    return (re_ + 1j * im).reshape(d["shape"])


def qir2json(qir: Sequence[Dict[str, Any]], simplified: bool = False) -> List[Dict[str, Any]]:
    """The QIR as plain JSON-compatible dicts: a scalar parameter as its
    ``[real, imag]`` floats, an array parameter by :func:`tensor_to_json`,
    and, unless ``simplified``, the gate tensor of an item without a gate
    factory (``any``, a fused one-qubit gate)."""
    out = []
    for item in qir:
        entry: Dict[str, Any] = {
            "name": item.get("name", "any"),
            "index": list(item["index"]),
        }
        jparams = {}
        for k, v in item.get("parameters", {}).items():
            v = _host(v)
            if hasattr(v, "shape") and np.asarray(v).ndim > 0:
                jparams[k] = tensor_to_json(v)
            elif hasattr(v, "item") or isinstance(v, (int, float, complex)):
                vv = complex(np.asarray(v))
                jparams[k] = [vv.real, vv.imag]
            else:
                jparams[k] = v
        if jparams:
            entry["parameters"] = jparams
        if not simplified and item.get("gatef") is None and item.get("gate") is not None:
            entry["gate_tensor"] = tensor_to_json(item["gate"].tensor)
        out.append(entry)
    return out


def _json_param(v: Any) -> Any:
    """A parameter of :func:`qir2json`'s output: a tensor dict as its array,
    a pair of floats (a scalar's real and imaginary part) as the number, and
    any other value (a list of ints such as ``ctrl``) as it is."""
    if isinstance(v, dict) and "shape" in v:
        return json_to_tensor(v)
    if isinstance(v, list) and len(v) == 2 and all(isinstance(x, float) for x in v):
        return v[0] if v[1] == 0 else complex(v[0], v[1])
    return v


def json2qir(data: Sequence[Dict[str, Any]], device: Any = None) -> List[Dict[str, Any]]:
    """QIR items of :func:`qir2json`'s output, for ``append_from_qir``; a
    gate tensor becomes a tensor on ``device`` (numpy when None)."""
    from .ops import gates as gates_mod
    from .ops.gates import Gate

    qir = []
    for entry in data:
        name = entry["name"]
        item: Dict[str, Any] = {
            "index": tuple(entry["index"]),
            "name": name,
            "split": None,
            "mpo": False,
        }
        if "gate_tensor" in entry:
            t = json_to_tensor(entry["gate_tensor"])
            if device is not None:
                t = torch.as_tensor(t).to(device=device, dtype=config.torch_dtype())
            item["gatef"] = None
            item["gate"] = Gate(t, name=name)
        else:
            item["gatef"] = gates_mod.GATES.get(name)
            item["parameters"] = {k: _json_param(v) for k, v in entry.get("parameters", {}).items()}
            if item["gatef"] is None:
                raise ValueError(f"unknown gate {name!r} without tensor payload")
        qir.append(item)
    return qir


def _export_qir(c: Any) -> Any:
    """The per-gate QIR of a circuit (fused layers expanded)."""
    if hasattr(c, "_expanded_qir"):
        return c._expanded_qir()
    return c.to_qir()


def circuit_to_json(c: Any, simplified: bool = False, as_str: bool = True) -> Any:
    """``{"nqubits": n, "qir": qir2json(...)}``, as a string or the dict."""
    payload = {
        "nqubits": c.nqubits,
        "qir": qir2json(_export_qir(c), simplified=simplified),
    }
    return json.dumps(payload) if as_str else payload


def circuit_from_json(data: Any, circuit_class: Optional[Any] = None, **kws: Any) -> Any:
    """The circuit (``Circuit`` or ``circuit_class``, built with ``kws``,
    e.g. ``device=``) of :func:`circuit_to_json`'s output."""
    from .models.circuit import Circuit

    if isinstance(data, str):
        data = json.loads(data)
    cls = circuit_class or Circuit
    c = cls(data["nqubits"], **kws)
    c.append_from_qir(json2qir(data["qir"], device=getattr(c, "_device", None)))
    return c


# ------------------------------------------------------------------
# OpenQASM 2
# ------------------------------------------------------------------

_QASM_EMIT = {
    "h": "h",
    "x": "x",
    "y": "y",
    "z": "z",
    "s": "s",
    "sd": "sdg",
    "t": "t",
    "td": "tdg",
    "sx": "sx",
    "cnot": "cx",
    "cx": "cx",
    "cy": "cy",
    "cz": "cz",
    "swap": "swap",
    "toffoli": "ccx",
    "ccx": "ccx",
    "fredkin": "cswap",
    "i": "id",
}

_QASM_PARAM = {
    "rx": ("rx", ["theta"]),
    "ry": ("ry", ["theta"]),
    "rz": ("rz", ["theta"]),
    "phase": ("p", ["theta"]),
    "cphase": ("cp", ["theta"]),
    "crx": ("crx", ["theta"]),
    "cry": ("cry", ["theta"]),
    "crz": ("crz", ["theta"]),
    "rxx": ("rxx", ["theta"]),
    "ryy": ("ryy", ["theta"]),
    "rzz": ("rzz", ["theta"]),
    "u": ("u", ["theta", "phi", "lbd"]),
}


def qir2qasm(qir: Sequence[Dict[str, Any]], n: int) -> str:
    """OpenQASM 2.0 text of the QIR: named gates by name, any other
    one-qubit gate as ``u`` of its ZYZ angles, ``multicz`` on 2 or 3 wires
    as ``cz`` or ``h ccx h``; anything else raises ValueError."""
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n}];",
    ]
    for item in qir:
        name = (item.get("name") or "any").lower()
        idx = ",".join(f"q[{i}]" for i in item["index"])
        if name in _QASM_EMIT:
            lines.append(f"{_QASM_EMIT[name]} {idx};")
        elif name in _QASM_PARAM:
            qname, pnames = _QASM_PARAM[name]
            params = item.get("parameters", {})
            vals = [repr(float(np.real(np.asarray(_host(params.get(p, 0.0)))))) for p in pnames]
            lines.append(f"{qname}({','.join(vals)}) {idx};")
        elif len(item["index"]) == 1 and item.get("gate") is not None:
            theta, phi, lam = _u3_angles(np.asarray(_host(item["gate"].matrix())))
            lines.append(f"u({theta!r},{phi!r},{lam!r}) {idx};")
        elif name == "multicz" and len(item["index"]) in (2, 3):
            qs = [f"q[{int(i)}]" for i in item["index"]]
            if len(qs) == 2:
                lines.append(f"cz {qs[0]},{qs[1]};")
            else:  # ccz = h(t) ccx h(t)
                lines.append(f"h {qs[2]};")
                lines.append(f"ccx {qs[0]},{qs[1]},{qs[2]};")
                lines.append(f"h {qs[2]};")
        else:
            raise ValueError(f"gate {name!r} has no OpenQASM 2 representation")
    return "\n".join(lines) + "\n"


def _u3_angles(m: np.ndarray) -> Tuple[float, float, float]:
    """(theta, phi, lam) with U = u(theta, phi, lam) up to a global phase."""
    a = abs(m[0, 0])
    b = abs(m[1, 0])
    theta = 2.0 * math.atan2(b, a)
    if a > 1e-9 and b > 1e-9:
        ref = np.angle(m[0, 0])
        phi = float(np.angle(m[1, 0]) - ref)
        lam = float(np.angle(-m[0, 1]) - ref)
    elif a <= 1e-9:  # theta = pi
        phi = float(np.angle(m[1, 0]) - np.angle(-m[0, 1]))
        lam = 0.0
    else:  # theta = 0
        phi = float(np.angle(m[1, 1]) - np.angle(m[0, 0]))
        lam = 0.0
    return float(theta), phi, lam


def circuit_to_qasm(c: Any) -> str:
    """OpenQASM 2.0 text of a circuit's per-gate QIR."""
    return qir2qasm(_export_qir(c), c.nqubits)


_QASM_IMPORT = {v: k for k, v in _QASM_EMIT.items()}
_QASM_IMPORT.update({"id": "i", "cx": "cnot", "p": "phase", "cp": "cphase", "u3": "u", "u": "u"})
_QASM_PARAM_IMPORT = {v[0]: (k, v[1]) for k, v in _QASM_PARAM.items()}
_QASM_PARAM_IMPORT["u3"] = ("u", ["theta", "phi", "lbd"])


def qasm2tc(qasm: str, circuit_class: Optional[Any] = None, **kws: Any) -> Any:
    """A circuit (``Circuit`` or ``circuit_class``, built with ``kws``,
    e.g. ``device=``) of OpenQASM 2.0 text: the gates of ``qelib1.inc``
    that :func:`qir2qasm` writes, parameters as arithmetic of numbers and
    ``pi``; ``creg``, ``barrier`` and ``measure`` lines are skipped."""
    from .models.circuit import Circuit

    cls = circuit_class or Circuit
    n = None
    ops: List[Tuple[str, List[float], List[int]]] = []
    for raw in qasm.splitlines():
        line = raw.split("//")[0].strip()
        if not line or line.startswith(("OPENQASM", "include")):
            continue
        m = re.match(r"qreg\s+(\w+)\[(\d+)\]", line)
        if m:
            n = int(m.group(2))
            continue
        if line.startswith(("creg", "barrier", "measure")):
            continue
        m = re.match(r"(\w+)\s*(\(([^)]*)\))?\s+(.*);", line)
        if not m:
            continue
        gname = m.group(1)
        params = [float(_eval_qasm_expr(x)) for x in m.group(3).split(",")] if m.group(3) else []
        qubits = [int(x) for x in re.findall(r"\[(\d+)\]", m.group(4))]
        ops.append((gname, params, qubits))
    if n is None:
        n = max((max(q) for _, _, q in ops if q), default=-1) + 1
    c = cls(n, **kws)
    for gname, params, qubits in ops:
        if params:
            tc_name, pnames = _QASM_PARAM_IMPORT[gname]
            getattr(c, tc_name)(*qubits, **dict(zip(pnames, params)))
        else:
            getattr(c, _QASM_IMPORT.get(gname, gname))(*qubits)
    return c


circuit_from_qasm = qasm2tc


def _eval_qasm_expr(expr: str) -> float:
    """A QASM parameter expression of numbers, ``pi`` and ``+ - * / ( )``."""
    expr = expr.strip().replace("pi", repr(math.pi))
    allowed = set("0123456789.+-*/() e")
    if not set(expr) <= allowed:
        raise ValueError(f"disallowed characters in QASM expression {expr!r}")
    return float(eval(expr, {"__builtins__": {}}, {}))  # noqa: S307 - sanitized above


def ctrl_str2ctrl_state(ctrl_str: str, nctrl: int) -> List[int]:
    """A control-state string as its bits, least significant first."""
    v = int(ctrl_str)
    return [0x1 & (v >> i) for i in range(nctrl)]


def eqasm2tc(
    eqasm: str, nqubits: Optional[int] = None, headers: Tuple[int, int] = (6, 1), **kws: Any
) -> Any:
    """A ``Circuit`` (built with ``kws``, e.g. ``device=``) of qexe/eqasm
    text: the ``bs`` lines between ``headers`` (lines skipped at the start
    and the end) as ``RZ_k`` (an rz of 2π/2^k), ``±Z/2`` (rz of ∓π/2) and
    named one- and two-qubit gates; other lines are skipped."""
    from .models.circuit import Circuit

    lines = eqasm.split("\n")
    if nqubits is None:
        nqubits = len(lines[2].split(","))
    body = lines[headers[0] : -headers[1]] if headers[1] else lines[headers[0] :]
    c = Circuit(nqubits, **kws)
    for inst in body:
        if not inst.strip().startswith("bs"):
            continue
        parts = inst.split(" ")
        op = parts[2]
        if op.startswith("RZ"):
            c.rz(int(parts[3][1:]), theta=2 * np.pi / 2 ** int(op[3:]))
        elif op == "Z/2":
            c.rz(int(parts[3][1:]), theta=-np.pi / 2)
        elif op == "-Z/2":
            c.rz(int(parts[3][1:]), theta=np.pi / 2)
        else:
            if len(parts) == 4:
                idx: Tuple[int, ...] = (int(parts[3][1:]),)
            elif len(parts) == 5:
                idx = (int(parts[3][2:-1]), int(parts[4][1:-1]))
            else:
                raise ValueError(f"Unknown format for eqasm: {parts!r}")
            getattr(c, op.lower())(*idx)
    return c


# ------------------------------------------------------------------
# qiskit and cirq (imported when called)
# ------------------------------------------------------------------


def qir2qiskit(qir: Sequence[Dict[str, Any]], n: int) -> Any:
    """A ``qiskit.QuantumCircuit`` of the QIR, by its OpenQASM text."""
    try:
        from qiskit.qasm2 import loads  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError("qiskit is not installed") from e
    return loads(qir2qasm(qir, n))


def qiskit2tc(qc: Any, circuit_class: Optional[Any] = None, **kws: Any) -> Any:
    """A circuit of a ``qiskit.QuantumCircuit``, by its OpenQASM text."""
    return qasm2tc(get_qiskit_qasm(qc), circuit_class, **kws)


def get_qiskit_qasm(qc: Any) -> str:
    """The OpenQASM 2 text of a qiskit circuit, across qiskit versions."""
    try:
        return qc.qasm()
    except AttributeError:
        from qiskit.qasm2 import dumps  # type: ignore

        return dumps(qc)


def qiskit_from_qasm_str_ordered_measure(qasm_str: str) -> Any:
    """``qiskit.QuantumCircuit.from_qasm_str`` with the measurements
    re-applied in the order of the text."""
    from qiskit import QuantumCircuit  # type: ignore

    measure_sequence = []
    other_lines = []
    for line in qasm_str.split("\n"):
        if line.strip().startswith("measure"):
            q = int(line.split(" ")[1].split("[")[1].rstrip("];"))
            cbit = int(line.split("->")[1].strip().rstrip(";").split("[")[1].rstrip("]"))
            measure_sequence.append((q, cbit))
        else:
            other_lines.append(line)
    qc = QuantumCircuit.from_qasm_str("\n".join(other_lines))
    for q, cbit in measure_sequence:
        qc.measure(q, cbit)
    return qc


def qir2cirq(qir: Sequence[Dict[str, Any]], n: int) -> Any:
    """A ``cirq.Circuit`` of the QIR (named gates, rotations, and any other
    gate by its matrix)."""
    try:
        import cirq  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError("cirq is not installed") from e
    qubits = cirq.LineQubit.range(n)
    gate_map = {
        "h": cirq.H, "x": cirq.X, "y": cirq.Y, "z": cirq.Z, "s": cirq.S, "t": cirq.T,
        "cnot": cirq.CNOT, "cz": cirq.CZ, "swap": cirq.SWAP, "toffoli": cirq.TOFFOLI,
    }
    ops = []
    for item in qir:
        name = (item.get("name") or "").lower()
        idx = [qubits[i] for i in item["index"]]
        params = item.get("parameters", {})
        if name in gate_map:
            ops.append(gate_map[name](*idx))
        elif name in ("rx", "ry", "rz"):
            th = float(np.real(np.asarray(_host(params.get("theta", 0)))))
            ops.append(getattr(cirq, name)(th)(*idx))
        else:
            ops.append(cirq.MatrixGate(np.asarray(_host(item["gate"].matrix())))(*idx))
    return cirq.Circuit(ops)


def cirq2tc(qc: Any, circuit_class: Optional[Any] = None, **kws: Any) -> Any:
    """A circuit of a ``cirq.Circuit``: each operation as ``any`` of its
    unitary, the qubits in sorted order."""
    import cirq  # type: ignore

    from .models.circuit import Circuit

    cls = circuit_class or Circuit
    qubits = sorted(qc.all_qubits())
    qmap = {q: i for i, q in enumerate(qubits)}
    c = cls(len(qubits), **kws)
    for moment in qc:
        for op in moment.operations:
            c.any(*[qmap[q] for q in op.qubits], unitary=cirq.unitary(op), name=str(op.gate).lower())
    return c


# ------------------------------------------------------------------
# stim program text
# ------------------------------------------------------------------

_TC2STIM = {
    "h": "H", "x": "X", "y": "Y", "z": "Z", "s": "S", "sd": "S_DAG",
    "sx": "SQRT_X", "cnot": "CX", "cx": "CX", "cy": "CY", "cz": "CZ",
    "swap": "SWAP", "iswap": "ISWAP", "i": "I",
}
_STIM2TC = {v: k for k, v in _TC2STIM.items()}
_STIM2TC.update({"CNOT": "cnot", "ZCX": "cnot", "ZCY": "cy", "ZCZ": "cz"})


def tc2stim(c: Any) -> str:
    """The gates of a Clifford circuit's QIR as stim program text, one
    line a gate; any other QIR item (a record, noise) raises ValueError."""
    lines = []
    for item in c.to_qir():
        name = (item.get("name") or "").lower()
        if name not in _TC2STIM:
            raise ValueError(f"gate {name!r} has no stim equivalent")
        idx = " ".join(str(int(i)) for i in item["index"])
        lines.append(f"{_TC2STIM[name]} {idx}")
    return "\n".join(lines) + ("\n" if lines else "")


def stim2tc(program: Any, circuit_class: Optional[Any] = None, device: Any = None) -> Any:
    """A stim program (text, or a ``stim.Circuit`` by its text) as a
    ``StabilizerCircuit`` (or ``circuit_class``) on ``device``: gates,
    ``M``/``MZ`` measurements, ``R`` resets, the Pauli-noise instructions,
    ``DETECTOR``, ``OBSERVABLE_INCLUDE``, ``TICK``, comments and ``REPEAT``
    blocks; the width is the largest qubit named, plus one."""
    if circuit_class is None:
        from .models.stabilizercircuit import StabilizerCircuit as circuit_class

    text = program if isinstance(program, str) else str(program)

    def parse_block(lines: List[str], pos: int) -> Tuple[List[Tuple[str, List[int]]], int]:
        ops: List[Tuple[str, List[int]]] = []
        while pos < len(lines):
            line = lines[pos].split("#", 1)[0].strip()
            pos += 1
            if not line:
                continue
            if line == "}":
                return ops, pos
            if line.upper().startswith("REPEAT"):
                reps = int(line.split()[1])
                inner, pos = parse_block(lines, pos)
                ops.extend(inner * reps)
                continue
            parts = line.replace("{", "").split()
            if not parts:
                continue
            head = parts[0].upper()
            arg = None
            if "(" in head:
                head, rest = head.split("(", 1)
                arg = float(rest.rstrip(")"))
            targets: List[Any] = []
            for tok in parts[1:]:
                tok = tok.strip(",")
                if tok.lower().startswith("rec[") and tok.endswith("]"):
                    targets.append(("rec", int(tok[4:-1])))
                elif tok.lstrip("-+").replace(".", "", 1).isdigit():
                    if "." in tok:
                        arg = float(tok)
                    else:
                        targets.append(int(tok))
            ops.append((head, targets, arg))
        return ops, pos

    ops, _ = parse_block(text.splitlines(), 0)
    nq = 1 + max(
        (q for _, qs, _ in ops for q in qs if isinstance(q, int)), default=0
    )
    c = circuit_class(nq, device=device)
    for op, qs, arg in ops:
        if op in ("TICK", "SHIFT_COORDS", "QUBIT_COORDS"):
            continue
        if op == "DETECTOR":
            c.detector(*[r for kind, r in qs if kind == "rec"] if qs and isinstance(qs[0], tuple) else [])
            continue
        if op == "OBSERVABLE_INCLUDE":
            recs = [r for item in qs if isinstance(item, tuple) for kind, r in [item] if kind == "rec"]
            c.observable_include(*recs, idx=int(arg or 0))
            continue
        ints = [q for q in qs if isinstance(q, int)]
        if op in ("M", "MZ"):
            c.measure_instruction(*ints)
            continue
        if op in ("R", "RZ"):
            c.reset_instruction(*ints)
            continue
        if op in ("X_ERROR", "Y_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2"):
            meth = {"X_ERROR": "x_error", "Y_ERROR": "y_error", "Z_ERROR": "z_error",
                    "DEPOLARIZE1": "depolarize1", "DEPOLARIZE2": "depolarize2"}[op]
            getattr(c, meth)(*ints, p=float(arg or 0.0))
            continue
        name = _STIM2TC.get(op)
        if name is None:
            raise ValueError(f"unsupported stim instruction {op!r}")
        arity = 2 if name in ("cnot", "cx", "cy", "cz", "swap", "iswap") else 1
        for g in range(0, len(ints), arity):
            getattr(c, name)(*ints[g : g + arity])
    return c
