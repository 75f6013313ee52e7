"""Compiler passes over the QIR, in numpy on the host.

Counterpart of ``tensorcircuit_ng_tpu/compiler/simple_compiler.py``: the
identity pruning, the merge of neighbouring gates on the same wires, the
rewrite of ``u`` into rz ry rz, and ``simple_compile``, which runs the
three until the QIR stops shrinking.  Each pass maps a QIR to a QIR and
reads concrete parameters (a tensor on the card is copied to the host);
the gates it builds come from the port's ``ops/gates.py``.  Fused layers
pass through unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..translation import _host

__all__ = ["prune_pass", "merge_pass", "replace_u_pass", "simple_compile", "default_merge_rules"]


def _gate_matrix(item: Dict[str, Any]) -> np.ndarray:
    g = item["gate"]
    m = np.asarray(_host(g.matrix() if hasattr(g, "matrix") else g))
    dim = int(round(math.sqrt(m.size)))
    return m.reshape(dim, dim)


def _is_identity(m: np.ndarray, atol: float = 1e-6) -> bool:
    d = m.shape[0]
    phase = m[0, 0]
    if abs(abs(phase) - 1.0) > atol:
        return False
    return bool(np.allclose(m, phase * np.eye(d), atol=atol))


def prune_pass(qir: List[Dict[str, Any]], atol: float = 1e-6) -> List[Dict[str, Any]]:
    """Drop gates that are (global-phase) identity."""
    out = []
    for item in qir:
        try:
            if _is_identity(_gate_matrix(item), atol):
                continue
        except Exception:
            pass
        out.append(item)
    return out


# fixed-gate pair merges, up to a global phase
default_merge_rules: Dict[Any, str] = {
    ("s", "s"): "z",
    ("sd", "sd"): "z",
    ("t", "t"): "s",
    ("td", "td"): "sd",
    ("x", "y"): "z",
    ("y", "x"): "z",
    ("x", "z"): "y",
    ("z", "x"): "y",
    ("z", "y"): "x",
    ("y", "z"): "x",
    ("x", "x"): "i",
    ("y", "y"): "i",
    ("z", "z"): "i",
    ("h", "h"): "i",
    ("s", "sd"): "i",
    ("sd", "s"): "i",
    ("t", "td"): "i",
    ("td", "t"): "i",
}

# pairs whose table entry holds only up to a global phase
_PHASEFUL_MERGES = {
    ("x", "y"), ("y", "x"), ("x", "z"), ("z", "x"), ("z", "y"), ("y", "z"),
}


def merge_pass(qir: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Merge neighboring gates acting on identical qubit supports.

    Fixed-gate pairs merge by name via ``default_merge_rules`` (up to global
    phase); same-name rotations merge by theta addition; anything else merges
    into one ``any`` matrix.
    """
    from ..ops.gates import Gate

    out: List[Dict[str, Any]] = []
    for item in qir:
        if out:
            prev = out[-1]
            if tuple(prev["index"]) == tuple(item["index"]):
                pn, cn = prev.get("name"), item.get("name")
                merged_name = default_merge_rules.get((pn, cn))
                # only apply merges that are exact (no global phase): pauli
                # products like x@y = i*z fall through to the matrix path
                if merged_name is not None and (pn, cn) not in _PHASEFUL_MERGES and "parameters" not in prev and "parameters" not in item:
                    from ..ops import gates as gates_mod

                    if merged_name == "i":
                        out.pop()
                        continue
                    gatef = gates_mod.GATES[merged_name]
                    out[-1] = {
                        "gatef": gatef,
                        "gate": gatef(),
                        "index": prev["index"],
                        "name": merged_name,
                        "split": None,
                        "mpo": False,
                    }
                    continue
                if (
                    pn == cn
                    and pn in ("rx", "ry", "rz", "rzz", "rxx", "ryy", "phase", "cphase")
                    and "parameters" in prev
                    and "parameters" in item
                ):
                    theta = float(np.real(np.asarray(_host(prev["parameters"].get("theta", 0))))) + float(
                        np.real(np.asarray(item["parameters"].get("theta", 0)))
                    )
                    from ..ops import gates as gates_mod

                    gatef = gates_mod.GATES[pn]
                    out[-1] = {
                        "gatef": gatef,
                        "gate": gatef(theta=theta),
                        "index": prev["index"],
                        "name": pn,
                        "parameters": {"theta": theta},
                        "split": None,
                        "mpo": False,
                    }
                    continue
                try:
                    m = _gate_matrix(item) @ _gate_matrix(prev)
                    out[-1] = {
                        "gatef": None,
                        "gate": Gate(m, name="any"),
                        "index": prev["index"],
                        "name": "any",
                        "split": None,
                        "mpo": False,
                    }
                    continue
                except Exception:
                    pass
        out.append(item)
    return out


def replace_u_pass(qir: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Rewrite u(θ, φ, λ) into rz(φ) ry(θ) rz(λ) (up to global phase)."""
    from ..ops import gates as gates_mod

    out = []
    for item in qir:
        if (item.get("name") or "").lower() == "u" and "parameters" in item:
            p = item["parameters"]
            theta = float(np.real(np.asarray(_host(p.get("theta", 0)))))
            phi = float(np.real(np.asarray(_host(p.get("phi", 0)))))
            lbd = float(np.real(np.asarray(_host(p.get("lbd", 0)))))
            q = item["index"]
            for name, val in (("rz", lbd), ("ry", theta), ("rz", phi)):
                gatef = gates_mod.GATES[name]
                out.append(
                    {
                        "gatef": gatef,
                        "gate": gatef(theta=val),
                        "index": q,
                        "name": name,
                        "parameters": {"theta": val},
                        "split": None,
                        "mpo": False,
                    }
                )
        else:
            out.append(item)
    return out


def simple_compile(
    circuit: Any,
    info: Optional[Dict[str, Any]] = None,
    output: str = "circuit",
    compiled_options: Optional[Dict[str, Any]] = None,
) -> Any:
    """``replace_u_pass``, ``merge_pass`` and ``prune_pass`` in turn until
    the QIR stops shrinking (20 rounds at most): a new circuit of the same
    class and device and ``info`` (or the QIR with ``output="qir"``)."""
    qir = list(circuit.to_qir())
    for _ in range(20):
        new = replace_u_pass(qir)
        new = merge_pass(new)
        new = prune_pass(new)
        if len(new) == len(qir):
            qir = new
            break
        qir = new
    new_c = type(circuit)(**circuit._copy_params())
    new_c.append_from_qir(qir)
    if output == "qir":
        return qir
    return new_c, info or {}


# ----------------------------------------------------------------------
# the passes on a circuit or a QIR
# ----------------------------------------------------------------------


def _qir_or_circuit(circuit: Any) -> Any:
    if isinstance(circuit, list):
        return list(circuit), "qir"
    return list(circuit.to_qir()), "circuit"


def _rebuild(circuit: Any, qir: List[Dict[str, Any]], output: str) -> Any:
    if output == "qir":
        return qir
    c = type(circuit)(**circuit._copy_params())
    c.append_from_qir(qir)
    return c


def replace_r(circuit: Any, **kws: Any) -> Any:
    """rx and ry rewritten as conjugated rz: rx(θ) = h rz(θ) h and
    ry(θ) = sd h rz(θ) h s (a circuit or a QIR in, the same out)."""
    from ..ops import gates as gates_mod

    qir, output = _qir_or_circuit(circuit)
    out: List[Dict[str, Any]] = []

    def emit(name: str, q: Any, theta: Optional[float] = None) -> None:
        gatef = gates_mod.GATES[name]
        g = gatef(theta=theta) if theta is not None else gatef()
        item = {
            "gatef": gatef,
            "gate": g,
            "index": q,
            "name": name,
            "split": None,
            "mpo": False,
        }
        if theta is not None:
            item["parameters"] = {"theta": theta}
        out.append(item)

    for item in qir:
        name = (item.get("name") or "").lower()
        if name in ("rx", "ry") and "parameters" in item:
            theta = float(np.real(np.asarray(_host(item["parameters"].get("theta", 0)))))
            q = item["index"]
            if name == "rx":
                emit("h", q)
                emit("rz", q, theta)
                emit("h", q)
            else:
                emit("sd", q)
                emit("h", q)
                emit("rz", q, theta)
                emit("h", q)
                emit("s", q)
        else:
            out.append(item)
    return _rebuild(circuit, out, output)


def replace_u(circuit: Any, **kws: Any) -> Any:
    """:func:`replace_u_pass` on a circuit or a QIR."""
    qir, output = _qir_or_circuit(circuit)
    return _rebuild(circuit, replace_u_pass(qir), output)


def prune(circuit: Any, rtol: float = 1e-3, atol: float = 1e-3, **kws: Any) -> Any:
    """:func:`prune_pass` (at ``atol``) on a circuit or a QIR."""
    qir, output = _qir_or_circuit(circuit)
    return _rebuild(circuit, prune_pass(qir, atol=atol), output)


def merge(circuit: Any, rules: Optional[Dict[Any, str]] = None, **kws: Any) -> Any:
    """:func:`merge_pass` on a circuit or a QIR."""
    qir, output = _qir_or_circuit(circuit)
    return _rebuild(circuit, merge_pass(qir), output)
