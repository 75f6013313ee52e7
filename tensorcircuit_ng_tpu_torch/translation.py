"""Circuit translation: the stim program text.

Counterpart of ``tensorcircuit_ng_tpu/translation.py``'s stim part
(``_TC2STIM``, ``tc2stim``, ``stim2tc``): Clifford gates to stim text, and
stim text (gates, ``M``/``MZ`` records, ``R`` resets, the Pauli-noise
instructions, ``DETECTOR``, ``OBSERVABLE_INCLUDE``, ``REPEAT`` blocks and
comments) to a ``StabilizerCircuit``.  No stim is needed; its text loads
into ``stim.Circuit(text)`` where stim is installed.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

__all__ = ["tc2stim", "stim2tc"]

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
