"""Circuit drawing: quantikz LaTeX and a unicode text sketch.

Counterpart of ``tensorcircuit_ng_tpu/vis.py``: ``qir2tex`` and
``circuit_to_tex`` write quantikz LaTeX of a QIR or of a circuit's per-gate
QIR, ``render_pdf`` runs ``pdflatex`` where it is installed (None
otherwise), and ``draw`` sketches a circuit in unicode without any package.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .translation import _host

__all__ = ["qir2tex", "circuit_to_tex", "render_pdf", "draw", "gate_name_trans"]


_TEX_NAMES = {
    "cnot": "targ",
    "cx": "targ",
}


def qir2tex(
    qir: Sequence[Dict[str, Any]],
    n: int,
    init: Optional[Sequence[str]] = None,
    measure: Optional[Sequence[int]] = None,
    rcompress: bool = False,
    lcompress: bool = False,
    standalone: bool = False,
    return_string_table: bool = False,
) -> Any:
    """quantikz LaTeX of the QIR on n wires: one column an item, a control
    dot and target for cnot/cz/swap, a box over the wires of any other
    multi-qubit gate, ``measure`` wires ending in a meter; ``standalone``
    wraps it in a document, ``return_string_table`` also returns the rows."""
    rows: List[List[str]] = [[] for _ in range(n)]
    inits = init or ["0"] * n
    for q in range(n):
        rows[q].append(rf"\lstick{{$\ket{{{inits[q]}}}$}}")
    for item in qir:
        idx = list(item["index"])
        name = (item.get("name") or "any").lower()
        col = max(len(rows[q]) for q in range(n))
        for q in range(n):
            while len(rows[q]) < col:
                rows[q].append(r"\qw")
        if len(idx) == 1:
            rows[idx[0]].append(rf"\gate{{{_fmt_name(name, item)}}}")
        elif name in ("cnot", "cx"):
            c, t = idx
            rows[c].append(rf"\ctrl{{{t - c}}}")
            rows[t].append(r"\targ{}")
        elif name == "cz":
            c, t = idx
            rows[c].append(rf"\ctrl{{{t - c}}}")
            rows[t].append(r"\control{}")
        elif name == "swap":
            a, b = idx
            rows[a].append(rf"\swap{{{b - a}}}")
            rows[b].append(r"\targX{}")
        else:
            lo, hi = min(idx), max(idx)
            rows[lo].append(
                rf"\gate[{hi - lo + 1}]{{{_fmt_name(name, item)}}}"
            )
            for q in range(lo + 1, hi + 1):
                rows[q].append(r"\qw")
        col = max(len(rows[q]) for q in range(n))
        for q in range(n):
            while len(rows[q]) < col:
                rows[q].append(r"\qw")
    for q in range(n):
        if measure and q in measure:
            rows[q].append(r"\meter{}")
        rows[q].append(r"\qw")
    body = " \\\\\n".join(" & ".join(r) for r in rows)
    tex = "\\begin{quantikz}\n" + body + "\n\\end{quantikz}"
    if standalone:
        tex = (
            "\\documentclass{standalone}\n\\usepackage{quantikz}\n"
            "\\begin{document}\n" + tex + "\n\\end{document}"
        )
    if return_string_table:
        return tex, rows
    return tex


def _fmt_name(name: str, item: Dict[str, Any]) -> str:
    """A gate's label: its name, with its angle to two decimals."""
    params = item.get("parameters", {})
    if "theta" in params:
        try:
            v = float(np.real(np.asarray(_host(params["theta"]))))
            return f"{name}({v:.2f})"
        except Exception:
            pass
    return name


def circuit_to_tex(c: Any, **kws: Any) -> str:
    """:func:`qir2tex` of a circuit's per-gate QIR (fused layers expanded)."""
    qir = c._expanded_qir() if hasattr(c, "_expanded_qir") else c.to_qir()
    return qir2tex(qir, c.nqubits, **kws)


def render_pdf(tex: str, filename: str = "circuit", path: str = ".") -> Optional[str]:
    """Write ``tex`` (a standalone document) to ``path/filename.tex`` and
    compile it with ``pdflatex``: the PDF's path, or None where pdflatex is
    missing or fails."""
    texfile = os.path.join(path, filename + ".tex")
    with open(texfile, "w") as f:
        f.write(tex)
    try:
        subprocess.run(
            ["pdflatex", "-interaction=nonstopmode", texfile],
            cwd=path,
            capture_output=True,
            timeout=60,
            check=True,
        )
        return os.path.join(path, filename + ".pdf")
    except (OSError, subprocess.SubprocessError):
        return None


def draw(c: Any) -> str:
    """A unicode sketch of a circuit's per-gate QIR, one line a qubit."""
    n = c.nqubits
    lines = [f"q{q}: " for q in range(n)]
    qir = c._expanded_qir() if hasattr(c, "_expanded_qir") else c.to_qir()
    for item in qir:
        idx = list(item["index"])
        name = (item.get("name") or "?")[:4]
        width = len(name) + 2
        for q in range(n):
            if q in idx:
                if len(idx) > 1 and q == idx[0] and name in ("cnot", "cx", "cz"):
                    lines[q] += "─●─".ljust(width, "─")
                elif len(idx) > 1 and q == idx[-1] and name in ("cnot", "cx"):
                    lines[q] += "─⊕─".ljust(width, "─")
                else:
                    lines[q] += f"[{name}]".ljust(width, "─")
            else:
                lines[q] += "─" * width
    return "\n".join(lines)


def gate_name_trans(gate_name: str) -> Tuple[int, str]:
    """(the number of controls, the rest of the name) of a gate name with
    leading ``c``s: ``gate_name_trans("ccnot") == (2, "not")``."""
    ctrl = 0
    while gate_name.startswith("c"):
        gate_name = gate_name[1:]
        ctrl += 1
    return ctrl, gate_name
