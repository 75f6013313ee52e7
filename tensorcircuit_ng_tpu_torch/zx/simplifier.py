"""ZX rewrite passes: fusion, identity removal, color change, fixpoint loop.

The port's copy of ``tensorcircuit_ng_tpu/zx/simplifier.py`` (host Python
over the graph): exact rewrites only, so ``to_matrix()`` is invariant under
``simplify``.
"""

from __future__ import annotations

import math
from typing import Any

from .graph import ZXGraph

__all__ = [
    "remove_identities",
    "color_change",
    "remove_self_loops",
    "simplify",
    "full_reduce",
    "teleport_reduce",
    "t_count",
]

_EPS = 1e-12


def _phase_zero(p: float) -> bool:
    p = p % (2 * math.pi)
    return min(p, 2 * math.pi - p) < _EPS


def remove_self_loops(g: ZXGraph) -> int:
    """Drop plain self-loops (exact factor 1 on a δ-spider)."""
    before = len(g.edges)
    g.edges = [(a, b, h) for (a, b, h) in g.edges if not (a == b and not h)]
    return before - len(g.edges)


def remove_identities(g: ZXGraph) -> int:
    """Contract phase-0 degree-2 Z/X spiders into a wire (H flags XOR)."""
    count = 0
    changed = True
    while changed:
        changed = False
        for sid, s in list(g.spiders.items()):
            if s.kind == "B" or not _phase_zero(s.phase):
                continue
            inc = [
                (k, e) for k, e in enumerate(g.edges) if sid in (e[0], e[1])
            ]
            if len(inc) != 2:
                continue
            (k1, (a1, b1, h1)), (k2, (a2, b2, h2)) = inc
            n1 = b1 if a1 == sid else a1
            n2 = b2 if a2 == sid else a2
            if n1 == sid or n2 == sid:  # self-loop through the spider
                continue
            g.edges = [e for k, e in enumerate(g.edges) if k not in (k1, k2)]
            g.edges.append((n1, n2, bool(h1) ^ bool(h2)))
            del g.spiders[sid]
            count += 1
            changed = True
            break
    return count


def color_change(g: ZXGraph, to: str = "Z") -> int:
    """Flip all spiders of the other color, toggling incident edge H flags."""
    src = "X" if to == "Z" else "Z"
    count = 0
    for sid, s in g.spiders.items():
        if s.kind != src:
            continue
        s.kind = to
        new_edges = []
        for a, b, h in g.edges:
            if a == sid and b == sid:
                new_edges.append((a, b, h))  # self-loop: two toggles cancel
            elif sid in (a, b):
                new_edges.append((a, b, not h))
            else:
                new_edges.append((a, b, h))
        g.edges = new_edges
        count += 1
    return count


def simplify(g: ZXGraph, graph_like: bool = True) -> int:
    """Fixpoint loop: (color-change to Z) + fuse + identity/self-loop removal.

    Returns the number of spiders removed.  With ``graph_like`` the result
    has only Z spiders and H-edges (the pyzx "graph-like" form, which
    maximizes fusion opportunities).
    """
    before = g.num_spiders()
    if graph_like:
        color_change(g, "Z")
    for _ in range(1000):
        did = g.fuse_spiders()
        did += remove_self_loops(g)
        did += remove_identities(g)
        if not did:
            break
    return before - g.num_spiders()


def full_reduce(g: ZXGraph, param_safe: bool = True) -> None:
    """Full exact simplification to fixpoint (reference delegates to pyzx).

    Our rewrite set: color-change to graph-like form, spider fusion,
    identity and self-loop removal, iterated to fixpoint in place.
    ``param_safe`` keeps parameterized spiders (``g.phase_vars``) unfused.
    """
    protected = set(getattr(g, "phase_vars", {}) or {})
    if protected and param_safe:
        # temporarily mark parameterized spiders as boundaries so no rewrite
        # touches them, then restore their kinds
        saved = {sid: g.spiders[sid].kind for sid in protected if sid in g.spiders}
        for sid in saved:
            g.spiders[sid].kind = "B"
        simplify(g, graph_like=False)
        for sid, kind in saved.items():
            if sid in g.spiders:
                g.spiders[sid].kind = kind
    else:
        simplify(g, graph_like=True)


def teleport_reduce(g: ZXGraph) -> ZXGraph:
    """Phase-teleporting reduction (reference: pyzx.teleport_reduce).

    Exact-rewrite subset: simplification that preserves the circuit-like
    structure (no color change), returning the same graph object.
    """
    simplify(g, graph_like=False)
    return g


def t_count(g: ZXGraph) -> int:
    """Number of T-like spiders (phase an odd multiple of π/4), ref parity."""
    count = 0
    for s in g.spiders.values():
        if s.kind == "B":
            continue
        frac = (s.phase / (math.pi / 4)) % 8
        if abs(frac - round(frac)) < 1e-9 and int(round(frac)) % 2 == 1:
            count += 1
    return count
