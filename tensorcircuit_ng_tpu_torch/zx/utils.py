"""GF(2) linear algebra and graph components for the ZX subsystem.

The port's copy of ``tensorcircuit_ng_tpu/zx/utils.py`` (host numpy over
:class:`~tensorcircuit_ng_tpu_torch.zx.graph.ZXGraph`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np

from .graph import ZXGraph

__all__ = ["find_basis", "ConnectedComponent", "connected_components", "get_params"]


def find_basis(vectors: Any) -> Tuple[np.ndarray, np.ndarray]:
    """GF(2) basis extraction: vectors == transform @ basis (mod 2).

    Returns (basis, transform) where ``basis`` stacks the linearly
    independent input rows (in first-seen order) and ``transform[i]`` gives
    the GF(2) expansion of row i over that basis (reference ``zx/utils.py:13``).
    """
    vecs = np.asarray(vectors, dtype=np.uint8) & 1
    num, width = vecs.shape
    basis_rows: List[int] = []
    echelon: List[np.ndarray] = []  # reduced residuals of basis rows
    pivot_cols: List[int] = []
    # expansion of each echelon row in terms of ORIGINAL basis rows
    echelon_expansion: List[np.ndarray] = []
    transform_rows: List[np.ndarray] = []

    for i in range(num):
        residual = vecs[i].copy()
        combo = np.zeros(num, dtype=np.uint8)  # over basis slots (indexed later)
        for j, e in enumerate(echelon):
            if residual[pivot_cols[j]]:
                residual ^= e
                combo ^= echelon_expansion[j]
        if residual.any():
            k = len(basis_rows)
            basis_rows.append(i)
            echelon.append(residual)
            pivot_cols.append(int(np.argmax(residual)))
            own = np.zeros(num, dtype=np.uint8)
            own[k] = 1
            echelon_expansion.append((combo ^ own))
            transform_rows.append(own.copy())
        else:
            transform_rows.append(combo.copy())

    rank = len(basis_rows)
    transform = np.stack(transform_rows)[:, :rank] if num else np.zeros((0, 0), np.uint8)
    return vecs[basis_rows], transform


@dataclass
class ConnectedComponent:
    """A connected ZX subgraph plus the global output slots it owns."""

    graph: Any
    output_indices: List[int]


def _adjacency(g: ZXGraph) -> Dict[int, Set[int]]:
    adj: Dict[int, Set[int]] = {sid: set() for sid in g.spiders}
    for a, b, _ in g.edges:
        adj[a].add(b)
        adj[b].add(a)
    return adj


def connected_components(g: ZXGraph) -> List[ConnectedComponent]:
    """Split a ZXGraph into its connected components (reference ``zx/utils.py``).

    Each component is an independent diagram; its outputs carry their global
    output positions so results can be re-assembled in circuit order.
    """
    adj = _adjacency(g)
    out_pos = {sid: i for i, sid in enumerate(g.outputs)}
    seen: Set[int] = set()
    comps: List[ConnectedComponent] = []
    for start in g.spiders:
        if start in seen:
            continue
        stack = [start]
        members: List[int] = []
        seen.add(start)
        while stack:
            v = stack.pop()
            members.append(v)
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        member_set = set(members)
        sub = ZXGraph()
        remap: Dict[int, int] = {}
        for sid in members:
            sp = g.spiders[sid]
            remap[sid] = sub.add_spider(sp.kind, sp.phase)
        for a, b, h in g.edges:
            if a in member_set and b in member_set:
                sub.add_edge(remap[a], remap[b], h)
        sub.inputs = [remap[s] for s in g.inputs if s in member_set]
        sub.outputs = [remap[s] for s in g.outputs if s in member_set]
        comps.append(
            ConnectedComponent(
                graph=sub,
                output_indices=[out_pos[s] for s in members if s in out_pos],
            )
        )
    return comps


def get_params(g: Any) -> Set[str]:
    """Names of symbolic parameters appearing in a graph's phases.

    Our spiders store numeric phases; parameterized diagrams carry
    ``(name, coeff)`` tuples in ``g.phase_vars`` when built by the
    stabilizer-T pipeline. Returns the active name set (reference
    ``zx/utils.py:188``).
    """
    active: Set[str] = set()
    for names in getattr(g, "phase_vars", {}).values():
        active |= set(names)
    return active
