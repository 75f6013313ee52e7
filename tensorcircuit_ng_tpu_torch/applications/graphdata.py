"""Graph instance generators for QAOA benchmarks (reference ``applications/graphdata.py``)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

__all__ = ["regular_graph_generator", "erdos_graph_generator", "all_nodes_covered", "graph1"]


def regular_graph_generator(d: int = 3, n: int = 8, weights: bool = False, seed: Optional[int] = None) -> Iterator[Any]:
    import networkx as nx

    rng = np.random.default_rng(seed)
    while True:
        g = nx.random_regular_graph(d, n, seed=int(rng.integers(1 << 31)))
        for a, b in g.edges:
            g[a][b]["weight"] = float(rng.uniform()) if weights else 1.0
        for v in g.nodes:
            g.nodes[v]["weight"] = 0.0
        yield g


def erdos_graph_generator(n: int = 8, p: float = 0.3, weights: bool = False, seed: Optional[int] = None) -> Iterator[Any]:
    import networkx as nx

    rng = np.random.default_rng(seed)
    while True:
        g = nx.erdos_renyi_graph(n, p, seed=int(rng.integers(1 << 31)))
        for a, b in g.edges:
            g[a][b]["weight"] = float(rng.uniform()) if weights else 1.0
        for v in g.nodes:
            g.nodes[v]["weight"] = 0.0
        yield g


def all_nodes_covered(g: Any) -> bool:
    return all(deg > 0 for _, deg in g.degree)


def graph1() -> Any:
    """A fixed 8-node 3-regular benchmark instance."""
    import networkx as nx

    g = nx.random_regular_graph(3, 8, seed=42)
    for a, b in g.edges:
        g[a][b]["weight"] = 1.0
    for v in g.nodes:
        g.nodes[v]["weight"] = 0.0
    return g


# ======================================================================
# reference-parity graph utilities (applications/graphdata.py:235-481)
# ======================================================================

import itertools as _itertools
from functools import partial as _partial
from typing import Sequence, Tuple


def dict2graph(d: Dict[Any, Any]) -> Any:
    """dict-of-dicts -> weighted nx.Graph (reference :235)."""
    import networkx as nx

    g = nx.to_networkx_graph(d)
    for e in g.edges:
        if not g[e[0]][e[1]].get("weight"):
            g[e[0]][e[1]]["weight"] = 1.0
    return g


#: small named instances for quick experiments (reference graph_instances role)
_GRAPH_INSTANCES: Dict[str, Dict[Any, Any]] = {
    "3C": {0: {1: {}, 2: {}}, 1: {2: {}}, 2: {}},  # triangle
    "4C": {0: {1: {}, 3: {}}, 1: {2: {}}, 2: {3: {}}, 3: {}},  # square cycle
    "8A": {i: {(i + 1) % 8: {}, (i + 2) % 8: {}} for i in range(8)},
}


def get_graph(c: str) -> Any:
    """Named benchmark graph (reference :251)."""
    return dict2graph(_GRAPH_INSTANCES.get(c, _GRAPH_INSTANCES["3C"]))


def _maxcut_value(g: Any, assignment: Sequence[int]) -> float:
    r = 0.0
    for a, b in g.edges:
        r += g[a][b].get("weight", 1.0) * int(assignment[a] != assignment[b])
    return r


def maxcut_solution_bruteforce(g: Any) -> Tuple[float, Sequence[int]]:
    """Exact maxcut by enumeration (reference :309)."""
    n = len(g.nodes)
    best, best_v = -1.0, [1] * n
    for v in _itertools.product((1, -1), repeat=n):
        val = _maxcut_value(g, v)
        if val > best:
            best, best_v = val, list(v)
    return best, best_v


def ensemble_maxcut_solution(g: Any, samples: int = 100) -> Tuple[float, float]:
    """Mean/stderr of the maxcut optimum over a graph generator (ref :321)."""
    r = [maxcut_solution_bruteforce(next(g))[0] for _ in range(samples)]
    return float(np.mean(r)), float(np.std(r) / np.sqrt(len(r)))


def reduce_edges(g: Any, m: int = 1) -> Sequence[Any]:
    """All graphs with m edges removed from g (reference :328)."""
    el = list(g.edges)
    glist = []
    for missing in _itertools.combinations(range(len(el)), m):
        g2 = g.copy()
        for k in missing:
            g2.remove_edge(*el[k])
        glist.append(g2)
    return glist


def reduced_ansatz(g: Any, ratio: Optional[int] = None) -> Any:
    """Random subgraph keeping ``ratio`` edges (reference :354)."""
    ne = len(g.edges)
    keep = ne // 2 if ratio is None else ratio
    el = list(g.edges)
    chosen = set(
        tuple(el[i]) for i in np.random.choice(ne, size=min(keep, ne), replace=False)
    )
    g2 = g.copy()
    for e in el:
        if tuple(e) not in chosen:
            g2.remove_edge(*e)
    return g2


def split_ansatz(g: Any, split: int = 2) -> Sequence[Any]:
    """Partition edges evenly into ``split`` subgraphs (reference :377)."""
    el = list(g.edges)
    out = []
    for s in range(split):
        g2 = g.copy()
        for k, e in enumerate(el):
            if k % split != s:
                g2.remove_edge(*e)
        out.append(g2)
    return out


def graph1D(n: int, pbc: bool = True) -> Any:
    """1D chain (PBC optional), unit weights (reference :398)."""
    import networkx as nx

    g = nx.Graph()
    for i in range(n):
        g.add_node(i)
    for i in range(n - 1):
        g.add_edge(i, i + 1, weight=1.0)
    if pbc and n > 2:
        g.add_edge(n - 1, 0, weight=1.0)
    return g


def even1D(n: int, s: int = 0) -> Any:
    """Alternating-bond chain starting at parity s (reference :418)."""
    import networkx as nx

    g = nx.Graph()
    for i in range(n):
        g.add_node(i)
    for i in range(s, n, 2):
        g.add_edge(i, (i + 1) % n, weight=1.0)
    return g


odd1D = _partial(even1D, s=1)


def Grid2D(m: int, n: int, pbc: bool = True) -> Any:
    """m x n grid graph, optional periodic wrap (reference :430)."""
    import networkx as nx

    g = nx.Graph()
    idx = lambda x, y: x * n + y
    for x in range(m):
        for y in range(n):
            g.add_node(idx(x, y))
    for x in range(m):
        for y in range(n):
            if y + 1 < n or pbc:
                g.add_edge(idx(x, y), idx(x, (y + 1) % n), weight=1.0)
            if x + 1 < m or pbc:
                g.add_edge(idx(x, y), idx((x + 1) % m, y), weight=1.0)
    return g


def Triangle2D(m: int, n: int) -> Any:
    """Triangular lattice on an m x n torus (reference :430+)."""
    import networkx as nx

    g = nx.Graph()
    idx = lambda x, y: (x % m) * n + (y % n)
    for x in range(m):
        for y in range(n):
            g.add_edge(idx(x, y), idx(x, y + 1), weight=1.0)
            g.add_edge(idx(x, y), idx(x + 1, y), weight=1.0)
            g.add_edge(idx(x, y), idx(x + 1, y + 1), weight=1.0)
    return g


def dress_graph_with_cirq_qubit(g: Any) -> Any:
    """Attach a qubit payload per node (reference uses cirq.GridQubit;
    here an (x, 0) coordinate tuple keeps the API offline-friendly)."""
    for i, v in enumerate(sorted(g.nodes)):
        g.nodes[v]["qubit"] = (i, 0)
    return g
