"""Graph generators: a 2D grid's coordinates and bonds, chains, and random
regular and Erdős-Rényi graphs as networkx graphs (node weight 0, edge
weight 1 or uniform from a seed)."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["Grid2DCoord", "Line1D", "Even1D", "Odd1D", "regular_graph", "erdos_graph"]


class Grid2DCoord:
    """An n (columns) x m (rows) grid: site i at (i % n, i // n)."""

    def __init__(self, n: int, m: int):
        self.n = n  # columns
        self.m = m  # rows

    def one2two(self, i: int) -> Tuple[int, int]:
        return i % self.n, i // self.n

    def two2one(self, x: int, y: int) -> int:
        return y * self.n + x

    def all_rows(self, pbc: bool = False) -> List[Tuple[int, int]]:
        pairs = []
        for y in range(self.m):
            for x in range(self.n - 1):
                pairs.append((self.two2one(x, y), self.two2one(x + 1, y)))
            if pbc and self.n > 2:
                pairs.append((self.two2one(self.n - 1, y), self.two2one(0, y)))
        return pairs

    def all_cols(self, pbc: bool = False) -> List[Tuple[int, int]]:
        pairs = []
        for x in range(self.n):
            for y in range(self.m - 1):
                pairs.append((self.two2one(x, y), self.two2one(x, y + 1)))
            if pbc and self.m > 2:
                pairs.append((self.two2one(x, self.m - 1), self.two2one(x, 0)))
        return pairs

    def lattice_graph(self, pbc: bool = True) -> Any:
        import networkx as nx

        g = nx.Graph()
        for i in range(self.n * self.m):
            g.add_node(i, weight=0.0)
        for a, b in self.all_rows(pbc) + self.all_cols(pbc):
            g.add_edge(a, b, weight=1.0)
        return g


def Line1D(n: int, pbc: bool = True, weight: float = 1.0) -> Any:
    import networkx as nx

    g = nx.Graph()
    for i in range(n):
        g.add_node(i, weight=0.0)
    for i in range(n - 1):
        g.add_edge(i, i + 1, weight=weight)
    if pbc:
        g.add_edge(n - 1, 0, weight=weight)
    return g


def Even1D(n: int, s: int = 0) -> Any:
    import networkx as nx

    g = nx.Graph()
    for i in range(n):
        g.add_node(i, weight=0.0)
    for i in range(s, n, 2):
        g.add_edge(i, (i + 1) % n, weight=1.0)
    return g


def Odd1D(n: int) -> Any:
    return Even1D(n, s=1)


def regular_graph(d: int, n: int, seed: Optional[int] = None, weights: bool = False) -> Any:
    import networkx as nx

    g = nx.random_regular_graph(d, n, seed=seed)
    rng = np.random.default_rng(seed)
    for a, b in g.edges:
        g[a][b]["weight"] = float(rng.uniform()) if weights else 1.0
    for v in g.nodes:
        g.nodes[v]["weight"] = 0.0
    return g


def erdos_graph(n: int, p: float, seed: Optional[int] = None, weights: bool = False) -> Any:
    import networkx as nx

    g = nx.erdos_renyi_graph(n, p, seed=seed)
    rng = np.random.default_rng(seed)
    for a, b in g.edges:
        g[a][b]["weight"] = float(rng.uniform()) if weights else 1.0
    for v in g.nodes:
        g.nodes[v]["weight"] = 0.0
    return g
