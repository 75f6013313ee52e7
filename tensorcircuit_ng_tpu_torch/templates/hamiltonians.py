"""Hamiltonian constructors on Pauli strings: Heisenberg, the transverse-field
Ising chain, a weighted Ising graph and Rydberg atoms, each as a COO tensor
(``sparse``) or a dense one in the configured dtype, on ``device`` (the
configured device by default)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..quantum import PauliStringSum2COO, PauliStringSum2Dense

__all__ = ["heisenberg_hamiltonian", "tfim_hamiltonian", "ising_hamiltonian", "rydberg_hamiltonian"]


def _build(ls: Any, ws: Any, sparse: bool, device: Optional[Any]) -> Any:
    if sparse:
        return PauliStringSum2COO(ls, ws, device=device)
    return PauliStringSum2Dense(ls, ws, device=device)


def _edges(g: Any):
    try:
        return list(g.edges), list(g.nodes)
    except AttributeError:
        edges = list(g)
        nodes = sorted({i for e in edges for i in e})
        return edges, nodes


def heisenberg_hamiltonian(
    g: Any,
    hzz: float = 1.0,
    hxx: float = 1.0,
    hyy: float = 1.0,
    hz: float = 0.0,
    hx: float = 0.0,
    hy: float = 0.0,
    sparse: bool = True,
    numpy: bool = False,
    device: Optional[Any] = None,
) -> Any:
    from ..quantum import heisenberg_hamiltonian as _h

    return _h(g, hzz, hxx, hyy, hz, hx, hy, sparse=sparse, numpy=numpy, device=device)


def tfim_hamiltonian(
    n: int, j: float = 1.0, h: float = -1.0, pbc: bool = False, sparse: bool = True, device: Optional[Any] = None
) -> Any:
    """Transverse-field Ising chain H = j Σ Z_i Z_{i+1} + h Σ X_i."""
    ls, ws = [], []
    bonds = [(i, i + 1) for i in range(n - 1)]
    if pbc:
        bonds.append((n - 1, 0))
    for a, b in bonds:
        l = [0] * n
        l[a] = 3
        l[b] = 3
        ls.append(l)
        ws.append(j)
    for i in range(n):
        l = [0] * n
        l[i] = 1
        ls.append(l)
        ws.append(h)
    return _build(ls, ws, sparse, device)


def ising_hamiltonian(g: Any, sparse: bool = True, device: Optional[Any] = None) -> Any:
    """Weighted Ising H = Σ_{(i,j)} w_ij Z_i Z_j + Σ_i w_i Z_i from a graph."""
    edges, nodes = _edges(g)
    n = len(nodes)
    idx = {v: i for i, v in enumerate(nodes)}
    ls, ws = [], []
    for e in edges:
        a, b = idx[e[0]], idx[e[1]]
        try:
            w = g[e[0]][e[1]].get("weight", 1.0)
        except Exception:
            w = 1.0
        l = [0] * n
        l[a] = 3
        l[b] = 3
        ls.append(l)
        ws.append(w)
    try:
        for node, data in g.nodes(data=True):
            w = data.get("weight", 0.0)
            if w:
                l = [0] * n
                l[idx[node]] = 3
                ls.append(l)
                ws.append(w)
    except Exception:
        pass
    return _build(ls, ws, sparse, device)


def rydberg_hamiltonian(
    lattice: Any,
    omega: float = 1.0,
    delta: float = 0.0,
    c6: float = 1.0,
    cutoff: float = np.inf,
    sparse: bool = True,
    device: Optional[Any] = None,
) -> Any:
    """Rydberg-atom H = Σ Ω/2 X_i - Σ δ n_i + Σ C6/r^6 n_i n_j.

    ``n_i = (1 - Z_i)/2``; ``lattice`` supplies the coordinates (a lattice
    or an array); the constant is an identity string.
    """
    coords = lattice.get_coordinates() if hasattr(lattice, "get_coordinates") else np.asarray(lattice)
    n = len(coords)
    ls, ws = [], []
    const = 0.0
    zcoef = np.zeros(n)
    for i in range(n):
        l = [0] * n
        l[i] = 1
        ls.append(l)
        ws.append(omega / 2.0)
        zcoef[i] += delta / 2.0  # -delta n_i = -delta/2 + delta/2 Z_i
        const += -delta / 2.0
    for i in range(n):
        for j in range(i + 1, n):
            r = float(np.linalg.norm(coords[i] - coords[j]))
            if r > cutoff or r == 0:
                continue
            v = c6 / r**6
            # n_i n_j = (1 - Z_i - Z_j + Z_i Z_j)/4
            l = [0] * n
            l[i] = 3
            l[j] = 3
            ls.append(l)
            ws.append(v / 4.0)
            zcoef[i] += -v / 4.0
            zcoef[j] += -v / 4.0
            const += v / 4.0
    for i in range(n):
        if zcoef[i] != 0:
            l = [0] * n
            l[i] = 3
            ls.append(l)
            ws.append(zcoef[i])
    if const != 0:
        ls.append([0] * n)
        ws.append(const)
    return _build(ls, ws, sparse, device)
