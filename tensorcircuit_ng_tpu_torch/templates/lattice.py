"""Lattices, in numpy: ``AbstractLattice``/``TILattice`` with coordinates,
identifier <-> index maps, a cached (minimum-image) distance matrix and
k-th-neighbor bonds, ten named lattices, ``CustomizeLattice``, and
``get_compatible_layers``, a greedy colouring of bonds into layers of
disjoint pairs for gate rounds.  The port's copy of
``tensorcircuit_ng_tpu/templates/lattice.py``.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# public typing aliases
SiteIndex = int
SiteIdentifier = Any
Coordinates = Any
NeighborMap = Dict[int, List[int]]

__all__ = [
    "AbstractLattice",
    "TILattice",
    "CustomizeLattice",
    "ChainLattice",
    "SquareLattice",
    "RectangularLattice",
    "HoneycombLattice",
    "TriangularLattice",
    "KagomeLattice",
    "LiebLattice",
    "CheckerboardLattice",
    "CubicLattice",
    "DimerizedChainLattice",
    "get_compatible_layers",
]

SiteId = Tuple[int, ...]


class AbstractLattice:
    """Sites with coordinates + neighbor structure."""

    def __init__(self, dimensionality: int):
        self._dim = dimensionality
        self._coords: List[np.ndarray] = []
        self._ids: List[Any] = []
        self._id2idx: Dict[Any, int] = {}
        self._distance_matrix: Optional[np.ndarray] = None

    # registry ----------------------------------------------------------

    def _add_site(self, ident: Any, coord: Sequence[float]) -> int:
        idx = len(self._coords)
        self._coords.append(np.asarray(coord, dtype=float))
        self._ids.append(ident)
        self._id2idx[ident] = idx
        return idx

    @property
    def num_sites(self) -> int:
        return len(self._coords)

    def __len__(self) -> int:
        return self.num_sites

    @property
    def dimensionality(self) -> int:
        return self._dim

    def get_coordinates(self) -> np.ndarray:
        return np.stack(self._coords)

    def get_site_info(self, idx: int) -> Tuple[Any, np.ndarray]:
        return self._ids[idx], self._coords[idx]

    def get_index(self, ident: Any) -> int:
        return self._id2idx[ident]

    def get_identifier(self, idx: int) -> Any:
        return self._ids[idx]

    # geometry ----------------------------------------------------------

    def distance_matrix(self) -> np.ndarray:
        if self._distance_matrix is None:
            coords = self.get_coordinates()
            diff = coords[:, None, :] - coords[None, :, :]
            self._distance_matrix = np.sqrt(np.sum(diff**2, axis=-1))
        return self._distance_matrix

    def get_neighbors(self, idx: int, k: int = 1, tol: float = 1e-6) -> List[int]:
        """Indices of the k-th nearest neighbors of site idx."""
        dm = self.distance_matrix()
        dists = np.unique(np.round(dm[idx][dm[idx] > tol], 6))
        if len(dists) < k:
            return []
        dk = dists[k - 1]
        return [int(j) for j in np.nonzero(np.abs(dm[idx] - dk) < tol)[0]]

    def get_neighbor_pairs(self, k: int = 1, unique: bool = True, tol: float = 1e-6) -> List[Tuple[int, int]]:
        """All k-th-neighbor bonds (i, j); ``unique`` keeps i < j."""
        pairs = []
        for i in range(self.num_sites):
            for j in self.get_neighbors(i, k, tol):
                if unique and j <= i:
                    continue
                pairs.append((i, j))
        return pairs

    @property
    def sites(self) -> List[Any]:
        """Site identifiers in index order."""
        return [self.get_identifier(i) for i in range(self.num_sites)]

    def get_all_pairs(self, k: int = 1, tol: float = 1e-6) -> List[Tuple[int, int]]:
        """All k-th-neighbor site pairs."""
        return self.get_neighbor_pairs(k=k, unique=True, tol=tol)

    def show(self, **kws: Any) -> Any:  # pragma: no cover - plotting
        """Scatter-plot of the lattice via matplotlib."""
        import matplotlib.pyplot as plt

        coords = self.get_coordinates()
        fig, ax = plt.subplots()
        if coords.shape[1] == 1:
            ax.scatter(coords[:, 0], np.zeros(len(coords)))
        else:
            ax.scatter(coords[:, 0], coords[:, 1])
        for a, b in self.get_neighbor_pairs():
            ca, cb = coords[a], coords[b]
            if coords.shape[1] == 1:
                ax.plot([ca[0], cb[0]], [0, 0], "k-", lw=0.5)
            else:
                ax.plot([ca[0], cb[0]], [ca[1], cb[1]], "k-", lw=0.5)
        return ax

    def to_networkx(self, k: int = 1) -> Any:
        import networkx as nx

        g = nx.Graph()
        for i in range(self.num_sites):
            g.add_node(i, coord=self._coords[i])
        for i, j in self.get_neighbor_pairs(k):
            g.add_edge(i, j)
        return g

    def __repr__(self) -> str:
        return f"{type(self).__name__}(num_sites={self.num_sites}, dim={self._dim})"


class TILattice(AbstractLattice):
    """Translation-invariant lattice from unit cell + basis.

    ``lattice_vectors``: (dim, dim); ``basis``: (nb, dim) positions inside the
    cell; ``size``: cells per direction; ``pbc``: periodic flags.
    """

    def __init__(
        self,
        dimensionality: int,
        lattice_vectors: Sequence[Sequence[float]],
        basis: Sequence[Sequence[float]],
        size: Sequence[int],
        pbc: Union[bool, Sequence[bool]] = True,
        lattice_constant: float = 1.0,
        precompute_neighbors: Optional[int] = None,
    ):
        super().__init__(dimensionality)
        lc = float(lattice_constant)
        self.lattice_constant = lc
        self.lattice_vectors = np.asarray(lattice_vectors, dtype=float) * lc
        self.basis = np.asarray(basis, dtype=float) * lc
        self.size = tuple(size)
        if isinstance(pbc, bool):
            pbc = (pbc,) * dimensionality
        self.pbc = tuple(pbc)
        for cell in itertools.product(*[range(s) for s in self.size]):
            for b, bpos in enumerate(self.basis):
                coord = bpos + sum(
                    c * v for c, v in zip(cell, self.lattice_vectors)
                )
                self._add_site(tuple(cell) + (b,), coord)
        if precompute_neighbors:
            for k in range(1, int(precompute_neighbors) + 1):
                self.get_neighbor_pairs(k=k)

    def distance_matrix(self) -> np.ndarray:
        """Minimum-image distances honoring periodic boundaries."""
        if self._distance_matrix is None:
            coords = self.get_coordinates()
            diff = coords[:, None, :] - coords[None, :, :]
            # minimum image over periodic directions
            shifts = []
            for d in range(self._dim):
                if self.pbc[d]:
                    shifts.append((-1, 0, 1))
                else:
                    shifts.append((0,))
            best = np.full(diff.shape[:2], np.inf)
            for combo in itertools.product(*shifts):
                offset = sum(
                    c * s * v
                    for c, s, v in zip(combo, self.size, self.lattice_vectors)
                )
                dd = np.sqrt(np.sum((diff + offset) ** 2, axis=-1))
                best = np.minimum(best, dd)
            self._distance_matrix = best
        return self._distance_matrix


class CustomizeLattice(AbstractLattice):
    """Lattice from explicit identifiers + coordinates."""

    def __init__(
        self,
        dimensionality: int,
        identifiers: Sequence[Any],
        coordinates: Sequence[Sequence[float]],
    ):
        super().__init__(dimensionality)
        for ident, coord in zip(identifiers, coordinates):
            self._add_site(ident, coord)

    def add_sites(
        self, identifiers: Sequence[Any], coordinates: Sequence[Sequence[float]]
    ) -> "CustomizeLattice":
        """Extend the lattice with new sites."""
        for ident, coord in zip(identifiers, coordinates):
            self._add_site(ident, coord)
        self._distance_matrix = None
        return self

    def remove_sites(self, identifiers: Sequence[Any]) -> "CustomizeLattice":
        """Remove sites by identifier, reindexing."""
        drop = set(identifiers)
        keep = [
            (i, c)
            for i, c in zip(self.sites, self.get_coordinates().tolist())
            if i not in drop
        ]
        new = CustomizeLattice(
            dimensionality=self.dimensionality,
            identifiers=[i for i, _ in keep],
            coordinates=[c for _, c in keep],
        )
        self.__dict__.update(new.__dict__)
        return self

    @classmethod
    def from_lattice(cls, lattice: AbstractLattice) -> "CustomizeLattice":
        """Freeze any lattice into an explicit-coordinate one."""
        return cls(
            dimensionality=lattice.dimensionality,
            identifiers=list(lattice.sites),
            coordinates=lattice.get_coordinates().tolist(),
        )


# ---------------------------------------------------------------- named


class ChainLattice(TILattice):
    def __init__(self, size: Union[int, Sequence[int]], pbc: bool = True, **kws: Any):
        if isinstance(size, int):
            size = (size,)
        super().__init__(1, [[1.0]], [[0.0]], size, pbc, **kws)


class SquareLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        super().__init__(2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]], size, pbc, **kws)


class RectangularLattice(TILattice):
    def __init__(self, size: Sequence[int], spacings: Sequence[float] = (1.0, 1.5), pbc: bool = True, **kws: Any):
        super().__init__(
            2,
            [[spacings[0], 0.0], [0.0, spacings[1]]],
            [[0.0, 0.0]],
            size,
            pbc,
            **kws,
        )


class HoneycombLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        a1 = [1.5, math.sqrt(3) / 2]
        a2 = [1.5, -math.sqrt(3) / 2]
        basis = [[0.0, 0.0], [1.0, 0.0]]
        super().__init__(2, [a1, a2], basis, size, pbc, **kws)


class TriangularLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        a1 = [1.0, 0.0]
        a2 = [0.5, math.sqrt(3) / 2]
        super().__init__(2, [a1, a2], [[0.0, 0.0]], size, pbc, **kws)


class KagomeLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        a1 = [2.0, 0.0]
        a2 = [1.0, math.sqrt(3)]
        basis = [[0.0, 0.0], [1.0, 0.0], [0.5, math.sqrt(3) / 2]]
        super().__init__(2, [a1, a2], basis, size, pbc, **kws)


class LiebLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        basis = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]
        super().__init__(2, [[2.0, 0.0], [0.0, 2.0]], basis, size, pbc, **kws)


class CheckerboardLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        basis = [[0.0, 0.0], [1.0, 1.0]]
        super().__init__(2, [[2.0, 0.0], [0.0, 2.0]], basis, size, pbc, **kws)


class CubicLattice(TILattice):
    def __init__(self, size: Sequence[int], pbc: bool = True, **kws: Any):
        super().__init__(
            3,
            [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]],
            [[0.0, 0.0, 0.0]],
            size,
            pbc,
            **kws,
        )


class DimerizedChainLattice(TILattice):
    def __init__(self, size: Union[int, Sequence[int]], pbc: bool = True, **kws: Any):
        if isinstance(size, int):
            size = (size,)
        super().__init__(1, [[2.0]], [[0.0], [0.9]], size, pbc, **kws)


def get_compatible_layers(bonds: Sequence[Tuple[int, int]]) -> List[List[Tuple[int, int]]]:
    """Greedy-color bonds into layers of disjoint pairs.

    Layers can be applied as parallel two-qubit gate rounds.
    """
    layers: List[List[Tuple[int, int]]] = []
    remaining = list(bonds)
    while remaining:
        used: set = set()
        layer: List[Tuple[int, int]] = []
        rest: List[Tuple[int, int]] = []
        for i, j in remaining:
            if i in used or j in used:
                rest.append((i, j))
            else:
                layer.append((i, j))
                used.add(i)
                used.add(j)
        layers.append(layer)
        remaining = rest
    return layers
