"""Mutable ZX graph with a pyzx-compatible surface (``GraphS``).

The port's own copy of ``tensorcircuit_ng_tpu/zx/graph_s.py`` (numpy and
``cmath`` only).  pyzx's ``Multigraph`` is replaced by a standalone
structure with the same mutable-graph API:

- integer vertices carrying (type, phase, qubit, row, ground, vdata)
- typed edges (SIMPLE / HADAMARD) with *parity-smart* insertion: adding a
  parallel edge applies the ZX Hopf/fusion edge rules instead of storing
  multi-edges (same-type pairs cancel or merge, with the correct scalar)
- phases in **units of pi** (``Fraction`` preserved exactly, floats allowed),
  matching pyzx conventions
- a global :class:`Scalar` accumulating powers of sqrt(2) and phases
- dense ``to_tensor()`` semantics (numpy) for validation on small diagrams

Edge-parity rules implemented by :meth:`GraphS.add_edge` (derived from the
spider-fusion/Hopf laws, scalars included):

==================  =====================  ==========================
existing + new      same-colour endpoints  different-colour endpoints
==================  =====================  ==========================
simple + simple     one simple edge        no edge, scalar 1/2
had + had           no edge, scalar 1/2    one hadamard edge
simple + had        both kept (type 3)     both kept (type 3)
==================  =====================  ==========================

Boundary (type 0) and H-box vertices never auto-simplify.
"""

from __future__ import annotations

import cmath
import math
from fractions import Fraction
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

__all__ = ["VertexType", "EdgeType", "Scalar", "GraphS"]


class VertexType:
    """pyzx-compatible vertex type codes."""

    BOUNDARY = 0
    Z = 1
    X = 2
    H_BOX = 3


class EdgeType:
    """pyzx-compatible edge type codes (3 = simple AND hadamard in parallel)."""

    SIMPLE = 1
    HADAMARD = 2
    BOTH = 3


def _phase_add(a: Any, b: Any) -> Any:
    """Add two phases in units of pi, normalizing into [0, 2)."""
    s = a + b
    if isinstance(s, Fraction) or isinstance(s, int):
        return Fraction(s) % 2
    return float(s) % 2.0


class Scalar:
    """Global diagram scalar: ``2^(power2/2) * e^(i*pi*phase) * floatfactor``."""

    def __init__(self) -> None:
        self.power2: int = 0
        self.phase: Any = Fraction(0)
        self.floatfactor: complex = 1.0
        self.is_zero: bool = False

    def add_power(self, p: int) -> None:
        self.power2 += p

    def add_phase(self, p: Any) -> None:
        self.phase = _phase_add(self.phase, p)

    def add_float(self, f: complex) -> None:
        self.floatfactor *= f

    def add_node(self, p: Any) -> None:
        """Multiply in a degree-0 spider's value 1 + e^(i*pi*p)."""
        self.add_float(1.0 + cmath.exp(1j * math.pi * float(p)))

    def mult_with_scalar(self, other: "Scalar") -> None:
        self.power2 += other.power2
        self.add_phase(other.phase)
        self.floatfactor *= other.floatfactor
        self.is_zero = self.is_zero or other.is_zero

    def to_number(self) -> complex:
        if self.is_zero:
            return 0.0
        return (
            (2.0 ** (self.power2 / 2.0))
            * cmath.exp(1j * math.pi * float(self.phase))
            * self.floatfactor
        )

    def copy(self) -> "Scalar":
        s = Scalar()
        s.power2, s.phase = self.power2, self.phase
        s.floatfactor, s.is_zero = self.floatfactor, self.is_zero
        return s

    def __repr__(self) -> str:
        return f"Scalar({self.to_number():.6g})"


_H = np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2.0)


class GraphS:
    """Simple mutable ZX graph (pyzx ``GraphS``/``Multigraph`` role).

    Vertices are dense integers; adjacency is dict-of-dict ``{v: {w: etype}}``.
    """

    backend = "simple"

    def __init__(self) -> None:
        self._adj: Dict[int, Dict[int, int]] = {}
        self._types: Dict[int, int] = {}
        self._phases: Dict[int, Any] = {}
        self._qubits: Dict[int, Any] = {}
        self._rows: Dict[int, Any] = {}
        self._grounds: Set[int] = set()
        self._vdata: Dict[int, Dict[str, Any]] = {}
        self._params: Dict[int, Set[Any]] = {}
        self._inputs: Tuple[int, ...] = ()
        self._outputs: Tuple[int, ...] = ()
        self._next: int = 0
        self.scalar = Scalar()
        self.track_phases: bool = False
        self.merge_vdata: Optional[Any] = None
        self._auto_simplify: bool = True
        self._phaseVars: Set[Any] = set()
        self.multigraph = False

    # -- vertices ------------------------------------------------------

    def add_vertex(
        self, ty: int = VertexType.Z, qubit: Any = -1, row: Any = -1, phase: Any = None
    ) -> int:
        v = self._next
        self._next += 1
        self._adj[v] = {}
        self._types[v] = ty
        self._phases[v] = Fraction(0) if phase is None else phase
        self._qubits[v] = qubit
        self._rows[v] = row
        return v

    def remove_vertex(self, v: int) -> None:
        for w in list(self._adj[v]):
            del self._adj[w][v]
        for d in (self._adj, self._types, self._phases, self._qubits, self._rows):
            d.pop(v, None)
        self._vdata.pop(v, None)
        self._params.pop(v, None)
        self._grounds.discard(v)
        self._inputs = tuple(i for i in self._inputs if i != v)
        self._outputs = tuple(o for o in self._outputs if o != v)

    def remove_vertices(self, vs: Any) -> None:
        for v in list(vs):
            self.remove_vertex(v)

    def vertices(self) -> Iterator[int]:
        return iter(self._adj)

    def vertex_set(self) -> Set[int]:
        return set(self._adj)

    def num_vertices(self) -> int:
        return len(self._adj)

    def neighbors(self, v: int) -> Any:
        return list(self._adj[v])

    def vertex_degree(self, v: int) -> int:
        # a type-3 (parallel simple+hadamard) edge counts twice
        return sum(2 if t == EdgeType.BOTH else 1 for t in self._adj[v].values())

    def type(self, v: int) -> int:
        return self._types[v]

    def set_type(self, v: int, t: int) -> None:
        self._types[v] = t

    def types(self) -> Dict[int, int]:
        return dict(self._types)

    def phase(self, v: int) -> Any:
        return self._phases[v]

    def set_phase(self, v: int, p: Any) -> None:
        self._phases[v] = Fraction(p) % 2 if isinstance(p, (int, Fraction)) else p

    def add_to_phase(self, v: int, p: Any, params: Any = None) -> None:
        self.set_phase(v, _phase_add(self._phases[v], p))
        if params:
            self._params.setdefault(v, set()).update(params)
            self._phaseVars.update(params)

    def phases(self) -> Dict[int, Any]:
        return dict(self._phases)

    def get_params(self, v: int) -> Set[Any]:
        """Symbolic phase variables attached to v (empty set if none)."""
        return set(self._params.get(v, set()))

    def set_params(self, v: int, params: Any) -> None:
        self._params[v] = set(params)
        self._phaseVars.update(params)

    def fuse_phases(self, v1: int, v2: int) -> None:
        """Merge v2's symbolic phase variables into v1 (spider fusion hook)."""
        if v2 in self._params:
            self._params.setdefault(v1, set()).update(self._params.pop(v2))

    def update_phase_index(self, old: int, new: int) -> None:
        if old in self._params:
            self._params[new] = self._params.pop(old)

    def qubit(self, v: int) -> Any:
        return self._qubits[v]

    def set_qubit(self, v: int, q: Any) -> None:
        self._qubits[v] = q

    def qubits(self) -> Dict[int, Any]:
        return dict(self._qubits)

    def row(self, v: int) -> Any:
        return self._rows[v]

    def set_row(self, v: int, r: Any) -> None:
        self._rows[v] = r

    def rows(self) -> Dict[int, Any]:
        return dict(self._rows)

    def is_ground(self, v: int) -> bool:
        return v in self._grounds

    def set_ground(self, v: int, g: bool = True) -> None:
        (self._grounds.add if g else self._grounds.discard)(v)

    def grounds(self) -> Set[int]:
        return set(self._grounds)

    def vdata(self, v: int, key: str, default: Any = None) -> Any:
        return self._vdata.get(v, {}).get(key, default)

    def set_vdata(self, v: int, key: str, val: Any) -> None:
        self._vdata.setdefault(v, {})[key] = val

    def vdata_keys(self, v: int) -> Any:
        return list(self._vdata.get(v, {}))

    # -- inputs / outputs ---------------------------------------------

    def inputs(self) -> Tuple[int, ...]:
        return self._inputs

    def set_inputs(self, inputs: Any) -> None:
        self._inputs = tuple(inputs)

    def outputs(self) -> Tuple[int, ...]:
        return self._outputs

    def set_outputs(self, outputs: Any) -> None:
        self._outputs = tuple(outputs)

    # -- edges ---------------------------------------------------------

    def add_edge(self, edge: Tuple[int, int], edgetype: int = EdgeType.SIMPLE) -> None:
        v, w = edge
        if v == w:
            # self-loops reduce immediately: simple loop = identity factor,
            # hadamard loop on a spider = pi phase + 1/sqrt(2) scalar
            if edgetype == EdgeType.HADAMARD and self._types[v] in (
                VertexType.Z,
                VertexType.X,
            ):
                self.add_to_phase(v, 1)
                self.scalar.add_power(-1)
            return
        old = self._adj[v].get(w)
        if old is None or not self._auto_simplify:
            self._adj[v][w] = edgetype if old is None else (old | edgetype)
            self._adj[w][v] = self._adj[v][w]
            return
        self._adj[v][w] = self._adj[w][v] = self._smart_merge(v, w, old, edgetype)
        if self._adj[v][w] == 0:
            del self._adj[v][w]
            del self._adj[w][v]

    def _smart_merge(self, v: int, w: int, old: int, new: int) -> int:
        """Edge-parity rules (module docstring table); returns merged type."""
        tv, tw = self._types[v], self._types[w]
        spiders = {VertexType.Z, VertexType.X}
        if tv not in spiders or tw not in spiders:
            return old | new  # boundaries / H-boxes: just record both
        same = tv == tw
        merged = 0
        for t, cancels in (
            (EdgeType.SIMPLE, not same),  # simple pair: Hopf iff bicolour
            (EdgeType.HADAMARD, same),  # hadamard pair: Hopf iff unicolour
        ):
            n = int(bool(old & t)) + int(bool(new & t))
            if n == 2:
                if cancels:
                    self.scalar.add_power(-2)  # cancelled pair leaves 1/2
                else:
                    merged |= t  # idempotent pair merges to one edge
            elif n == 1:
                merged |= t
        return merged

    def add_edges(self, edges: Any, edgetype: int = EdgeType.SIMPLE) -> None:
        for e in edges:
            self.add_edge(e, edgetype)

    def add_edge_table(self, etab: Dict[Tuple[int, int], List[int]]) -> None:
        """Apply an edge-count table {(v,w): [n_simple, n_hadamard]}."""
        for (v, w), (ns, nh) in etab.items():
            for _ in range(ns):
                self.add_edge((v, w), EdgeType.SIMPLE)
            for _ in range(nh):
                self.add_edge((v, w), EdgeType.HADAMARD)

    def remove_edge(self, edge: Tuple[int, int]) -> None:
        v, w = edge
        self._adj[v].pop(w, None)
        self._adj[w].pop(v, None)

    def remove_edges(self, edges: Any) -> None:
        for e in list(edges):
            self.remove_edge(e)

    def edge(self, v: int, w: int) -> Tuple[int, int]:
        """Canonical edge handle for the (v, w) pair."""
        return (v, w) if v <= w else (w, v)

    def edge_st(self, edge: Tuple[int, int]) -> Tuple[int, int]:
        return edge

    def edge_s(self, edge: Tuple[int, int]) -> int:
        return edge[0]

    def edge_t(self, edge: Tuple[int, int]) -> int:
        return edge[1]

    def connected(self, v: int, w: int) -> bool:
        return w in self._adj[v]

    def edge_type(self, e: Tuple[int, int]) -> int:
        v, w = e
        return self._adj[v].get(w, 0)

    def set_edge_type(self, e: Tuple[int, int], t: int) -> None:
        v, w = e
        if w in self._adj[v]:
            self._adj[v][w] = self._adj[w][v] = t

    def edges(self, s: Optional[int] = None, t: Optional[int] = None) -> Any:
        if s is not None and t is not None:
            return self.edge(s, t)
        if s is not None:
            return [self.edge(s, w) for w in self._adj[s]]
        return [(v, w) for v in self._adj for w in self._adj[v] if v < w]

    def edge_set(self) -> Set[Tuple[int, int]]:
        return set(self.edges())

    def num_edges(self) -> int:
        return len(self.edges())

    def incident_edges(self, v: int) -> Any:
        return [self.edge(v, w) for w in self._adj[v]]

    # -- config --------------------------------------------------------

    def get_auto_simplify(self) -> bool:
        return self._auto_simplify

    def set_auto_simplify(self, b: bool) -> None:
        self._auto_simplify = b

    def is_multigraph(self) -> bool:
        return False

    # -- whole-graph ops ----------------------------------------------

    def copy(self) -> "GraphS":
        g = GraphS()
        g._adj = {v: dict(nbrs) for v, nbrs in self._adj.items()}
        g._types = dict(self._types)
        g._phases = dict(self._phases)
        g._qubits = dict(self._qubits)
        g._rows = dict(self._rows)
        g._grounds = set(self._grounds)
        g._vdata = {v: dict(d) for v, d in self._vdata.items()}
        g._params = {v: set(s) for v, s in self._params.items()}
        g._inputs, g._outputs = self._inputs, self._outputs
        g._next = self._next
        g.scalar = self.scalar.copy()
        g.track_phases = self.track_phases
        g.merge_vdata = self.merge_vdata
        g._auto_simplify = self._auto_simplify
        g._phaseVars = set(self._phaseVars)
        return g

    def to_tensor(self) -> Any:
        """Dense semantics; open indices ordered [outputs..., inputs...].

        Z spider tensor: 1 at all-zeros, e^(i*pi*phase) at all-ones.
        X spiders are hadamard-conjugated Z spiders; H-boxes put
        e^(i*pi*phase) (default -1) at all-ones and 1 elsewhere.
        Small graphs only (everything is contracted densely).
        """
        import opt_einsum as oe

        sym: Dict[Any, str] = {}

        def idx(key: Any) -> str:
            if key not in sym:
                sym[key] = oe.get_symbol(len(sym))
            return sym[key]

        operands: List[Any] = []
        subscripts: List[str] = []
        # pre-pass: one index per (edge, part, endpoint-view); H edges get two
        # indices joined by an H matrix so each endpoint sees its own leg
        leg_of: Dict[Tuple[int, Tuple[int, int], int], str] = {}
        for a, b in self.edges():
            t = self._adj[a][b]
            for part, et in ((0, EdgeType.SIMPLE), (1, EdgeType.HADAMARD)):
                if not (t & et):
                    continue
                if et == EdgeType.SIMPLE:
                    i = idx(("e", (a, b), part))
                    leg_of[(a, (a, b), part)] = i
                    leg_of[(b, (a, b), part)] = i
                else:
                    ia, ib = idx(("e", (a, b), part, "l")), idx(("e", (a, b), part, "r"))
                    leg_of[(a, (a, b), part)] = ia
                    leg_of[(b, (a, b), part)] = ib
                    operands.append(_H)
                    subscripts.append(ia + ib)

        def vertex_legs(v: int) -> List[str]:
            legs = []
            for w, t in self._adj[v].items():
                e = self.edge(v, w)
                for part, et in ((0, EdgeType.SIMPLE), (1, EdgeType.HADAMARD)):
                    if t & et:
                        legs.append(leg_of[(v, e, part)])
            return legs

        ground_vec = np.array([1.0, 1.0])
        for v in self._adj:
            ty = self._types[v]
            legs = vertex_legs(v)
            if ty == VertexType.BOUNDARY:
                if len(legs) == 1:
                    continue  # open leg: emitted in the output ordering below
                if len(legs) == 2:  # pass-through wire
                    operands.append(np.eye(2))
                    subscripts.append(legs[0] + legs[1])
                    continue
                raise ValueError(f"boundary vertex {v} with degree {len(legs)}")
            k = len(legs)
            ph = cmath.exp(1j * math.pi * float(self._phases[v]))
            if ty in (VertexType.Z, VertexType.X):
                if k == 0:
                    self_val = 1.0 + ph  # degree-0 spider is a scalar
                    operands.append(np.asarray(self_val))
                    subscripts.append("")
                    continue
                kk = k + 1 if self.is_ground(v) else k  # ground: virtual leg
                t_arr = np.zeros((2,) * kk, dtype=complex)
                t_arr[(0,) * kk] = 1.0
                t_arr[(1,) * kk] = ph
                if ty == VertexType.X:
                    for _ax in range(kk):
                        # conjugate every leg by H (cyclic tensordot keeps order)
                        t_arr = np.tensordot(t_arr, _H, axes=([0], [0]))
                if self.is_ground(v):
                    # discard: sum the spider's virtual leg (trace with ones)
                    t_arr = np.tensordot(t_arr, ground_vec, axes=([kk - 1], [0]))
            elif ty == VertexType.H_BOX:
                t_arr = np.ones((2,) * k, dtype=complex)
                t_arr[(1,) * k] = ph if float(self._phases[v]) != 0 else -1.0
            else:
                raise ValueError(f"unknown vertex type {ty}")
            operands.append(t_arr)
            subscripts.append("".join(legs))
        out_legs = []
        for v in list(self._outputs) + list(self._inputs):
            nbrs = self._adj[v]
            if len(nbrs) != 1:
                raise ValueError(f"boundary {v} must have exactly one edge")
            ((w, t),) = nbrs.items()
            part = 0 if t & EdgeType.SIMPLE else 1
            out_legs.append(leg_of[(v, self.edge(v, w), part)])
        eq = ",".join(subscripts) + "->" + "".join(out_legs)
        result = oe.contract(eq, *operands)
        return np.asarray(result) * self.scalar.to_number()
