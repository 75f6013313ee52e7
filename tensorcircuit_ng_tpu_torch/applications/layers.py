"""Parameterized circuit-layer generators (reference ``applications/layers.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

__all__ = [
    "rx_layer",
    "ry_layer",
    "rz_layer",
    "zz_layer",
    "xx_layer",
    "yy_layer",
    "cnot_ring",
    "cz_ring",
    "entangler_layer",
]


def rx_layer(c: Any, params: Any) -> Any:
    for i in range(c.nqubits):
        c.rx(i, theta=params[i])
    return c


def ry_layer(c: Any, params: Any) -> Any:
    for i in range(c.nqubits):
        c.ry(i, theta=params[i])
    return c


def rz_layer(c: Any, params: Any) -> Any:
    for i in range(c.nqubits):
        c.rz(i, theta=params[i])
    return c


def _bond_layer(c: Any, params: Any, g: Optional[Any], gate: str) -> Any:
    n = c.nqubits
    if g is None:
        bonds = [(i, i + 1) for i in range(n - 1)]
    else:
        bonds = list(g.edges) if hasattr(g, "edges") else list(g)
    for k, (a, b) in enumerate(bonds):
        theta = params[k] if hasattr(params, "__len__") or getattr(params, "ndim", 0) else params
        getattr(c, gate)(a, b, theta=theta)
    return c


def zz_layer(c: Any, params: Any, g: Optional[Any] = None) -> Any:
    return _bond_layer(c, params, g, "rzz")


def xx_layer(c: Any, params: Any, g: Optional[Any] = None) -> Any:
    return _bond_layer(c, params, g, "rxx")


def yy_layer(c: Any, params: Any, g: Optional[Any] = None) -> Any:
    return _bond_layer(c, params, g, "ryy")


def cnot_ring(c: Any) -> Any:
    n = c.nqubits
    for i in range(n):
        c.cnot(i, (i + 1) % n)
    return c


def cz_ring(c: Any) -> Any:
    n = c.nqubits
    for i in range(n):
        c.cz(i, (i + 1) % n)
    return c


def entangler_layer(c: Any, params: Any) -> Any:
    """ry-rz + cnot ladder entangling layer."""
    n = c.nqubits
    for i in range(n):
        c.ry(i, theta=params[0, i])
        c.rz(i, theta=params[1, i])
    for i in range(n - 1):
        c.cnot(i, i + 1)
    return c


# ======================================================================
# reference-parity layer generators (applications/layers.py:53-380)
# ======================================================================

import sys as _sys
import itertools as _itertools

_thismodule = _sys.modules[__name__]

#: structural (parameter-free) gate names
_SGATES = ["h", "i", "x", "y", "z", "cnot", "cz", "swap"]


def _resolve(symbol: Any, i: int = 0) -> Any:
    """Pick entry i from list/1D-tensor symbols; pass scalars through."""
    if isinstance(symbol, (list, tuple)):
        return symbol[i]
    if getattr(symbol, "ndim", 0) == 1:
        return symbol[i]
    return symbol


def _edge_weight(g: Any, e: Any) -> float:
    try:
        return g[e[0]][e[1]].get("weight", 1.0)
    except Exception:
        return 1.0


def _complete_graph(n: int) -> Any:
    import networkx as nx

    return nx.complete_graph(n)


def generate_double_gate(gates: str) -> None:
    """Register ``{gates}gate(circuit, q1, q2, theta)``: exp(-i θ σ_a σ_b / 2)-style
    two-Pauli rotation via basis change + CNOT-rz-CNOT (reference :53)."""
    d1, d2 = gates[0], gates[1]

    def f(circuit: Any, qubit1: int, qubit2: int, symbol: Any) -> Any:
        if d1 == "x":
            circuit.h(qubit1)
        elif d1 == "y":
            circuit.rx(qubit1, theta=-np.pi / 2)
        if d2 == "x":
            circuit.h(qubit2)
        elif d2 == "y":
            circuit.rx(qubit2, theta=-np.pi / 2)
        circuit.cnot(qubit1, qubit2)
        circuit.rz(qubit2, theta=symbol)
        circuit.cnot(qubit1, qubit2)
        if d1 == "x":
            circuit.h(qubit1)
        elif d1 == "y":
            circuit.rx(qubit1, theta=np.pi / 2)
        if d2 == "x":
            circuit.h(qubit2)
        elif d2 == "y":
            circuit.rx(qubit2, theta=np.pi / 2)
        return circuit

    f.__doc__ = "%sgate" % gates
    setattr(_thismodule, gates + "gate", f)


def generate_gate_layer(gate: str) -> None:
    """Register ``{gate}layer(circuit, symbol, g)``: shared-angle wall (ref :86)."""

    def f(circuit: Any, symbol: Any = None, g: Any = None) -> Any:
        if gate.lower() in _SGATES:
            for n in range(circuit._nqubits):
                getattr(circuit, gate.lower())(n)
        else:
            s0 = _resolve(symbol)
            for n in range(circuit._nqubits):
                getattr(circuit, gate.lower())(n, theta=2 * s0)
        return circuit

    f.__doc__ = "%slayer" % gate
    f.__trainable__ = gate.lower() not in _SGATES
    setattr(_thismodule, gate + "layer", f)


def generate_any_gate_layer(gate: str) -> None:
    """Register ``any{gate}layer``: per-qubit angles (reference :112)."""

    def f(circuit: Any, symbol: Any = None, g: Any = None) -> Any:
        if gate.lower() in _SGATES:
            for n in range(circuit._nqubits):
                getattr(circuit, gate.lower())(n)
        else:
            for n in range(circuit._nqubits):
                getattr(circuit, gate.lower())(n, theta=2 * symbol[n])
        return circuit

    f.__doc__ = "any%slayer" % gate
    f.__trainable__ = gate.lower() not in _SGATES
    setattr(_thismodule, "any" + gate + "layer", f)


def generate_any_double_gate_layer(gates: str) -> None:
    """Register ``any{gates}layer``: per-edge angles over graph g (ref :138)."""

    def f(circuit: Any, symbol: Any, g: Any = None) -> Any:
        if g is None:
            g = _complete_graph(circuit._nqubits)
        for i, e in enumerate(g.edges):
            getattr(_thismodule, gates + "gate")(
                circuit, e[0], e[1], -symbol[i] * _edge_weight(g, e) * 2
            )
        return circuit

    f.__doc__ = "any%slayer" % gates
    f.__trainable__ = True
    setattr(_thismodule, "any" + gates + "layer", f)


def generate_double_gate_layer(gates: str) -> None:
    """Register ``{gates}layer``: shared angle over graph edges (ref :158)."""

    def f(circuit: Any, symbol: Any, g: Any = None) -> Any:
        s0 = _resolve(symbol)
        if g is None:
            g = _complete_graph(circuit._nqubits)
        for e in g.edges:
            getattr(_thismodule, gates + "gate")(
                circuit, e[0], e[1], -s0 * _edge_weight(g, e) * 2
            )
        return circuit

    f.__doc__ = "%slayer" % gates
    f.__trainable__ = True
    setattr(_thismodule, gates + "layer", f)


def generate_double_gate_layer_bitflip(gates: str) -> None:
    """Register ``{gates}layer_bitflip``: exact channel after each edge (ref :176)."""
    from ..ops.channels import depolarizingchannel

    def f(circuit: Any, symbol: Any, g: Any, *params: float) -> Any:
        s0 = _resolve(symbol)
        for e in g.edges:
            getattr(_thismodule, gates + "gate")(
                circuit, e[0], e[1], -s0 * _edge_weight(g, e) * 2
            )
            circuit.apply_general_kraus(depolarizingchannel(*params[:3]), e[0])
            circuit.apply_general_kraus(depolarizingchannel(*params[:3]), e[1])
        return circuit

    f.__doc__ = "%slayer_bitflip" % gates
    f.__trainable__ = True
    setattr(_thismodule, gates + "layer_bitflip", f)


def generate_double_gate_layer_bitflip_mc(gates: str) -> None:
    """Register ``{gates}layer_bitflip_mc``: MC depolarizing after edges (ref :205)."""

    def f(circuit: Any, symbol: Any, g: Any, *params: float) -> Any:
        s0 = _resolve(symbol)
        for e in g.edges:
            getattr(_thismodule, gates + "gate")(
                circuit, e[0], e[1], -s0 * _edge_weight(g, e) * 2
            )
            circuit.depolarizing(e[0], px=params[0], py=params[1], pz=params[2])
            circuit.depolarizing(e[1], px=params[0], py=params[1], pz=params[2])
        return circuit

    f.__doc__ = "%slayer_bitflip_mc" % gates
    f.__trainable__ = True
    setattr(_thismodule, gates + "layer_bitflip_mc", f)


def generate_any_double_gate_layer_bitflip_mc(gates: str) -> None:
    def f(circuit: Any, symbol: Any, g: Any = None, *params: float) -> Any:
        if g is None:
            g = _complete_graph(circuit._nqubits)
        for i, e in enumerate(g.edges):
            getattr(_thismodule, gates + "gate")(
                circuit, e[0], e[1], -symbol[i] * _edge_weight(g, e) * 2
            )
            circuit.depolarizing(e[0], px=params[0], py=params[1], pz=params[2])
            circuit.depolarizing(e[1], px=params[0], py=params[1], pz=params[2])
        return circuit

    f.__doc__ = "any%slayer_bitflip_mc" % gates
    f.__trainable__ = True
    setattr(_thismodule, "any" + gates + "layer_bitflip_mc", f)


def generate_double_layer_block(gates: Any) -> None:
    """Register ``{d1}_{d2}_block``: two stacked layers sharing symbol[0:2] (ref :272)."""
    d1, d2 = gates[0], gates[1]

    def f(circuit: Any, symbol: Any, g: Any = None) -> Any:
        if g is None:
            g = _complete_graph(circuit._nqubits)
        getattr(_thismodule, d1 + "layer")(circuit, symbol[0], g)
        getattr(_thismodule, d2 + "layer")(circuit, symbol[1], g)
        return circuit

    f.__doc__ = "%s_%s_block" % (d1, d2)
    f.__trainable__ = not (d1.lower() in _SGATES and d2.lower() in _SGATES)
    setattr(_thismodule, "%s_%s_block" % (d1, d2), f)


def anyswaplayer(circuit: Any, symbol: Any, g: Any) -> Any:
    """Per-edge exp1(SWAP, θ_i·w_i) layer (reference :318)."""
    swap = np.eye(4)[[0, 2, 1, 3]]
    for i, e in enumerate(g.edges):
        circuit.exp1(e[0], e[1], unitary=swap, theta=symbol[i] * _edge_weight(g, e))
    return circuit


def anyswaplayer_bitflip_mc(
    circuit: Any, symbol: Any, g: Any, px: float, py: float, pz: float
) -> Any:
    swap = np.eye(4)[[0, 2, 1, 3]]
    for i, e in enumerate(g.edges):
        circuit.exp1(e[0], e[1], unitary=swap, theta=symbol[i] * _edge_weight(g, e))
        circuit.depolarizing(e[0], px=px, py=py, pz=pz)
        circuit.depolarizing(e[1], px=px, py=py, pz=pz)
    return circuit


def bitfliplayer(ci: Any, g: Any, px: float, py: float, pz: float) -> None:
    """Exact depolarizing on every node (DMCircuit; reference :364)."""
    from ..ops.channels import depolarizingchannel

    for i in range(len(g.nodes)):
        ci.apply_general_kraus(depolarizingchannel(px, py, pz), i)


def bitfliplayer_mc(ci: Any, g: Any, px: float, py: float, pz: float) -> None:
    """MC depolarizing on every node (Circuit; reference :372)."""
    for i in range(len(g.nodes)):
        ci.depolarizing(i, px=px, py=py, pz=pz)


def generate_qubits(g: Any) -> List[Any]:
    """Sorted qubit payloads of a graph's nodes (reference :382)."""
    return sorted([v for _, v in g.nodes.data("qubit")])


from typing import List  # noqa: E402

for _gate in ["rx", "ry", "rz", "H", "I"]:
    generate_gate_layer(_gate)
    generate_any_gate_layer(_gate)

for _pair in _itertools.product("xyz", repeat=2):
    _gs = _pair[0] + _pair[1]
    generate_double_gate(_gs)
    generate_double_gate_layer(_gs)
    generate_any_double_gate_layer(_gs)
    generate_double_gate_layer_bitflip(_gs)
    generate_double_gate_layer_bitflip_mc(_gs)
    generate_any_double_gate_layer_bitflip_mc(_gs)

for _pair in _itertools.product(["rx", "ry", "rz", "xx", "yy", "zz"], repeat=2):
    generate_double_layer_block(_pair)
