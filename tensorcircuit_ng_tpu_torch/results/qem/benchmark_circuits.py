"""Chip-benchmark circuits with known ideal distributions.

Self-contained counterpart of reference ``results/qem/benchmark_circuits.py``
(which generates via mitiq + qiskit round trips, ``:12-24``): GHZ, W-state
(linear-depth construction, arXiv:1807.05572), 1-qubit randomized
benchmarking, mirror circuits (arXiv:2008.11294), and the internal QAOA
harness.  Each returns ``(circuit, ideal_counts_dict)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ghz_circuit", "w_circuit", "rb_circuit", "mirror_circuit", "QAOA_circuit"]


def _circuit(n: int) -> Any:
    from ...models.circuit import Circuit

    return Circuit(n)


def ghz_circuit(num_qubits: int) -> Tuple[Any, Dict[str, float]]:
    c = _circuit(num_qubits)
    c.h(0)
    for i in range(num_qubits - 1):
        c.cnot(i, i + 1)
    ideal = {"0" * num_qubits: 0.5, "1" * num_qubits: 0.5}
    return c, ideal


def w_circuit(num_qubits: int) -> Tuple[Any, Dict[str, float]]:
    """Linear-complexity W state (arXiv:1807.05572): F gates + CNOT ladder."""
    n = num_qubits
    c = _circuit(n)
    c.x(0)
    for i in range(n - 1):
        # F(p) block: controlled rotation moving amplitude down the register
        p = 1.0 / (n - i)
        theta = math.acos(math.sqrt(p))
        c.ry(i + 1, theta=-theta)
        c.cz(i, i + 1)
        c.ry(i + 1, theta=theta)
        c.cnot(i + 1, i)
    ideal = {}
    for i in range(n):
        ideal["0" * i + "1" + "0" * (n - i - 1)] = 1.0 / n
    return c, ideal


def rb_circuit(num_qubits: int, depth: int, seed: int = 0) -> Tuple[Any, Dict[str, float]]:
    """Single-qubit randomized benchmarking: random Cliffords + exact inverse.

    num_qubits limited to 1 (the reference's mitiq generator supports 1-2).
    """
    if num_qubits != 1:
        raise ValueError("rb_circuit supports num_qubits=1 (reference parity)")
    from ...ops import gates as G

    rng = np.random.default_rng(seed)
    names = ["h", "s", "sd", "x", "y", "z", "sx"]
    c = _circuit(1)
    total = np.eye(2, dtype=complex)
    for _ in range(depth):
        g = names[rng.integers(len(names))]
        getattr(c, g)(0)
        m = np.asarray(getattr(G, "GATES")[g]().matrix())
        total = m @ total
    c.any(0, unitary=total.conj().T)  # exact inverse
    ideal = {"0" * num_qubits: 1.0}
    return c, ideal


def mirror_circuit(
    depth: int,
    two_qubit_gate_prob: float,
    connectivity_graph: Any,
    seed: int,
    two_qubit_gate_name: str = "CNOT",
) -> Tuple[Any, Dict[str, float]]:
    """Mirror circuit (arXiv:2008.11294): random layers + inverse mirror.

    The ideal output is a single deterministic bitstring.
    """
    try:
        nodes = sorted(connectivity_graph.nodes)
        edges = [tuple(sorted(e)) for e in connectivity_graph.edges]
    except AttributeError:
        edges = [tuple(sorted(e)) for e in connectivity_graph]
        nodes = sorted({q for e in edges for q in e})
    n = len(nodes)
    rng = np.random.default_rng(seed)
    gate2 = two_qubit_gate_name.lower()
    if gate2 == "cnot":
        gate2 = "cnot"
    elif gate2 == "cz":
        gate2 = "cz"
    else:
        raise ValueError("two_qubit_gate_name must be CNOT or CZ")

    pauli_names = ["i", "x", "y", "z"]
    clifford1 = ["h", "s", "sd", "x", "y", "z", "sx"]

    layers: List[List[Tuple[str, Tuple[int, ...]]]] = []
    # initial random Pauli layer
    init_paulis = [pauli_names[rng.integers(4)] for _ in range(n)]
    for d in range(depth):
        layer: List[Tuple[str, Tuple[int, ...]]] = []
        used: set = set()
        for e in rng.permutation(len(edges)):
            a, b = edges[int(e)]
            if a in used or b in used:
                continue
            if rng.random() < two_qubit_gate_prob:
                layer.append((gate2, (a, b)))
                used.add(a)
                used.add(b)
        for q in range(n):
            if q not in used:
                layer.append((clifford1[rng.integers(len(clifford1))], (q,)))
        layers.append(layer)

    inv_map = {"h": "h", "s": "sd", "sd": "s", "x": "x", "y": "y", "z": "z",
               "sx": "sxd", "cnot": "cnot", "cz": "cz"}

    c = _circuit(n)
    for q, p in enumerate(init_paulis):
        if p != "i":
            getattr(c, p)(q)
    for layer in layers:
        for gname, idx in layer:
            getattr(c, gname)(*idx)
    # central random Pauli layer
    mid_paulis = [pauli_names[rng.integers(4)] for _ in range(n)]
    for q, p in enumerate(mid_paulis):
        if p != "i":
            getattr(c, p)(q)
    # mirror (inverse) layers
    for layer in reversed(layers):
        for gname, idx in reversed(layer):
            iname = inv_map[gname]
            if iname == "sxd":
                # sx† = H S† H (circuit order: h, sd, h)
                c.h(*idx)
                c.sd(*idx)
                c.h(*idx)
                continue
            getattr(c, iname)(*idx)
    for q, p in enumerate(init_paulis):
        if p != "i":
            getattr(c, p)(q)

    # the ideal bitstring: simulate with the stabilizer engine (Clifford only)
    # when sx† composition above is used, fall back to dense for exactness
    probs = np.abs(c.state().detach().cpu().numpy()) ** 2
    bit_idx = int(np.argmax(probs))
    ideal_bitstring = format(bit_idx, f"0{n}b")
    return c, {ideal_bitstring: 1.0}


def QAOA_circuit(
    graph: List[Tuple[int, int]], weight: List[float], params: Any
) -> Any:
    """QAOA harness (reference ``QAOA_circuit``; internal API)."""
    params = np.asarray(params)
    nlayers = params.shape[0]
    qlist = sorted({q for e in graph for q in e[:2]})
    n = max(qlist) + 1
    c = _circuit(n)
    for i in qlist:
        c.h(i)
    for i in range(nlayers):
        for e, (a, b) in enumerate([g[:2] for g in graph]):
            c.cnot(a, b)
            c.rz(b, theta=params[i, 0] * weight[e])
            c.cnot(a, b)
        for k in qlist:
            c.rx(k, theta=params[i, 1] * 2)
    return c
