"""Quantum error mitigation methods: ZNE, DD, randomized compiling.

Self-contained counterparts of reference ``results/qem/qem_methods.py``
(which wraps mitiq, ``:18-27, 36-78, 145-247, 320-373``):

- **ZNE**: unitary folding (global or random per-gate) scales the effective
  noise, a Factory extrapolates expectation values back to zero noise.
- **DD**: the circuit is scheduled into moments (greedy ASAP); idle windows
  on used qubits are filled with a decoupling sequence (XX / XYXY / custom).
- **RC**: every two-qubit Clifford gate is Pauli-twirled with a random
  sandwich from its invariance group; results averaged over samples.

All functions take OUR circuits directly (no qiskit round trip) and any
``executor: Circuit -> float | counts-dict``.
"""

from __future__ import annotations

import collections
import functools
import operator
from itertools import product
from random import choice
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Tensor = Any

__all__ = [
    "apply_zne",
    "apply_dd",
    "apply_rc",
    "zne_option",
    "dd_option",
    "used_qubits",
    "prune_ddcircuit",
    "add_dd",
    "rc_circuit",
    "rc_candidates",
    "fold_gates_at_random",
    "fold_global",
    "LinearFactory",
    "RichardsonFactory",
    "PolyFactory",
    "ExpFactory",
]


def _host(t: Any) -> np.ndarray:
    """A gate operand as a host array (a tensor detached and copied)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().resolve_conj().numpy()
    return np.asarray(t)


def _like(c: Any) -> Any:
    """An empty circuit of ``c``'s class, width and device."""
    return type(c)(c._nqubits, device=c.device)


def _copy_items(qir: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [dict(item) for item in qir]


def _dagger_item(item: Dict[str, Any]) -> Dict[str, Any]:
    """QIR item of the adjoint gate (matrix conjugate-transpose)."""
    t = _host(item["gate"].tensor)
    dim = int(round(np.sqrt(t.size)))
    m = t.reshape(dim, dim).conj().T
    from ...ops.gates import Gate

    return {
        "gatef": None,
        "gate": Gate(m, name=(item.get("name") or "any") + "d"),
        "index": item["index"],
        "name": (item.get("name") or "any") + "d",
        "split": None,
        "mpo": False,
    }


# ---------------------------------------------------------------------------
# ZNE: folding + extrapolation factories
# ---------------------------------------------------------------------------


class LinearFactory:
    """Fit E(s) = a + b s; zero-noise value = a (mitiq-compatible role)."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 3.0)):
        self.scale_factors = list(scale_factors)

    def extrapolate(self, scales: Sequence[float], values: Sequence[float]) -> float:
        coef = np.polyfit(np.asarray(scales, dtype=float), np.asarray(values, dtype=float), 1)
        return float(np.polyval(coef, 0.0))


class PolyFactory:
    def __init__(self, scale_factors: Sequence[float] = (1.0, 2.0, 3.0), order: int = 2):
        self.scale_factors = list(scale_factors)
        self.order = order

    def extrapolate(self, scales: Sequence[float], values: Sequence[float]) -> float:
        coef = np.polyfit(
            np.asarray(scales, dtype=float), np.asarray(values, dtype=float), self.order
        )
        return float(np.polyval(coef, 0.0))


class RichardsonFactory(PolyFactory):
    """Richardson extrapolation = exact-degree polynomial through all points."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 3.0, 5.0)):
        super().__init__(scale_factors, order=len(list(scale_factors)) - 1)


class ExpFactory:
    """Fit E(s) = a + b exp(-c s) via log-linear fallback."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 2.0, 3.0), asymptote: float = 0.0):
        self.scale_factors = list(scale_factors)
        self.asymptote = asymptote

    def extrapolate(self, scales: Sequence[float], values: Sequence[float]) -> float:
        s = np.asarray(scales, dtype=float)
        v = np.asarray(values, dtype=float) - self.asymptote
        sign = np.sign(v[0]) or 1.0
        v = np.maximum(np.abs(v), 1e-12)
        coef = np.polyfit(s, np.log(v), 1)
        return float(self.asymptote + sign * np.exp(np.polyval(coef, 0.0)))


def fold_global(circuit: Any, scale: float) -> Any:
    """Global unitary folding C -> C (C† C)^k with k=(scale-1)/2 (+ partial).

    The mitiq ``fold_global`` role: effective noise scales ~linearly with
    the gate count while the ideal unitary is unchanged.
    """
    qir = list(circuit.to_qir())
    k_full = int((scale - 1) / 2)
    frac = (scale - 1) / 2 - k_full
    out = _like(circuit)
    out.append_from_qir(_copy_items(qir))
    for _ in range(k_full):
        for item in reversed(qir):
            out._apply_qir_item(_dagger_item(item))
        out.append_from_qir(_copy_items(qir))
    if frac > 1e-9:
        m = int(round(frac * len(qir)))
        tail = qir[len(qir) - m :]
        for item in reversed(tail):
            out._apply_qir_item(_dagger_item(item))
        out.append_from_qir(_copy_items(tail))
    return out


def fold_gates_at_random(circuit: Any, scale: float, seed: Optional[int] = None) -> Any:
    """Per-gate folding g -> g g† g on a random gate subset (mitiq role)."""
    rng = np.random.default_rng(seed)
    qir = list(circuit.to_qir())
    k_full = int((scale - 1) / 2)
    frac = (scale - 1) / 2 - k_full
    mask = rng.random(len(qir)) < frac
    out = _like(circuit)
    for i, item in enumerate(qir):
        out._apply_qir_item(dict(item))
        reps = k_full + (1 if mask[i] else 0)
        for _ in range(reps):
            out._apply_qir_item(_dagger_item(item))
            out._apply_qir_item(dict(item))
    return out


def apply_zne(
    circuit: Any,
    executor: Callable[[Any], Any],
    factory: Optional[Any] = None,
    scale_noise: Optional[Callable[[Any, float], Any]] = None,
    num_to_average: int = 1,
    **kws: Any,
) -> float:
    """Zero-noise extrapolation (reference ``apply_zne`` ``qem_methods.py:36``).

    Runs ``executor`` on noise-scaled versions of ``circuit`` and
    extrapolates to the zero-noise limit with ``factory``.
    """
    if factory is None:
        factory = RichardsonFactory((1.0, 3.0, 5.0))
    if scale_noise is None:
        scale_noise = fold_gates_at_random
    scales = list(factory.scale_factors)
    values = []
    for s in scales:
        acc = 0.0
        for _ in range(num_to_average):
            acc += float(np.real(executor(scale_noise(circuit, s))))
        values.append(acc / num_to_average)
    return float(factory.extrapolate(scales, values))


#: mitiq-compat namespaces (reference exposes ``zne_option``/``dd_option``)
class _ZneNS:
    class scaling:
        fold_global = staticmethod(fold_global)
        fold_gates_at_random = staticmethod(fold_gates_at_random)

    LinearFactory = LinearFactory
    RichardsonFactory = RichardsonFactory
    PolyFactory = PolyFactory
    ExpFactory = ExpFactory


zne_option = _ZneNS


# ---------------------------------------------------------------------------
# DD: moment scheduling + sequence insertion
# ---------------------------------------------------------------------------


def used_qubits(c: Any) -> List[int]:
    """Qubits touched by at least one gate (reference ``used_qubits``)."""
    qlist: List[int] = []
    for d in c.to_qir():
        for i in d["index"]:
            if i not in qlist:
                qlist.append(i)
    return qlist


def _moments(qir: List[Dict[str, Any]], n: int) -> List[List[Optional[Dict[str, Any]]]]:
    """Greedy ASAP schedule: list of moments, each slot q holds an item or None."""
    frontier = [0] * n
    moments: List[List[Optional[Dict[str, Any]]]] = []
    for item in qir:
        idx = list(item["index"])
        t = max(frontier[q] for q in idx)
        while len(moments) <= t:
            moments.append([None] * n)
        moments[t][idx[0]] = item
        for q in idx[1:]:
            moments[t][q] = {"_occupied": True}
        for q in idx:
            frontier[q] = t + 1
    return moments


def add_dd(c: Any, rule: Callable[[int], List[str]]) -> Any:
    """Insert DD sequences into idle windows (reference ``add_dd`` via mitiq).

    ``rule(slack_length)`` returns the gate-name sequence for a window of
    that many idle moments ([] to leave it idle).
    """
    n = c._nqubits
    qir = list(c.to_qir())
    moments = _moments(qir, n)
    T = len(moments)
    # active span per qubit
    first = [T] * n
    last = [-1] * n
    for t, mom in enumerate(moments):
        for q in range(n):
            if mom[q] is not None:
                first[q] = min(first[q], t)
                last[q] = max(last[q], t)
    # collect idle windows inside each qubit's active span, fill via rule
    inserts: Dict[Tuple[int, int], List[str]] = {}
    for q in range(n):
        t = 0
        while t < T:
            if moments[t][q] is None and first[q] <= t <= last[q]:
                t0 = t
                while t < T and moments[t][q] is None and t <= last[q]:
                    t += 1
                seq = list(rule(t - t0))
                for k, gname in enumerate(seq[: t - t0]):
                    inserts[(t0 + k, q)] = [gname]
            else:
                t += 1
    out = _like(c)
    for t, mom in enumerate(moments):
        for q in range(n):
            for gname in inserts.get((t, q), ()):  # DD gates first in the moment
                getattr(out, gname.lower())(q)
        for q in range(n):
            item = mom[q]
            if item is not None and "_occupied" not in item:
                out._apply_qir_item(dict(item))
    return out


def prune_ddcircuit(c: Any, qlist: List[int]) -> Any:
    """Drop identity gates and DD gates on qubits outside ``qlist``."""
    qir = c.to_qir()
    cnew = _like(c)
    for d in qir:
        if d["index"][0] not in qlist:
            continue
        t = _host(d["gate"].tensor)
        dim = int(round(np.sqrt(t.size)))
        if np.sum(np.abs(np.eye(dim) - t.reshape(dim, dim))) <= 1e-4:
            continue
        cnew._apply_qir_item(dict(d))
    return cnew


def _xx_rule(slack_length: int) -> List[str]:
    return ["x", "x"] if slack_length >= 2 else []


def _xyxy_rule(slack_length: int) -> List[str]:
    return ["x", "y", "x", "y"] if slack_length >= 4 else _xx_rule(slack_length)


class _DDNS:
    class rules:
        xx = staticmethod(_xx_rule)
        xyxy = staticmethod(_xyxy_rule)

        @staticmethod
        def general_rule(slack_length: int, gates: Sequence[str], spacing: int = -1) -> List[str]:
            seq = [str(g) for g in gates]
            return seq if slack_length >= len(seq) else []


dd_option = _DDNS


def apply_dd(
    circuit: Any,
    executor: Callable[[Any], Any],
    rule: Union[Callable[[int], List[str]], List[str]],
    rule_args: Optional[Dict[str, Any]] = None,
    num_trials: int = 1,
    full_output: bool = False,
    ignore_idle_qubit: bool = True,
    fulldd: bool = False,
    iscount: bool = False,
) -> Any:
    """Dynamical decoupling mitigation (reference ``apply_dd``)."""
    if rule_args is None:
        rule_args = {}
    if isinstance(rule, list):
        names = [r.lower() for r in rule]
        rule_fn: Callable[[int], List[str]] = lambda slack, _names=names: (
            list(_names) if slack >= len(_names) else []
        )
    else:
        rule_fn = functools.partial(rule, **rule_args) if rule_args else rule

    qlist = used_qubits(circuit) if ignore_idle_qubit else list(range(circuit._nqubits))
    c2 = circuit
    c3 = prune_ddcircuit(add_dd(c2, rule_fn), qlist)
    if fulldd:
        for _ in range(8):
            if len(c3.to_qir()) == len(c2.to_qir()):
                break
            c2 = c3
            c3 = prune_ddcircuit(add_dd(c2, rule_fn), qlist)

    exp = [executor(c3) for _ in range(num_trials)]
    if iscount:
        summed = dict(functools.reduce(operator.add, map(collections.Counter, exp)))
        result: Any = {k: v / num_trials for k, v in summed.items()}
    else:
        result = float(np.mean([float(np.real(e)) for e in exp]))
    if full_output:
        return [result, c3]
    return result


# ---------------------------------------------------------------------------
# RC: Pauli twirling of two-qubit gates
# ---------------------------------------------------------------------------

_PAULIS = [
    np.eye(2, dtype=complex),
    np.array([[0, 1], [1, 0]], dtype=complex),
    np.array([[0, -1j], [1j, 0]], dtype=complex),
    np.array([[1, 0], [0, -1]], dtype=complex),
]

candidate_dict: Dict[str, List[Tuple[int, int, int, int]]] = {}


def rc_candidates(gate: Any) -> List[Tuple[int, int, int, int]]:
    """Pauli sandwiches (a,b,c,d) with (Pa⊗Pb) G (Pc⊗Pd) = ±G (reference ``:249``)."""
    t = _host(getattr(gate, "tensor", gate))
    dim = int(round(np.sqrt(t.size)))
    gatem = t.reshape(dim, dim)
    r = []
    for combo in product(range(4), repeat=4):
        m = (
            np.kron(_PAULIS[combo[0]], _PAULIS[combo[1]])
            @ gatem
            @ np.kron(_PAULIS[combo[2]], _PAULIS[combo[3]])
        )
        if np.allclose(m, gatem, atol=1e-4) or np.allclose(m, -gatem, atol=1e-4):
            r.append(combo)
    return r


def _apply_pauli(c: Any, i: int, q: int) -> None:
    if i == 1:
        c.x(q)
    elif i == 2:
        c.y(q)
    elif i == 3:
        c.z(q)


def rc_circuit(c: Any) -> Any:
    """One random twirl of every 2-qubit gate (reference ``rc_circuit``)."""
    qir = c.to_qir()
    cnew = _like(c)
    for d in qir:
        if len(d["index"]) == 2:
            name = d.get("name") or "any"
            if name in candidate_dict:
                cand = candidate_dict[name]
            else:
                cand = rc_candidates(d["gate"])
                candidate_dict[name] = cand
            a, b, cc, dd = choice(cand)
            _apply_pauli(cnew, a, d["index"][0])
            _apply_pauli(cnew, b, d["index"][1])
            cnew._apply_qir_item(dict(d))
            _apply_pauli(cnew, cc, d["index"][0])
            _apply_pauli(cnew, dd, d["index"][1])
        else:
            cnew._apply_qir_item(dict(d))
    return cnew


def apply_rc(
    circuit: Any,
    executor: Callable[[Any], Any],
    num_to_average: int = 1,
    simplify: bool = True,
    iscount: bool = False,
    **kws: Any,
) -> Tuple[Any, List[Any]]:
    """Randomized compiling / Pauli twirling (reference ``apply_rc``):
    the mean of ``executor`` over ``num_to_average`` twirled circuits, each
    simplified by ``compiler.simple_compile`` unless ``simplify=False``."""
    exp = []
    circuits = []
    for _ in range(num_to_average):
        c1 = rc_circuit(circuit)
        if simplify:
            from ...compiler.simple_compiler import simple_compile

            c1, _ = simple_compile(c1)
        exp.append(executor(c1))
        circuits.append(c1)
    if iscount:
        summed = dict(functools.reduce(operator.add, map(collections.Counter, exp)))
        result: Any = {k: v / num_to_average for k, v in summed.items()}
    else:
        result = float(np.mean([float(np.real(e)) for e in exp]))
    return result, circuits
