"""Compiled sampling programs for stabilizer+T circuits with Pauli noise.

Counterpart of ``tensorcircuit_ng_tpu/zx/scalar_graph.py`` (tsim-derived).
Each "compiled scalar graph" is a closure over the port's dense engine
computing a conditional outcome probability: conditioned on an error
pattern ``f``, the outcome distribution is sampled EXACTLY by the chain
rule (no Monte-Carlo over measurement randomness), which is the tsim
algorithm's defining property.

The JAX package traces one shot and vmaps it over the batch.  Here a batch
of shots is one ``[batch, 2^n]`` complex64 state on the device
(:func:`_run_steps`): every gate, conditional Pauli, marginal and
projection acts on all rows at once (``torch.func.vmap`` of
``core.statevec``'s ``apply_unitary``, ``flip_slot``, ``sign_slot``,
``marginal_probability`` and ``project_slot``), so a component's
``sample_fn`` and its prefix graphs' ``eval_fn`` take a whole batch of
f-bits and uniforms (or outcome bits).  Above a memory budget the rows go
in chunks (``models.detectors.detector_chunk``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..core import statevec

Tensor = Any

__all__ = [
    "CompiledScalarGraphs",
    "CompiledComponent",
    "CompiledProgram",
    "compile_scalar_graphs",
    "compile_program",
    "find_stab",
    "find_stab_magic",
    "find_stab_u3",
]


@dataclass
class CompiledScalarGraphs:
    """One conditional-probability evaluator (a "scalar graph").

    ``eval_fn(params)`` takes a 0-1 matrix [batch, num_params] whose columns
    are (f-bits…, earlier outcomes…, 1) and returns the joint probability
    P(m_<i = given, m_i = 1 | f) of each row (float32, on the device)."""

    eval_fn: Callable[[Tensor], Tensor]
    num_params: int

    def eval(self, params: Tensor) -> Tensor:
        return self.eval_fn(params)


def compile_scalar_graphs(graphs: Sequence[CompiledScalarGraphs]) -> List[CompiledScalarGraphs]:
    """The scalar graphs as a list (their closures run as they are)."""
    return list(graphs)


@dataclass
class CompiledComponent:
    """Independent output block: scalar graphs + fused exact sampler."""

    compiled_scalar_graphs: List[CompiledScalarGraphs]
    f_selection: np.ndarray
    output_indices: List[int]
    sample_fn: Optional[Callable[..., Tensor]] = None


@dataclass
class CompiledProgram:
    """All components of a circuit plus global output ordering."""

    components: List[CompiledComponent]
    output_order: List[int]
    num_records: int = 0


# ----------------------------------------------------------------------
# the batched dense replay
# ----------------------------------------------------------------------

_H = np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2)
#: the rotation before a Y-basis measurement (S^dagger then H) and its
#: inverse after a Y-basis reset
_SDG_H = np.array([[1.0, -1.0j], [1.0, 1.0j]]) / math.sqrt(2)
_H_S = np.array([[1.0, 1.0], [1.0j, -1.0j]]) / math.sqrt(2)


def _rows(fn: Callable[..., Tensor], psi: Tensor, *per_row: Tensor) -> Tensor:
    """``fn`` of one state (and its row of ``per_row``) on every row."""
    return torch.func.vmap(fn)(psi, *per_row)


def _run_steps(
    steps: Sequence[Tuple],
    n: int,
    f_bits: Tensor,
    outcome_source: Callable[[int, Tensor, Tensor], Tensor],
    dtype: torch.dtype = torch.complex64,
) -> Tuple[Tensor, List[Tensor], Tensor]:
    """Replay ``steps`` on a batch: ``f_bits`` [batch, num_f] on the
    device; a measurement asks ``outcome_source(record_index, p1, psi)``
    for every row's outcome ([batch] float32, from p1 [batch] float32 and
    the state [batch, 2^n]).

    Returns (psi [batch, 2^n], the records, each [batch] float32, the
    probability [batch] float32 of the realized visible records).  ``psi``
    stays normalized; the probability is accumulated apart, so sampling
    (chain rule) and outcome probabilities share the walk."""
    dev = f_bits.device
    rows = f_bits.shape[0]
    psi = torch.zeros((rows, 2**n), dtype=dtype, device=dev)
    psi[:, 0] = 1.0

    def const(m: Any) -> Tensor:
        return config.device_constant(np.asarray(m), dev, dtype)

    def gate(psi: Tensor, m: Any, idx: Sequence[int]) -> Tensor:
        g = const(m)
        return _rows(lambda s: statevec.apply_unitary(s, g, list(idx), 2), psi)

    def where(bit: Tensor, a: Tensor, b: Tensor) -> Tensor:
        return torch.where((bit > 0.5)[:, None], a, b)

    records: List[Tensor] = []
    prob = torch.ones((rows,), dtype=torch.float32, device=dev)
    for step in steps:
        kind = step[0]
        if kind == "gate":
            _, m, idx = step
            psi = gate(psi, m, idx)
        elif kind == "pauli_zx":
            _, q, fz, fx = step
            if fx is not None:
                psi = where(f_bits[:, fx].float(), _rows(lambda s: statevec.flip_slot(s, q), psi), psi)
            if fz is not None:
                psi = where(f_bits[:, fz].float(), _rows(lambda s: statevec.sign_slot(s, q), psi), psi)
        elif kind == "measure":
            _, q, basis, reset, flip_slot_id, hidden = step
            if basis == "x":
                psi = gate(psi, _H, [q])
            elif basis == "y":
                psi = gate(psi, _SDG_H, [q])
            marg = _rows(lambda s: statevec.marginal_probability(s, [q], 2), psi)
            marg = marg / torch.sum(marg, dim=1, keepdim=True)
            p1 = torch.real(marg[:, 1]).to(torch.float32)
            outcome = outcome_source(len(records), p1, psi)
            raw = outcome
            if flip_slot_id is not None:
                outcome = torch.remainder(outcome + f_bits[:, flip_slot_id].to(outcome.dtype), 2)
            if not hidden:
                prob = prob * torch.where(raw > 0.5, p1, 1.0 - p1)
            psi = _rows(lambda s, o: statevec.project_slot(s, q, o, 2), psi, raw.to(torch.int32))
            records.append(outcome)
            if reset:
                psi = where(raw, _rows(lambda s: statevec.flip_slot(s, q, 2), psi), psi)
                if basis == "x":
                    psi = gate(psi, _H, [q])
                elif basis == "y":
                    psi = gate(psi, _H_S, [q])
    return psi, records, prob


def _chunked(fn: Callable[..., Tensor], n: int, *batch: Tensor) -> Tensor:
    """``fn(*batch)`` in chunks of rows that fit the device's memory
    (``models.detectors.detector_chunk``), concatenated."""
    from ..models.detectors import detector_chunk

    rows = batch[0].shape[0]
    chunk = detector_chunk(rows, 2**n, torch.complex64, batch[0].device) if rows else 1
    if chunk >= rows:
        return fn(*batch)
    parts = [fn(*(b[i:i + chunk] for b in batch)) for i in range(0, rows, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[j] for p in parts]) for j in range(len(parts[0])))
    return torch.cat(parts)


#: the tie-break of the sampler's outcome rule, as in the JAX package
_TIE = 1e-12


def compile_program(prepared: Any, mode: str = "sequential", strategy: str = "dense",
                    device: Any = None) -> CompiledProgram:
    """Compile a prepared instruction spec (``zx.converter.prepare_graph``:
    n, steps, num_f, num_records, detectors, observables) into a sampling
    program on ``device`` (the configured one by default).  ``strategy`` is
    kept for the JAX package's signature; the dense engine is always used
    ("dense")."""
    n = prepared.n
    steps = prepared.steps
    num_f = prepared.num_f
    num_records = prepared.num_records  # visible records only
    visible_pos = prepared.visible_pos  # raw record index -> visible index (or None)
    dev = config.resolve_device(device)

    def as_rows(x: Any, dtype: torch.dtype) -> Tensor:
        x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
        return torch.atleast_2d(x.to(device=dev, dtype=dtype))

    def sample_fn(f_bits: Tensor, uniforms: Tensor, with_margin: bool = False) -> Any:
        """Outcome bits [batch, visible records] (float32) of every row of
        f-bits [batch, num_f] and uniforms [batch, raw records]: a record
        is 1 where u - (1 - p1) + 1e-12 > 0 (the JAX package's rule);
        ``with_margin`` also gives each row's least |u - (1 - p1)|."""

        def run(f: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
            margin = torch.full((f.shape[0],), float("inf"), dtype=torch.float32, device=dev)

            def source(rec_i: int, p1: Tensor, psi: Tensor) -> Tensor:
                nonlocal margin
                d = u[:, rec_i].to(p1.dtype) - (1.0 - p1)
                margin = torch.minimum(margin, torch.abs(d))
                return (torch.sign(d + _TIE) + 1.0) / 2.0

            _, records, _ = _run_steps(steps, n, f, source)
            vis = [r for i, r in enumerate(records) if visible_pos[i] is not None]
            bits = (torch.stack(vis, dim=1) if vis
                    else torch.zeros((f.shape[0], 0), dtype=torch.float32, device=dev))
            return bits, margin

        bits, margin = _chunked(run, n, as_rows(f_bits, torch.float32), as_rows(uniforms, torch.float32))
        return (bits, margin) if with_margin else bits

    def make_prefix_graph(i: int) -> CompiledScalarGraphs:
        def eval_fn(params: Tensor) -> Tensor:
            def run(p: Tensor) -> Tensor:
                f, m_bits = p[:, :num_f], p[:, num_f:]

                def source(rec_i: int, p1: Tensor, psi: Tensor) -> Tensor:
                    v = visible_pos[rec_i]
                    if v is None:
                        # hidden reset collapse: deterministic dominant branch
                        # (exact for the fresh-|0> resets of QEC programs)
                        return (torch.sign(p1 - 0.5) + 1.0) / 2.0
                    return m_bits[:, v].to(torch.float32)

                return _run_steps(steps[: prepared.step_cut[i]], n, f, source)[2]

            return _chunked(run, n, as_rows(params, torch.float32))

        return CompiledScalarGraphs(eval_fn=eval_fn, num_params=num_f + i + 1)

    def norm_eval(params: Tensor) -> Tensor:
        return torch.ones((as_rows(params, torch.float32).shape[0],), dtype=torch.float32, device=dev)

    graphs = [CompiledScalarGraphs(eval_fn=norm_eval, num_params=num_f)]
    graphs += [make_prefix_graph(i) for i in range(num_records)]
    comp = CompiledComponent(
        compiled_scalar_graphs=compile_scalar_graphs(graphs),
        f_selection=np.arange(num_f, dtype=np.int64),
        output_indices=list(range(num_records)),
        sample_fn=sample_fn,
    )
    return CompiledProgram(components=[comp], output_order=list(range(num_records)), num_records=num_records)


# ----------------------------------------------------------------------
# stabilizer decompositions of magic states (strategy tables)
# ----------------------------------------------------------------------


def find_stab(k: int = 1) -> List[Tuple[complex, List[np.ndarray]]]:
    """Stabilizer decomposition of T^{⊗k} as Σ c_j · Clifford_j terms.

    T = a·I + b·S with a = 1 - b, b = (e^{iπ/4} - 1)/(i - 1); a k-T circuit
    expands into 2^k stabilizer terms (reference ``find_stab``; the
    reference's "cat" strategies trade term count for graph size — with the
    dense engine the direct product form is the natural choice).
    """
    b = (np.exp(1j * np.pi / 4) - 1.0) / (1j - 1.0)
    a = 1.0 - b
    eye = np.eye(2, dtype=complex)
    s = np.diag([1.0, 1.0j])
    terms: List[Tuple[complex, List[np.ndarray]]] = [(1.0, [])]
    for _ in range(k):
        new_terms = []
        for c, ops in terms:
            new_terms.append((c * a, ops + [eye]))
            new_terms.append((c * b, ops + [s]))
        terms = new_terms
    return terms


def find_stab_magic(k: int = 1) -> List[Tuple[complex, np.ndarray]]:
    """|T⟩^{⊗k} magic-state stabilizer decomposition (reference parity).

    |T⟩ = cos(π/8)|+⟩' … expressed directly: |T⟩ = (|0⟩ + e^{iπ/4}|1⟩)/√2
    = a|+⟩ + b·S|+⟩ with the :func:`find_stab` coefficients.
    """
    plus = np.array([1.0, 1.0], dtype=complex) / np.sqrt(2.0)
    out: List[Tuple[complex, np.ndarray]] = []
    for c, ops in find_stab(k):
        vec = np.array([1.0], dtype=complex)
        for op in ops:
            vec = np.kron(vec, op @ plus)
        if not ops:
            vec = np.ones(1, dtype=complex)
        out.append((c, vec))
    return out


def find_stab_u3(theta: float, phi: float, lam: float) -> List[Tuple[complex, np.ndarray]]:
    """Decompose a u3 gate into a sum of (at most 4) Clifford terms.

    Any diagonal-plus-rotation u3 = Rz(phi) Ry(theta) Rz(lam); each Rz/Ry
    splits as cos(t/2)·I - i sin(t/2)·P over the Clifford axis P, giving a
    stabilizer-sum without Clifford+T compilation (reference ``find_stab_u3``).
    """
    eye = np.eye(2, dtype=complex)
    z = np.diag([1.0, -1.0]).astype(complex)
    y = np.array([[0.0, -1.0j], [1.0j, 0.0]])

    def rot_terms(t: float, p: np.ndarray) -> List[Tuple[complex, np.ndarray]]:
        return [(np.cos(t / 2.0), eye), (-1.0j * np.sin(t / 2.0), p)]

    terms: List[Tuple[complex, np.ndarray]] = [(1.0, eye)]
    for t, p in ((lam, z), (theta, y), (phi, z)):
        terms = [(c1 * c2, m2 @ m1) for c1, m1 in terms for c2, m2 in rot_terms(t, p)]
    # merge identical Clifford factors
    merged: Dict[bytes, Tuple[complex, np.ndarray]] = {}
    for c, m in terms:
        key = np.round(m, 12).tobytes()
        if key in merged:
            merged[key] = (merged[key][0] + c, m)
        else:
            merged[key] = (c, m)
    return [(c, m) for c, m in merged.values() if abs(c) > 1e-12]
