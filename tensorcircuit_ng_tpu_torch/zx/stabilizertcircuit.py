"""Stabilizer+T circuits with Pauli noise: exact conditional sampling.

Counterpart of ``tensorcircuit_ng_tpu/zx/stabilizertcircuit.py``
(tsim-derived).  Noise is sampled in a reduced error basis
(:class:`~tensorcircuit_ng_tpu_torch.zx.noise_model.ChannelSampler`), and,
conditioned on each error pattern, measurement outcomes are drawn EXACTLY
by the chain rule, so rare-outcome statistics need no extra trajectories.
The conditional probabilities come from the port's dense engine: a batch
of shots is one ``[shots, 2^n]`` complex64 state on the circuit's device
(``zx/scalar_graph.py``), so arbitrary-angle rotations work too, not just
Clifford+T.  The JAX package's random keys are a ``torch.Generator`` on the
device, seeded by ``seed=``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..models.abstractcircuit import AbstractCircuit
from ..ops import gates as gates_mod
from .converter import prepare_graph
from .noise_model import ChannelSampler
from .scalar_graph import CompiledComponent, CompiledProgram, _run_steps, compile_program

Tensor = Any

__all__ = ["StabilizerTCircuit", "sample_component", "sample_program"]


def _host(m: Any) -> np.ndarray:
    """A gate matrix (numpy or a tensor on any device) as complex64 numpy."""
    if isinstance(m, torch.Tensor):
        m = m.detach().resolve_conj().cpu().numpy()
    return np.asarray(m, dtype=np.complex64)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def sample_component(
    comp: CompiledComponent, f_params: Any, key: torch.Generator
) -> Tuple[Tensor, torch.Generator, Tensor]:
    """Exact chain-rule sampling of one component's outputs for every row
    of ``f_params`` [batch, num_f], the draws from the generator ``key``:
    the fused ``sample_fn`` (one batched replay, uniforms [batch, raw
    records]) when present, else the prefix scalar graphs one output at a
    time (a Bernoulli draw a row).  Returns (bits [batch, outputs] bool,
    the generator, 0.0)."""
    batch = f_params.shape[0]
    dev = f_params.device
    if comp.sample_fn is not None:
        uniforms = torch.rand((batch, _raw_records_of(comp)), generator=key, device=dev)
        bits = comp.sample_fn(f_params[:, comp.f_selection], uniforms)
        return bits.to(torch.bool), key, torch.zeros((), device=dev)
    num_outputs = len(comp.compiled_scalar_graphs) - 1
    f_sel = f_params[:, comp.f_selection].to(torch.float32)
    m_acc = torch.zeros((batch, num_outputs), dtype=torch.float32, device=dev)
    prev = torch.abs(comp.compiled_scalar_graphs[0].eval(f_sel))
    ones = torch.ones((batch, 1), dtype=torch.float32, device=dev)
    for i, graph in enumerate(comp.compiled_scalar_graphs[1:]):
        p1 = torch.abs(graph.eval(torch.cat([f_sel, m_acc[:, :i], ones], dim=1)))
        bits = torch.bernoulli(torch.clamp(p1 / torch.clamp(prev, min=1e-30), 0, 1), generator=key)
        m_acc[:, i] = bits
        prev = torch.where(bits > 0.5, p1, prev - p1)
    return m_acc.to(torch.bool), key, torch.zeros((), device=dev)


def _raw_records_of(comp: CompiledComponent) -> int:
    return getattr(comp, "_raw_records", len(comp.compiled_scalar_graphs) - 1)


def sample_program(program: CompiledProgram, f_params: Any, key: torch.Generator) -> Tensor:
    """Sample every component and reassemble outputs in circuit order."""
    results = [sample_component(comp, f_params, key)[0] for comp in program.components]
    if not results:
        return torch.zeros((f_params.shape[0], len(program.output_order)), dtype=torch.bool, device=f_params.device)
    order = np.argsort(np.asarray(program.output_order))
    return torch.cat(results, dim=1)[:, torch.as_tensor(order, device=f_params.device)]


class StabilizerTCircuit(AbstractCircuit):
    """Noisy Clifford+T (and beyond) circuit with exact-outcome sampling on
    ``device`` (the configured one by default)."""

    def __init__(self, nqubits: int, seed: Optional[int] = None, strategy: str = "dense",
                 device: Any = None) -> None:
        self._nqubits = nqubits
        self._d = 2
        self._qir: List[Dict[str, Any]] = []
        self._extra_qir: List[Dict[str, Any]] = []
        self._tape: List[Dict[str, Any]] = []
        self._device = config.resolve_device(device)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**30))
        self._seed = seed
        self._key = _generator(seed, self._device)
        self.strategy = strategy
        self._cache: Dict[Any, Any] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @property
    def nqubits(self) -> int:
        return self._nqubits

    def _invalidate(self) -> None:
        self._cache = {}

    def _record_gate(self, name: str, matrix: Any, *index: int, **parameters: Any) -> None:
        item = {
            "kind": "gate",
            "name": name,
            "index": tuple(int(q) % self._nqubits for q in index),
            "matrix": _host(matrix),
        }
        if parameters:
            item["parameters"] = parameters  # a rotation's angle, for the sampling graph
        self._tape.append(item)
        self._qir.append({"name": name, "index": tuple(index), "gatef": None})
        self._invalidate()

    def apply_general_gate(self, gate: Any, *index: int, name: Optional[str] = None, **kws: Any) -> None:
        m = gate.matrix() if hasattr(gate, "matrix") else gate
        self._record_gate(name or getattr(gate, "name", "any"), m, *index)

    def apply(self, gate: Any, *index: int, **kws: Any) -> None:
        self.apply_general_gate(gate, *index, **kws)

    def __getattr__(self, name: str) -> Any:
        lname = name.lower()
        if lname in gates_mod.GATES:
            gf = gates_mod.GATES[lname]

            def wrapper(*index: int, **kws: Any) -> None:
                g = gf(**kws) if kws else gf()
                self._record_gate(lname, g.matrix(), *index)

            return wrapper
        raise AttributeError(name)

    # explicit Clifford+T names
    def h(self, q: int) -> None:
        self._record_gate("h", gates_mod.GATES["h"]().matrix(), q)

    def x(self, q: int) -> None:
        self._record_gate("x", np.array([[0, 1], [1, 0]]), q)

    def y(self, q: int) -> None:
        self._record_gate("y", np.array([[0, -1j], [1j, 0]]), q)

    def z(self, q: int) -> None:
        self._record_gate("z", np.diag([1.0, -1.0]), q)

    def s(self, q: int) -> None:
        self._record_gate("s", np.diag([1.0, 1.0j]), q)

    def sd(self, q: int) -> None:
        self._record_gate("sd", np.diag([1.0, -1.0j]), q)

    sdg = sd

    def t(self, q: int) -> None:
        self._record_gate("t", np.diag([1.0, np.exp(0.25j * np.pi)]), q)

    def td(self, q: int) -> None:
        self._record_gate("td", np.diag([1.0, np.exp(-0.25j * np.pi)]), q)

    tdg = td

    def cnot(self, c: int, t: int) -> None:
        m = np.eye(4)[[0, 1, 3, 2]]
        self._record_gate("cx", m, c, t)

    cx = cnot

    def cz(self, a: int, b: int) -> None:
        self._record_gate("cz", np.diag([1.0, 1.0, 1.0, -1.0]), a, b)

    def cy(self, a: int, b: int) -> None:
        m = np.eye(4, dtype=complex)
        m[2:, 2:] = np.array([[0, -1j], [1j, 0]])
        self._record_gate("cy", m, a, b)

    def swap(self, a: int, b: int) -> None:
        self._record_gate("swap", np.eye(4)[[0, 2, 1, 3]], a, b)

    def rx(self, q: int, theta: float = 0) -> None:
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        self._record_gate("rx", np.array([[c, -1j * s], [-1j * s, c]]), q, theta=theta)

    def ry(self, q: int, theta: float = 0) -> None:
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        self._record_gate("ry", np.array([[c, -s], [s, c]]), q, theta=theta)

    def rz(self, q: int, theta: float = 0) -> None:
        self._record_gate("rz", np.diag([np.exp(-0.5j * theta), np.exp(0.5j * theta)]), q, theta=theta)

    # ------------------------------------------------------------------
    # noise / instructions (stim vocabulary)
    # ------------------------------------------------------------------

    def _record_channel(self, channel: str, index: Tuple[int, ...], params: Sequence[float], **extra: Any) -> None:
        self._tape.append(
            {"kind": "channel", "channel": channel, "index": tuple(index), "params": list(params), **extra}
        )
        self._invalidate()

    def depolarizing(self, q: int, px: float, py: float, pz: float) -> None:
        self._record_channel("pauli1", (q,), [px, py, pz])

    def pauli(self, q: int, px: float, py: float, pz: float) -> None:
        self._record_channel("pauli1", (q,), [px, py, pz])

    def pauli_instruction(self, q: int, px: float = 0, py: float = 0, pz: float = 0) -> None:
        self._record_channel("pauli1", (q,), [px, py, pz])

    def depolarizing_instruction(self, q: int, p: float) -> None:
        self._record_channel("pauli1", (q,), [p / 3, p / 3, p / 3])

    def depolarize1(self, *qubits: int, p: float) -> None:
        for q in qubits:
            self._record_channel("pauli1", (q,), [p / 3, p / 3, p / 3])

    def depolarizing2(self, q1: int, q2: int, p: float) -> None:
        probs = [p / 15.0] * 15
        self._record_channel("pauli2", (q1, q2), probs)

    def depolarizing2_instruction(self, q1: int, q2: int, p: float) -> None:
        self.depolarizing2(q1, q2, p)

    def depolarize2(self, *qubits: int, p: float) -> None:
        for a, b in zip(qubits[::2], qubits[1::2]):
            self.depolarizing2(a, b, p)

    def x_error(self, *qubits: int, p: float) -> None:
        for q in qubits:
            self._record_channel("x", (q,), [p])

    def y_error(self, *qubits: int, p: float) -> None:
        for q in qubits:
            self._record_channel("y", (q,), [p])

    def z_error(self, *qubits: int, p: float) -> None:
        for q in qubits:
            self._record_channel("z", (q,), [p])

    def correlated_error(self, targets: Sequence[Tuple[int, str]], probabilities: Sequence[float]) -> None:
        self._record_channel("correlated", tuple(q for q, _ in targets), list(probabilities), targets=list(targets))

    # measurement / reset

    def _record_measure(self, q: int, basis: str, reset: bool, p: float, hidden: bool = False) -> None:
        self._tape.append(
            {"kind": "measure", "index": (int(q),), "basis": basis, "reset": reset, "p": p, "hidden": hidden}
        )
        self._invalidate()

    def measure_instruction(self, *qubits: int, p: float = 0) -> None:
        for q in qubits:
            self._record_measure(q, "z", False, p)

    def m(self, *qubits: int, p: float = 0) -> None:
        self.measure_instruction(*qubits, p=p)

    def mx(self, q: int, p: float = 0) -> None:
        self._record_measure(q, "x", False, p)

    def my(self, q: int, p: float = 0) -> None:
        self._record_measure(q, "y", False, p)

    def mr_instruction(self, *qubits: int, p: float = 0) -> None:
        for q in qubits:
            self._record_measure(q, "z", True, p)

    def mrx_instruction(self, q: int, p: float = 0) -> None:
        self._record_measure(q, "x", True, p)

    def mry_instruction(self, q: int, p: float = 0) -> None:
        self._record_measure(q, "y", True, p)

    def mrz_instruction(self, q: int, p: float = 0) -> None:
        self._record_measure(q, "z", True, p)

    def reset_z(self, *qubits: int, p: float = 0) -> None:
        for q in qubits:
            self._tape.append({"kind": "reset", "index": (int(q),), "basis": "z"})
        self._invalidate()

    def reset_x(self, *qubits: int) -> None:
        for q in qubits:
            self._tape.append({"kind": "reset", "index": (int(q),), "basis": "x"})
        self._invalidate()

    def reset_y(self, *qubits: int) -> None:
        for q in qubits:
            self._tape.append({"kind": "reset", "index": (int(q),), "basis": "y"})
        self._invalidate()

    def r(self, q: int, p: float = 0) -> None:
        self.reset_z(q)

    def reset_instruction(self, *qubits: int) -> None:
        self.reset_z(*qubits)

    def detector_instruction(self, *records: int) -> None:
        self._tape.append({"kind": "detector", "records": tuple(records)})
        self._invalidate()

    detector = detector_instruction

    def observable_instruction(self, *records: int, idx: int = 0) -> None:
        self._tape.append({"kind": "observable", "records": tuple(records), "idx": idx})
        self._invalidate()

    def observable_include(self, *records: int, idx: int = 0) -> None:
        self.observable_instruction(*records, idx=idx)

    def qubit_coords_instruction(self, qubit: int, coords: Sequence[float]) -> None:
        self._tape.append({"kind": "coords", "index": (qubit,), "coords": list(coords)})

    def tick_instruction(self) -> None:
        self._tape.append({"kind": "tick"})

    # ------------------------------------------------------------------
    # construction from other representations
    # ------------------------------------------------------------------

    @classmethod
    def from_circuit(cls, circuit: Any, strategy: str = "dense", device: Any = None) -> "StabilizerTCircuit":
        """Lift a circuit's QIR (its gates' matrices) into a
        StabilizerTCircuit, on ``device`` (the circuit's by default)."""
        dev = device if device is not None else getattr(circuit, "_device", None)
        c = cls(circuit._nqubits, strategy=strategy, device=dev)
        for item in circuit.to_qir():
            gate = item.get("gate")
            if gate is None and item.get("gatef") is not None:
                gate = item["gatef"](**(item.get("parameters") or {}))
            c._record_gate(item.get("name") or "any", gate.matrix(), *item["index"])
        return c

    @classmethod
    def from_stim_str(cls, stim_str: str, device: Any = None) -> "StabilizerTCircuit":
        from ..translation import stim2tc

        return stim2tc(stim_str, circuit_class=cls, device=device)

    @classmethod
    def from_stim_circuit(cls, stim_circuit: Any, device: Any = None) -> "StabilizerTCircuit":
        return cls.from_stim_str(str(stim_circuit), device=device)

    def _merge_qir(self) -> List[Dict[str, Any]]:
        return self._tape

    # ------------------------------------------------------------------
    # compilation + sampling
    # ------------------------------------------------------------------

    def _compile(self, force_measure_all: bool = False) -> Tuple[CompiledProgram, ChannelSampler, Any]:
        key = ("prog", force_measure_all)
        if key not in self._cache:
            prepared = prepare_graph(self, force_measure_all=force_measure_all)
            program = compile_program(prepared, strategy=self.strategy, device=self._device)
            for comp in program.components:
                comp._raw_records = len(prepared.visible_pos)  # type: ignore[attr-defined]
            sampler = ChannelSampler(prepared.channel_probs, prepared.error_transform, seed=self._seed,
                                     device=self._device)
            self._cache[key] = (program, sampler, prepared)
        return self._cache[key]

    def _sample_f(self, sampler: ChannelSampler, shots: int) -> Tensor:
        if sampler.num_f_params == 0:
            return torch.zeros((shots, 1), dtype=torch.uint8, device=self._device)
        return sampler.sample_jax(shots, self._key)[0]

    def _has_measure(self) -> bool:
        return any(t["kind"] == "measure" for t in self._tape)

    def sample_measurements(self, shots: int = 1, seed: Optional[int] = None, batch_size: int = 100000) -> Tensor:
        """All measurement records, bool [shots, num_measurements] on the
        device; ``batch_size`` shots a draw (each replay chunked further by
        free memory)."""
        if seed is not None:
            self._key = _generator(seed, self._device)
        program, sampler, _ = self._compile(force_measure_all=not self._has_measure())
        outs = []
        left = shots
        while left > 0:
            b = min(left, batch_size)
            outs.append(sample_program(program, self._sample_f(sampler, b), self._key))
            left -= b
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def sample_detectors(
        self,
        shots: int = 1,
        separate_observables: bool = False,
        use_reference: bool = False,
        seed: Optional[int] = None,
        batch_size: int = 100000,
    ) -> Any:
        """Detector/observable parities, bool [shots, D (+ O)] on the device;
        ``use_reference`` XORs in the parities of one noiseless shot drawn
        from a generator seeded 0."""
        if seed is not None:
            self._key = _generator(seed, self._device)
        program, sampler, prepared = self._compile()
        records = self.sample_measurements(shots, batch_size=batch_size)
        parities = _parity_matrix(prepared, records.shape[1], self._device)
        dets = _parities(records, parities)
        if use_reference:
            fzero = torch.zeros((1, max(sampler.num_f_params, 1)), dtype=torch.uint8, device=self._device)
            ref_rec = sample_program(program, fzero, _generator(0, self._device))
            dets = dets ^ _parities(ref_rec, parities)
        nd = prepared.num_detectors
        no = len(prepared.observables)
        if separate_observables:
            return dets[:, :nd], dets[:, nd : nd + no]
        return dets[:, : nd + no]

    # ------------------------------------------------------------------
    # exact quantities
    # ------------------------------------------------------------------

    def _unitary_state(self) -> Tensor:
        """Noise-free pure state of the gate-only part (measurements
        skipped), complex64 on the device."""
        from ..core import statevec

        psi = statevec.init_state(self._nqubits, dtype="complex64", device=self._device)
        for item in self._tape:
            if item["kind"] == "gate":
                g = config.device_constant(item["matrix"], self._device, psi.dtype)
                psi = statevec.apply_unitary(psi, g, list(item["index"]), 2)
        return psi

    def amplitude(self, state: Union[str, Sequence[int]]) -> Tensor:
        """⟨state|C|0…0⟩ of the noise-free unitary part."""
        from ..core import statevec

        bits = [int(b) for b in (state if not isinstance(state, str) else list(state))]
        return statevec.amplitude(self._unitary_state(), bits, 2)

    def outcome_probability(self, state: Any, shots: int = 1) -> Tensor:
        """P(measurement records == state) of each of ``shots`` sampled
        noise realizations: exact a realization (one chain-rule
        evaluation of the last prefix graph over the batch)."""
        program, sampler, prepared = self._compile(force_measure_all=not self._has_measure())
        comp = program.components[0]
        nrec = prepared.num_records
        if nrec == 0:
            return torch.ones((shots,), dtype=torch.float32, device=self._device)
        bits = torch.as_tensor(np.asarray(state, dtype=np.float32)[:nrec], device=self._device)
        f = self._sample_f(sampler, shots)
        f_sel = f[:, comp.f_selection].to(torch.float32)
        params = torch.cat([f_sel, bits[None, :].expand(shots, nrec)], dim=1)
        return torch.abs(comp.compiled_scalar_graphs[nrec].eval(params))

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        shots: Optional[int] = None,
        **kws: Any,
    ) -> Tensor:
        """Noise-averaged Pauli-string expectation (real, on the device).
        With noise channels the value is the mean over ``shots`` error
        patterns (default 1024), all replayed as one batch (a measurement
        takes its dominant branch); noiseless circuits are exact."""
        from ..core import statevec

        program, sampler, prepared = self._compile()

        def source(rec_i: int, p1: Tensor, psi: Tensor) -> Tensor:
            return (torch.sign(p1 - 0.5) + 1.0) / 2.0

        def expect(f: Tensor) -> Tensor:
            psi = _run_steps(prepared.steps, self._nqubits, f.to(torch.float32), source)[0]
            return torch.real(torch.func.vmap(lambda s: statevec.expectation_ps(s, x=x, y=y, z=z))(psi))

        if sampler.num_f_params == 0 or not prepared.channel_probs:
            f0 = torch.zeros((1, max(sampler.num_f_params, 1)), dtype=torch.uint8, device=self._device)
            return expect(f0)[0]
        return torch.mean(expect(self._sample_f(sampler, shots or 1024)))


def _parity_matrix(prepared: Any, num_records: int, device: torch.device) -> Tensor:
    """[detectors + observables, records] 0-1 rows (float32, on device)."""
    rows = []
    for recs in list(prepared.detectors) + list(prepared.observables):
        row = np.zeros(num_records, dtype=np.float32)
        for r in recs:
            row[r] = 1.0 - row[r]
        rows.append(row)
    mat = np.stack(rows) if rows else np.zeros((0, num_records), dtype=np.float32)
    return torch.as_tensor(mat, device=device)


def _parities(records: Tensor, parities: Tensor) -> Tensor:
    """(records @ parities^T) mod 2 as bool: a float32 product (exact
    below 2^24 records), the card having no integer GEMM."""
    return torch.remainder(records.to(torch.float32) @ parities.T, 2) > 0.5
