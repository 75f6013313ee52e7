"""``StabilizerCircuit``: the Clifford simulator on the CHP tableau.

Counterpart of ``tensorcircuit_ng_tpu/models/stabilizercircuit.py``.  The
tableau is a host engine, as in the JAX package: the bit-packed C++ one of
``core/native_tableau.py`` (built by g++ at first use; a failed build
raises), or the numpy one of ``core/tableau.py`` given as
``tableau_inputs``.  What the JAX package computes with ``jnp`` lives on the
circuit's device: the dense ``state()`` (the QIR replayed through the port's
``Circuit``, or rebuilt from the stabilizer group), the expectations (a real
scalar tensor) and the formatted samples.

The QEC instructions (``measure_instruction``, ``reset_instruction``, the
lazy Pauli noise, ``detector``, ``observable_include``) are recorded in the
QIR and replayed shot by shot by :meth:`StabilizerCircuit.sample_detectors`,
which draws from ``np.random.default_rng(seed)`` in the JAX package's order.

``sample`` without ``status`` or ``random_generator`` draws the native
engine's seed from the global numpy stream (the one ``measure`` and the
numpy route draw from), so ``np.random.seed(k)`` reproduces a call and two
unseeded calls differ (the JAX package passes seed 0, the engine's fixed
default, and repeats itself: Queue 3 F13 of ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from .. import quantum as qu
from ..core.native_tableau import NativeTableau, make_tableau, native_tableau_available  # noqa: F401
from ..core.tableau import Tableau
from .abstractcircuit import AbstractCircuit

__all__ = ["StabilizerCircuit"]

#: gate-word name -> tableau method (x/y/z are *_gate on the tableau)
_TABLEAU_OPS = {"x": "x_gate", "y": "y_gate", "z": "z_gate", "cx": "cnot"}

#: gate name -> tableau method (None: the identity)
_GATE_MAP = {
    "h": "h",
    "x": "x_gate",
    "y": "y_gate",
    "z": "z_gate",
    "s": "s",
    "sd": "sd",
    "sdg": "sd",
    "sx": "sx",
    "cnot": "cnot",
    "cx": "cnot",
    "cz": "cz",
    "cy": "cy",
    "swap": "swap",
    "iswap": "iswap",
    "i": None,
}

_PAULIS1 = ("x_gate", "y_gate", "z_gate")


class StabilizerCircuit(AbstractCircuit):
    """Clifford-only circuit on the CHP tableau."""

    is_stabilizer = True

    def __init__(
        self,
        nqubits: int,
        inputs: Any = None,
        tableau_inputs: Optional[Union[Tableau, NativeTableau]] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        super().__init__()
        if inputs is not None:
            raise ValueError("StabilizerCircuit does not take dense inputs")
        self._nqubits = nqubits
        self._d = 2
        self._device = config.resolve_device(device)
        self._tab = tableau_inputs.copy() if tableau_inputs is not None else make_tableau(nqubits)
        self._measure_record: List[int] = []
        #: False once the tableau holds what the QIR cannot replay (tableau
        #: inputs, collapses, unrecorded Cliffords, noise)
        self._replayable = tableau_inputs is None

    @property
    def device(self) -> torch.device:
        return self._device

    def _copy_params(self) -> Dict[str, Any]:
        return {"nqubits": self._nqubits, "device": self._device}

    def copy(self) -> "StabilizerCircuit":
        c = StabilizerCircuit(self._nqubits, device=self._device)
        c._tab = self._tab.copy()
        c._qir = [dict(i) for i in self._qir]
        c._measure_record = list(self._measure_record)
        c._replayable = self._replayable
        return c

    # ------------------------------------------------------------------
    # gates
    # ------------------------------------------------------------------

    def apply_general_gate(
        self,
        gate: Any,
        *index: int,
        name: Optional[str] = None,
        split: Optional[Dict[str, Any]] = None,
        mpo: bool = False,
        ir_dict: Optional[Dict[str, Any]] = None,
    ) -> None:
        gname = (name or "").lower()
        gname = self.gate_aliases.get(gname, gname)
        if gname not in _GATE_MAP:
            raise ValueError(f"gate {gname!r} is not Clifford / not supported by the tableau engine")
        index = tuple(int(i) % self._nqubits for i in index)
        if ir_dict is None:
            ir_dict = {"gatef": None, "gate": gate, "index": index, "name": gname, "split": None, "mpo": False}
        else:
            ir_dict = dict(ir_dict)
            ir_dict["index"] = index
        self._qir.append(ir_dict)
        meth = _GATE_MAP[gname]
        if meth is not None:
            getattr(self._tab, meth)(*index)

    def _apply_gate_instance(self, gatef: Any, *index: Any, name: str, split: Any = None, **params: Any) -> None:
        """A named Clifford, recorded without a matrix; index sequences
        broadcast elementwise."""
        if params:
            raise ValueError("StabilizerCircuit takes no parameterized gates")
        if index and hasattr(index[0], "__iter__"):
            seqs = [list(i) for i in index]
            for pos in range(len(seqs[0])):
                self._apply_gate_instance(gatef, *(s[pos] for s in seqs), name=name, split=split)
            return
        self.apply_general_gate(None, *index, name=name)

    def _apply_qir_item(self, item: Dict[str, Any]) -> None:
        """Replay one QIR item (``append``, ``compose``, ``from_qir``): a
        gate by its name, a record or a noise instruction as recorded."""
        if item.get("measure"):
            self.measure_instruction(*item["index"])
        elif item.get("reset"):
            self.reset_instruction(*item["index"])
        elif item.get("noise"):
            self._noise_instruction(item["name"], item["index"], item["p"])
        elif item.get("meta"):
            self._qir.append(dict(item))
        else:
            self.apply_general_gate(None, *item["index"], name=item["name"])

    #: gate -> its inverse in circuit order, each entry (gate, which of the
    #: item's qubits it acts on)
    _INVERSE_SEQ = {
        "h": (("h", (0,)),),
        "x": (("x", (0,)),),
        "y": (("y", (0,)),),
        "z": (("z", (0,)),),
        "s": (("sd", (0,)),),
        "sd": (("s", (0,)),),
        # sx = H S H, so sx† = H S† H
        "sx": (("h", (0,)), ("sd", (0,)), ("h", (0,))),
        "cnot": (("cnot", (0, 1)),),
        "cz": (("cz", (0, 1)),),
        "cy": (("cy", (0, 1)),),
        "swap": (("swap", (0, 1)),),
        # iswap = SWAP; CZ; S_a; S_b, so its inverse is S†_a; S†_b; CZ; SWAP
        "iswap": (("sd", (0,)), ("sd", (1,)), ("cz", (0, 1)), ("swap", (0, 1))),
        "i": (("i", (0,)),),
    }

    def inverse(self, circuit_params: Optional[Dict[str, Any]] = None) -> "StabilizerCircuit":
        """The adjoint circuit by name-level Clifford inversion (no matrices),
        on this circuit's device."""
        c = StabilizerCircuit(self._nqubits, device=self._device)
        for item in reversed(self._qir):
            name = item["name"]
            seq = self._INVERSE_SEQ.get(name)
            if seq is None:
                raise ValueError(f"no Clifford inverse rule for {name!r}")
            idx = item["index"]
            for g, which in seq:
                getattr(c, g)(*(idx[w] for w in which))
        return c

    # ------------------------------------------------------------------
    # measurement and sampling (on the host tableau)
    # ------------------------------------------------------------------

    def mid_measurement(self, index: int, keep: int = 0) -> None:
        """Post-select qubit ``index`` on ``keep``; a determined outcome
        other than ``keep`` raises."""
        self._replayable = False
        if self._tab.measure(index, status=float(keep)) != keep:
            raise ValueError("post-selected outcome has zero probability (deterministic mismatch)")

    post_select = mid_measurement
    mid_measure = mid_measurement

    def cond_measurement(self, index: int, status: Optional[float] = None) -> int:
        """Measure qubit ``index`` with collapse; the outcome is recorded."""
        self._replayable = False
        out = self._tab.measure(index, status=None if status is None else float(status))
        self._measure_record.append(out)
        return out

    cond_measure = cond_measurement

    def measure(
        self, *index: int, with_prob: bool = False, status: Optional[Sequence[float]] = None
    ) -> Tuple[np.ndarray, float]:
        """Measure the listed qubits on a copy of the tableau (the circuit is
        unchanged): (int32 outcomes, their probability or -1.0)."""
        tab = self._tab.copy()
        outs = []
        p = 1.0
        for k, q in enumerate(index):
            st = None if status is None else float(np.asarray(status)[k])
            if tab.is_random(q):
                p *= 0.5
            outs.append(tab.measure(q, status=st))
        res = np.asarray(outs, dtype=np.int32)
        return (res, p) if with_prob else (res, -1.0)

    measure_jit = measure

    def sample(
        self,
        batch: Optional[int] = None,
        allow_state: bool = False,
        format: Optional[str] = None,
        random_generator: Optional[Any] = None,
        status: Optional[Any] = None,
        **kws: Any,
    ) -> Any:
        """``batch`` shots of every qubit.  Without ``status`` the native
        engine samples the whole batch, seeded by ``random_generator`` (a
        numpy Generator) or by a draw from the global numpy stream; with a
        [batch, n] ``status`` (or on the numpy engine) each shot measures a
        copy of the tableau.  ``format`` None: (int32 bits, -1.0) a shot on
        the circuit's device; else :func:`quantum.sample2all`'s formats."""
        nbatch = 1 if batch is None else batch
        if status is None and isinstance(self._tab, NativeTableau):
            if hasattr(random_generator, "integers"):
                seed = int(random_generator.integers(2**63))
            else:
                seed = int(np.random.randint(2**63 - 1, dtype=np.int64))
            samples = self._tab.sample(nbatch, seed=seed).astype(np.int32)
        else:
            if status is None:
                status = np.random.uniform(size=(nbatch, self._nqubits))
            status = np.asarray(status)
            samples = np.stack([
                self.measure(*range(self._nqubits), status=status[b])[0] for b in range(nbatch)
            ])
        bits = torch.as_tensor(samples, device=self._device)
        if format is None:
            if batch is None:
                return bits[0], -1.0
            return [(bits[b], -1.0) for b in range(nbatch)]
        idx = qu.sample_bin2int(bits, self._nqubits)
        return qu.sample2all(idx, self._nqubits, format=format, jittable=False)

    # ------------------------------------------------------------------
    # expectations
    # ------------------------------------------------------------------

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(float(v), dtype=getattr(torch, config.rdtypestr()), device=self._device)

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        ps: Optional[Sequence[int]] = None,
        **kws: Any,
    ) -> torch.Tensor:
        """Exact ⟨P⟩ (+1, -1 or 0) by a peek at the tableau, as a real
        scalar on the circuit's device; ``ps`` lists 0/1/2/3 a qubit."""
        if ps is not None:
            x = [i for i, v in enumerate(ps) if v == 1]
            y = [i for i, v in enumerate(ps) if v == 2]
            z = [i for i, v in enumerate(ps) if v == 3]
        return self._scalar(self._tab.expectation_pauli(tuple(x or ()), tuple(z or ()), tuple(y or ())))

    def expectation(self, *ops: Any, **kws: Any) -> torch.Tensor:
        raise NotImplementedError("StabilizerCircuit supports expectation_ps (Pauli strings) only")

    def sample_expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        shots: Optional[int] = None,
        status: Optional[Any] = None,
        **kws: Any,
    ) -> torch.Tensor:
        """The mean of (-1)^parity over ``shots`` measurements in the
        string's basis (rows of ``status``), or the exact value without
        ``shots``."""
        if shots is None:
            return self.expectation_ps(x=x, y=y, z=z)
        c = self.copy()
        for q in x or ():
            c.h(q)  # type: ignore[attr-defined]
        for q in y or ():
            c.sd(q)  # type: ignore[attr-defined]
            c.h(q)  # type: ignore[attr-defined]
        wires = list(x or ()) + list(y or ()) + list(z or ())
        if status is None:
            status = np.random.uniform(size=(shots, self._nqubits))
        status = np.asarray(status)
        acc = 0.0
        for s in range(shots):
            res, _ = c.measure(*wires, status=status[s][: len(wires)])
            acc += (-1.0) ** int(np.sum(res))
        return self._scalar(acc / shots)

    # ------------------------------------------------------------------
    # the dense state and the tableau
    # ------------------------------------------------------------------

    def state(self, form: str = "default") -> torch.Tensor:
        """The dense state vector on the circuit's device.

        The recorded Cliffords replayed through the port's ``Circuit`` keep
        the global phase exactly; where the tableau holds what the QIR
        cannot replay, the state is rebuilt from the stabilizer group, its
        global phase fixed by making the anchor amplitude real and positive
        (a tableau defines the state up to a phase)."""
        if self._replayable:
            from .circuit import Circuit

            c = Circuit(self._nqubits, device=self._device)
            for item in self._qir:
                gname = item["name"]
                # identities and records carry no unitary; an unknown gate
                # name fails loudly
                if (
                    gname == "i"
                    or item.get("noise")
                    or item.get("measure")
                    or item.get("reset")
                    or item.get("detector")
                    or item.get("meta")
                    or "index" not in item
                ):
                    continue
                getattr(c, gname)(*item["index"])
            return c.state(form=form)
        psi = self._state_from_tableau()
        if form == "tensor":
            return torch.reshape(psi, (2,) * self._nqubits)
        return psi

    wavefunction = state

    def _state_from_tableau(self) -> torch.Tensor:
        """|ψ⟩ ∝ Π_j (I + g_j)/2 |z*⟩ with z* a basis state of the support
        (every qubit measured on a copy, the status-0 branch).  Each
        stabilizer g_j = (-1)^{r_j} i^{#Y} X^xmask Z^zmask applies in one
        pass: (g ψ)[i] = ± i^{#Y} (-1)^{popcount((i ^ xmask) & zmask)}
        ψ[i ^ xmask]."""
        n = self._nqubits
        tab = self._tab.copy()
        zstar = [int(tab.measure(q, status=0.0)) for q in range(n)]
        anchor = 0
        for b in zstar:
            anchor = anchor * 2 + b
        cdt = config.torch_dtype()
        idx = torch.arange(2**n, device=self._device, dtype=torch.int64)
        psi = torch.zeros(2**n, dtype=cdt, device=self._device)
        psi[anchor] = 1.0
        xs, zs, rs = self._tab.stabilizers()
        weights = [1 << (n - 1 - q) for q in range(n)]
        for j in range(n):
            xmask = sum(w for w, b in zip(weights, xs[j]) if b)
            zmask = sum(w for w, b in zip(weights, zs[j]) if b)
            ny = int(np.sum(xs[j] & zs[j]))
            src = idx ^ xmask
            par = src & zmask
            for shift in (32, 16, 8, 4, 2, 1):
                par = par ^ (par >> shift)
            sign = (1 - 2 * (par & 1)).to(cdt)
            phi = psi[src] * sign * ((1j**ny) * (-1.0 if int(rs[j]) else 1.0))
            psi = 0.5 * (psi + phi)
        psi = psi / torch.linalg.vector_norm(psi).to(cdt)
        a = psi[anchor]
        return psi * torch.conj(a / torch.abs(a).to(cdt))

    def entanglement_entropy(self, cut: Sequence[int]) -> float:
        """The entropy of region ``cut`` (nats) from a GF(2) rank."""
        return self._tab.entanglement_entropy(list(cut))

    def get_tableau(self) -> Union[Tableau, NativeTableau]:
        return self._tab

    current_tableau = get_tableau
    current_simulator = get_tableau

    def current_circuit(self) -> str:
        """The recorded gates as stim program text (:func:`translation.tc2stim`)."""
        from ..translation import tc2stim

        return tc2stim(self)

    def current_inverse_tableau(self) -> Union[Tableau, NativeTableau]:
        """The tableau of the inverse circuit run on |0...0⟩ (the tableau
        tracks states, not maps)."""
        return self.inverse().get_tableau()

    def cond_measure_many(self, *index: int) -> np.ndarray:
        """Measure several qubits with collapse, in place."""
        return np.asarray([self.cond_measurement(q) for q in index], dtype=np.int32)

    def random_gate(self, *index: int, recorded: bool = False) -> None:
        """A random Clifford on ``index``: a word of 20 m + 12 random
        H, S and CX on the m qubits (``np.random.default_rng()``), applied
        by :meth:`tableau_gate`."""
        rng = np.random.default_rng()
        m = len(index)
        ops: List[Tuple[str, Tuple[int, ...]]] = []
        for _ in range(20 * m + 12):
            choice = rng.integers(0, 3 if m > 1 else 2)
            if choice == 0:
                ops.append(("h", (int(rng.integers(m)),)))
            elif choice == 1:
                ops.append(("s", (int(rng.integers(m)),)))
            else:
                a, b = rng.choice(m, size=2, replace=False)
                ops.append(("cnot", (int(a), int(b))))
        self.tableau_gate(*index, tableau=ops, recorded=recorded)

    def tableau_gate(self, *index: int, tableau: Any, recorded: bool = False) -> None:
        """Apply a Clifford given as a word of ``(name, local indices)``
        pairs over the local qubits 0..len(index)-1; recorded in the QIR
        (as ``untracked`` items) only when ``recorded``."""
        if not recorded:
            self._replayable = False
        for name, local in tableau:
            getattr(self._tab, _TABLEAU_OPS.get(name, name))(*(index[i] for i in local))
        if recorded:
            for name, local in tableau:
                self._qir.append({"name": name, "index": tuple(index[i] for i in local), "gatef": None,
                                  "untracked": True})

    # ------------------------------------------------------------------
    # QEC program instructions, replayed shot by shot by sample_detectors
    # ------------------------------------------------------------------

    def measure_instruction(self, *qubits: int) -> List[int]:  # type: ignore[override]
        """stim ``M``: measure now, and record the instruction."""
        self._qir.append({"name": "m", "index": tuple(int(q) for q in qubits), "measure": True})
        return [self.cond_measurement(q) for q in qubits]

    m_instruction = measure_instruction

    def reset_instruction(self, *qubits: int) -> None:  # type: ignore[override]
        """stim ``R``: reset to |0⟩ (not a record), and record the
        instruction."""
        self._qir.append({"name": "r", "index": tuple(int(q) for q in qubits), "reset": True})
        for q in qubits:
            out = self.cond_measurement(q)
            self._measure_record.pop()
            if out == 1:
                self._tab.x_gate(q)

    def _noise_instruction(self, name: str, qubits: Sequence[int], p: float) -> None:
        self._qir.append({"name": name, "index": tuple(int(q) for q in qubits), "p": float(p), "noise": True})

    def x_error(self, *qubits: int, p: float) -> None:
        self._noise_instruction("x_error", qubits, p)

    def y_error(self, *qubits: int, p: float) -> None:
        self._noise_instruction("y_error", qubits, p)

    def z_error(self, *qubits: int, p: float) -> None:
        self._noise_instruction("z_error", qubits, p)

    def depolarize1(self, *qubits: int, p: float) -> None:
        self._noise_instruction("depolarize1", qubits, p)

    def depolarize2(self, *qubits: int, p: float) -> None:
        """Two-qubit depolarizing on consecutive pairs (stim DEPOLARIZE2)."""
        if len(qubits) % 2:
            raise ValueError("depolarize2 needs an even number of qubits")
        self._noise_instruction("depolarize2", qubits, p)

    def detector(self, *rec: int) -> None:
        """stim ``DETECTOR``: the parity of measurement records (a negative
        offset counts back from the last record before it)."""
        self._qir.append({"name": "detector", "rec": tuple(int(r) for r in rec), "meta": True})

    def observable_include(self, *rec: int, idx: int = 0) -> None:
        self._qir.append({"name": "observable", "rec": tuple(int(r) for r in rec), "obs_idx": int(idx),
                          "meta": True})

    def sample_detectors(self, shots: int, seed: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Monte-Carlo detector and observable samples, uint8 [shots, n_det]
        and [shots, n_obs]: the recorded program replayed a shot on a fresh
        native tableau, with the noise and the measurement outcomes drawn
        from ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        det_items = [d for d in self._qir if d.get("meta") and d["name"] == "detector"]
        obs_items = [d for d in self._qir if d.get("meta") and d["name"] == "observable"]
        n_obs = 1 + max((d["obs_idx"] for d in obs_items), default=-1)
        dets = np.zeros((shots, len(det_items)), dtype=np.uint8)
        obs = np.zeros((shots, n_obs), dtype=np.uint8)
        for s in range(shots):
            tab = make_tableau(self._nqubits)
            record: List[int] = []
            di = 0
            for item in self._qir:
                if item.get("measure"):
                    for q in item["index"]:
                        record.append(tab.measure(q, status=rng.random()))
                elif item.get("reset"):
                    for q in item["index"]:
                        if tab.measure(q, status=rng.random()) == 1:
                            tab.x_gate(q)
                elif item.get("noise"):
                    _apply_noise(tab, item, rng)
                elif item.get("meta"):
                    bits = [record[r] for r in item["rec"]]
                    val = int(np.bitwise_xor.reduce(bits)) if bits else 0
                    if item["name"] == "detector":
                        dets[s, di] = val
                        di += 1
                    else:
                        obs[s, item["obs_idx"]] ^= val
                else:
                    meth = _GATE_MAP.get(item.get("name", ""))
                    if meth is not None:
                        getattr(tab, meth)(*item["index"])
        return dets, obs

    def depolarizing(self, *index: int, p: float = 0.0, status: Optional[Any] = None) -> None:
        """One trajectory of depolarizing noise: a uniform r a qubit (from
        ``status`` or ``np.random.uniform``); r < p applies X, Y or Z by
        int(3 r / p)."""
        vals = np.asarray(status if status is not None else np.random.uniform(size=len(index))).reshape(-1)
        for k, q in enumerate(index):
            r = float(vals[k])
            if r < p:
                self._replayable = False
                getattr(self._tab, _PAULIS1[int(r / p * 3)])(q)


def _apply_noise(tab: Any, item: Dict[str, Any], rng: np.random.Generator) -> None:
    """One shot of a lazy Pauli-noise instruction on ``tab``, drawing from
    ``rng`` in the JAX package's order."""
    nm, pp = item["name"], item["p"]
    qs = item["index"]
    if nm == "depolarize2":
        for g in range(0, len(qs), 2):
            if rng.random() < pp:
                w = int(rng.integers(1, 16))  # the 15 non-identity pairs
                pa, pb = w // 4, w % 4
                if pa:
                    getattr(tab, _PAULIS1[pa - 1])(qs[g])
                if pb:
                    getattr(tab, _PAULIS1[pb - 1])(qs[g + 1])
        return
    for q in qs:
        if rng.random() >= pp:
            continue
        if nm == "x_error":
            tab.x_gate(q)
        elif nm == "y_error":
            tab.y_gate(q)
        elif nm == "z_error":
            tab.z_gate(q)
        else:  # depolarize1
            getattr(tab, _PAULIS1[int(rng.integers(3))])(q)
