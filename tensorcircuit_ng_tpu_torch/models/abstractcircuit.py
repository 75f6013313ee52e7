"""Node-free circuit IR: the QIR instruction list is the circuit.

Counterpart of ``tensorcircuit_ng_tpu/models/abstractcircuit.py``: the gate
methods (every name of the gate registry, lower and upper case, with
broadcast over index sequences), ``any``/``unitary``, the QIR round trip
(``to_qir``, ``from_qir``, ``append_from_qir``) for the items the port's
engine knows, copies, composition, remapping and the inverse circuit, gate
counts, the recorded hardware instructions, ``expectation_structures``
(``expectation_ps`` itself lives with the state, in ``basecircuit.py``), and
the I/O methods over ``translation.py`` and ``vis.py`` (OpenQASM, JSON,
qsim files, qiskit and cirq, ``draw`` and ``vis_tex``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..ops import gates as gates_mod
from ..ops.gates import Gate, GateF

__all__ = ["AbstractCircuit"]


def _is_sequence(x: Any) -> bool:
    return isinstance(x, (list, tuple, range, np.ndarray))


def _remap_qir_item(item: Dict[str, Any], mapping: Dict[int, int], n_new: int) -> Dict[str, Any]:
    """A QIR item with its qubits renamed through ``mapping``.

    Layer items carry wires outside ``index`` (``pairs``, renamed in place,
    each keeping its parameter) and full-register per-qubit parameters
    (``rx_thetas``, ``gates``, and ``thetas`` of rx and fused one-qubit
    layers), which are permuted: that needs ``mapping`` to be a bijection of
    the new register, else ValueError.  A tensor is permuted by an index
    tensor on its own device (kept there, like a gate constant), so
    autograd reaches the original angles."""
    new_item = dict(item)
    if "index" in item:
        new_item["index"] = tuple(mapping[int(q)] for q in item["index"])
    if item.get("pairs") is not None:
        new_item["pairs"] = [(mapping[int(a)], mapping[int(b)]) for a, b in item["pairs"]]
    keys = [k for k in ("rx_thetas", "gates") if item.get(k) is not None]
    if (item.get("rx_layer") or item.get("fused_1q_layer")) and item.get("thetas") is not None:
        keys.append("thetas")
    for key in keys:
        arr = item[key]
        if len(mapping) != n_new or sorted(mapping.values()) != list(range(n_new)) or arr.shape[0] != n_new:
            raise ValueError(
                f"cannot remap fused-layer item {item.get('name')!r}: "
                "per-qubit parameters need a full-register bijection"
            )
        perm = np.zeros(n_new, dtype=np.int64)
        for logical, physical in mapping.items():
            perm[int(physical)] = int(logical)
        if isinstance(arr, torch.Tensor):
            new_item[key] = arr[config.device_constant(perm, arr.device, torch.int64)]
        else:
            new_item[key] = np.asarray(arr)[perm]
    return new_item


class AbstractCircuit:
    """Gate bookkeeping shared by the port's simulators."""

    is_dm = False  # a density-matrix circuit (doubled wires) sets it
    _nqubits: int
    _d: int

    sgates = list(gates_mod.FIXED_GATE_NAMES)
    vgates = list(gates_mod.VARIABLE_GATE_NAMES)
    mpogates = ["multicontrol", "mpo"]
    diaggates = ["diagonal", "rzm", "cmz"]
    gate_aliases = dict(gates_mod.GATE_ALIASES)

    def __init__(self) -> None:
        self._qir: List[Dict[str, Any]] = []
        self._extra_qir: List[Dict[str, Any]] = []

    def apply_general_gate(
        self,
        gate: Any,
        *index: int,
        name: Optional[str] = None,
        split: Optional[Dict[str, Any]] = None,
        mpo: bool = False,
        ir_dict: Optional[Dict[str, Any]] = None,
    ) -> None:
        raise NotImplementedError  # engine-specific

    def _apply_gate_instance(
        self,
        gatef: GateF,
        *index: Any,
        name: str,
        split: Optional[Dict[str, Any]] = None,
        **params: Any,
    ) -> None:
        """Build the gate and record it; index sequences broadcast
        elementwise (``c.cnot(range(3), range(1, 4))``), and a parameter
        sequence of the same length gives each application its entry."""
        if index and _is_sequence(index[0]):
            seqs = [list(i) if _is_sequence(i) else None for i in index]
            length = len(seqs[0])
            if any(s is not None and len(s) != length for s in seqs):
                raise ValueError("mismatched index sequence lengths")
            for pos in range(length):
                idx_i = tuple(
                    seqs[j][pos] if seqs[j] is not None else index[j] for j in range(len(index))
                )
                params_i = {}
                for key, val in params.items():
                    per_index = (_is_sequence(val) and len(val) == length) or (
                        getattr(val, "ndim", 0) >= 1 and val.shape[0] == length
                    )
                    params_i[key] = val[pos] if per_index else val
                self._apply_gate_instance(gatef, *idx_i, name=name, split=split, **params_i)
            return
        index = tuple(int(i) for i in index)
        gate = gatef(**params) if params else gatef()
        ir_dict = {
            "gatef": gatef,
            "gate": gate,
            "index": index,
            "name": name,
            "split": split,
            "mpo": False,
        }
        if params:
            ir_dict["parameters"] = dict(params)
        self.apply_general_gate(gate, *index, name=name, split=split, ir_dict=ir_dict)

    @classmethod
    def _meta_apply(cls) -> None:
        """Install every gate of the registry as a method, lower and upper
        case: ``c.cnot(0, 1)``, ``c.RX(2, theta=0.3)``."""

        def make_method(gname: str, gatef: GateF) -> Callable[..., None]:
            def method(self: "AbstractCircuit", *index: Any, **params: Any) -> None:
                split = params.pop("split", None)
                params.pop("name", None)
                self._apply_gate_instance(gatef, *index, name=gname, split=split, **params)

            method.__name__ = gname
            method.__doc__ = (
                f"Apply the **{gname}** gate on the given qubit indices."
                "\n\nIndex arguments may be sequences (elementwise broadcast)."
            )
            return method

        for gname, gatef in gates_mod.GATES.items():
            m = make_method(gname, gatef)
            setattr(cls, gname, m)
            setattr(cls, gname.upper(), m)

    def any(self, *index: int, unitary: Any, name: str = "any", **kws: Any) -> None:
        """Apply an arbitrary dense gate given its matrix or tensor."""
        k = len(index)
        shape = (self._d,) * (2 * k)
        if isinstance(unitary, torch.Tensor):
            tensor = torch.reshape(unitary.to(config.torch_dtype()), shape)
        else:
            tensor = np.reshape(np.asarray(unitary).astype(config.np_dtype()), shape)
        gate = Gate(tensor, name=name)
        ir_dict = {
            "gatef": None,
            "gate": gate,
            "index": tuple(int(i) for i in index),
            "name": name,
            "split": kws.get("split"),
            "mpo": False,
            "parameters": {"unitary": tensor},
        }
        self.apply_general_gate(gate, *ir_dict["index"], name=name, split=kws.get("split"), ir_dict=ir_dict)

    unitary = any
    ANY = any
    UNITARY = any

    # ------------------------------------------------------------------
    # QIR
    # ------------------------------------------------------------------

    def to_qir(self) -> List[Dict[str, Any]]:
        """The circuit's intermediate representation (a list of dicts)."""
        return self._qir

    @classmethod
    def from_qir(
        cls, qir: List[Dict[str, Any]], circuit_params: Optional[Dict[str, Any]] = None
    ) -> "AbstractCircuit":
        """Rebuild a circuit from QIR; ``nqubits`` defaults to the widest
        index used."""
        circuit_params = dict(circuit_params or {})
        if "nqubits" not in circuit_params:
            circuit_params["nqubits"] = max((max(item["index"]) + 1 for item in qir), default=0)
        c = cls(**circuit_params)  # type: ignore[call-arg]
        c.append_from_qir(qir)
        return c

    def append_from_qir(self, qir: List[Dict[str, Any]]) -> "AbstractCircuit":
        for item in qir:
            self._apply_qir_item(item)
        return self

    def _apply_qir_item(self, item: Dict[str, Any]) -> None:
        index = item["index"]
        if item.get("fused_1q_layer"):
            if item.get("h_fold"):
                self.h_layer()  # type: ignore[attr-defined]
            else:
                self.fused_single_qubit_layer(  # type: ignore[attr-defined]
                    item["gates"], name=item.get("name", "fused_1q_layer"),
                    constant=bool(item.get("constant")),
                )
            return
        if item.get("zz_product"):
            self.rzz_product(item["pairs"], item["thetas"])  # type: ignore[attr-defined]
            return
        if item.get("rx_layer"):
            self.rx_layer(item["thetas"])  # type: ignore[attr-defined]
            return
        if item.get("zzrx_layer"):
            self.zzrx_layer(item["pairs"], item["zz_thetas"], item["rx_thetas"])  # type: ignore[attr-defined]
            return
        if item.get("multicz"):
            self.multicz(*index)  # type: ignore[attr-defined]
            return
        if item.get("zstring_rot"):
            self.rzm(*index, theta=item["theta"])  # type: ignore[attr-defined]
            return
        if item.get("cond_collapse"):
            self.cond_measurement(*index, status=item.get("status"))  # type: ignore[attr-defined]
            return
        if item.get("is_channel"):
            self.general_kraus(  # type: ignore[attr-defined]
                item["channel_kraus"], *index, status=item.get("channel_status"), name=item.get("name")
            )
            return
        gatef = item.get("gatef")
        if gatef is None:
            self.any(*index, unitary=item["gate"].tensor, name=item.get("name", "any"))
        else:
            self._apply_gate_instance(
                gatef, *index, name=item.get("name", gatef.name), split=item.get("split"),
                **item.get("parameters", {}),
            )

    # ------------------------------------------------------------------
    # translation, drawing
    # ------------------------------------------------------------------

    def to_openqasm(self, **kws: Any) -> str:
        """OpenQASM 2.0 text of the circuit's per-gate QIR."""
        from ..translation import circuit_to_qasm

        return circuit_to_qasm(self)

    def to_openqasm_file(self, file: str, **kws: Any) -> None:
        with open(file, "w") as f:
            f.write(self.to_openqasm(**kws))

    @classmethod
    def from_openqasm(cls, qasm: str, **kws: Any) -> "AbstractCircuit":
        """The circuit of OpenQASM 2.0 text; ``kws`` (e.g. ``device=``) go
        to the constructor."""
        from ..translation import qasm2tc

        return qasm2tc(qasm, circuit_class=cls, **kws)

    @classmethod
    def from_openqasm_file(cls, file: str, **kws: Any) -> "AbstractCircuit":
        with open(file) as f:
            return cls.from_openqasm(f.read(), **kws)

    def to_json(self, simplified: bool = False, file: Optional[str] = None) -> str:
        """The circuit as JSON text (``translation.circuit_to_json``),
        also written to ``file`` when given."""
        from ..translation import circuit_to_json

        s = circuit_to_json(self, simplified=simplified, as_str=True)
        if file is not None:
            with open(file, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, data: Any, **kws: Any) -> "AbstractCircuit":
        """The circuit of :meth:`to_json`'s text (or its dict); ``kws``
        (e.g. ``device=``) go to the constructor."""
        from ..translation import circuit_from_json

        return circuit_from_json(data, circuit_class=cls, **kws)

    @classmethod
    def from_json_file(cls, file: str, **kws: Any) -> "AbstractCircuit":
        with open(file) as f:
            return cls.from_json(f.read(), **kws)

    def to_qiskit(self, **kws: Any) -> Any:
        """A ``qiskit.QuantumCircuit`` by the OpenQASM text (needs qiskit)."""
        from qiskit import QuantumCircuit  # type: ignore

        return QuantumCircuit.from_qasm_str(self.to_openqasm())

    @classmethod
    def from_qiskit(cls, qc: Any, **kws: Any) -> "AbstractCircuit":
        from ..translation import get_qiskit_qasm

        return cls.from_openqasm(get_qiskit_qasm(qc), **kws)

    def to_cirq(self, **kws: Any) -> Any:
        """A ``cirq.Circuit`` (needs cirq)."""
        from ..translation import qir2cirq

        return qir2cirq(self.to_qir(), self._nqubits)

    @classmethod
    def from_cirq(cls, qc: Any, **kws: Any) -> "AbstractCircuit":
        from ..translation import cirq2tc

        return cirq2tc(qc, circuit_class=cls, **kws)

    @classmethod
    def from_qsim_file(cls, file: str, **kws: Any) -> "AbstractCircuit":
        """The circuit of a qsim file: the width on the first line, then
        ``cycle gate q [q2] [angles]`` a line (``rx``/``ry``/``rz``,
        ``fs``/``fsim``, ``x_1_2``, ``y_1_2``, ``hz_1_2``/``w_1_2`` and the
        named gates); ``kws`` (e.g. ``device=``) go to the constructor."""
        with open(file) as f:
            lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        c = cls(int(lines[0]), **kws)
        for ln in lines[1:]:
            parts = ln.split()
            name = parts[1].lower()
            rest = parts[2:]
            if name in ("rz", "rx", "ry"):
                getattr(c, name)(int(rest[0]), theta=float(rest[1]))
            elif name in ("fs", "fsim"):
                theta, phi = float(rest[2]), float(rest[3])
                m = np.eye(4, dtype=complex)
                m[1, 1] = m[2, 2] = np.cos(theta)
                m[1, 2] = m[2, 1] = -1j * np.sin(theta)
                m[3, 3] = np.exp(-1j * phi)
                c.any(int(rest[0]), int(rest[1]), unitary=m, name="fsim")
            elif name == "x_1_2":
                c.rx(int(rest[0]), theta=np.pi / 2)
            elif name == "y_1_2":
                c.ry(int(rest[0]), theta=np.pi / 2)
            elif name in ("hz_1_2", "w_1_2"):
                w = np.array([[1, -np.sqrt(1j)], [np.sqrt(-1j), 1]]) / np.sqrt(2)
                c.any(int(rest[0]), unitary=w, name="w_1_2")
            else:
                getattr(c, name)(*[int(x) for x in rest])
        return c

    def draw(self, output: Optional[str] = None, **kws: Any) -> Any:
        """The qiskit drawing where qiskit is installed, else a text wire
        diagram of the QIR, one line a qubit."""
        try:
            return self.to_qiskit().draw(output=output, **kws)
        except Exception:
            lines = [f"q{q}: -" for q in range(self._nqubits)]
            for item in self._qir:
                width = max(len(item.get("name") or "?"), 1)
                touched = set(item["index"])
                for q in range(self._nqubits):
                    if q in touched:
                        lines[q] += f"[{item.get('name')}]-"
                    else:
                        lines[q] += "-" * (width + 3)
            return "\n".join(lines)

    def vis_tex(self, **kws: Any) -> str:
        """quantikz LaTeX of the QIR (``vis.qir2tex``)."""
        from ..vis import qir2tex

        return qir2tex(self.to_qir(), self._nqubits, **kws)

    def get_positional_logical_mapping(self) -> Dict[int, int]:
        """Position in a measured bitstring -> logical qubit: the identity,
        or the qubits of the recorded measure instructions in order."""
        measured = [
            item["index"][0]
            for item in self._extra_qir + self._qir
            if item.get("measure") or item.get("name") == "measure"
        ]
        if not measured:
            return {i: i for i in range(self._nqubits)}
        return dict(enumerate(measured))

    # ------------------------------------------------------------------
    # composition, copies, remapping, inverse
    # ------------------------------------------------------------------

    def _new_params(self, circuit_params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """``circuit_params`` with the device of this circuit unless it
        names one (a port circuit lands on the configured device else)."""
        params = {k: v for k, v in self._copy_params().items() if k == "device"}  # type: ignore[attr-defined]
        params.update(circuit_params or {})
        return params

    def compose(self, other: "AbstractCircuit", indices: Optional[Sequence[int]] = None) -> "AbstractCircuit":
        """Append ``other`` (in place, returns self), its qubit i placed on
        ``indices[i]`` when given."""
        qir = other.to_qir()
        if indices is not None:
            mapping = {i: int(j) for i, j in enumerate(indices)}
            qir = [_remap_qir_item(item, mapping, self._nqubits) for item in qir]
        return self.append_from_qir([dict(item) for item in qir])

    def initial_mapping(
        self,
        logical_physical_mapping: Dict[int, int],
        n: Optional[int] = None,
        circuit_params: Optional[Dict[str, Any]] = None,
    ) -> "AbstractCircuit":
        """A new circuit with logical qubit q on ``logical_physical_mapping[q]``
        (on this circuit's device; no input state)."""
        circuit_params = self._new_params(circuit_params)
        circuit_params.setdefault("nqubits", self._nqubits if n is None else n)
        c = type(self)(**circuit_params)  # type: ignore[call-arg]
        for item in self._qir:
            c._apply_qir_item(_remap_qir_item(item, logical_physical_mapping, circuit_params["nqubits"]))
        return c

    def inverse(self, circuit_params: Optional[Dict[str, Any]] = None) -> "AbstractCircuit":
        """The adjoint circuit, from |0...0> (the inputs are dropped): the
        expanded QIR in reverse, each gate as ``any`` named ``name + "d"``
        with its conjugate transpose (a tensor gate keeps autograd);
        ``multicz`` is its own inverse, a wide ``rzm`` negates its angle,
        and channel items (``general_kraus``, ``cond_measurement``) are
        left out."""
        if circuit_params is None:
            circuit_params = dict(self._copy_params())  # type: ignore[attr-defined]
            circuit_params.pop("inputs", None)
        circuit_params = self._new_params(circuit_params)
        circuit_params.setdefault("nqubits", self._nqubits)
        c = type(self)(**circuit_params)  # type: ignore[call-arg]
        for item in reversed(self._expanded_qir()):  # type: ignore[attr-defined]
            if item.get("is_channel"):
                continue  # a channel or a measurement with collapse has no adjoint
            if item.get("multicz"):
                c.multicz(*item["index"])  # type: ignore[attr-defined]
            elif item.get("gate") is None and item.get("gatef") is None:
                params = item.get("parameters") or {}
                if "theta" in params:
                    getattr(c, item["name"])(*item["index"], theta=-params["theta"])
                else:
                    getattr(c, item["name"])(*item["index"])
            else:
                m = item["gate"].matrix()
                c.any(*item["index"], unitary=m.T.conj(), name=(item.get("name") or "any") + "d")
        return c

    def append(self, c: "AbstractCircuit", indices: Optional[Sequence[int]] = None) -> "AbstractCircuit":
        """Append ``c`` after this circuit (in place, returns self); with
        ``indices`` only each item's ``index`` is renamed, so a fused layer
        of a smaller circuit fails."""
        for item in c.to_qir():
            new_item = dict(item)
            if indices is not None:
                new_item["index"] = tuple(indices[i] for i in item["index"])
            self._apply_qir_item(new_item)
        return self

    def prepend(self, c: "AbstractCircuit") -> "AbstractCircuit":
        """A new circuit: a copy of ``c``, then this circuit."""
        new = c.copy()
        new.append(self)
        return new

    def copy(self) -> "AbstractCircuit":
        c = type(self)(**self._copy_params())  # type: ignore[attr-defined]
        c.append_from_qir([dict(item) for item in self._qir])
        return c

    # ------------------------------------------------------------------
    # counts
    # ------------------------------------------------------------------

    @property
    def nqubits(self) -> int:
        return self._nqubits

    def gate_count(self, gate_list: Optional[Sequence[str]] = None) -> int:
        """The number of QIR items, or of those named in ``gate_list``
        (aliases count as their gate)."""
        if gate_list is None:
            return len(self._qir)
        wanted = {self.gate_aliases.get(g.lower(), g.lower()) for g in gate_list}
        return sum(
            1 for item in self._qir
            if self.gate_aliases.get((item.get("name") or "").lower(), (item.get("name") or "").lower()) in wanted
        )

    def gate_count_by_condition(self, cond_func: Callable[[Dict[str, Any]], bool]) -> int:
        """The number of QIR items for which ``cond_func`` is true."""
        return sum(1 for item in self._qir if cond_func(item))

    def gate_summary(self) -> Dict[str, int]:
        """QIR item count by name."""
        summary: Dict[str, int] = {}
        for item in self._qir:
            name = item.get("name") or "any"
            summary[name] = summary.get(name, 0) + 1
        return summary

    def count_flop(self) -> int:
        """A rough FLOP count of the dense forward pass: 8 d^(n+k) an item
        on k wires (a fused layer counts as an n-wire gate)."""
        return sum(8 * self._d ** (self._nqubits + len(item["index"])) for item in self._qir)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(nqubits={self._nqubits}, ngates={len(self._qir)})"

    # ------------------------------------------------------------------
    # hardware instructions (recorded beside the QIR, not simulated)
    # ------------------------------------------------------------------

    def _instruction(self, name: str, index: Sequence[int]) -> None:
        self._extra_qir.append({"name": name, "index": tuple(index), "pos": len(self._qir)})

    def measure_instruction(self, *index: int) -> None:
        self._instruction("measure", index)

    def reset_instruction(self, *index: int) -> None:
        self._instruction("reset", index)

    def barrier_instruction(self, *index: int) -> None:
        self._instruction("barrier", index)

    def pauli_instruction(self, *index: int, p: Any = None, **kws: Any) -> None:
        """Record a one-qubit Pauli channel instruction with probabilities ``p``."""
        self._extra_qir.append({"name": "pauli", "index": tuple(index), "p": p, "pos": len(self._qir), **kws})

    def pauli2_instruction(self, *index: int, p: Any = None, **kws: Any) -> None:
        self._extra_qir.append({"name": "pauli2", "index": tuple(index), "p": p, "pos": len(self._qir), **kws})

    def depolarizing_instruction(self, *index: int, p: float = 0.0, **kws: Any) -> None:
        self._extra_qir.append({"name": "depolarizing", "index": tuple(index), "p": p, "pos": len(self._qir), **kws})

    def depolarizing2_instruction(self, *index: int, p: float = 0.0, **kws: Any) -> None:
        self._extra_qir.append({"name": "depolarizing2", "index": tuple(index), "p": p, "pos": len(self._qir), **kws})

    def mr_instruction(self, *index: int, **kws: Any) -> None:
        """Record a measure-and-reset instruction."""
        self._extra_qir.append({"name": "mr", "index": tuple(index), "pos": len(self._qir), **kws})

    # ------------------------------------------------------------------
    # expectation sugar and gate-factory plumbing
    # ------------------------------------------------------------------

    def expectation_structures(self, structures: Any, weights: Any, **kws: Any) -> Any:
        """Σ_s w_s ⟨P_s⟩ over Pauli strings given as ``ps`` lists (0/1/2/3
        for I/X/Y/Z a qubit)."""
        total = 0.0
        for s, w in zip(structures, weights):
            total = total + w * self.expectation_ps(ps=s, **kws)  # type: ignore[attr-defined]
        return total

    @staticmethod
    def apply_general_gate_delayed(gatef: Any, name: Optional[str] = None, mpo: bool = False) -> Any:
        """An unbound method that applies the gates of ``gatef``."""

        def apply(self: "AbstractCircuit", *index: int, **kws: Any) -> None:
            self._apply_gate_instance(gatef, *index, name=name or getattr(gatef, "name", "any"), **kws)

        return apply

    @staticmethod
    def apply_general_variable_gate_delayed(gatef: Any, name: Optional[str] = None, mpo: bool = False) -> Any:
        """As :meth:`apply_general_gate_delayed`, for a parameterized gate."""
        return AbstractCircuit.apply_general_gate_delayed(gatef, name=name, mpo=mpo)

    @staticmethod
    def standardize_gate(name: str) -> str:
        """The canonical lower-case name of a gate alias."""
        name = name.lower()
        aliases = {"cx": "cnot", "toff": "toffoli", "ccx": "toffoli", "cswap": "fredkin", "sdg": "sd", "tdg": "td"}
        return aliases.get(name, name)


AbstractCircuit._meta_apply()

# the gate registry's names at module level, as the JAX package binds them
sgates = AbstractCircuit.sgates
vgates = AbstractCircuit.vgates
mpogates = AbstractCircuit.mpogates
diaggates = AbstractCircuit.diaggates
gate_aliases = AbstractCircuit.gate_aliases
defined_gates = list(dict.fromkeys(sgates + vgates + mpogates + diaggates + list(gate_aliases)))
