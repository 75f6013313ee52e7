"""Node-free circuit IR: the QIR instruction list is the circuit.

Counterpart of ``tensorcircuit_ng_tpu/models/abstractcircuit.py``: the gate
methods (every name of the gate registry, lower and upper case, with
broadcast over index sequences), ``any``/``unitary``, the QIR round trip
(``to_qir``, ``from_qir``, ``append_from_qir``) for the items the port's
engine knows, and gate counts.
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


class AbstractCircuit:
    """Gate bookkeeping shared by the port's simulators."""

    _nqubits: int
    _d: int

    sgates = list(gates_mod.FIXED_GATE_NAMES)
    vgates = list(gates_mod.VARIABLE_GATE_NAMES)
    gate_aliases = dict(gates_mod.GATE_ALIASES)

    def __init__(self) -> None:
        self._qir: List[Dict[str, Any]] = []

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
        gatef = item.get("gatef")
        if gatef is None:
            self.any(*index, unitary=item["gate"].tensor, name=item.get("name", "any"))
        else:
            self._apply_gate_instance(
                gatef, *index, name=item.get("name", gatef.name), split=item.get("split"),
                **item.get("parameters", {}),
            )

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

    def gate_summary(self) -> Dict[str, int]:
        """QIR item count by name."""
        summary: Dict[str, int] = {}
        for item in self._qir:
            name = item.get("name") or "any"
            summary[name] = summary.get(name, 0) + 1
        return summary


AbstractCircuit._meta_apply()
