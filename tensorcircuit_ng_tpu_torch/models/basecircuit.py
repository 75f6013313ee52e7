"""Dense-engine circuit layer of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/basecircuit.py``, the subset
of the fused TFIM path: the state is a flat ``(2^n,)`` torch tensor on the
circuit's device, folded over the QIR when it is asked for.  A leading
``h_layer`` on |0...0> folds to the uniform state, and runs of consecutive
``zzrx_layer`` items with the same pairs go to the multi-layer kernels.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..core import kernels, statevec
from ..ops.gates import GATES, Gate
from .abstractcircuit import AbstractCircuit

__all__ = ["BaseCircuit"]

#: gates applied by the diagonal fast path (broadcast multiply, no matmul)
_DIAGONAL_GATES = frozenset(
    ["z", "s", "sd", "t", "td", "rz", "rzz", "cz", "cphase", "phase", "mid_measurement"]
)


class BaseCircuit(AbstractCircuit):
    def __init__(
        self,
        nqubits: int,
        inputs: Optional[Any] = None,
        dim: int = 2,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        super().__init__()
        self._nqubits = nqubits
        self._d = dim
        self._device = config.resolve_device(device)
        self._inputs = inputs
        self._state_cache: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _param(self, x: Any) -> torch.Tensor:
        """A flat parameter tensor on the circuit's device (keeps autograd)."""
        return torch.reshape(torch.as_tensor(x, device=self._device), (-1,))

    def _append(self, item: Dict[str, Any]) -> None:
        self._qir.append(item)
        self._state_cache = None

    # ------------------------------------------------------------------
    # state computation
    # ------------------------------------------------------------------

    def _initial_state(self) -> torch.Tensor:
        return statevec.init_state(
            self._nqubits, d=self._d, inputs=self._inputs, device=self._device
        )

    def apply_general_gate(
        self,
        gate: Any,
        *index: int,
        name: Optional[str] = None,
        split: Optional[Dict[str, Any]] = None,
        mpo: bool = False,
        ir_dict: Optional[Dict[str, Any]] = None,
    ) -> None:
        if not isinstance(gate, Gate):
            gate = Gate(gate, name=name or "any")
        index = tuple(int(i) % self._nqubits for i in index)
        if len(set(index)) != len(index):
            raise ValueError(f"duplicate qubit indices in gate application: {index}")
        if ir_dict is None:
            ir_dict = {
                "gatef": None,
                "gate": gate,
                "index": index,
                "name": name or gate.name,
                "split": split,
                "mpo": mpo,
            }
        else:
            ir_dict = dict(ir_dict)
            ir_dict["index"] = index
        if (ir_dict.get("name") or "").lower() in _DIAGONAL_GATES:
            ir_dict["diagonal"] = True
        self._append(ir_dict)

    def _compute_state(self) -> torch.Tensor:
        return self._run_groups(self._grouped_qir())

    def _run_groups(self, groups: List[Any]) -> torch.Tensor:
        psi = None
        if (
            self._inputs is None
            and self._d == 2
            and groups
            and isinstance(groups[0], dict)
            and groups[0].get("h_fold")
        ):
            # H^n |0...0> is the uniform state: fold it to a constant
            dim = 2**self._nqubits
            cdt = config.torch_dtype()
            rdt = torch.float64 if cdt == torch.complex128 else torch.float32
            psi = torch.full(
                (dim,), 1.0 / math.sqrt(dim), dtype=rdt, device=self._device
            ).to(cdt)
            groups = groups[1:]
        if psi is None:
            psi = self._initial_state()
        for group in groups:
            if isinstance(group, list):  # consecutive zzrx layers, same pairs
                zz = torch.stack([it["zz_thetas"] for it in group])
                rx = torch.stack([it["rx_thetas"] for it in group])
                psi = kernels.fused_zzrx_multilayer(psi, group[0]["pairs"], zz, rx)
            else:
                psi = self._apply_item(psi, group)
        return psi

    def _grouped_qir(self) -> List[Any]:
        """QIR with runs of >= 2 consecutive ``zzrx_layer`` items (identical
        pairs) collected into lists."""
        out: List[Any] = []
        run: List[Dict[str, Any]] = []

        def flush():
            nonlocal run
            if len(run) >= 2:
                out.append(run)
            else:
                out.extend(run)
            run = []

        for item in self._qir:
            if item.get("zzrx_layer"):
                if run and run[0]["pairs"] != item["pairs"]:
                    flush()
                run.append(item)
            else:
                flush()
                out.append(item)
        flush()
        return out

    def _apply_item(self, psi: torch.Tensor, item: Dict[str, Any]) -> torch.Tensor:
        if item.get("fused_1q_layer"):
            return kernels.fused_single_qubit_layer(
                psi, item["gates"], constant=bool(item.get("constant"))
            )
        if item.get("zz_product"):
            return statevec.apply_zz_product_phase(psi, item["pairs"], item["thetas"])
        if item.get("zzrx_layer"):
            return kernels.fused_zzrx_layer(
                psi, item["pairs"], item["zz_thetas"], item["rx_thetas"]
            )
        k = len(item["index"])
        gate = item["gate"].tensor
        if item.get("diagonal"):
            dim = self._d**k
            if isinstance(gate, torch.Tensor):
                diag = torch.diagonal(torch.reshape(gate, (dim, dim)))
            else:
                diag = np.diagonal(np.reshape(gate, (dim, dim)))
            return statevec.apply_diagonal(psi, diag, item["index"], self._d)
        return statevec.apply_unitary(psi, gate, item["index"], self._d)

    # ------------------------------------------------------------------
    # fused layers
    # ------------------------------------------------------------------

    def fused_single_qubit_layer(
        self, gates: Any, name: str = "fused_1q_layer", constant: bool = False
    ) -> None:
        """Apply gates[q] on every qubit q in one fused pass."""
        if not isinstance(gates, torch.Tensor):
            gates = np.asarray(gates).astype(config.np_dtype())
        assert gates.shape[0] == self._nqubits
        self._append(
            {
                "fused_1q_layer": True,
                "gates": gates,
                "index": tuple(range(self._nqubits)),
                "name": name,
                "constant": bool(constant),
                "split": None,
                "mpo": False,
            }
        )

    def h_layer(self) -> None:
        """Hadamard on every qubit, fused (folded on |0...0>)."""
        h = GATES["h"]().matrix()
        self.fused_single_qubit_layer(
            np.broadcast_to(h, (self._nqubits, 2, 2)), name="h_layer", constant=True
        )
        # only this method marks the item for the uniform-state fold
        self._qir[-1]["h_fold"] = True

    def rzz_product(self, pairs: Sequence[Tuple[int, int]], thetas: Any) -> None:
        """exp(-i/2 Σ θ_k Z_a Z_b) over all listed pairs in one pass."""
        self._append(
            {
                "zz_product": True,
                "pairs": [(int(a), int(b)) for a, b in pairs],
                "thetas": self._param(thetas),
                "index": tuple(sorted({q for p_ in pairs for q in p_})),
                "name": "rzz_product",
                "split": None,
                "mpo": False,
            }
        )

    def zzrx_layer(
        self, pairs: Sequence[Tuple[int, int]], zz_thetas: Any, rx_thetas: Any
    ) -> None:
        """Fused TFIM layer: exp(-i/2 Σ θ_k Z_a Z_b) then rx on every qubit;
        equals ``rzz_product(pairs, zz_thetas)`` then rx(rx_thetas[q]) on
        each qubit q."""
        self._append(
            {
                "zzrx_layer": True,
                "pairs": [(int(a), int(b)) for a, b in pairs],
                "zz_thetas": self._param(zz_thetas),
                "rx_thetas": self._param(rx_thetas),
                "index": tuple(range(self._nqubits)),
                "name": "zzrx_layer",
                "split": None,
                "mpo": False,
            }
        )

    # ------------------------------------------------------------------
    # readout
    # ------------------------------------------------------------------

    def expectation_zz_sum(
        self, pairs: Sequence[Tuple[int, int]], weights: Optional[Any] = None
    ) -> torch.Tensor:
        return statevec.expectation_zz_sum(self.state(), pairs, weights)

    def expectation_x_sum(self, wires: Optional[Sequence[int]] = None) -> torch.Tensor:
        return statevec.expectation_x_sum(self.state(), wires)

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        return statevec.expectation_ps(self.state(), x, y, z)

    def expectation_ising_sum(
        self,
        zz_terms: Optional[Sequence[Any]] = None,
        z_terms: Optional[Sequence[Any]] = None,
        x_terms: Any = None,
    ) -> torch.Tensor:
        """⟨Σ w_s Π_{q∈s} Z_q + Σ w_q X_q⟩ in one fused readout.

        When the circuit ends in a run of >= 2 ``zzrx_layer`` items, the
        layers and the readout evaluate together on float32 planes
        (:func:`kernels.fused_zzrx_multilayer_energy`); otherwise the
        readout runs as block sandwiches on the dense state."""
        spec = kernels.ising_readout_spec(self._nqubits, zz_terms, z_terms, x_terms)
        groups = self._grouped_qir()
        if self._d == 2 and groups and isinstance(groups[-1], list):
            run = groups[-1]
            psi = self._run_groups(groups[:-1])
            zz = torch.stack([it["zz_thetas"] for it in run])
            rx = torch.stack([it["rx_thetas"] for it in run])
            return kernels.fused_zzrx_multilayer_energy(
                psi, run[0]["pairs"], zz, rx, spec
            )
        return kernels.ising_energy_dense(self.state(), self._nqubits, spec)

    def expectation_zzx_energy(
        self,
        pairs: Optional[Sequence[Tuple[int, int]]] = None,
        zz_weight: float = 1.0,
        x_weight: float = 1.0,
    ) -> torch.Tensor:
        """``zz_weight·Σ_pairs ⟨Z_a Z_b⟩ + x_weight·Σ_q ⟨X_q⟩`` fused readout."""
        zz = [(int(a), int(b), float(zz_weight)) for a, b in (pairs or ())]
        xs = [(q, float(x_weight)) for q in range(self._nqubits)] if x_weight else None
        return self.expectation_ising_sum(zz_terms=zz, x_terms=xs)

    def state(self, form: str = "default", reuse: bool = True) -> torch.Tensor:
        """The output state (flat), cached until the next gate application;
        ``form="tensor"`` reshapes to ``(d,)*n``."""
        s = self._state_cache if reuse else None
        if s is None:
            s = self._compute_state()
            if reuse:
                self._state_cache = s
        if form == "tensor":
            return torch.reshape(s, (self._d,) * self._nqubits)
        return s
