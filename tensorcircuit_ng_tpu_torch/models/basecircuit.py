"""Dense-engine circuit layer of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/basecircuit.py``: the state is
a flat ``(d^n,)`` torch tensor on the circuit's device, folded over the QIR
when it is asked for.  A leading ``h_layer`` on |0...0> folds to the
uniform state, runs of consecutive ``zzrx_layer`` items with the same pairs
go to the multi-layer kernels, and single-qubit layers (``rx/ry/rz_layer``,
``h_layer``, ``fused_single_qubit_layer``) to the row-layer kernels.
Measurement and sampling take their uniforms from ``status`` (as in the JAX
package) or from a ``torch.Generator`` on the circuit's device (the
caller's, or the backend's implicit one).  ``_expanded_qir`` unfolds the
fused layers into one gate a qubit or pair (for ``inverse`` and
``matrix``); the light-cone expectation applies the items that reach the
observable one by one, from |0...0>, without the fold or the grouping.

Above ``_DENSE_MAX_QUBITS`` = 30 qubits no 2^n object is made:
``amplitude`` and ``expectation`` contract the einsum IR of the expanded QIR
(``amplitude_before``, ``expectation_before``; light-cone pruned) on the
circuit's device, and ``sample`` draws each qubit in turn from planned
contractions of projector expectations.

The state of the first k QIR items is kept once computed, and the next
``state()`` applies only the items appended since: a trajectory whose
channels read the state at each channel (``general_kraus``, the replay of a
channel item) then costs each item once, not once a channel.  Anything
but an append (``replace_inputs``, a QIR item replaced or removed) drops
the kept state, which is used only under the autograd mode it was computed
in; ``state(reuse=False)`` computes from the first item.

A circuit built with ``mesh=`` (``Circuit``) holds a ``_mesh_engine``, the
sharded engine of ``parallel/sharded_state.py``: the state (and the kept
prefix) is then a ``ShardedState``, and ``state()``, ``expectation``,
``expectation_ps``, the Ising readouts, ``amplitude``, ``probability``,
``measure_jit`` and ``sample`` run on the shards without gathering them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from .. import quantum as qu
from ..backend import backend as K
from ..backend import check_generator, device_tensor
from ..core import kernels, statevec
from ..ops.gates import (
    GATES,
    Gate,
    multicontrol_matrix,
    rx_matrix,
    ry_matrix,
    rz_matrix,
    rzm_diagonal,
    rzz_matrix,
)
from .abstractcircuit import AbstractCircuit

__all__ = ["BaseCircuit"]

#: gates applied by the diagonal fast path (broadcast multiply, no matmul)
_DIAGONAL_GATES = frozenset(
    ["z", "s", "sd", "t", "td", "rz", "rzz", "cz", "cphase", "phase", "mid_measurement"]
)


class BaseCircuit(AbstractCircuit):
    is_dm = False
    #: set by ``Circuit(mesh=...)``: the sharded-statevector engine
    _mesh_engine: Optional[Any] = None

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
        #: (the prefix's items, autograd mode, state) of the kept prefix
        self._state_cache: Optional[Tuple[List[Dict[str, Any]], Tuple[bool, bool], torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _copy_params(self) -> Dict[str, Any]:
        return {"nqubits": self._nqubits, "inputs": self._inputs, "dim": self._d, "device": self._device}

    def _param(self, x: Any) -> torch.Tensor:
        """A flat parameter tensor on the circuit's device (keeps autograd;
        Python floats in the real dtype of the default complex dtype)."""
        return torch.reshape(statevec.real_tensor(x, self._device, config.torch_dtype()), (-1,))

    def _append(self, item: Dict[str, Any]) -> None:
        self._qir.append(item)  # the kept prefix state stays valid

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
        if self._mesh_engine is not None:
            return self._mesh_engine.run_groups(self._grouped_qir(), self._inputs)
        return self._run_groups(self._grouped_qir())

    def _extend_state(self, psi: torch.Tensor, items: List[Dict[str, Any]]) -> torch.Tensor:
        """``psi`` with ``items`` applied after it."""
        if self._mesh_engine is not None:
            return self._mesh_engine.run_groups(self._grouped_qir(items), psi=psi)
        return self._run_groups(self._grouped_qir(items), psi)

    def _kept_state(self) -> torch.Tensor:
        """The state of the whole QIR, from the kept prefix state when it
        is still the prefix of the QIR and was computed under the current
        autograd mode; kept again for the next call."""
        mode = (torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        kept = self._state_cache
        s = None
        if kept is not None:
            items, kmode, psi = kept
            k = len(items)
            if kmode == mode and 0 < k <= len(self._qir) and all(a is b for a, b in zip(items, self._qir)):
                s = psi if k == len(self._qir) else self._extend_state(psi, self._qir[k:])
        if s is None:
            s = self._compute_state()
        self._state_cache = (list(self._qir), mode, s)
        return s

    def _run_groups(self, groups: List[Any], psi: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (
            psi is None
            and self._inputs is None
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

    def _grouped_qir(self, items: Optional[List[Dict[str, Any]]] = None) -> List[Any]:
        """QIR (or ``items``) with runs of >= 2 consecutive ``zzrx_layer``
        items (identical pairs) collected into lists."""
        out: List[Any] = []
        run: List[Dict[str, Any]] = []

        def flush():
            nonlocal run
            if len(run) >= 2:
                out.append(run)
            else:
                out.extend(run)
            run = []

        for item in self._qir if items is None else items:
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
        if item.get("rx_layer"):
            return kernels.fused_rx_layer(psi, item["thetas"])
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
        if item.get("multicz"):
            return statevec.apply_multicz(psi, item["index"])
        if item.get("zstring_rot"):
            return statevec.apply_zstring_phase(psi, item["index"], item["theta"])
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

    def _expanded_qir(self, items: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
        """The QIR (or ``items``) with each fused item unfolded into plain gate items: an
        rx layer into n ``rx``, a zz product into one ``rzz`` a pair, a zzrx
        layer into both, a fused one-qubit layer into n ``fused1q``, and
        ``rzm``/``multicz`` on at most 8 wires into one diagonal matrix
        (wider ones stay as they are).  Tensor angles keep autograd."""
        cdt = config.dtypestr()

        def gate_item(gate, index, name, gatef=None, theta=None, diagonal=False):
            item = {"gatef": gatef, "gate": gate, "index": tuple(int(i) for i in index), "name": name,
                    "split": None, "mpo": False, "diagonal": diagonal}
            if theta is not None:
                item["parameters"] = {"theta": theta}
            return item

        def rzz_items(pairs, thetas):
            ms = rzz_matrix(thetas)
            return [gate_item(Gate(ms[k].reshape(2, 2, 2, 2), name="rzz"), (a, b), "rzz", GATES["rzz"], thetas[k], True)
                    for k, (a, b) in enumerate(pairs)]

        def rx_items(thetas):
            ms = rx_matrix(thetas)
            return [gate_item(Gate(ms[q], name="rx"), (q,), "rx", theta=thetas[q]) for q in range(self._nqubits)]

        out: List[Dict[str, Any]] = []
        for item in self._qir if items is None else items:
            k = len(item["index"])
            if item.get("rx_layer"):
                out.extend(rx_items(item["thetas"]))
            elif item.get("zstring_rot") and k <= 8:
                diag = rzm_diagonal(item["theta"], k, cdt)
                m = torch.diag(diag) if isinstance(diag, torch.Tensor) else np.diag(diag)
                out.append(gate_item(Gate(m, name="rzm"), item["index"], "rzm", diagonal=True))
            elif item.get("multicz") and k <= 8:
                m = multicontrol_matrix(np.diag([1.0, -1.0]), [1] * (k - 1))
                out.append(gate_item(Gate(m, name="multicz"), item["index"], "multicz", diagonal=True))
            elif item.get("fused_1q_layer"):
                out.extend(gate_item(Gate(item["gates"][q], name="any"), (q,), "fused1q") for q in range(self._nqubits))
            elif item.get("zz_product"):
                out.extend(rzz_items(item["pairs"], item["thetas"]))
            elif item.get("zzrx_layer"):
                out.extend(rzz_items(item["pairs"], item["zz_thetas"]))
                out.extend(rx_items(item["rx_thetas"]))
            else:
                out.append(item)
        return out

    # ------------------------------------------------------------------
    # fused layers
    # ------------------------------------------------------------------

    def multicz(self, *index: int) -> None:
        r"""Multi-controlled Z on ``index``: the sign flips where every wire
        is 1, one elementwise pass (no 2^k matrix)."""
        if len(index) == 1 and hasattr(index[0], "__len__"):
            index = tuple(index[0])  # multicz([0, 1, 2]) as well
        self._append(
            {
                "gatef": None,
                "gate": None,
                "index": tuple(int(i) % self._nqubits for i in index),
                "name": "multicz",
                "split": None,
                "mpo": False,
                "multicz": True,
            }
        )

    mcz = multicz
    cmz = multicz

    def rzm(self, *index: int, theta: Any = 0.0) -> None:
        r"""exp(-i θ/2 Z⊗...⊗Z) on ``index``, one diagonal parity mask."""
        if len(index) == 1 and hasattr(index[0], "__len__"):
            index = tuple(index[0])
        self._append(
            {
                "gatef": None,
                "gate": None,
                "index": tuple(int(i) % self._nqubits for i in index),
                "name": "rzm",
                "split": None,
                "mpo": False,
                "zstring_rot": True,
                "theta": theta,
                "parameters": {"theta": theta},
            }
        )

    def fused_single_qubit_layer(
        self, gates: Any, name: str = "fused_1q_layer", constant: bool = False
    ) -> None:
        """Apply gates[q] on every qubit q in one fused pass (unitary gates).

        ``constant=True`` marks non-trainable gates (``h_layer``): the
        backward then walks the cotangent only (K8).  Concrete gate stacks
        stay numpy; a tensor stack keeps autograd."""
        if isinstance(gates, torch.Tensor):
            gates = gates.to(device=self._device, dtype=config.torch_dtype())
        else:
            gates = np.asarray(gates).astype(config.np_dtype())
        if gates.shape[0] != self._nqubits:
            raise ValueError(f"one gate per qubit required: {gates.shape[0]} gates for {self._nqubits} qubits")
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

    def rx_layer(self, thetas: Any) -> None:
        """rx(thetas[q]) on every qubit, fused."""
        self._append(
            {
                "gatef": None,
                "gate": None,
                "index": tuple(range(self._nqubits)),
                "name": "rx_layer",
                "split": None,
                "mpo": False,
                "rx_layer": True,
                "thetas": self._param(thetas),
            }
        )

    def ry_layer(self, thetas: Any) -> None:
        """ry(thetas[q]) on every qubit, fused."""
        self.fused_single_qubit_layer(ry_matrix(self._param(thetas)), name="ry_layer")

    def rz_layer(self, thetas: Any) -> None:
        """rz(thetas[q]) on every qubit, fused."""
        self.fused_single_qubit_layer(rz_matrix(self._param(thetas)), name="rz_layer")

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
        ps: Optional[Sequence[int]] = None,
        reuse: bool = True,
        noise_conf: Optional[Any] = None,
        nmc: int = 1000,
        status: Optional[Any] = None,
        enable_lightcone: bool = False,
    ) -> torch.Tensor:
        """⟨X_x Y_y Z_z⟩ by slot flips and sign masks (no matmuls).  ``ps``,
        a length-n list of 0/1/2/3 for I/X/Y/Z, takes precedence over the
        x/y/z lists.  With ``noise_conf`` the noisy value of
        :func:`noisemodel.expectation_noisfy` for the Pauli gates
        (``nmc`` trajectories, or the rows of ``status``)."""
        if ps is not None:
            x, y, z = ([i for i, v in enumerate(ps) if v == p] for p in (1, 2, 3))
        if noise_conf is not None:
            return self._noisy_expectation(self._pauli_ops(x, y, z), noise_conf, nmc, status,
                                           enable_lightcone=enable_lightcone)
        if self._mesh_engine is not None:
            return self._mesh_engine.expectation_ps(self.state(reuse=reuse), x, y, z)
        dry = self._dense_debug()
        if dry is not None:
            return dry
        if enable_lightcone:
            psi = self._lightcone_state([int(q) for q in (*(x or ()), *(y or ()), *(z or ()))])
        else:
            psi = self.state(reuse=reuse)
        return statevec.expectation_ps(psi, x, y, z)

    @staticmethod
    def _pauli_ops(x: Optional[Sequence[int]], y: Optional[Sequence[int]], z: Optional[Sequence[int]]) -> List[Any]:
        """The Pauli gates of ⟨X_x Y_y Z_z⟩ as ``(gate, [wire])`` operators."""
        return [(GATES[name](), [int(q)]) for name, qs in (("x", x), ("y", y), ("z", z)) for q in qs or ()]

    def _noisy_expectation(self, ops: Sequence[Any], noise_conf: Any, nmc: int, status: Optional[Any],
                           enable_lightcone: bool = False) -> torch.Tensor:
        from .. import noisemodel

        kws = {"enable_lightcone": True} if enable_lightcone else {}
        return noisemodel.expectation_noisfy(self, *ops, noise_conf=noise_conf, nmc=nmc, status=status, **kws)

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
        if self._mesh_engine is not None:
            return self._mesh_engine.expectation_ising_sum(self.state(), spec)
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

    def expectation(
        self,
        *ops: Tuple[Any, Sequence[int]],
        reuse: bool = True,
        enable_lightcone: bool = False,
        noise_conf: Optional[Any] = None,
        nmc: int = 1000,
        status: Optional[Any] = None,
    ) -> torch.Tensor:
        """⟨psi| O_1 O_2 ... |psi⟩ with ``O_i = (operator, [wires])`` on the
        dense state; an operator is a ``Gate`` or a dense matrix or tensor.
        ``enable_lightcone`` builds the state from the items in the
        observables' causal cone only (:meth:`_lightcone_qir`).  Above 30
        qubits the light-cone pruned einsum IR is contracted instead.  With
        ``noise_conf`` the noisy value of :func:`noisemodel.expectation_noisfy`
        (``nmc`` trajectories, or the rows of ``status``)."""
        if noise_conf is not None:
            return self._noisy_expectation(ops, noise_conf, nmc, status)
        for op in ops:
            if not (isinstance(op, tuple) and len(op) == 2):
                raise ValueError("each op must be (operator, [wires])")
        if self._mesh_engine is not None:
            return self._mesh_engine.expectation(self.state(reuse=reuse), self._norm_ops(ops))
        if self._nqubits > self._DENSE_MAX_QUBITS:
            from ..core import contractor

            return contractor.contract_ir(self.expectation_before(*ops))
        norm_ops = self._norm_ops(ops)
        dry = self._dense_debug()
        if dry is not None:
            return dry
        if enable_lightcone:
            psi = self._lightcone_state([w for _, ws in norm_ops for w in ws])
        else:
            psi = self.state(reuse=reuse)
        phi = psi
        for o, wires in norm_ops:
            phi = statevec.apply_unitary(phi, o, wires, self._d)
        return torch.vdot(psi, phi)

    def _dense_debug(self) -> Optional[torch.Tensor]:
        """The contractor's debug options on the dense readouts.  With
        ``contraction_info=True`` print the dense cost summary once a
        circuit shape ``(n, d, number of QIR items)``: 2 d^n d^k FLOPs an
        item on k wires, the state's d^n amplitudes and the item count (the
        JAX package's line, to the letter).  At ``debug_level >= 2`` return
        the zero of a dry run (shape ``()``, the configured complex dtype),
        else None."""
        opts = config.contractor_options()
        if opts.get("contraction_info"):
            from ..core import contractor

            key = ("dense", self._nqubits, self._d, len(self._qir))
            if key not in contractor._INFO_PRINTED:
                contractor._INFO_PRINTED.add(key)
                dim = self._d**self._nqubits
                flops = sum(2 * dim * self._d ** (len(item.get("index", ())) or 1) for item in self._qir)
                print(
                    "------ contraction cost summary ------\n"
                    f"log10[FLOPs]: {math.log10(max(flops, 1)):.3f}  "
                    f"log2[SIZE]: {math.log2(dim):.3f}  gates: {len(self._qir)}"
                )
        if int(opts.get("debug_level", 0)) >= 2:
            return torch.zeros((), dtype=config.torch_dtype(), device=self._device)
        return None

    def _norm_ops(self, ops: Sequence[Tuple[Any, Any]]) -> List[Tuple[Any, List[int]]]:
        """``(operator, [wires])`` pairs with a ``Gate`` unwrapped and the
        wires taken modulo n."""
        out = []
        for o, wires in ops:
            if isinstance(o, Gate):
                o = o.tensor
            if not hasattr(wires, "__len__"):
                wires = [wires]
            out.append((o, [int(w) % self._nqubits for w in wires]))
        return out

    def amplitude_before(self, l: Union[str, Sequence[int], torch.Tensor]) -> Any:
        """The einsum IR of the ⟨l|C|0...0⟩ network (contract it with
        ``core.contractor.contract_ir``)."""
        from ..core import einsum_ir

        return einsum_ir.amplitude_ir(self._expanded_qir(), self._nqubits, self._digits(l), d=self._d,
                                      device=self._device)

    def expectation_before(self, *ops: Tuple[Any, Sequence[int]], enable_lightcone: bool = True) -> Any:
        """The einsum IR of the ⟨ψ|O_1 O_2 ...|ψ⟩ network, pruned to the
        observables' light cone with ``enable_lightcone``."""
        from ..core import einsum_ir

        return einsum_ir.expectation_ir(self._expanded_qir(), self._nqubits, self._norm_ops(ops), d=self._d,
                                        lightcone=enable_lightcone, device=self._device)

    @staticmethod
    def _digits(l: Union[str, Sequence[int], torch.Tensor]) -> List[int]:
        if isinstance(l, str):
            return [int(ch, 36) for ch in l]
        if isinstance(l, torch.Tensor):
            return [int(v) for v in l.reshape(-1).tolist()]
        return [int(v) for v in np.reshape(np.asarray(l), (-1,))]

    def _lightcone_qir(self, obs_wires: Sequence[int]) -> List[Dict[str, Any]]:
        """The QIR items in the causal cone of ``obs_wires``, in order: an
        item is kept when it touches the cone, and then widens it (a fused
        layer touches every wire, so the cone keeps everything before it).
        A non-unitary channel item (a ``general_kraus`` branch: damping,
        reset, thermal relaxation, a measurement) is kept wherever it
        stands: its branch is renormalized by the reduced state of its
        wires, which conditions the qubits entangled with them (the JAX
        package drops it, Queue 3 F11 of ``ROADMAP.md``)."""
        cone = set(obs_wires)
        keep: List[Dict[str, Any]] = []
        for item in reversed(self._qir):
            state_dependent = item.get("is_channel") and not item.get("channel_unitary")
            if state_dependent or cone.intersection(item["index"]):
                keep.append(item)
                cone.update(item["index"])
        keep.reverse()
        return keep

    def _lightcone_state(self, obs_wires: Sequence[int]) -> torch.Tensor:
        """The cone's items applied one by one to the initial state."""
        psi = self._initial_state()
        for item in self._lightcone_qir(obs_wires):
            psi = self._apply_item(psi, item)
        return psi

    def replace_inputs(self, inputs: Any) -> None:
        """Swap the input state."""
        self._inputs = inputs
        self._state_cache = None

    def amplitude(self, l: Union[str, Sequence[int]]) -> torch.Tensor:
        r"""⟨l|psi⟩ for a basis string such as ``"0101"`` (base d, 0-9A-Z)
        or a sequence of ints; above 30 qubits by contracting
        :meth:`amplitude_before`."""
        if self._mesh_engine is not None:
            return self._mesh_engine.amplitude(self.state(), self._digits(l))
        if self._nqubits > self._DENSE_MAX_QUBITS:
            from ..core import contractor

            return contractor.contract_ir(self.amplitude_before(l))
        if isinstance(l, str):
            l = [int(ch, 36) for ch in l]
        return statevec.amplitude(self.state(), l, self._d)

    def probability(self) -> torch.Tensor:
        """The probability vector |psi|^2 (length d^n)."""
        if self._mesh_engine is not None:
            return self._mesh_engine.probability(self.state())
        return statevec.probabilities(self.state())

    def outcome_probability(self, bitstring: Union[str, Sequence[int]]) -> torch.Tensor:
        """The probability of measuring ``bitstring`` on every qubit."""
        amp = self.amplitude(bitstring)
        return torch.real(torch.conj(amp) * amp)

    def projected_subsystem(self, traceout: Any, left: Sequence[int]) -> torch.Tensor:
        """The normalized state of the sites in ``left``, every other site
        projected onto its digit in ``traceout`` (length n; the entries at
        ``left`` are ignored; a tensor may lie on the card)."""
        left = tuple(int(q) for q in left)
        tv = torch.reshape(torch.as_tensor(traceout, device=self._device), (-1,)).to(torch.int64)
        psi = self.state()
        n, d = self._nqubits, self._d
        for q in sorted((q for q in range(self._nqubits) if q not in left), reverse=True):
            psi = torch.reshape(torch.reshape(psi, (d**q, d, d ** (n - 1 - q)))[:, tv[q], :], (-1,))
            n -= 1
        return psi / torch.linalg.vector_norm(psi).to(psi.dtype)

    #: tie-break added to each uniform, as in the JAX package
    _MEASURE_EPS = statevec.MEASURE_EPS
    #: above this many qubits no dense state is made: the einsum routes
    _DENSE_MAX_QUBITS = 30

    def _uniforms(self, shape: Sequence[int], generator: Optional[torch.Generator]) -> torch.Tensor:
        """Uniforms on the circuit's device: from ``generator`` (which must
        lie there) or from the backend's implicit generator."""
        if generator is None:
            return K.implicit_randu(shape, device=self._device)
        check_generator(generator, self._device)
        return K.stateful_randu(generator, shape)

    def measure_jit(
        self,
        *index: int,
        with_prob: bool = False,
        status: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projective measurement of the ``index`` qubits in turn.

        ``status``: uniforms in [0, 1), one a qubit (numpy or tensor); the
        same status gives the JAX package's outcomes.  Without it the
        uniforms come from ``generator`` or the backend's implicit generator
        on the circuit's device.  Returns (outcomes (len(index),) int32,
        their probability, or -1 without ``with_prob``)."""
        if self._mesh_engine is not None:
            return self._mesh_engine.measure_jit(self.state(), index, status=status, with_prob=with_prob,
                                                 generator=generator)
        if status is None:
            status = self._uniforms([len(index)], generator)
        psi = self.state()
        status = statevec.real_tensor(status, self._device, psi.dtype)
        rdt = statevec._real_dtype(psi.dtype)
        outcomes = []
        prob = torch.ones((), dtype=rdt, device=self._device)
        for k, q in enumerate(index):
            marg = statevec.marginal_probability(psi, [q], self._d)
            marg = marg / torch.sum(marg)
            cdf = torch.cumsum(marg, 0)
            u = status[k].to(cdf.dtype) + self._MEASURE_EPS
            outcome = torch.clamp(torch.searchsorted(cdf, u.reshape(1), side="left")[0], 0, self._d - 1)
            psi = statevec.project_slot(psi, q, outcome, self._d)
            outcomes.append(outcome)
            prob = prob * marg[outcome]
        sample = torch.stack(outcomes).to(torch.int32)
        if with_prob:
            return sample, prob
        return sample, torch.tensor(-1.0, device=self._device)

    def measure(
        self, *index: int, with_prob: bool = False, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.measure_jit(*index, with_prob=with_prob, generator=generator)

    def perfect_sampling(
        self, status: Optional[Any] = None, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample every qubit once: (bits, probability)."""
        return self.measure_jit(*range(self._nqubits), with_prob=True, status=status, generator=generator)

    def sample(
        self,
        batch: Optional[int] = None,
        allow_state: bool = False,
        readout_error: Optional[Any] = None,
        format: Optional[str] = None,
        random_generator: Optional[torch.Generator] = None,
        status: Optional[Any] = None,
        jittable: bool = True,
        format_: Optional[str] = None,
    ) -> Any:
        """``batch`` shots of every qubit (one when ``batch`` is None).

        ``allow_state=True`` samples the renormalized ``probability()``
        (through ``readouterror_bs`` when ``readout_error`` is given) by
        inverse CDF, one uniform a shot: ``status`` [batch], or the first
        column of a [batch, n] one.  Otherwise each shot measures the qubits
        in turn as ``measure_jit`` does, from a row of ``status`` [batch, n],
        by :func:`statevec.sample_trajectories` (no state a shot), and
        ``readout_error`` is ignored, as in the JAX package.  Without a
        status the uniforms come from ``random_generator`` (a
        ``torch.Generator`` on the circuit's device) or the backend's
        implicit generator.

        ``format`` (or ``format_``) None gives the legacy output: (digits,
        probability) for ``batch=None``, else a list of them (the
        probability is -1.0 on the ``allow_state`` route); else one of
        :func:`quantum.sample2all`'s six formats.

        Above 2^30 amplitudes :meth:`_sample_large_n` draws the shots (the
        probability is -1.0, ``allow_state`` is moot)."""
        if format is None:
            format = format_
        nbatch = 1 if batch is None else batch
        n, d = self._nqubits, self._d
        if self._mesh_engine is not None:
            return self._sample_mesh(nbatch, batch, format, status, jittable, readout_error, random_generator)
        if d**n > 2**self._DENSE_MAX_QUBITS:
            return self._sample_large_n(nbatch, batch, format, status, jittable, readout_error, random_generator)
        if status is not None:
            status = device_tensor(status, self._device)
        if allow_state:
            p = self.probability()
            p = p / torch.sum(p)
            if readout_error is not None:
                p = self.readouterror_bs(readout_error, p)
            if status is not None and status.ndim == 2:
                status = status[:, 0]
            idx = K.probability_sample(nbatch, p, status=status, g=random_generator)
            return self._format_indices(idx, nbatch, batch, format, jittable)
        if status is None:
            status = self._uniforms([nbatch, n], random_generator)
        if status.ndim != 2:
            raise ValueError(f"the trajectory route takes a [batch, {n}] status, not shape {tuple(status.shape)}")
        samples, probs = statevec.sample_trajectories(self.probability(), status, d)
        if format is None:
            if batch is None:
                return samples[0], probs[0]
            return [(samples[i], probs[i]) for i in range(nbatch)]
        idx = qu.sample_bin2int(samples, n, d)
        return qu.sample2all(idx, n, format=format, jittable=jittable, d=d)

    def _sample_large_n(
        self,
        nbatch: int,
        batch: Optional[int],
        format: Optional[str],
        status: Optional[Any],
        jittable: bool,
        readout_error: Optional[Any] = None,
        random_generator: Optional[torch.Generator] = None,
    ) -> Any:
        """Shots without any 2^n object: each qubit in turn from P(q = v |
        the prefix drawn) = P(prefix, v) / P(prefix), each joint probability
        one planned, light-cone pruned contraction of projector expectations
        on the circuit's device (one plan a prefix length, cached by its
        signature), once a call for each distinct prefix.  ``status``
        [batch, n] gives the uniforms, as in the JAX package, else
        ``random_generator`` or the backend's implicit one.

        ``readout_error[i] = [P(0|0), P(1|1)]`` then flips bits with uniforms
        from ``np.random.default_rng(zlib.crc32(status.tobytes()))``, the
        status as a numpy array of its own dtype: the JAX package's flips
        for the same status."""
        import zlib

        from ..core import contractor

        n, d = self._nqubits, self._d
        if status is None:
            status = self._uniforms([nbatch, n], random_generator)
        if isinstance(status, torch.Tensor):
            status_np = status.detach().cpu().numpy().reshape(nbatch, n)
        else:
            status_np = np.asarray(status).reshape(nbatch, n)
        eye = np.eye(d, dtype=np.complex64)
        # shots that share a prefix share its joint probability (a GHZ
        # state's 64 shots walk two prefixes): each is contracted once a call
        joints: Dict[Tuple[int, ...], float] = {}

        def joint(prefix: List[int]) -> float:
            key = tuple(prefix)
            if key not in joints:
                ops = [(np.diag(eye[v]), [i]) for i, v in enumerate(prefix)]
                val = contractor.contract_ir(self.expectation_before(*ops))
                joints[key] = max(float(torch.real(val).reshape(())), 0.0)
            return joints[key]

        samples = np.zeros((nbatch, n), dtype=np.int32)
        for b in range(nbatch):
            prefix: List[int] = []
            p_prefix = 1.0
            for q in range(n):
                r = status_np[b, q] * p_prefix
                acc = 0.0
                outcome, p_joint = d - 1, None
                for v in range(d - 1):
                    pv = joint(prefix + [v])
                    if r < acc + pv:
                        outcome, p_joint = v, pv
                        break
                    acc += pv
                if p_joint is None:  # the last outcome takes the remainder
                    p_joint = max(p_prefix - acc, 1e-30)
                samples[b, q] = outcome
                prefix.append(outcome)
                p_prefix = max(p_joint, 1e-30)
        if readout_error is not None:
            if d != 2:
                raise NotImplementedError("readout_error needs qubits (d=2)")
            # in the configured real dtype first, as the JAX package reads it
            err = np.asarray(
                [[float(x) for x in (e.tolist() if isinstance(e, torch.Tensor) else e)] for e in readout_error],
                dtype=config.rdtypestr(),
            ).astype(np.float64)
            rng_ro = np.random.default_rng(zlib.crc32(status_np.tobytes()))
            keep = np.where(samples == 0, err[None, :, 0], err[None, :, 1])
            flips = rng_ro.uniform(size=samples.shape) >= keep
            samples = np.where(flips, 1 - samples, samples).astype(np.int32)
        bits = torch.as_tensor(samples, device=self._device)
        if format is None:
            if batch is None:
                return bits[0], -1.0
            return [(bits[i], -1.0) for i in range(nbatch)]
        return qu.sample2all(qu.sample_bin2int(bits, n, d), n, format=format, jittable=jittable, d=d)

    def _sample_mesh(self, nbatch: int, batch: Optional[int], format: Optional[str], status: Optional[Any],
                     jittable: bool, readout_error: Optional[Any], generator: Optional[torch.Generator]) -> Any:
        """``sample`` on the sharded engine: one uniform a shot (``status``
        [batch], or the first column of a [batch, n] one) through
        ``sample_direct``, two collectives for all the shots.  A readout
        error is not modelled there (ValueError)."""
        if readout_error is not None:
            raise ValueError("the sharded engine does not model a readout error: sample without it")
        if status is None:
            status = self._mesh_engine._uniforms([nbatch], generator)
        status = device_tensor(status, self._device)
        if status.ndim == 2:
            status = status[:, 0]
        idx = self._mesh_engine.sample_direct(self.state(), status)
        return self._format_indices(idx, nbatch, batch, format, jittable)

    def _format_indices(self, idx: torch.Tensor, nbatch: int, batch: Optional[int], format: Optional[str],
                        jittable: bool) -> Any:
        """Flat shot indices in ``sample``'s output: the legacy (digits, -1.0)
        pairs for ``format`` None, else :func:`quantum.sample2all`'s."""
        n, d = self._nqubits, self._d
        if format is None:
            bins = qu.sample_int2bin(idx, n, d)
            if batch is None:
                return bins[0], -1.0
            return [(bins[i], -1.0) for i in range(nbatch)]
        return qu.sample2all(idx, n, format=format, jittable=jittable, d=d)

    def readouterror_bs(self, readout_error: Optional[Any] = None, p: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The probability vector ``p`` through each qubit's readout
        confusion, ``readout_error[i] = [P(0|0), P(1|1)]`` (qubit i)."""
        if readout_error is None:
            return p
        for i, err in enumerate(readout_error):
            err = statevec.real_tensor(err, p.device, torch.complex128)
            m = torch.stack([torch.stack([err[0], 1.0 - err[1]]), torch.stack([1.0 - err[0], err[1]])])
            m = m.to(p.dtype)
            p = statevec.apply_unitary(p, m, [i], self._d)
        return p

    def sample_expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        shots: Optional[int] = None,
        random_generator: Optional[torch.Generator] = None,
        status: Optional[Any] = None,
        readout_error: Optional[Any] = None,
        noise_conf: Optional[Any] = None,
        nmc: int = 1000,
        statusc: Optional[Any] = None,
        **kws: Any,
    ) -> torch.Tensor:
        """⟨X_x Y_y Z_z⟩ from measurements in the Pauli bases: a copy of the
        circuit rotated into the Z basis (h on x, sd then h on y), its
        renormalized probabilities (through ``readouterror_bs``), and the
        mean parity of the measured wires, exact when ``shots`` is None,
        else over ``shots`` samples of ``backend.probability_sample``.
        With ``noise_conf`` the noisy value of
        :func:`noisemodel.sample_expectation_ps_noisfy`: ``nmc``
        trajectories, or the rows of ``statusc``, each sampled with the shot
        uniforms ``status``, through the readout error of ``noise_conf``
        (else ``readout_error``)."""
        if noise_conf is not None:
            from .. import noisemodel

            return noisemodel.sample_expectation_ps_noisfy(
                self, x=x, y=y, z=z, noise_conf=noise_conf, nmc=nmc, shots=shots, status=status,
                statusc=statusc, readout_error=readout_error, random_generator=random_generator, **kws,
            )
        c = self.copy()
        for q in x or ():
            c.h(q)  # type: ignore[attr-defined]
        for q in y or ():
            c.sd(q)  # type: ignore[attr-defined]
            c.h(q)  # type: ignore[attr-defined]
        p = c.probability()
        p = p / torch.sum(p)
        if readout_error is not None:
            p = c.readouterror_bs(readout_error, p)
        parity = torch.ones_like(p)
        sign = np.asarray([1.0, -1.0] + [1.0] * (self._d - 2))
        for w in list(x or ()) + list(y or ()) + list(z or ()):
            parity = statevec.apply_diagonal(parity, sign, [w], self._d)
        if shots is None:
            return torch.sum(p * parity)
        if status is not None:
            status = device_tensor(status, self._device)
        idx = K.probability_sample(shots, p, status=status, g=random_generator)
        return torch.mean(parity[idx.to(torch.int64)])

    def select_gate(self, which: Any, kraus: Sequence[Any], *index: int) -> None:
        """Apply ``kraus[which]`` on ``index``: ``which`` may be a tensor on
        the circuit's device (a measured outcome), picked there without a
        host sync; the picked matrix is applied as a gate."""
        mats = self._kraus_stack(kraus, index)
        which = device_tensor(which, self._device, "which").to(torch.int64)
        chosen = torch.index_select(mats, 0, torch.reshape(which, (1,)))[0]
        self.any(*index, unitary=chosen, name="select_gate")  # type: ignore[attr-defined]

    conditional_gate = select_gate

    def _kraus_mats(self, kraus: Sequence[Any], index: Sequence[int]) -> List[torch.Tensor]:
        """Each operator as a (d^k, d^k) tensor of the configured dtype on
        the circuit's device (a tensor keeps its autograd)."""
        dim = self._d ** len(index)
        like = torch.empty((), dtype=config.torch_dtype(), device=self._device)
        return [torch.reshape(statevec._as_tensor(k.tensor if isinstance(k, Gate) else k, like), (dim, dim))
                for k in kraus]

    def _kraus_host(self, kraus: Sequence[Any], index: Sequence[int]) -> Optional[np.ndarray]:
        """The operators stacked as a numpy (m, d^k, d^k) array of the
        configured dtype, or None when one of them is a tensor."""
        dim = self._d ** len(index)
        raw = [k.tensor if isinstance(k, Gate) else k for k in kraus]
        if any(isinstance(m, torch.Tensor) for m in raw):
            return None
        return np.stack([np.reshape(np.asarray(m), (dim, dim)) for m in raw]).astype(config.np_dtype())

    def _kraus_stack(self, kraus: Sequence[Any], index: Sequence[int]) -> torch.Tensor:
        """The operators stacked, (m, d^k, d^k), as :meth:`_kraus_mats`
        gives them; a numpy set goes to the device once, as one constant."""
        host = self._kraus_host(kraus, index)
        if host is None:
            return torch.stack(self._kraus_mats(kraus, index))
        return config.device_constant(host, self._device, config.torch_dtype())

    def state(self, form: str = "default", reuse: bool = True) -> torch.Tensor:
        """The output state (flat), from the kept prefix state and the items
        appended since (``reuse=False``: from the first item, nothing kept);
        ``form="tensor"`` reshapes to ``(d,)*n``."""
        s = self._kept_state() if reuse else self._compute_state()
        if form == "tensor":
            return torch.reshape(s, (self._d,) * self._nqubits)
        return s

    wavefunction = state

    def get_quvector(self) -> qu.QuVector:
        """The output state as a QuVector (n legs), on the circuit's device."""
        return qu.QuVector.from_tensor(self.state(form="tensor"))

    quvector = get_quvector

    def mpo(self, *index: int, mpo: Any = None, name: str = "mpo") -> None:
        """Apply an operator on ``index`` as an ``any`` gate: a QuOperator,
        a list of MPO site tensors (l, out, in, r) through
        :func:`quantum.tn2qop`, or a matrix."""
        if isinstance(mpo, qu.QuOperator):
            m = mpo.eval_matrix()
        elif isinstance(mpo, (list, tuple)):
            m = qu.tn2qop(mpo).eval_matrix()
        else:
            m = mpo
        self.any(*index, unitary=m, name=name)  # type: ignore[attr-defined]

    # ------------------------------------------------------------------
    # the node-graph helpers of the JAX package's API, over the QIR
    # ------------------------------------------------------------------

    def all_zero_nodes(self) -> List[torch.Tensor]:
        """The |0...0> input "nodes": the initial state."""
        return [self._initial_state()]

    def copy_nodes(self, conj: bool = False) -> List[Any]:
        """The expanded QIR's gate tensors on the circuit's device
        (conjugated with ``conj``, for the bra half)."""
        like = torch.empty((), dtype=config.torch_dtype(), device=self._device)
        tensors = [statevec._as_tensor(item["gate"].tensor, like) for item in self._expanded_qir()
                   if item.get("gate") is not None]
        return [torch.conj(t) for t in tensors] if conj else tensors

    def front_from_nodes(self, nodes: Any = None) -> List[int]:
        """The dangling legs: the qubit slots of the state."""
        return list(range(self._nqubits))

    def coloring_nodes(self, *args: Any, **kws: Any) -> None:
        """Light-cone tagging is a QIR pass here (``simplify.light_cone_qir``):
        a no-op kept for the API."""

    def coloring_copied_nodes(self, *args: Any, **kws: Any) -> None:
        """See :meth:`coloring_nodes`."""

    def to_graphviz(self, graph: Any = None, include_all_names: bool = False) -> str:
        """DOT text of the circuit's DAG: gates as nodes, qubit wires as edges."""
        lines = ["digraph circuit {", "  rankdir=LR;"]
        last = {q: f"q{q}_in" for q in range(self._nqubits)}
        for q in range(self._nqubits):
            lines.append(f'  q{q}_in [label="q{q}|0>", shape=plaintext];')
        for gi, item in enumerate(self._qir):
            node = f"g{gi}"
            lines.append(f'  {node} [label="{item.get("name") or "?"}", shape=box];')
            for q in item["index"]:
                lines.append(f"  {last[int(q)]} -> {node};")
                last[int(q)] = node
        for q in range(self._nqubits):
            lines.append(f'  q{q}_out [label="q{q}", shape=plaintext];')
            lines.append(f"  {last[q]} -> q{q}_out;")
        lines.append("}")
        return "\n".join(lines)

