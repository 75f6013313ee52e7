"""``Circuit``: the exact statevector simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/circuit.py``:
post-selection, Monte-Carlo trajectories of noise channels
(``unitary_kraus``, ``general_kraus`` and the channel methods
``c.depolarizing(q, px=..)``, ``c.amplitudedamping(q, gamma=..)``,
... of ``ops/channels.py``), the measurement with collapse
(``cond_measurement``, ``general_kraus`` on the projectors), the circuit
unitary (``matrix``), the exact density-matrix twin (``to_dm_circuit``) and
the free function :func:`expectation`.  ``mps_inputs=`` (an
``MPSCircuit``, a ``FiniteMPS``, a list of (l, d, r) site tensors or a
``QuVector``) starts from that state, contracted once into the dense
vector, and ``get_quoperator`` gives the circuit unitary as a
``QuOperator``.  A channel picks its branch where
the cdf of its branch probabilities first reaches ``status`` (a uniform;
one is drawn on the circuit's device without it), so the same status gives
the JAX package's branch.  ``device`` defaults to the configured device
(``"cuda"`` unless :func:`config.set_device` says otherwise); a CUDA device
without a card raises.  Detector and observable instructions, their
trajectories and exact rates come from :class:`detectors.DetectorMixin`.
``mesh=`` (a ``parallel.Mesh`` or ``parallel.ProcessGroupMesh``) runs the
circuit on the sharded engine (``parallel/sharded_state.py``): the state
is split over the mesh, and ``state()``, ``expectation``,
``expectation_ps``, the Ising readouts, ``amplitude``, ``measure_jit`` and
``sample`` never gather it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from .. import quantum as qu
from ..backend import device_tensor
from ..core import statevec
from ..ops import channels as channels_mod
from ..ops.gates import Gate
from .basecircuit import BaseCircuit
from .detectors import DetectorMixin

__all__ = ["Circuit", "expectation"]


class Circuit(DetectorMixin, BaseCircuit):
    """Exact statevector circuit simulator (dense engine)."""

    #: set by ``mesh=``: the mesh and its axis
    _mesh: Optional[Any] = None
    _mesh_axis = "sv"

    def __init__(
        self,
        nqubits: int,
        inputs: Optional[Any] = None,
        dim: int = 2,
        device: Union[None, str, torch.device] = None,
        split: Optional[Dict[str, Any]] = None,
        mps_inputs: Optional[Any] = None,
        mesh: Optional[Any] = None,
        mesh_axis: str = "sv",
    ) -> None:
        """``mps_inputs``: an MPS input state, densified by
        :func:`_mps_to_dense` (it replaces ``inputs``).  ``split``: the split
        rules of two-qubit gates (``contractor.split_rules``), stored as the
        JAX package stores them.  ``mesh``: run on the sharded engine, the
        state split over the mesh's ``mesh_axis`` (qubits only; the
        circuit's device is the mesh's first device, and another
        ``device`` is a ValueError)."""
        if mps_inputs is not None:
            inputs = _mps_to_dense(mps_inputs)
        if mesh is not None:
            if dim != 2:
                raise ValueError("the sharded engine supports qubits (dim=2) only")
            if device is not None and not _same_device(device, mesh.device):
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
            device = mesh.device
        super().__init__(nqubits, inputs=inputs, dim=dim, device=device)
        self._split = split
        self._mesh, self._mesh_axis = mesh, mesh_axis
        if mesh is not None:
            from ..parallel.sharded_state import ShardedStatevec

            self._mesh_engine = ShardedStatevec(nqubits, mesh, axis=mesh_axis)

    def _copy_params(self) -> Dict[str, Any]:
        params = super()._copy_params()
        if self._mesh is not None:
            params.update(mesh=self._mesh, mesh_axis=self._mesh_axis)
        return params

    def replace_mps_inputs(self, mps_inputs: Any) -> None:
        """Replace the input state by an MPS (densified once)."""
        self.replace_inputs(_mps_to_dense(mps_inputs))

    def get_quoperator(self) -> qu.QuOperator:
        """The circuit unitary as a QuOperator (n output legs, then n input
        legs), on the circuit's device."""
        dims = (self._d,) * self._nqubits
        return qu.QuOperator.from_tensor(torch.reshape(self.matrix(), dims + dims))

    quoperator = get_quoperator
    get_circuit_as_quoperator = get_quoperator

    def mid_measurement(self, index: int, keep: Union[int, torch.Tensor] = 0) -> None:
        """Post-select qubit ``index`` onto outcome ``keep``, without
        renormalization."""
        if isinstance(keep, torch.Tensor):
            sel = torch.nn.functional.one_hot(keep.to(torch.int64), self._d)
            m = torch.diag(sel.to(device=self._device, dtype=config.torch_dtype()))
        else:
            m = np.diag(np.eye(self._d)[int(keep)]).astype(config.np_dtype())
        self.apply_general_gate(Gate(m, name="mid_measurement"), index, name="mid_measurement")

    post_select = mid_measurement
    mid_measure = mid_measurement

    def cond_measurement(self, index: int, status: Optional[Any] = None) -> torch.Tensor:
        """Projective measurement of qubit ``index`` with the state collapsed
        and renormalized: :meth:`general_kraus` on the d projectors.
        Returns the outcome, a 0-d int32 tensor on the circuit's device."""
        projs = []
        for v in range(self._d):
            m = np.zeros((self._d, self._d))
            m[v, v] = 1.0
            projs.append(m)
        return self.general_kraus(projs, index, status=status, name="cond_measurement")

    cond_measure = cond_measurement

    # ------------------------------------------------------------------
    # Monte-Carlo noise channels
    # ------------------------------------------------------------------

    def _unitary_probs(
        self, kraus: Sequence[Any], index: Sequence[int], prob: Optional[Sequence[float]]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the operators to apply, the branch probabilities), each stacked
        on the circuit's device: the renormalized operators and tr(K†K)/dim,
        without the state, or the operators as given and ``prob``.  Numpy
        operators are worked on the host in the configured dtype and kept on
        the device as constants."""
        rdt = config.rdtypestr()
        host = self._kraus_host(kraus, index)
        if host is None:
            mats = self._kraus_stack(kraus, index)
        else:
            mats = config.device_constant(host, self._device, config.torch_dtype())
        if prob is not None:
            if isinstance(prob, torch.Tensor):
                p = device_tensor(prob, self._device, "prob").to(getattr(torch, rdt))
            else:
                p = config.device_constant(np.asarray(prob, dtype=rdt), self._device, getattr(torch, rdt))
            return mats, p / torch.sum(p)
        dim = mats.shape[-1]
        if host is not None:
            p = np.real(np.trace(np.conj(np.swapaxes(host, 1, 2)) @ host, axis1=1, axis2=2)) / dim
            new = host / np.sqrt(p + np.asarray(1e-30, dtype=rdt))[:, None, None]
            return (config.device_constant(new, self._device, mats.dtype),
                    config.device_constant(p / np.sum(p), self._device, getattr(torch, rdt)))
        p = torch.real(torch.diagonal(mats.conj().transpose(1, 2) @ mats, dim1=1, dim2=2).sum(-1)) / dim
        return mats / torch.sqrt(p + 1e-30).to(mats.dtype)[:, None, None], p / torch.sum(p)

    def unitary_kraus(
        self,
        kraus: Sequence[Any],
        *index: int,
        prob: Optional[Sequence[float]] = None,
        status: Optional[Any] = None,
        name: Optional[str] = None,
    ) -> torch.Tensor:
        """One trajectory of a mixed-unitary channel: branch i has
        probability p_i = tr(K_i†K_i)/dim (or ``prob[i]``), read without the
        state, and applies U_i, K_i renormalized.  The channel item keeps
        √p_i·U_i as its operators, so a replay through ``general_kraus``
        (``copy``, the light cone, ``to_dm_circuit``) draws with p_i and
        applies U_i (the JAX package keeps the K_i as given: with ``prob``
        its replay is another channel, Queue 3 F5 of ``ROADMAP.md``).
        Returns the branch (0-d int32)."""
        new_mats, p = self._unitary_probs(kraus, index, prob)
        kept = torch.sqrt(p).to(new_mats.dtype)[:, None, None] * new_mats
        return self._apply_selected_kraus(new_mats, p, index, status=status, name=name or "unitary_kraus",
                                          orig_mats=list(kept), unitary=True)

    def unitary_kraus2(
        self,
        kraus: Sequence[Any],
        *index: int,
        prob: Optional[Sequence[float]] = None,
        status: Optional[Any] = None,
        name: Optional[str] = None,
    ) -> torch.Tensor:
        """:meth:`unitary_kraus` with the branch's operator picked by an
        ``index_select`` of the stacked set (the JAX package's
        ``lax.switch``), tie-break 1e-12, and applied as a plain ``any``
        gate (no channel item)."""
        mats, p = self._unitary_probs(kraus, index, prob)
        status = self._uniforms([], None) if status is None else device_tensor(status, self._device)
        cdf = torch.cumsum(p, 0)
        r = torch.reshape(status, (1,)).to(cdf.dtype) + 1e-12
        idx = torch.clamp(torch.searchsorted(cdf, r, side="left"), 0, mats.shape[0] - 1)
        chosen = torch.index_select(mats, 0, idx)[0]
        self.any(*index, unitary=chosen, name=name or "unitary_kraus2")  # type: ignore[attr-defined]
        return idx[0].to(torch.int32)

    @classmethod
    def _meta_apply_channels(cls) -> None:
        """Install each channel of ``ops/channels.CHANNEL_NAMES`` as a
        method: ``c.depolarizing(0, px=0.1, py=0.1, pz=0.1, status=u)`` runs
        one trajectory (``unitary_kraus`` for a mixed-unitary channel, else
        ``general_kraus``) and returns the branch."""

        def make_method(cname: str, factory: Callable[..., Any]) -> Callable[..., torch.Tensor]:
            def method(self: "Circuit", *index: int, status: Optional[Any] = None, **params: Any) -> torch.Tensor:
                kraus = factory(**params)
                if getattr(kraus, "is_unitary", False):
                    return self.unitary_kraus(kraus, *index, status=status, name=cname)
                return self.general_kraus(kraus, *index, status=status, name=cname)

            method.__name__ = cname
            method.__doc__ = f"One Monte-Carlo trajectory of the {cname} channel; returns the branch."
            return method

        for cname, factory in channels_mod.CHANNEL_NAMES.items():
            setattr(cls, cname, make_method(cname, factory))

    def depolarizing2(self, *index: int, px: Any = 0, py: Any = 0, pz: Any = 0,
                      status: Optional[Any] = None) -> torch.Tensor:
        """Same as ``depolarizing``."""
        return self.depolarizing(*index, px=px, py=py, pz=pz, status=status)  # type: ignore[attr-defined]

    def depolarizing_reference(
        self, index: int, *, px: Any, py: Any, pz: Any, status: Optional[Any] = None
    ) -> torch.Tensor:
        """Depolarizing by the sign trick: branch
        (sign(r-px) + sign(r-px-py) + sign(r-px-py-pz))/2 + 1.5, truncated,
        0: X, 1: Y, 2: Z, 3: I, applied as a plain ``any`` gate.  Returns
        the branch (0-d int32)."""
        rdt = getattr(torch, config.rdtypestr())
        status = self._uniforms([], None) if status is None else device_tensor(status, self._device)
        r = status.to(rdt)
        step = torch.sign(r - px) + torch.sign(r - px - py) + torch.sign(r - px - py - pz)
        which = (step / 2 + 1.5).to(torch.int32)
        paulis = np.stack([channels_mod._X, channels_mod._Y, channels_mod._Z, np.eye(2)])
        stack = config.device_constant(paulis, self._device, config.torch_dtype())
        op = torch.index_select(stack, 0, torch.reshape(which, (1,)).to(torch.int64))[0]
        self.any(index, unitary=op, name="depolarizing_reference")  # type: ignore[attr-defined]
        return which

    def measure_reference(self, *index: int, with_prob: bool = False) -> Tuple[str, float]:
        """Measurement on the host, drawing from numpy's global generator
        (``np.random.choice``), as the JAX package does: the outcomes as a
        base-d string and their probability (-1.0 without ``with_prob``)."""
        alphabet = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        d, n = self._d, self._nqubits
        probs_full = np.abs(self.state().detach().cpu().numpy().reshape((d,) * n)) ** 2
        sample = ""
        p_tot = 1.0
        fixed: Dict[int, int] = {}
        for j in index:
            sl: List[Any] = [slice(None)] * n
            for q, v in fixed.items():
                sl[q] = v
            sub = probs_full[tuple(sl)]
            axes = tuple(k for k, q in enumerate(sorted(set(range(n)) - set(fixed))) if q != j)
            pj = sub.sum(axis=axes)
            pj = pj / pj.sum()
            outcome = int(np.random.choice(d, p=pj))
            sample += alphabet[outcome]
            p_tot *= float(pj[outcome])
            fixed[j] = outcome
        if with_prob:
            return sample, p_tot
        return sample, -1.0

    @staticmethod
    def apply_general_kraus_delayed(kraus: Sequence[Any], name: Optional[str] = None) -> Callable[..., Any]:
        """An unbound method that runs one trajectory of the fixed ``kraus``."""

        def apply(self: "Circuit", *index: int, status: Optional[Any] = None, **kws: Any) -> torch.Tensor:
            return self.general_kraus(kraus, *index, status=status, name=name)

        return apply

    def to_dm_circuit(self) -> Any:
        """The :class:`DMCircuit` of the same QIR, inputs and device: each
        channel item becomes its exact channel."""
        from .densitymatrix import DMCircuit

        dmc = DMCircuit(self._nqubits, inputs=self._inputs, dim=self._d, device=self._device)
        dmc.append_from_qir(self.to_qir())
        return dmc

    def general_kraus(
        self,
        kraus: Sequence[Any],
        *index: int,
        status: Optional[Any] = None,
        with_prob: bool = False,
        name: Optional[str] = None,
    ) -> Any:
        """One trajectory of the channel with Kraus operators ``kraus`` on
        ``index``: branch i has probability ⟨ψ|K_i†K_i|ψ⟩ = tr(K_i ρ K_i†) on
        the state at this point (computed now; ρ the reduced density matrix
        of ``index``, one pass over the state), is picked by the uniform
        ``status`` (or one drawn on the circuit's device) and applied
        renormalized, so the state stays normalized.  On a mesh circuit
        branch i's probability is Re ⟨ψ|K_i†K_i|ψ⟩ on the shards (the
        engine's exchanges and one ``psum`` a branch), and the chosen
        operator is applied by the engine: the state is never gathered.
        Returns the branch (and the branch probabilities with
        ``with_prob``)."""
        ks = self._kraus_stack(kraus, index)
        if self._mesh_engine is not None:
            psi = self.state()
            p = torch.stack([
                torch.real(self._mesh_engine.expectation(psi, [(k.conj().transpose(0, 1) @ k, index)]))
                for k in ks
            ]).to(self._device)
        else:
            rho = statevec.reduced_density_matrix(self.state(), index, self._d)
            p = torch.real(torch.einsum("kab,bc,kac->k", ks, rho, torch.conj(ks)))
        p = p / torch.sum(p)
        new_mats = ks / torch.sqrt(p + 1e-30).to(ks.dtype)[:, None, None]
        idx = self._apply_selected_kraus(new_mats, p, index, status=status, name=name or "general_kraus",
                                         orig_mats=list(ks))
        if with_prob:
            return idx, p
        return idx

    apply_general_kraus = general_kraus

    def _apply_selected_kraus(
        self,
        mats: torch.Tensor,
        p: torch.Tensor,
        index: Sequence[int],
        status: Optional[Any] = None,
        name: str = "kraus",
        orig_mats: Optional[List[torch.Tensor]] = None,
        unitary: bool = False,
    ) -> torch.Tensor:
        """Pick branch i where the cdf of ``p`` first reaches ``status`` +
        the measurement tie-break, on the device, and append ``mats[i]``
        (of the stacked ``mats``, picked there) as a channel item (the Kraus
        set and the status kept for the QIR replay; ``unitary``: the branch
        probabilities do not read the state, as a mixed-unitary channel's)."""
        status = self._uniforms([], None) if status is None else device_tensor(status, self._device)
        cdf = torch.cumsum(p, 0)
        r = torch.reshape(status, (1,)).to(cdf.dtype) + self._MEASURE_EPS
        idx = torch.clamp(torch.searchsorted(cdf, r, side="left"), 0, mats.shape[0] - 1)
        g = Gate(torch.index_select(mats, 0, idx)[0], name=name)
        ir_dict = {
            "gatef": None,
            "gate": g,
            "index": tuple(int(i) for i in index),
            "name": name,
            "split": None,
            "mpo": False,
            "is_channel": True,
            "channel_unitary": unitary,
            "channel_kraus": orig_mats if orig_mats is not None else list(mats),
            "channel_status": status,
            # the trajectory's branch and branch probabilities, for its readers
            "channel_branch": idx[0],
            "channel_probs": p,
        }
        self.apply_general_gate(g, *index, name=name, ir_dict=ir_dict)
        return idx[0].to(torch.int32)

    def matrix(self) -> torch.Tensor:
        """The circuit unitary, (d^n, d^n), on the circuit's device: the
        expanded QIR applied to the identity held as a state of 2n slots,
        the gates on the first n (the row index)."""
        dim = self._d**self._nqubits
        psi = torch.reshape(torch.eye(dim, dtype=config.torch_dtype(), device=self._device), (-1,))
        for item in self._expanded_qir():
            psi = statevec.apply_unitary(psi, item["gate"].tensor, item["index"], self._d)
        return torch.reshape(psi, (dim, dim))

    def get_unitary(self) -> torch.Tensor:
        return self.matrix()

    def is_valid(self) -> bool:
        """Whether the state computes, with d^n finite amplitudes."""
        try:
            psi = self.state()
        except (RuntimeError, ValueError, AssertionError):
            return False
        return psi.numel() == self._d**self._nqubits and bool(torch.isfinite(psi).all())


Circuit._meta_apply_channels()


def _same_device(device: Union[str, torch.device], mesh_device: torch.device) -> bool:
    """Whether ``device`` names the mesh's device (a bare ``"cuda"`` names
    any card)."""
    dev = torch.device(device)
    return dev.type == mesh_device.type and (dev.index is None or dev.index == mesh_device.index)


def _mps_to_dense(mps_inputs: Any) -> torch.Tensor:
    """The flat dense state of an MPS input: a QuVector's tensor as it is,
    else the (l, d, r) site tensors of an ``MPSCircuit``, a ``FiniteMPS`` or a
    list, contracted as (rows, bond) matrices on the first tensor's device
    (numpy goes to the configured device)."""
    if isinstance(mps_inputs, qu.QuOperator):
        return torch.reshape(mps_inputs.eval(), (-1,))
    tensors = mps_inputs.tensors if hasattr(mps_inputs, "tensors") else mps_inputs
    psi = None
    for t in tensors:
        t = qu._tensor(t)
        l, d, r = t.shape
        if psi is None:
            psi = torch.reshape(t, (l * d, r))
        else:
            psi = torch.reshape(psi @ torch.reshape(t.to(device=psi.device, dtype=psi.dtype), (l, d * r)), (-1, r))
    return torch.reshape(psi, (-1,))


def expectation(
    *ops: Tuple[Any, Sequence[int]],
    ket: Any,
    bra: Optional[Any] = None,
    conj: bool = True,
    normalization: bool = False,
) -> torch.Tensor:
    """⟨bra| O_1 O_2 ... |ket⟩ on dense qubit states, ``O_i = (operator,
    [wires])``; ``bra`` defaults to ``ket``, ``conj=False`` skips its
    conjugation and ``normalization`` divides by both norms.  A tensor ket
    keeps its device, anything else goes to the configured device; a real
    ket takes the configured complex dtype."""
    if isinstance(ket, torch.Tensor):
        psi = torch.reshape(ket, (-1,))
    else:
        psi = torch.reshape(torch.as_tensor(np.asarray(ket), device=config.resolve_device()), (-1,))
    if not psi.is_complex():
        psi = psi.to(config.torch_dtype())
    bra_t = psi if bra is None else torch.reshape(torch.as_tensor(bra), (-1,)).to(device=psi.device, dtype=psi.dtype)
    phi = psi
    for op, wires in ops:
        if isinstance(op, Gate):
            op = op.tensor
        if not hasattr(wires, "__len__"):
            wires = [wires]
        phi = statevec.apply_unitary(phi, op, list(wires))
    val = torch.sum((torch.conj(bra_t) if conj else bra_t) * phi)
    if normalization:
        nrm = torch.sqrt(torch.real(torch.vdot(psi, psi)) * torch.real(torch.vdot(bra_t, bra_t)))
        val = val / nrm.to(val.dtype)
    return val
