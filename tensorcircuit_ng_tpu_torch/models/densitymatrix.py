"""``DMCircuit``: the exact density-matrix simulator, channels exact.

Counterpart of ``tensorcircuit_ng_tpu/models/densitymatrix.py``'s
``DMCircuit``.  ρ is held flat as a vector of 2n slots, the ket legs first
and the bra legs after them, on the circuit's device; each item of the
expanded QIR is applied as U on the ket slots and U* on the bra slots, a
diagonal gate as two broadcast multiplies, and a channel item exactly as
Σ_k K ρ K†.  The state of a QIR prefix is kept as in ``BaseCircuit``.
``sample`` and ``sample_expectation_ps`` are ``BaseCircuit``'s, on this
circuit's ``probability``.  ``DMCircuit2`` contracts the doubled
network's einsum IR instead above 14 qubits.  ``mps_inputs=`` starts
from the pure ρ of an MPS state; ``get_dm_as_quoperator`` gives ρ as a
``QuOperator``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..backend import device_tensor
from ..core import statevec
from ..ops import channels as channels_mod
from ..ops.gates import Gate
from .basecircuit import BaseCircuit

Tensor = Any

__all__ = ["DMCircuit", "DMCircuit2", "DensityMatrixCircuit"]


def _conj(g: Any) -> Any:
    return torch.conj(g) if isinstance(g, torch.Tensor) else np.conj(g)


class DMCircuit(BaseCircuit):
    is_dm = True

    def __init__(
        self,
        nqubits: int,
        inputs: Optional[Tensor] = None,
        dminputs: Optional[Tensor] = None,
        mps_inputs: Optional[Any] = None,
        dim: int = 2,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        """``mps_inputs``: an MPS input state (as ``Circuit`` takes it),
        densified to the pure ρ = |ψ⟩⟨ψ|; it replaces ``inputs``."""
        if mps_inputs is not None:
            from .circuit import _mps_to_dense

            inputs = _mps_to_dense(mps_inputs)
        super().__init__(nqubits, inputs=inputs, dim=dim, device=device)
        self._dminputs = dminputs

    def _copy_params(self) -> Dict[str, Any]:
        params = super()._copy_params()
        params["dminputs"] = self._dminputs
        return params

    # ------------------------------------------------------------------
    # state computation
    # ------------------------------------------------------------------

    def _initial_dm(self) -> torch.Tensor:
        if self._dminputs is not None:
            rho = self._dminputs
            if isinstance(rho, torch.Tensor):
                rho = rho.to(device=self._device, dtype=config.torch_dtype())
            else:
                rho = torch.as_tensor(np.asarray(rho), device=self._device).to(config.torch_dtype())
            return torch.reshape(rho, (-1,))
        psi = self._initial_state()
        return torch.reshape(torch.outer(psi, torch.conj(psi)), (-1,))

    def _apply_unitary_rho(self, rho: torch.Tensor, g: Any, wires: Sequence[int]) -> torch.Tensor:
        n = self._nqubits
        rho = statevec.apply_unitary(rho, g, list(wires), self._d)
        return statevec.apply_unitary(rho, _conj(g), [w + n for w in wires], self._d)

    def _apply_diagonal_rho(self, rho: torch.Tensor, diag: Any, wires: Sequence[int]) -> torch.Tensor:
        """U ρ U† for a diagonal U: d ⊙ ρ ⊙ d̄, two broadcast multiplies."""
        n = self._nqubits
        rho = statevec.apply_diagonal(rho, diag, list(wires), self._d)
        return statevec.apply_diagonal(rho, _conj(diag), [w + n for w in wires], self._d)

    def _apply_kraus_rho(self, rho: torch.Tensor, kraus: Sequence[Any], wires: Sequence[int]) -> torch.Tensor:
        acc = None
        for k1 in kraus:
            term = self._apply_unitary_rho(rho, k1, wires)
            acc = term if acc is None else acc + term
        return acc

    def _compute_state(self) -> torch.Tensor:
        return self._extend_state(self._initial_dm(), self._qir)

    def _extend_state(self, rho: torch.Tensor, items: List[Dict[str, Any]]) -> torch.Tensor:
        n = self._nqubits
        for item in self._expanded_qir(items):
            index = list(item["index"])
            if item.get("cond_collapse"):
                rho = self._collapse_rho(rho, index[0], item["status"])
            elif item.get("multicz"):
                rho = statevec.apply_multicz(rho, index)
                rho = statevec.apply_multicz(rho, [w + n for w in index])
            elif item.get("zstring_rot"):
                rho = statevec.apply_zstring_phase(rho, index, item["theta"])
                rho = statevec.apply_zstring_phase(rho, [w + n for w in index], -item["theta"])
            elif item.get("is_channel"):
                rho = self._apply_kraus_rho(rho, item["channel_kraus"], index)
            elif item.get("diagonal"):
                dim = self._d ** len(index)
                t = item["gate"].tensor
                if isinstance(t, torch.Tensor):
                    diag = torch.diagonal(torch.reshape(t, (dim, dim)))
                else:
                    diag = np.diagonal(np.reshape(t, (dim, dim)))
                rho = self._apply_diagonal_rho(rho, diag, index)
            else:
                rho = self._apply_unitary_rho(rho, item["gate"].tensor, index)
        return rho

    def state(self, form: str = "default", reuse: bool = True) -> torch.Tensor:
        """ρ as a (d^n, d^n) matrix, or flat with ``form="flat"``."""
        s = self._kept_state() if reuse else self._compute_state()
        if form == "flat":
            return s
        dim = self._d**self._nqubits
        return torch.reshape(s, (dim, dim))

    def densitymatrix(self, check: bool = False, reuse: bool = True) -> torch.Tensor:
        """ρ as a (d^n, d^n) matrix."""
        rho = self.state(reuse=reuse)
        if check:
            self.check_density_matrix(rho)
        return rho

    def wavefunction(self, form: str = "default") -> torch.Tensor:
        """The dominant eigenvector scaled by the square root of its
        eigenvalue (the state itself for a pure ρ, up to a phase)."""
        e, v = torch.linalg.eigh(self.densitymatrix())
        return v[:, -1] * torch.sqrt(e[-1]).to(v.dtype)

    def purity(self) -> torch.Tensor:
        rho = self.densitymatrix()
        return torch.real(torch.trace(rho @ rho))

    def amplitude(self, l: Union[str, Sequence[int], Tensor]) -> torch.Tensor:
        r"""⟨l|ρ|l⟩, the probability of the basis string ``l`` (a string in
        base d, a sequence of digits, or a digit tensor on the device)."""
        if isinstance(l, str):
            l = [int(ch, 36) for ch in l]
        lv = torch.reshape(torch.as_tensor(l, device=self._device), (-1,)).to(torch.int64)
        n = self._nqubits
        powers = torch.as_tensor([self._d ** (n - 1 - i) for i in range(n)], dtype=torch.int64, device=self._device)
        idx = torch.sum(lv * powers)
        return self.densitymatrix()[idx, idx]

    def _site_marginal(self, rho: torch.Tensor, q: int) -> torch.Tensor:
        """The (d,) diagonal marginal of site ``q``."""
        d = self._d
        dim = d**self._nqubits
        p = torch.real(torch.diagonal(torch.reshape(rho, (dim, dim))))
        return torch.sum(torch.reshape(p, (d**q, d, dim // d ** (q + 1))), dim=(0, 2))

    def _collapse_index(self, rho: torch.Tensor, q: int, status: Optional[Any]) -> torch.Tensor:
        """The outcome where the cdf of site q's marginal first reaches
        ``status`` (0.5 without it; no tie-break), as the JAX package picks."""
        p = self._site_marginal(rho, q)
        p = p / torch.sum(p)
        st = torch.as_tensor(0.5, device=self._device) if status is None else device_tensor(status, self._device)
        v = torch.searchsorted(torch.cumsum(p, 0), torch.reshape(st, (1,)).to(p.dtype))
        return torch.clamp(v[0], 0, self._d - 1)

    def _collapse_rho(self, rho: torch.Tensor, q: int, status: Optional[Any]) -> torch.Tensor:
        """Projective Z collapse of site ``q``: Π_v ρ Π_v / p_v."""
        d = self._d
        dim = d**self._nqubits
        v = self._collapse_index(rho, q, status)
        mask = torch.nn.functional.one_hot(v, d).to(rho.dtype)
        a = d**q
        b = dim // (a * d)
        r6 = torch.reshape(rho, (a, d, b, a, d, b))
        r6 = r6 * mask[None, :, None, None, None, None] * mask[None, None, None, None, :, None]
        rho2 = torch.reshape(r6, (dim, dim))
        tr = torch.trace(rho2)
        return torch.reshape(rho2 / (tr + 1e-12), rho.shape)

    def cond_measurement(self, index: int, status: Optional[Any] = None) -> torch.Tensor:
        """Projective Z measurement with the exact renormalized collapse on
        ρ; returns the outcome (0-d int32 on the device).  The outcome is
        where the cdf of the current marginal first reaches ``status`` (0.5
        without it), as in the JAX package."""
        q = int(index) % self._nqubits
        v = self._collapse_index(self.densitymatrix(), q, status)
        st = None if status is None else device_tensor(status, self._device)
        self._append(
            {
                "gatef": None,
                "gate": None,
                "index": (q,),
                "name": "cond_measurement",
                "split": None,
                "mpo": False,
                "cond_collapse": True,
                "status": st,
                "parameters": {"status": st},
            }
        )
        return v.to(torch.int32)

    cond_measure = cond_measurement

    def projected_subsystem(self, traceout: Tensor, left: Sequence[int]) -> torch.Tensor:
        """The trace-normalized ρ of the sites in ``left``, every other site
        projected onto its digit in ``traceout``."""
        left = tuple(int(q) for q in left)
        tv = torch.reshape(torch.as_tensor(traceout, device=self._device), (-1,)).to(torch.int64)
        n, d = self._nqubits, self._d
        rho = self.densitymatrix()
        m = n
        for q in sorted((q for q in range(n) if q not in left), reverse=True):
            dim = d**m
            a, b = d**q, d ** (m - 1 - q)
            r4 = torch.reshape(rho, (a, d, b, a, d, b))
            rho = torch.reshape(r4[:, tv[q], :, :, tv[q], :], (dim // d, dim // d))
            m -= 1
        tr = torch.trace(rho)
        return rho / (tr + 1e-10)

    @staticmethod
    def check_density_matrix(dm: Tensor) -> None:
        """Raise ValueError unless tr(dm) ≈ 1 (within 1e-5)."""
        tr = complex(torch.trace(torch.as_tensor(dm)).item())
        if not np.allclose(tr, 1.0, atol=1e-5):
            raise ValueError(f"input is not a valid density matrix: trace={tr} (expected 1.0)")

    @staticmethod
    def check_kraus(kraus: Sequence[Any]) -> bool:
        """Σ K†K = I, else AssertionError."""
        channels_mod.kraus_identity_check(kraus)
        return True

    def get_dm_as_quoperator(self) -> Any:
        """ρ as a QuOperator (n output legs, n input legs) on the circuit's device."""
        from .. import quantum as qu

        dims = (self._d,) * self._nqubits
        return qu.QuOperator.from_tensor(torch.reshape(self.densitymatrix(), dims + dims))

    @staticmethod
    def apply_general_kraus_delayed(kraus: Sequence[Any], name: Optional[str] = None) -> Any:
        """An unbound method that applies the fixed ``kraus`` exactly."""

        def apply(self: "DMCircuit", *index: int, **kws: Any) -> None:
            self.apply_general_kraus(kraus, *index, name=name)

        return apply

    def to_circuit(self) -> Any:
        """The pure-state ``Circuit`` of the non-channel items (same inputs
        and device)."""
        from .circuit import Circuit

        c = Circuit(self._nqubits, inputs=self._inputs, dim=self._d, device=self._device)
        for item in self._qir:
            if not item.get("is_channel"):
                c._apply_qir_item(item)
        return c

    # ------------------------------------------------------------------
    # channels, exact
    # ------------------------------------------------------------------

    def apply_general_kraus(self, kraus: Sequence[Any], *index: Any, name: Optional[str] = None, **kws: Any) -> None:
        """The channel Σ_k K ρ K† on ``index`` (ints, a sequence, or a list
        of site tuples; ``status`` and other keywords are ignored)."""

        def flatten(idx: Any) -> List[int]:
            out: List[int] = []
            for i in idx:
                out.extend(flatten(i) if isinstance(i, (list, tuple)) else [int(i)])
            return out

        index = tuple(i % self._nqubits for i in flatten(index))
        mats = self._kraus_mats(kraus, index)
        self._append(
            {
                "gatef": None,
                "gate": Gate(mats[0], name=name or "channel"),
                "index": index,
                "name": name or "channel",
                "split": None,
                "mpo": False,
                "is_channel": True,
                "channel_kraus": mats,
            }
        )

    general_kraus = apply_general_kraus

    def unitary_kraus(
        self,
        kraus: Sequence[Any],
        *index: int,
        prob: Optional[Sequence[float]] = None,
        status: Optional[Any] = None,
        name: Optional[str] = None,
    ) -> torch.Tensor:
        """The mixed-unitary channel exactly, each K_i scaled by
        √``prob[i]`` when given; returns -1."""
        if prob is not None:
            kraus = [
                torch.sqrt(statevec.real_tensor(p, self._device, config.torch_dtype())).to(config.torch_dtype())
                * m for p, m in zip(prob, self._kraus_mats(kraus, index))
            ]
        self.apply_general_kraus(kraus, *index, name=name or "unitary_kraus")
        return torch.tensor(-1, device=self._device)

    @classmethod
    def _meta_apply_channels(cls) -> None:
        def make_method(cname: str, factory: Callable[..., Any]) -> Callable[..., None]:
            def method(self: "DMCircuit", *index: int, status: Optional[Any] = None, **params: Any) -> None:
                self.apply_general_kraus(factory(**params), *index, name=cname)

            method.__name__ = cname
            method.__doc__ = f"The {cname} channel, exactly, on the density matrix."
            return method

        for cname, factory in channels_mod.CHANNEL_NAMES.items():
            setattr(cls, cname, make_method(cname, factory))

    # ------------------------------------------------------------------
    # measurement and expectation on ρ
    # ------------------------------------------------------------------

    def probability(self) -> torch.Tensor:
        return torch.real(torch.diagonal(self.densitymatrix()))

    def measure_jit(
        self,
        *index: int,
        with_prob: bool = False,
        status: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projective measurement of the ``index`` qubits in turn from the
        diagonal of ρ, one uniform of ``status`` a qubit (else from
        ``generator`` or the backend's implicit one)."""
        if status is None:
            status = self._uniforms([len(index)], generator)
        p_full = self.probability()
        status = statevec.real_tensor(status, self._device, config.torch_dtype())
        p = p_full / torch.sum(p_full)
        outcomes = []
        prob = torch.ones((), dtype=p.dtype, device=self._device)
        for k, q in enumerate(index):
            a, b = self._d**q, self._d ** (self._nqubits - 1 - q)
            marg = torch.sum(torch.reshape(p, (a, self._d, b)), dim=(0, 2))
            marg = marg / torch.sum(marg)
            cdf = torch.cumsum(marg, 0)
            r = torch.reshape(status[k], (1,)).to(cdf.dtype) + self._MEASURE_EPS
            outcome = torch.clamp(torch.searchsorted(cdf, r, side="left")[0], 0, self._d - 1)
            sel = torch.nn.functional.one_hot(outcome, self._d).to(p.dtype)
            p = statevec.apply_diagonal(p, sel, [q], self._d)
            p = p / torch.sum(p)
            outcomes.append(outcome)
            prob = prob * marg[outcome]
        sample = torch.stack(outcomes).to(torch.int32)
        if with_prob:
            return sample, prob
        return sample, torch.tensor(-1.0, device=self._device)

    def expectation(
        self,
        *ops: Tuple[Any, Sequence[int]],
        reuse: bool = True,
        noise_conf: Optional[Any] = None,
        nmc: int = 1000,
        status: Optional[Any] = None,
        **kws: Any,
    ) -> torch.Tensor:
        """tr(ρ O_1 O_2 ...) exactly (``noise_conf``: the channels added,
        exactly)."""
        if noise_conf is not None:
            return self._noisy_expectation(ops, noise_conf, nmc, status)
        n = self._nqubits
        phi = self.state(form="flat", reuse=reuse)
        for o, wires in ops:
            if isinstance(o, Gate):
                o = o.tensor
            if not hasattr(wires, "__len__"):
                wires = [wires]
            phi = statevec.apply_unitary(phi, o, [int(w) % n for w in wires], self._d)
        dim = self._d**n
        return torch.trace(torch.reshape(phi, (dim, dim)))

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
        **kws: Any,
    ) -> torch.Tensor:
        """tr(ρ X_x Y_y Z_z); ``ps`` as in ``Circuit.expectation_ps``."""
        if ps is not None:
            x, y, z = ([i for i, v in enumerate(ps) if v == p] for p in (1, 2, 3))
        return self.expectation(*self._pauli_ops(x, y, z), reuse=reuse, noise_conf=noise_conf, nmc=nmc,
                                status=status)


DMCircuit._meta_apply_channels()


class DMCircuit2(DMCircuit):
    """``DMCircuit`` whose readouts contract the doubled (superoperator)
    network lazily above ``_DENSE_MAX_QUBITS_DM`` = 14 qubits, so a noisy
    wide shallow circuit never makes its d^2n ρ.

    ``expectation_before`` lowers the expanded QIR to
    ``einsum_ir.superop_expectation_ir`` (channels as superoperator tensors,
    light-cone pruned); ``expectation`` contracts it above the cliff (with
    ``noise_conf`` it stays dense); ``probability(*index)``,
    ``measure_jit`` (one contraction a qubit, the earlier outcomes as
    one-hot boundaries) and ``amplitude`` contract
    ``einsum_ir.superop_boundary_ir``; ``sample`` above 2^14 amplitudes
    draws from contractions of ``expectation_before``.  Below the cliff
    each method is ``DMCircuit``'s."""

    #: above this qubit count the readouts bypass the dense ρ
    _DENSE_MAX_QUBITS_DM = 14
    #: ``BaseCircuit.sample``'s cliff: ρ holds d^2n entries, so half the
    #: pure state's width
    _DENSE_MAX_QUBITS = _DENSE_MAX_QUBITS_DM

    def _dense(self) -> bool:
        return self._nqubits <= self._DENSE_MAX_QUBITS_DM

    def expectation_before(self, *ops: Tuple[Any, Sequence[int]], enable_lightcone: bool = True) -> Any:
        """The einsum IR of tr(O_1 O_2 ... ρ) over the doubled network."""
        from ..core import einsum_ir

        return einsum_ir.superop_expectation_ir(self._expanded_qir(), self._nqubits, self._norm_ops(ops),
                                                d=self._d, lightcone=enable_lightcone, device=self._device)

    def expectation(
        self,
        *ops: Tuple[Any, Sequence[int]],
        reuse: bool = True,
        noise_conf: Optional[Any] = None,
        nmc: int = 1000,
        status: Optional[Any] = None,
        enable_lightcone: bool = True,
        **kws: Any,
    ) -> torch.Tensor:
        if noise_conf is not None or self._dense():
            return DMCircuit.expectation(self, *ops, reuse=reuse, noise_conf=noise_conf, nmc=nmc, status=status,
                                         **kws)
        from ..core import contractor

        return contractor.contract_ir(self.expectation_before(*ops, enable_lightcone=enable_lightcone))

    def _boundary_ir(self, **kws: Any) -> Any:
        from ..core import einsum_ir

        return einsum_ir.superop_boundary_ir(self._expanded_qir(), self._nqubits, d=self._d, device=self._device,
                                             **kws)

    def probability(self, *index: int) -> torch.Tensor:
        """The diagonal of ρ, or with wires given the joint diagonal
        marginal of those wires (flat, the first wire slowest), by a
        light-cone contraction that never makes ρ (so at any n)."""
        from ..core import contractor

        if not index:
            if self._dense():
                return DMCircuit.probability(self)
            index = tuple(range(self._nqubits))
        p = contractor.contract_ir(self._boundary_ir(diag_wires=[int(q) for q in index]))
        return torch.real(torch.reshape(p, (-1,)))

    def measure_jit(
        self,
        *index: int,
        with_prob: bool = False,
        status: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``index`` qubits measured in turn, each from one contraction
        of its marginal conditioned on the earlier outcomes (one-hot
        boundary vectors on the device); ``DMCircuit``'s below the cliff."""
        if self._dense():
            return DMCircuit.measure_jit(self, *index, with_prob=with_prob, status=status, generator=generator)
        from ..core import contractor

        d = self._d
        if status is None:
            status = self._uniforms([len(index)], generator)
        status = statevec.real_tensor(status, self._device, config.torch_dtype())
        rdt = getattr(torch, config.rdtypestr())
        fixed: Dict[int, torch.Tensor] = {}
        outcomes = []
        prob = torch.ones((), dtype=rdt, device=self._device)
        for k, q in enumerate(index):
            marg = torch.real(torch.reshape(contractor.contract_ir(self._boundary_ir(fixed=fixed, diag_wires=[q])),
                                            (d,)))
            marg = marg / torch.sum(marg)
            cdf = torch.cumsum(marg, 0)
            r = torch.reshape(status[k], (1,)).to(cdf.dtype) + self._MEASURE_EPS
            outcome = torch.clamp(torch.searchsorted(cdf, r, side="left")[0], 0, d - 1)
            prob = prob * marg[outcome]
            fixed = dict(fixed)
            fixed[int(q)] = torch.nn.functional.one_hot(outcome, d).to(rdt)
            outcomes.append(outcome)
        sample = torch.stack(outcomes).to(torch.int32)
        if with_prob:
            return sample, prob
        return sample, torch.tensor(-1.0, device=self._device)

    def amplitude(self, l: Union[str, Sequence[int], Tensor]) -> torch.Tensor:
        """⟨l|ρ|l⟩; above the cliff a closed doubled-network contraction."""
        if self._dense():
            return DMCircuit.amplitude(self, l)
        from ..core import contractor

        eye = np.eye(self._d)
        fixed = {q: eye[v] for q, v in enumerate(self._digits(l))}
        return contractor.contract_ir(self._boundary_ir(fixed=fixed))


DensityMatrixCircuit = DMCircuit
