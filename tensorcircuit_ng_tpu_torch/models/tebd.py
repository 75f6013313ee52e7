"""Parallel TEBD in Vidal Γ-λ form: batched same-parity two-site updates.

Counterpart of ``tensorcircuit_ng_tpu/models/tebd.py``.  The state is kept
in the canonical Vidal form (site tensors Γ_i and bond weights λ_i), where
a two-site gate on bond i touches only (Γ_i, λ_i, Γ_{i+1}) and reads the
frozen neighbours λ_{i-1}, λ_{i+1}; all bonds of one parity update at
once, through one batched truncation SVD of their ``(χd, dχ)`` thetas.
All bonds are padded to the static bond dimension χ (zero λ entries mark
unused directions), so every Γ is (χ, d, χ).

On a CUDA tensor the truncation runs kernel K5 (``core/kernels_jacobi``),
as the JAX package runs its Pallas Jacobi on the TPU; on a CPU tensor the
Gram-eigh SVD (``SVD_MODE="auto"``).  The einsums and matmuls around the
SVD run in full float32 whatever the caller set (``config.full_float32``
around :meth:`ParallelTEBD.apply_two_site_layer` and
:meth:`ParallelTEBD.canonicalize`), as the JAX package asks XLA for
``precision="highest"``.  Unlike the JAX engine, which is functional, a
layer updates ``gammas`` and ``lambdas`` in place, by strided slice
assignment; :meth:`ParallelTEBD.from_state` copies what it is given.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import config
from ..core import linalg as _linalg

__all__ = ["ParallelTEBD"]

#: batched truncation engine: "auto" (K5 Jacobi on a CUDA tensor, Gram-eigh
#: elsewhere), "gram", "jacobi" or "subspace"
SVD_MODE = "auto"
JACOBI_SWEEPS = 10
#: de Rijk column-norm presort of the cold panel before K5
JACOBI_PRESORT = False
#: sweeps when warm-started by the previous step's V on the same bond
JACOBI_SWEEPS_WARM = 4
#: subspace-capture rounds, cold and warm
SUBSPACE_REFINE = 2
SUBSPACE_REFINE_WARM = 1
#: warm-panel random probe columns (0 disables; opt-in knob)
SUBSPACE_INJECT = 0
#: captured-basis width beyond chi
SUBSPACE_OVERSAMPLE = 16

Tensor = torch.Tensor


def _svd_batched(
    theta: Tensor, chi: int, vh0: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Batched truncation SVD; returns (u, s, vh, warm_record).

    ``warm_record`` is the mode's state worth threading to the next step on
    the same bond (full vh for "jacobi", the captured V basis for
    "subspace", None for "gram"); ``vh0`` is the previous record.  "auto"
    decides on the tensor's device, as the JAX package decides on the
    backend: "jacobi" on CUDA, "gram" otherwise.
    """
    mode = SVD_MODE
    if mode == "auto":
        mode = "jacobi" if theta.is_cuda else "gram"
    if mode == "subspace":
        from ..core.kernels_jacobi import subspace_svd

        return subspace_svd(
            theta,
            chi,
            sweeps=JACOBI_SWEEPS,
            refine=SUBSPACE_REFINE if vh0 is None else SUBSPACE_REFINE_WARM,
            v0=vh0,
            oversample=SUBSPACE_OVERSAMPLE,
            inject=0 if vh0 is None else SUBSPACE_INJECT,
            return_basis=True,
        )
    if mode == "jacobi":
        from ..core.kernels_jacobi import jacobi_svd, jacobi_svd_warm

        # accumulate_v=True: the cheap vh = S^-1 U^H A recovery amplifies
        # U's residual non-orthogonality by s_max/s_cut at the truncation edge
        if vh0 is not None:
            u, s, vh = jacobi_svd_warm(theta, JACOBI_SWEEPS_WARM, True, vh0)
        else:
            u, s, vh = jacobi_svd(theta, JACOBI_SWEEPS, True, JACOBI_PRESORT)
        return u, s, vh, vh
    if mode != "gram":
        raise ValueError(f"SVD_MODE must be 'auto', 'gram', 'jacobi' or 'subspace', got {mode!r}")
    u, s, vh = _linalg.gram_svd(theta)
    return u, s, vh, None


def _safe_inv(x: Tensor, eps: float = 1e-12) -> Tensor:
    return torch.where(x > eps, 1.0 / torch.where(x > eps, x, torch.ones_like(x)), torch.zeros_like(x))


#: RELATIVE floor for the S^-1 unwrap: singular directions below
#: ``INV_S_REL * s_max`` are dropped from the new site tensors instead of
#: inverted (their Schmidt weight is < INV_S_REL^2).  The float32 Jacobi
#: recovers u_i = q_i / s_i, so columns at the float32 noise floor are not
#: orthonormal to eps; inverting them walks the trajectory off the float64
#: track.  ``None`` = auto, keyed on the singular values' dtype as in the
#: JAX package: 1e-6 for float32, 0 for float64.
INV_S_REL: Optional[float] = None


class ParallelTEBD:
    """Vidal-form MPS with batched even/odd two-site updates.

    :param n: number of sites
    :param chi: static bond dimension (all bonds padded to χ)
    :param d: local dimension
    :param initial: "zeros" | "neel" | list of product-state kets (d,)
    :param dtype: complex dtype of Γ (default: ``config.dtypestr()``)
    :param device: "cuda" (the default through ``config``) or "cpu"
    """

    def __init__(
        self,
        n: int,
        chi: int,
        d: int = 2,
        initial: Any = "zeros",
        dtype: Optional[str] = None,
        device: Union[None, str, torch.device] = None,
    ):
        dev = config.resolve_device(device)
        self.n = n
        self.chi = chi
        self.d = d
        g, lam = self.initial_tensors(n, chi, d, initial, dtype)
        self.gammas = torch.as_tensor(g, device=dev)
        self.lambdas = torch.as_tensor(lam, device=dev)
        # warm start is opt-in (from_state(warm=...))
        self._warm_in: dict = {}
        self._vh_warm: dict = {}
        self._record_warm = False

    @property
    def device(self) -> torch.device:
        return self.gammas.device

    @staticmethod
    def initial_tensors(
        n: int,
        chi: int,
        d: int = 2,
        initial: Any = "zeros",
        dtype: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Numpy Vidal tensors for a product state: (n,χ,d,χ) Γ, (n+1,χ) λ."""
        dt = config.np_dtype(dtype)
        if isinstance(initial, str):
            kets = []
            for i in range(n):
                v = np.zeros(d)
                # "neel": |1> on even sites (matches x(0), x(2), ... circuits)
                v[(1 - i % 2) if initial == "neel" else 0] = 1.0
                kets.append(v)
        else:
            kets = [np.asarray(v) for v in initial]
        gammas = np.zeros((n, chi, d, chi), dtype=dt)
        for i, v in enumerate(kets):
            gammas[i, 0, :, 0] = v
        lam = np.zeros((n + 1, chi), dtype=np.float32)
        lam[:, 0] = 1.0
        return gammas, lam

    @classmethod
    def from_state(cls, gammas: Tensor, lambdas: Tensor, warm: Optional[dict] = None) -> "ParallelTEBD":
        """Wrap copies of existing (n,χ,d,χ) Γ / (n+1,χ) λ tensors (for a
        JAX engine's state, see ``convert.tebd_state``).

        ``warm``: optional :meth:`warm_state` dict of per-parity (real, imag)
        planes of the previous step's full ``vh``, which warm-starts the
        Jacobi truncation; ``warm={}`` opts in to recording with cold sweeps.
        """
        e = cls.__new__(cls)
        e.gammas = torch.as_tensor(gammas).clone()
        e.lambdas = torch.as_tensor(lambdas).clone()
        e.n, e.chi, e.d = (int(x) for x in e.gammas.shape[:3])
        e._warm_in = {}
        e._vh_warm = {}
        e._record_warm = warm is not None
        for p, (vr, vi) in (warm or {}).items():
            e._warm_in[int(p)] = torch.complex(vr, vi)
        return e

    def warm_state(self) -> dict:
        """Per-parity (real, imag) planes of the last full ``vh``."""
        return {p: (vh.real, vh.imag) for p, vh in self._vh_warm.items()}

    # ------------------------------------------------------------------
    # core batched update
    # ------------------------------------------------------------------

    @staticmethod
    def _pair_update(gl, gr, lam_l, lam_c, lam_r, gate, chi, d):
        """One Vidal two-site update (Gram SVD, λ^-1 unwrap).

        gl, gr: (χ, d, χ); lam_*: (χ,); gate: (d*d, d*d).
        Returns new (gl, gr, lam_c).
        """
        dt = gl.dtype
        # theta_{(a i), (j b)} = λl_a Γl_{a i m} λc_m Γr_{m j b} λr_b
        left = lam_l.to(dt)[:, None, None] * gl * lam_c.to(dt)[None, None, :]
        right = gr * lam_r.to(dt)[None, None, :]
        theta = torch.einsum("aim,mjb->aijb", left, right)
        th = torch.einsum("pq,aqb->apb", gate.to(dt), theta.reshape(chi, d * d, chi))
        u, s, vh = _linalg.gram_svd(th.reshape(chi * d, d * chi))
        u = u[:, :chi]
        s = s[:chi]
        vh = vh[:chi, :]
        nrm = torch.linalg.vector_norm(s)
        s = s / torch.where(nrm > 1e-30, nrm, torch.ones_like(nrm))
        # unwrap the environment weights: Γl' = λl^{-1} U, Γr' = Vh λr^{-1}
        gl_new = u.reshape(chi, d, chi) * _safe_inv(lam_l).to(dt)[:, None, None]
        gr_new = vh.reshape(chi, d, chi) * _safe_inv(lam_r).to(dt)[None, None, :]
        return gl_new, gr_new, s

    def _layer_thetas(self, gates: Any, parity: int) -> Tuple[Tensor, Tensor, Tensor]:
        """(theta, theta_nl, theta_nr), each (nb, χd, dχ), of every bond of
        the parity with its gate folded in: theta = λl Γl λc Γr λr and its
        λl-free and λr-free variants (the unwrap uses the latter two)."""
        n, chi, d = self.n, self.chi, self.d
        p = parity
        nb = len(range(p, n - 1, 2))
        hi = p + 2 * nb  # one past the last touched site
        gates = torch.as_tensor(gates, device=self.device)
        if gates.dim() == 2:
            gates = gates.expand((nb,) + tuple(gates.shape))
        gl = self.gammas[p:hi:2]
        gr = self.gammas[p + 1 : hi : 2]
        lam_l = self.lambdas[p:hi:2]
        lam_c = self.lambdas[p + 1 : hi : 2]
        lam_r = self.lambdas[p + 2 : hi + 1 : 2]
        dt = gl.dtype
        gates = gates.to(dt)

        def fold_gate(th):
            th = torch.einsum("bpq,baqc->bapc", gates, th.reshape(nb, chi, d * d, chi))
            return th.reshape(nb, chi * d, d * chi)

        left_bare = gl * lam_c.to(dt)[:, None, None, :]
        right = gr * lam_r.to(dt)[:, None, None, :]
        theta_nl = fold_gate(torch.einsum("baim,bmjc->baijc", left_bare, right))
        left = lam_l.to(dt)[:, :, None, None] * left_bare
        theta_nr = fold_gate(torch.einsum("baim,bmjc->baijc", left, gr))
        # theta = λl-row-scale of the λl-free variant (exact, elementwise)
        theta = (lam_l.to(dt)[:, :, None, None] * theta_nl.reshape(nb, chi, d, d * chi)).reshape(
            nb, chi * d, d * chi
        )
        return theta, theta_nl, theta_nr

    def apply_two_site_layer(self, gates: Any, parity: int = 0) -> None:
        """Apply two-site gates on every bond of the given parity, batched.

        ``gates``: (nb, d², d²), one gate per parity bond, or a single
        (d², d²) gate for the whole layer.
        """
        with config.full_float32():
            self._apply_layer(gates, parity)

    def _apply_layer(self, gates: Any, parity: int) -> None:
        n, chi, d = self.n, self.chi, self.d
        p = parity
        nb = len(range(p, n - 1, 2))
        hi = p + 2 * nb
        lam_l = self.lambdas[p:hi:2]
        lam_r = self.lambdas[p + 2 : hi + 1 : 2]
        # The unwrap uses Γl' = θ_noλl Vh^H S^-1 and Γr' = S^-1 U^H θ_noλr
        # (inverse-free form) instead of dividing U/Vh by the environment λ,
        # which would amplify noise at small-λ positions by 1/λ.
        theta, theta_nl, theta_nr = self._layer_thetas(gates, parity)
        dt = theta.dtype
        u, s, vh, warm_rec = _svd_batched(theta, chi, self._warm_in.pop(parity, None))
        if self._record_warm and warm_rec is not None:
            self._vh_warm[parity] = warm_rec
        u = u[..., :, :chi]
        s = s[..., :chi]
        vh = vh[..., :chi, :]
        nrm = s.norm(dim=-1, keepdim=True)
        s_new = s / torch.where(nrm > 1e-30, nrm, torch.ones_like(nrm))
        inv_s = _safe_inv(s).to(dt)
        rel = INV_S_REL
        if rel is None:
            rel = 1e-6 if torch.finfo(s.dtype).bits <= 32 else 0.0
        if rel:
            # drop (not invert) noise-floor directions: see INV_S_REL
            inv_s = torch.where(s > rel * s[..., :1], inv_s, torch.zeros_like(inv_s))
        gl_new = (torch.matmul(theta_nl, vh.conj().transpose(-1, -2)) * inv_s[:, None, :]).reshape(
            nb, chi, d, chi
        )
        gr_new = (inv_s[:, :, None] * torch.matmul(u.conj().transpose(-1, -2), theta_nr)).reshape(
            nb, chi, d, chi
        )
        # the zero-at-padded-directions invariant: float32 noise in theta at
        # zero-λ environment directions must not survive the unwrap
        zero = torch.zeros((), dtype=dt, device=gl_new.device)
        gl_new = torch.where(lam_l[:, :, None, None] > 1e-12, gl_new, zero)
        gr_new = torch.where(lam_r[:, None, None, :] > 1e-12, gr_new, zero)
        # in place, by strided slices (λ keeps its float32 storage)
        self.gammas[p:hi:2] = gl_new
        self.gammas[p + 1 : hi : 2] = gr_new
        self.lambdas[p + 1 : hi + 1 : 2] = s_new.to(self.lambdas.dtype)

    def trotter_step(self, even_gates: Any, odd_gates: Any = None) -> None:
        """Even layer then odd layer (2nd-order users call with half-steps).

        For imaginary time or open chains pass per-bond ``(nb, d², d²)``
        stacks with boundary-corrected bond Hamiltonians, and call
        :meth:`canonicalize` periodically during non-unitary evolution.
        """
        self.apply_two_site_layer(even_gates, parity=0)
        self.apply_two_site_layer(even_gates if odd_gates is None else odd_gates, parity=1)

    # ------------------------------------------------------------------
    # readout
    # ------------------------------------------------------------------

    def canonicalize(self) -> None:
        """Restore the Vidal canonical form (QR left sweep + SVD right sweep);
        the state is unchanged up to global norm and phase, and λ become
        true Schmidt spectra."""
        with config.full_float32():
            self._canonicalize()

    def _canonicalize(self) -> None:
        n, chi, d = self.n, self.chi, self.d
        # re-gauging invalidates any recorded warm-start basis
        self._warm_in = {}
        self._vh_warm = {}
        tensors = self.to_mps_tensors()
        dt = tensors[0].dtype
        dev = self.device
        # left-to-right QR sweep -> left-canonical A_i
        a_list = []
        carry = torch.eye(chi, dtype=dt, device=dev)
        for i in range(n):
            t = torch.einsum("ab,bdc->adc", carry, tensors[i])
            q, r = torch.linalg.qr(t.reshape(chi * d, chi), mode="reduced")
            a_list.append(q.reshape(chi, d, chi))
            carry = r
        # right-to-left SVD sweep -> Schmidt λ and right-canonical B_i
        lam_edge = torch.zeros((chi,), dtype=torch.float32, device=dev)
        lam_edge[0] = 1.0
        lambdas: List[Tensor] = [lam_edge] * (n + 1)
        gammas: List[Tensor] = [None] * n
        # seed with the final QR carry: it projects out the completion
        # columns QR invented for the rank-1 edge bond
        nrm0 = torch.abs(carry[0, 0])
        carry = carry / torch.where(nrm0 > 1e-30, nrm0, torch.ones_like(nrm0)).to(dt)
        for i in range(n - 1, -1, -1):
            t = torch.einsum("adc,ce->ade", a_list[i], carry)
            u, s, vh = _linalg.gram_svd(t.reshape(chi, d * chi))
            u = u[..., :, :chi]
            s = s[..., :chi]
            vh = vh[..., :chi, :]
            nrm = torch.linalg.vector_norm(s)
            s = s / torch.where(nrm > 1e-30, nrm, torch.ones_like(nrm))
            # Vidal: right-canonical B_i = Γ_i λ_{i+1}  =>  Γ_i = B_i λ_{i+1}^{-1}
            inv_r = _safe_inv(lambdas[i + 1]).to(dt)
            gammas[i] = vh.reshape(chi, d, chi) * inv_r[None, None, :]
            lambdas[i] = s.real.to(torch.float32)
            carry = u * s.to(dt)[None, :]
        # bond 0 is the open left edge: slot 0 only
        lambdas[0] = lam_edge
        self.gammas = torch.stack(gammas)
        self.lambdas = torch.stack(lambdas)

    def theta_single(self, i: int) -> Tensor:
        """Canonical single-site tensor λ_{i-1} Γ_i λ_i (χ, d, χ)."""
        dt = self.gammas.dtype
        return (
            self.lambdas[i].to(dt)[:, None, None]
            * self.gammas[i]
            * self.lambdas[i + 1].to(dt)[None, None, :]
        )

    def expectation_single(self, op: Any, i: int) -> Tensor:
        """⟨O_i⟩ via the canonical environment (exact in Vidal form)."""
        th = self.theta_single(i)
        op = torch.as_tensor(op, device=th.device).to(th.dtype)
        num = torch.einsum("aib,ij,ajb->", th.conj(), op, th)
        den = torch.einsum("aib,aib->", th.conj(), th)
        return num / den

    def expectation_two_site(self, op: Any, i: int) -> Tensor:
        """⟨O_{i,i+1}⟩ for a (d², d²) operator on bond i."""
        dt = self.gammas.dtype
        left = self.lambdas[i].to(dt)[:, None, None] * self.gammas[i]
        left = left * self.lambdas[i + 1].to(dt)[None, None, :]
        right = self.gammas[i + 1] * self.lambdas[i + 2].to(dt)[None, None, :]
        th = torch.einsum("aim,mjb->aijb", left, right)
        th2 = th.reshape(self.chi, self.d * self.d, self.chi)
        op = torch.as_tensor(op, device=th.device).to(dt)
        oth = torch.einsum("pq,aqb->apb", op, th2)
        num = torch.einsum("apb,apb->", th2.conj(), oth)
        den = torch.einsum("apb,apb->", th2.conj(), th2)
        return num / den

    def entanglement_entropy(self, bond: int) -> Tensor:
        """Von Neumann entropy of the bond's λ spectrum."""
        p = self.lambdas[bond] ** 2
        p = p / torch.sum(p)
        p = torch.clamp(p, 1e-12, 1.0)
        return -torch.sum(p * torch.log(p))

    def to_mps_tensors(self) -> List[Tensor]:
        """Site tensors (l, d, r) of the equivalent left-absorbed MPS."""
        out = []
        dt = self.gammas.dtype
        for i in range(self.n):
            t = self.lambdas[i].to(dt)[:, None, None] * self.gammas[i]
            if i == self.n - 1:
                t = t * self.lambdas[i + 1].to(dt)[None, None, :]
            out.append(t)
        return out

    def wavefunction(self) -> Tensor:
        """Dense state (small n only)."""
        tensors = self.to_mps_tensors()
        # the padded edge bond starts at slot 0
        psi = tensors[0][:1].reshape(self.d, self.chi)
        with config.full_float32():
            for t in tensors[1:]:
                psi = torch.einsum("xm,mdb->xdb", psi, t).reshape(-1, self.chi)
        return psi[:, 0]
