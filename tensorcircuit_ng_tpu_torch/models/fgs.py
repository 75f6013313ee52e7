"""Fermion Gaussian states (free fermions) on the device.

Counterpart of ``tensorcircuit_ng_tpu/models/fgs.py``.  :class:`FGSSimulator`
keeps the 2L x L Bogoliubov matrix ``alpha`` on its device (Ψ = (c_1..c_L,
c†_1..c†_L), H = (1/2) Ψ† M Ψ, C = ⟨Ψ Ψ†⟩ = alpha alpha†): evolution by
``torch.linalg.matrix_exp`` (in complex128 for a complex64 state),
re-orthonormalization by the reduced
``torch.linalg.qr``, the O(L) local updates (``evol_hp``, ``evol_sp``,
``evol_cp``, ``evol_icp``; the 4x4 exponentials in closed form) as an
out-of-place ``index_copy`` of the rows they touch (autograd never sees a write into a tensor it saved, so a chain of
updates has a gradient), the correlation matrices, entropies, charge moments
and the entanglement asymmetry (its angles as one batch of determinants).
``post_select`` projects exactly (the limit of the imaginary-time step
that the JAX package takes at e^{±30}, where a complex64 state loses its
correlation matrix: F17).

``alpha`` is defined up to a unitary on its right, which QR and ``eigh``
pick differently on another device or library: compare ``get_cmatrix``,
``overlap`` and the entropies across devices, not ``alpha``.

:class:`FGSTestSimulator` is the dense 2^L Jordan-Wigner oracle, host
numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config

__all__ = ["FGSSimulator", "FGSCircuit", "FGSTestSimulator", "onehot_matrix"]

Device = Union[None, str, torch.device]


def onehot_matrix(i: int, j: int, N: int) -> np.ndarray:
    """N x N matrix with a single 1 at (i, j)."""
    m = np.zeros([N, N], dtype=complex)
    m[i, j] = 1.0
    return m


def _on(x: Any, device: Device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as ``dtype``: a tensor on its own device (keeps autograd) unless
    ``device`` is given, anything else on ``device`` (default: the
    configured one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else config.resolve_device(device), dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=config.resolve_device(device), dtype=dtype)


def _expm(a: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.matrix_exp``, a complex64 argument in complex128 and
    rounded once: torch's complex64 exponential of a 1024x1024 (or 4x4)
    anti-hermitian generator of norm ~1 is unitary only to 5e-5 (3e-5; the
    JAX package's ``expm`` to 1.2e-7)."""
    if a.dtype == torch.complex64:
        return torch.linalg.matrix_exp(a.to(torch.complex128)).to(a.dtype)
    return torch.linalg.matrix_exp(a)


#: the 4x4 generators of the local updates on the rows [i, j, L+i, L+j]:
#: M = chi * A + conj(chi) * B
_HP = (
    np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, -1, 0]]),
    np.array([[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, -1], [0, 0, 0, 0]]),
)
_SP = (
    np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]),
    np.array([[0, 0, 0, -1], [0, 0, 1, 0], [0, 0, 0, 0], [0, 0, 0, 0]]),
)


class FGSSimulator:
    """Free-fermion simulator on the correlation-matrix representation, on
    ``device`` (default: the configured device, which needs a card when it is
    CUDA; a tensor ``alpha`` or ``hc`` stays on its own device unless
    ``device`` is given)."""

    def __init__(
        self,
        L: int,
        filled: Optional[Sequence[int]] = None,
        alpha: Optional[Any] = None,
        hc: Optional[Any] = None,
        dtype: Optional[str] = None,
        device: Device = None,
    ) -> None:
        self.L = L
        dt = config.torch_dtype(dtype)
        if alpha is not None:
            self.alpha = _on(alpha, device, dt)
        elif hc is not None:
            # the ground state: the annihilators are the positive-energy BdG
            # modes, alpha's columns their conjugates
            _, v = torch.linalg.eigh(_on(hc, device, dt))
            self.alpha = torch.conj(v[:, L:])
        else:
            self.alpha = _on(self.init_alpha(list(filled or []), L), device, dt)
        self.alpha0 = self.alpha  # the initial state, for the OTOC correlators
        self.cmatrix: Optional[torch.Tensor] = None
        self.otcmatrix: dict = {}

    @property
    def device(self) -> torch.device:
        return self.alpha.device

    def _invalidate(self) -> None:
        self.cmatrix = None
        self.otcmatrix = {}

    @staticmethod
    def init_alpha(filled: Sequence[int], L: int) -> np.ndarray:
        """Initial alpha for the occupied sites ``filled``."""
        alpha = np.zeros([2 * L, L])
        for i in range(L):
            if i in filled:
                alpha[i + L, i] = 1.0
            else:
                alpha[i, i] = 1.0
        return alpha

    @staticmethod
    def wmatrix(L: int) -> np.ndarray:
        r"""The fermion -> Majorana transform W with γ = W Ψ: rows alternate
        γ_{2i} = c_i + c†_i and γ_{2i+1} = i(c_i - c†_i)."""
        w = np.zeros([2 * L, 2 * L], dtype=complex)
        for i in range(2 * L):
            if i % 2 == 1:
                w[i, (i - 1) // 2] = 1.0j
                w[i, (i - 1) // 2 + L] = -1.0j
            else:
                w[i, i // 2] = 1.0
                w[i, i // 2 + L] = 1.0
        return w

    @classmethod
    def fermion_diagonalization(cls, hc: Any, L: int, device: Device = None) -> Tuple[torch.Tensor, ...]:
        """(eigenvalues descending, eigenvectors, alpha) of a BdG matrix."""
        es, u = torch.linalg.eigh(_on(hc, device, config.torch_dtype()))
        es, u = torch.flip(es, [0]), torch.flip(u, [1])
        return es, u, u[:, :L]

    @classmethod
    def fermion_diagonalization_2(cls, hc: Any, L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Schur-based real-Majorana diagonalization, on the host (scipy)."""
        import scipy.linalg as sl

        w = cls.wmatrix(L)
        hc = hc.detach().cpu().numpy() if isinstance(hc, torch.Tensor) else np.asarray(hc)
        hm = np.real(-1.0j * (0.25 * w @ hc @ w.conj().T))
        hd, om = sl.schur(hm, output="real")
        es = w.conj().T @ (1.0j * hd) @ w
        u = 0.5 * w.conj().T @ om.T @ w
        return es, u, u.conj().T[:, :L]

    # ------------------------------------------------------------------
    # generators (BdG matrices, host numpy)
    # ------------------------------------------------------------------

    @staticmethod
    def hopping(L: int, i: int, j: int, chi: complex = 1.0) -> np.ndarray:
        r"""M for H = chi c_i† c_j + conj(chi) c_j† c_i."""
        h = np.zeros((L, L), dtype=complex)
        h[i, j] += chi
        h[j, i] += np.conj(chi)
        return FGSSimulator.bdg(h, np.zeros((L, L), dtype=complex))

    @staticmethod
    def chemical_potential(L: int, i: int, mu: float = 1.0) -> np.ndarray:
        r"""M for H = mu c_i† c_i."""
        h = np.zeros((L, L), dtype=complex)
        h[i, i] = mu
        return FGSSimulator.bdg(h, np.zeros((L, L), dtype=complex))

    @staticmethod
    def pairing(L: int, i: int, j: int, delta: complex = 1.0) -> np.ndarray:
        r"""M for H = delta c_i c_j + conj(delta) c_j† c_i†."""
        d = np.zeros((L, L), dtype=complex)
        d[i, j] += delta
        d[j, i] -= delta
        return FGSSimulator.bdg(np.zeros((L, L), dtype=complex), d)

    sc_pairing = pairing

    @staticmethod
    def bdg(h: np.ndarray, d: np.ndarray) -> np.ndarray:
        r"""M = [[h, -conj(d)], [d, -h^T]] (hermitized) for
        H = Σ h_ij c_i† c_j + (1/2) Σ (d_ij c_i c_j + h.c.) = (1/2) Ψ† M Ψ + tr(h)/2,
        h hermitian, d antisymmetric."""
        h = np.asarray(h, dtype=complex)
        d = np.asarray(d, dtype=complex)
        L = h.shape[0]
        m = np.zeros((2 * L, 2 * L), dtype=complex)
        m[:L, :L] = h
        m[L:, L:] = -h.T
        m[:L, L:] = -np.conj(d)
        m[L:, :L] = d
        return (m + m.conj().T) / 2.0

    # ------------------------------------------------------------------
    # evolution
    # ------------------------------------------------------------------

    def _generator(self, m: Any) -> torch.Tensor:
        return _on(m, self.device, self.alpha.dtype)

    def _scalar(self, x: Any) -> torch.Tensor:
        """A scalar as a 0-d tensor of alpha's dtype on its device."""
        return _on(x, self.device, self.alpha.dtype)

    def evol_hamiltonian(self, m: Any, t: Any = 1.0) -> None:
        r"""Unitary evolution e^{-iHt} with H = (1/2) Ψ† M Ψ."""
        m = self._generator(m)
        self.alpha = _expm(-1j * self._scalar(t) * m) @ self.alpha
        self._invalidate()

    def evol_ihamiltonian(self, m: Any, t: Any = 1.0) -> None:
        r"""Imaginary-time evolution e^{-Ht}, re-orthonormalized.  The
        annihilator map is antilinear in the state, so e^{-Ht} on kets is
        alpha' = e^{+Mt} alpha."""
        m = self._generator(m)
        self.alpha = _expm(self._scalar(t) * m) @ self.alpha
        self.orthogonalize()
        self._invalidate()

    def evol_ghamiltonian(self, m: Any, t: Any = 1.0) -> None:
        r"""Evolution by a general (non-hermitian) M, re-orthonormalized."""
        m = self._generator(m)
        self.alpha = _expm(-1j * self._scalar(t) * m) @ self.alpha
        self.orthogonalize()
        self._invalidate()

    def orthogonalize(self) -> None:
        self.alpha = torch.linalg.qr(self.alpha, mode="reduced")[0]

    orthogonal = orthogonalize

    def _rows(self, *rows: int) -> torch.Tensor:
        """The row indices as an int64 tensor on alpha's device, stacked from
        0-d views of a kept arange (no copy from the host)."""
        ar = getattr(self, "_arange", None)
        if ar is None or ar.device != self.device or ar.shape[0] != 2 * self.L:
            ar = self._arange = torch.arange(2 * self.L, device=self.device)
        return torch.stack([ar[r] for r in rows])

    def _update_rows(self, idx: torch.Tensor, new_rows: torch.Tensor) -> None:
        self.alpha = self.alpha.index_copy(0, idx, new_rows)
        self._invalidate()

    def _evol_rows4(self, i: int, j: int, pair: Tuple[np.ndarray, np.ndarray], chi: Any) -> None:
        """alpha's rows [i, j, L+i, L+j] times exp(-i M), M = chi A +
        conj(chi) B.  Both generators square to |chi|² (two 2x2 blocks
        [[0, z], [conj(z), 0]] with |z| = |chi|), so exp(-i M) = cos|chi| -
        i sin|chi| / |chi| M exactly: no ``matrix_exp`` (whose degree choice
        waits for the card at every update) and no host copy."""
        c = self._scalar(chi)
        dev, dt = self.device, self.alpha.dtype
        m4 = c * config.device_constant(pair[0], dev, dt) + torch.conj(c) * config.device_constant(pair[1], dev, dt)
        r = torch.abs(c)
        u4 = torch.cos(r) * config.device_constant(np.eye(4), dev, dt) - 1j * torch.sinc(r / np.pi) * m4
        idx = self._rows(i, j, self.L + i, self.L + j)
        self._update_rows(idx, u4 @ self.alpha.index_select(0, idx))

    def evol_hp(self, i: int, j: int, chi: Any = 0) -> None:
        r"""Evolve by H = chi c_i† c_j + h.c. in O(L) (``evol_hamiltonian``
        of ``hopping(L, i, j, chi)``); ``chi`` may be a tensor with autograd."""
        self._evol_rows4(i, j, _HP, chi)

    def evol_sp(self, i: int, j: int, chi: Any = 0) -> None:
        r"""Evolve by H = chi c_i c_j + h.c. in O(L) (``evol_hamiltonian`` of
        ``pairing(L, i, j, chi)``)."""
        self._evol_rows4(i, j, _SP, chi)

    def _scale_rows(self, i: int, a: torch.Tensor, b: torch.Tensor) -> None:
        idx = self._rows(i, self.L + i)
        self._update_rows(idx, torch.stack([a, b])[:, None] * self.alpha.index_select(0, idx))

    def evol_cp(self, i: int, chi: Any = 0) -> None:
        r"""Evolve by H = chi c_i† c_i in O(L)."""
        c = self._scalar(chi)
        self._scale_rows(i, torch.exp(-1j * c), torch.exp(1j * c))

    def evol_icp(self, i: int, chi: Any = 0) -> None:
        r"""Imaginary-time evolve by H = chi c_i† c_i in O(L) (alpha' ∝
        e^{+M} alpha, as ``evol_ihamiltonian``), re-orthonormalized."""
        c = self._scalar(chi)
        self._scale_rows(i, torch.exp(c), torch.exp(-c))
        self.orthogonalize()

    # ------------------------------------------------------------------
    # observables
    # ------------------------------------------------------------------

    def get_alpha(self) -> torch.Tensor:
        return self.alpha

    def get_cmatrix(self, now_i: bool = True, now_j: bool = True) -> torch.Tensor:
        r"""C = ⟨Ψ Ψ†⟩ = alpha alpha† (2L x 2L); ``now_i``/``now_j`` False take
        the initial state's alpha on that side (the out-of-time-order ones)."""
        key = (int(now_i), int(now_j))
        if key == (1, 1):
            if self.cmatrix is None:
                self.cmatrix = self.alpha @ self.alpha.mH
            return self.cmatrix
        if key not in self.otcmatrix:
            a = self.alpha if now_i else self.alpha0
            b = self.alpha if now_j else self.alpha0
            self.otcmatrix[key] = a @ b.mH
        return self.otcmatrix[key]

    def _region_rows(self, sites: Sequence[int]) -> torch.Tensor:
        idx = [int(i) for i in sites] + [self.L + int(i) for i in sites]
        return torch.as_tensor(idx, dtype=torch.int64).to(self.device)

    def _region_cmatrix(self, sites: Sequence[int]) -> torch.Tensor:
        """C on the rows and columns of ``sites`` and their L-shifted twins,
        O(L · |sites|²): alpha's rows first, then the product."""
        sub = self.alpha.index_select(0, self._region_rows(sites))
        return sub @ sub.mH

    def get_reduced_cmatrix(self, subsystems_to_trace_out: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The correlation matrix of the kept sites."""
        trace_set = set(subsystems_to_trace_out or [])
        keep = [i for i in range(self.L) if i not in trace_set]
        if not keep:
            raise ValueError("the full system is traced out, no subsystems to keep")
        return self._region_cmatrix(keep)

    def expectation_2body(self, i: int, j: int, now_i: bool = True, now_j: bool = True) -> torch.Tensor:
        r"""⟨op_i op_j⟩, op_m = c_m for m < L and c†_{m-L} for m >= L: C[i, (j+L) mod 2L]
        (⟨c†_i c_j⟩ = ``expectation_2body(i + L, j)``)."""
        return self.get_cmatrix(now_i, now_j)[i, (j + self.L) % (2 * self.L)]

    def expectation_4body(self, i: int, j: int, k: int, l: int) -> torch.Tensor:
        r"""⟨op_i op_j op_k op_l⟩ by Wick's theorem."""
        e = self.expectation_2body
        return e(i, j) * e(k, l) - e(i, k) * e(j, l) + e(i, l) * e(j, k)

    def occupation(self, i: int) -> torch.Tensor:
        r"""⟨c†_i c_i⟩."""
        return torch.real(self.expectation_2body(self.L + i, i))

    def get_bogoliubov_uv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        r"""(u, v) with the annihilators b_k = Σ_i u_ik c_i + v_ik c†_i."""
        return self.alpha[: self.L, :], self.alpha[self.L :, :]

    def get_cmatrix_majorana(self) -> torch.Tensor:
        r"""⟨γ γ†⟩ in the Majorana basis."""
        w = config.device_constant(self.wmatrix(self.L), self.device, self.alpha.dtype)
        return w @ self.get_cmatrix() @ w.mH

    def get_covariance_matrix(self) -> torch.Tensor:
        """-i (2 M - I), M the Majorana correlation matrix."""
        m = self.get_cmatrix_majorana()
        return -1.0j * (2.0 * m - torch.eye(2 * self.L, dtype=m.dtype, device=m.device))

    # ---- charge moments and the entanglement asymmetry ----

    @staticmethod
    def _charge_moment_core(gamma: torch.Tensor, angles: torch.Tensor, n: int) -> torch.Tensor:
        """Z_n for each row of ``angles`` ([batch, n]): sqrt det(M^n + W),
        W the product over i of ((1+eps) - Γ) W (1+eps - Γ)^{-1} (1+Γ)/2
        diag(e^{i (a_{i+1} - a_i) N}).  Computed in complex128 and returned
        in Γ's dtype: (1+eps) - Γ has eigenvalues down to eps = 1e-3, and in
        complex64 its inverse and products round Z_n by 1e-4 (2.4e-4 to
        3.7e-4 in the JAX package at L=6; 8e-8 from a complex64 Γ here)."""
        out_dtype = gamma.dtype
        gamma, angles = gamma.to(torch.complex128), angles.to(torch.complex128)
        d = gamma.shape[-1]
        eye = torch.eye(d, dtype=gamma.dtype, device=gamma.device)
        eps = {2: 1e-3, 3: 2e-2}.get(n, 8e-2)
        na = torch.cat([-torch.ones(d // 2), torch.ones(d // 2)]).to(device=gamma.device, dtype=gamma.dtype)
        half = (eye - gamma) / 2.0
        m = half
        for _ in range(n - 1):
            m = m @ half
        shifted = (1 + eps) * eye - gamma
        invm = torch.linalg.inv(shifted)
        plus = (eye + gamma) / 2.0
        wprod = eye.expand(angles.shape[0], d, d)
        for i in range(n):
            dphase = angles[:, (i + 1) % n] - angles[:, i]
            wprod = ((shifted @ (wprod @ invm)) @ plus) * torch.exp(1.0j * dphase[:, None] * na[None, :])[:, None, :]
        return torch.sqrt(torch.linalg.det(m + wprod)).to(out_dtype)

    def charge_moment(
        self, alpha_angles: Any, n: int, subsystems_to_trace_out: Optional[Sequence[int]] = None
    ) -> torch.Tensor:
        """The charge moment Z_n({alpha}) of the kept sites (arXiv 2302.03330)."""
        m = self.get_reduced_cmatrix(subsystems_to_trace_out)
        gamma = 2.0 * m - torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        angles = _on(alpha_angles, m.device, m.dtype).reshape(1, n)
        return self._charge_moment_core(gamma, angles, n)[0]

    def renyi_entanglement_asymmetry(
        self,
        n: int,
        subsystems_to_trace_out: Optional[Sequence[int]] = None,
        batch: int = 100,
        status: Optional[Any] = None,
        with_std: bool = False,
    ) -> Any:
        """The Monte-Carlo Rényi-n entropy of the charge-dephased reduced
        state, S_n(ρ_AQ) = 1/(1-n) log E_α[Z_n(α)] (not normalized by tr ρ_A^n,
        as in the JAX package).  ``status``: [batch, n] angles in (-π, π),
        else drawn from an unseeded ``np.random.default_rng()``; the batch
        is one set of batched determinants."""
        if status is None:
            status = np.random.default_rng().uniform(-np.pi, np.pi, size=[batch, n])
        m = self.get_reduced_cmatrix(subsystems_to_trace_out)
        gamma = 2.0 * m - torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        r = self._charge_moment_core(gamma, _on(status, m.device, m.dtype), n)
        saq = 1.0 / (1 - n) * torch.log(torch.real(torch.mean(r)))
        if not with_std:
            return saq
        return saq, torch.abs(1.0 / (1 - n) * torch.std(r, correction=0) / saq)

    def cond_measure(self, ind: int, status: Any, with_prob: bool = False) -> Any:
        """Measure the occupation of site ``ind`` and collapse: the outcome
        (sign(status - P(0) + 1e-12) + 1) / 2 (1. occupied; sign(0) = 0
        gives 0.5, as in the JAX package), optionally with [P(0), P(1)]."""
        row = self.alpha[ind]
        p0 = torch.sum(torch.real(row * torch.conj(row)))  # C[ind, ind] = P(unoccupied)
        status = _on(status, self.device, p0.dtype)
        keep = (torch.sign(status - p0 + 1e-12) + 1) / 2
        self.post_select(ind, keep)
        if with_prob:
            return keep, torch.stack([p0, 1 - p0])
        return keep

    def _region_spectrum(self, region: Sequence[int]) -> torch.Tensor:
        return torch.real(torch.linalg.eigvalsh(self._region_cmatrix(region)))

    def entropy(self, region: Sequence[int]) -> torch.Tensor:
        r"""The entanglement entropy of the sites ``region``; the spectrum
        clipped at 10 eps of its dtype (1 - 1e-12 rounds to 1 in float32)."""
        lam = self._region_spectrum(region)
        eps = 10.0 * torch.finfo(lam.dtype).eps
        lam = torch.clamp(lam, eps, 1 - eps)
        return -0.5 * torch.sum(lam * torch.log(lam) + (1 - lam) * torch.log(1 - lam))

    def renyi_entropy(self, region: Sequence[int], k: int = 2) -> torch.Tensor:
        lam = torch.clamp(self._region_spectrum(region), 1e-12, 1 - 1e-12)
        return 0.5 * torch.sum(torch.log(lam**k + (1 - lam) ** k)) / (1 - k)

    def overlap(self, other: "FGSSimulator") -> torch.Tensor:
        r"""|⟨ψ1|ψ2⟩| = sqrt |det(alpha_1† alpha_2)|, the determinant's modulus
        as the product of R's diagonal in a QR of the overlap matrix (the
        QR the simulator already runs: the card's first LU initializes
        another solver library, 2.9 s)."""
        r = torch.linalg.qr(self.alpha.mH @ other.alpha, mode="r")[1]
        return torch.sqrt(torch.prod(torch.abs(torch.diagonal(r))))

    def post_select(self, i: int, keep: Any = 0) -> None:
        r"""Project mode i onto occupation ``keep`` (0 or 1, a tensor too; 0.5,
        the outcome of ``cond_measure`` at sign(0) = 0, leaves the state), and
        re-orthonormalize.

        The projection is the limit t -> oo of e^{-t (1 - 2 keep) n_i}, taken
        exactly: the "grown" row g (i for keep 0, L+i for keep 1) becomes the
        annihilator e_g, and the other L-1 columns are alpha's combinations
        with no weight on row g (a Householder reflection of the columns
        onto conj(alpha[g])), rows i and L+i cleared.  The JAX package takes
        the step at t = 30 (rows scaled by e^{±30}) and a QR of that matrix,
        which rounds the other rows at 1e13 times their scale: its correlation
        matrix after a projection is O(1) off at complex64 (ROADMAP.md Queue
        3, F17)."""
        L, A = self.L, self.alpha
        sign = (1.0 - 2.0 * _on(keep, self.device, torch.float32)).to(A.real.dtype)
        up, dn = (1 + sign) / 2, (1 - sign) / 2  # sign +1: row i grows; -1: row L+i
        grown = up * A[i] + dn * A[L + i]
        x = torch.conj(grown) / torch.linalg.vector_norm(grown)
        # Householder H (hermitian, unitary) with H x = -e^{i arg x_0} e_0:
        # alpha H's first column carries the whole grown row, the others none
        phase = torch.sgn(x[0]) + (x[0] == 0).to(A.dtype)
        w = x + phase * torch.eye(L, 1, dtype=A.dtype, device=A.device)[:, 0]
        w = w / torch.linalg.vector_norm(w)
        rest = (A - 2.0 * (A @ w)[:, None] * torch.conj(w)[None, :])[:, 1:]
        rows = self._rows(i, L + i)
        rest = rest.index_fill(0, rows, 0)
        e_g = torch.zeros(2 * L, dtype=A.dtype, device=A.device)
        e_g = e_g.index_copy(0, rows, torch.stack([up, dn]).to(A.dtype))
        q = torch.linalg.qr(torch.cat([e_g[:, None], rest], dim=1), mode="reduced")[0]
        mix = torch.abs(sign).to(A.dtype)
        self.alpha = mix * q + (1 - mix) * A
        self._invalidate()


FGSCircuit = FGSSimulator


# ----------------------------------------------------------------------
# the dense Jordan-Wigner oracle (host numpy)
# ----------------------------------------------------------------------


def _reduced_rho(psi: np.ndarray, L: int, keep: Sequence[int]) -> np.ndarray:
    """The density matrix of the kept sites (in their order) of a 2^L ket."""
    keep = list(keep)
    rest = [i for i in range(L) if i not in set(keep)]
    t = np.transpose(psi.reshape((2,) * L), keep + rest).reshape(2 ** len(keep), -1)
    return t @ t.conj().T


def _spectrum(rho: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return np.clip(np.real(np.linalg.eigvalsh(rho)), eps, 1.0)


class FGSTestSimulator:
    """The dense 2^L Jordan-Wigner oracle, host numpy (complex128)."""

    def __init__(self, L: int, filled: Optional[Sequence[int]] = None) -> None:
        self.L = L
        psi = np.zeros(2**L, dtype=complex)
        idx = 0
        for i in filled or []:
            idx |= 1 << (L - 1 - i)
        psi[idx] = 1.0  # c†_{i1} c†_{i2} ... |0> with i1 < i2 < ...: JW signs +1
        self.psi = psi

    def c_op(self, i: int) -> np.ndarray:
        """The JW annihilation operator c_i as a dense matrix."""
        sz, sm, eye = np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2)
        m = np.eye(1)
        for k in range(self.L):
            m = np.kron(m, sz if k < i else sm if k == i else eye)
        return m

    def _ops(self) -> List[np.ndarray]:
        cs = [self.c_op(i) for i in range(self.L)]
        return cs + [c.conj().T for c in cs]

    def hamiltonian_dense(self, h: np.ndarray, d: Optional[np.ndarray] = None) -> np.ndarray:
        """H = Σ h_ij c†_i c_j + (1/2) Σ (d_ij c_i c_j + h.c.) as a 2^L matrix."""
        L = self.L
        cs = [self.c_op(i) for i in range(L)]
        H = np.zeros((2**L, 2**L), dtype=complex)
        for i in range(L):
            for j in range(L):
                if h[i, j] != 0:
                    H += h[i, j] * cs[i].conj().T @ cs[j]
                if d is not None and d[i, j] != 0:
                    H += 0.5 * d[i, j] * cs[i] @ cs[j]
                    H += 0.5 * np.conj(d[i, j]) * cs[j].conj().T @ cs[i].conj().T
        return H

    get_hmatrix = hamiltonian_dense

    def _apply_expm(self, a: np.ndarray, normalize: bool = False) -> None:
        import scipy.linalg as sl

        self.psi = sl.expm(a) @ self.psi
        if normalize:
            self.orthogonal()

    def evol(self, h: np.ndarray, d: Optional[np.ndarray] = None, t: float = 1.0) -> None:
        self._apply_expm(-1j * t * self.hamiltonian_dense(h, d))

    evol_hamiltonian = evol

    def evol_ihamiltonian(self, h: np.ndarray, d: Optional[np.ndarray] = None, t: float = 1.0) -> None:
        self._apply_expm(-t * self.hamiltonian_dense(h, d), normalize=True)

    def evol_ghamiltonian(self, h: np.ndarray, d: Optional[np.ndarray] = None, t: float = 1.0) -> None:
        self._apply_expm(-1j * t * self.hamiltonian_dense(h, d), normalize=True)

    def hopping_jw(self, i: int, j: int, chi: complex = 1.0) -> np.ndarray:
        """Dense chi c†_i c_j + h.c."""
        ci, cj = self.c_op(i), self.c_op(j)
        return chi * ci.conj().T @ cj + np.conj(chi) * cj.conj().T @ ci

    def chemical_potential_jw(self, i: int, chi: float = 1.0) -> np.ndarray:
        """Dense chi c†_i c_i."""
        c = self.c_op(i)
        return chi * c.conj().T @ c

    def sc_pairing_jw(self, i: int, j: int, chi: complex = 1.0) -> np.ndarray:
        """Dense chi c_i c_j + h.c."""
        ci, cj = self.c_op(i), self.c_op(j)
        return chi * ci @ cj + np.conj(chi) * cj.conj().T @ ci.conj().T

    def evol_hp(self, i: int, j: int, chi: complex = 0) -> None:
        self._apply_expm(-1j * self.hopping_jw(i, j, chi))

    def evol_sp(self, i: int, j: int, chi: complex = 0) -> None:
        self._apply_expm(-1j * self.sc_pairing_jw(i, j, chi))

    def evol_cp(self, i: int, chi: float = 0) -> None:
        self._apply_expm(-1j * self.chemical_potential_jw(i, chi))

    def evol_icp(self, i: int, chi: float = 0) -> None:
        self._apply_expm(self.chemical_potential_jw(i, -chi), normalize=True)

    def orthogonal(self) -> None:
        """Normalize the state."""
        self.psi = self.psi / np.linalg.norm(self.psi)

    @staticmethod
    def init_state(filled: Sequence[int], L: int) -> np.ndarray:
        """The dense JW basis state with ``filled`` occupied."""
        return FGSTestSimulator(L, filled=list(filled)).psi

    def get_ot_cmatrix(self, psi0: Optional[np.ndarray] = None) -> np.ndarray:
        """⟨ψ0|Ψ Ψ†|ψ⟩ (the state itself without ``psi0``)."""
        ops = self._ops()
        bra = self.psi if psi0 is None else np.asarray(psi0)
        n = len(ops)
        C = np.zeros((n, n), dtype=complex)
        for a in range(n):
            for b in range(n):
                C[a, b] = bra.conj() @ (ops[a] @ ops[b].conj().T) @ self.psi
        return C

    def get_cmatrix(self) -> np.ndarray:
        """⟨Ψ Ψ†⟩ in the (c, c†) block convention of :class:`FGSSimulator`."""
        return self.get_ot_cmatrix()

    def get_cmatrix_majorana(self) -> np.ndarray:
        w = FGSSimulator.wmatrix(self.L)
        return w @ self.get_cmatrix() @ w.conj().T

    def occupation(self, i: int) -> float:
        c = self.c_op(i)
        return float(np.real(self.psi.conj() @ c.conj().T @ c @ self.psi))

    def expectation_2body(self, i: int, j: int) -> complex:
        return complex(self.get_cmatrix()[i, (j + self.L) % (2 * self.L)])

    def expectation_4body(self, i: int, j: int, k: int, l: int) -> complex:
        """The exact ⟨op_i op_j op_k op_l⟩."""
        ops = self._ops()
        return complex(self.psi.conj() @ ops[i] @ ops[j] @ ops[k] @ ops[l] @ self.psi)

    def entropy(self, region: Sequence[int]) -> float:
        lam = _spectrum(_reduced_rho(self.psi, self.L, sorted(region)))
        return float(-np.sum(lam * np.log(lam)))

    def renyi_entropy(self, region: Sequence[int], k: int = 2) -> float:
        if k == 1:
            return self.entropy(region)
        lam = _spectrum(_reduced_rho(self.psi, self.L, sorted(region)))
        return float(np.log(np.sum(lam**k)) / (1 - k))

    def get_dm(self) -> np.ndarray:
        return np.outer(self.psi, self.psi.conj())

    def product(self, other: "FGSTestSimulator") -> complex:
        """⟨self|other⟩."""
        return complex(self.psi.conj() @ other.psi)

    def overlap(self, other: "FGSTestSimulator") -> float:
        return abs(self.product(other))

    def _number_op(self, region: Sequence[int]) -> np.ndarray:
        n_op = np.zeros((2**self.L, 2**self.L), dtype=complex)
        for i in region:
            c = self.c_op(i)
            n_op += c.conj().T @ c
        return n_op

    def charge_moment(
        self, alpha_angles: Sequence[float], n: int, subsystems_to_trace_out: Optional[Sequence[int]] = None
    ) -> complex:
        """Z_n = tr Π_i ρ_A e^{i (a_{i+1} - a_i) Q_A}."""
        import scipy.linalg as sl

        trace_out = set(subsystems_to_trace_out or [])
        keep = [i for i in range(self.L) if i not in trace_out]
        rho = _reduced_rho(self.psi, self.L, keep)
        q = FGSTestSimulator(len(keep))._number_op(range(len(keep)))
        m = np.eye(rho.shape[0], dtype=complex)
        for i in range(n):
            m = m @ rho @ sl.expm(1j * (alpha_angles[(i + 1) % n] - alpha_angles[i]) * q)
        return complex(np.trace(m))

    def post_select(self, i: int, keep: int = 0) -> None:
        """Project site i onto occupation ``keep`` and renormalize."""
        n_op = self.chemical_potential_jw(i)
        proj = n_op if keep == 1 else np.eye(2**self.L) - n_op
        self.psi = proj @ self.psi
        self.orthogonal()

    def cond_measure(self, ind: int, status: float, with_prob: bool = False) -> Any:
        """Measure site ``ind`` with the uniform ``status``."""
        p1 = self.occupation(ind)
        p0 = 1.0 - p1
        keep = 0 if status < p0 else 1
        self.post_select(ind, keep)
        if with_prob:
            return float(keep), np.array([p0, p1])
        return float(keep)

    def fermion_diagonalization(self, hc: Any, L: int) -> np.ndarray:
        """The ground state's alpha of a BdG matrix (host)."""
        es, u = np.linalg.eigh(np.asarray(hc))
        return u[:, ::-1][:, :L]

    def renyi_entanglement_asymmetry(
        self,
        n: int,
        subsystems_to_trace_out: Optional[Sequence[int]] = None,
        batch: int = 100,
        status: Optional[np.ndarray] = None,
        with_std: bool = False,
    ) -> Any:
        """S_n of the charge-dephased ρ_A, as :class:`FGSSimulator` defines it."""
        if status is None:
            status = np.random.default_rng().uniform(-np.pi, np.pi, size=[batch, n])
        zs = np.array([self.charge_moment(a, n, subsystems_to_trace_out) for a in np.asarray(status)])
        saq = 1.0 / (1 - n) * np.log(float(np.mean(zs.real)))
        if with_std:
            return saq, abs(1.0 / (1 - n) * float(np.std(zs.real)) / saq)
        return saq
