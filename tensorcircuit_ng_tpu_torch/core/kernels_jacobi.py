"""One-sided Jacobi SVD of a batch of complex matrices, the whole sweep loop
inside one kernel.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_jacobi.py``.  The JAX
package runs the Hestenes iteration in one Pallas kernel, in one of three
TPU layouts (``_run_kernel_lanes``, ``_run_kernel_packed``, ``_run_kernel``);
all three compute one function, and here one hand-written Hopper kernel,
K5 (``csrc/jacobi_svd.cu``, ``tcng_jacobi_svd``), serves it:

- **transposed planes**: each matrix is stored as ``(n, m)`` float32 (real,
  imag) planes, so row j is column j of A;
- **Brent-Luk tournament**: slot 0 stays, the other slots cycle;
  ``new_top = [top0, bot0, top1..top_{h-2}]``, ``new_bot = [bot1..bot_{h-1},
  top_{h-1}]``; all n/2 plane rotations of a round at once, ``sweeps *
  (n-1)`` rounds, no convergence test;
- optional V accumulated with the same rotations, in the same kernel;
- one thread-block cluster of C CTAs a matrix, each holding a slice of every
  column (:func:`_cluster_size` picks C from the card's occupancy).

:func:`jacobi_rotations` is K5's wrapper: a CUDA tensor launches the kernel
(``jacobi_rotations.launches`` counts the launches) or raises; a CPU tensor
runs :func:`jacobi_rotations_plain`, which repeats the Pallas
``_jacobi_kernel`` step by step in torch.  Around it, as XLA ops are around
the Pallas call in JAX, torch ops pad, sort and recover ``(u, s, vh)``
(:func:`jacobi_svd_nodiff`, the counterpart of ``jacobi_svd_pallas``).
:func:`jacobi_svd` differentiates with the degenerate-safe SVD adjoint of
``linalg`` (plain torch: JAX has no backward kernel here), and
:func:`subspace_svd` runs K5 on a compressed ``(m, chi + 16)`` panel.  The
TPU layout knobs ``LANES``, ``LANE_GROUP`` and ``PACKED`` do not carry over.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _build
from . import linalg as _linalg
from .transform_rules import front_vmap

__all__ = [
    "jacobi_rotations",
    "jacobi_rotations_plain",
    "cluster_size",
    "jacobi_svd_nodiff",
    "jacobi_svd_pallas",
    "jacobi_svd",
    "jacobi_svd_warm",
    "subspace_svd",
    "NS_ITERS",
    "OVERSAMPLE",
]

#: a CTA holds its slices of a matrix's (real, imag) planes in shared memory
#: (227 KB); the wrapper admits the shapes one CTA held before clusters
_MAX_SMEM_BYTES = 232448
_MAX_M = 256
#: the cluster sizes K5 launches with (CTAs a matrix; 8 is the portable limit)
_CLUSTERS = (1, 2, 4, 8)


def _smem_bytes(n: int, m: int, with_v: bool, c: int) -> int:
    """Shared memory of one K5 CTA in a cluster of ``c``: the partials
    buffer (2 parities x c ranks x n/2 pairs x 16 B), its two mbarriers
    (16 B), the rotations (n/2 x 16 B) and its slices of A's and V's
    planes, ceil(m/c) and ceil(n/c) elements of each column rounded up to
    even (the C ``smem_bytes`` of ``csrc/jacobi_svd.cu``)."""
    mw = -(-m // c)
    nw = -(-n // c) if with_v else 0
    return (2 * c + 1) * 16 * (n // 2) + 16 + 2 * 4 * n * (mw + mw % 2 + nw + nw % 2)


def _cluster_size(b: int, n: int, m: int, with_v: bool, max_active: Callable[[int], int]) -> int:
    """K5's cluster size for a batch of ``b`` (n, m) matrices.

    The largest C in {1, 2, 4, 8} whose slices fit one CTA and whose
    clusters hold the whole batch in one wave, ``b <= max_active(C)``
    (``cudaOccupancyMaxActiveClusters`` on the card); with no such C, the
    smallest that fits, in several waves.  Rounds are a dependent chain, so
    more CTAs a matrix shorten each round while the batch still runs at
    once.  Raises ValueError if no C fits (V's n x n planes of a matrix with
    n >> m, which :func:`jacobi_svd_nodiff` never gives: it needs m >= n).
    """
    fits = [c for c in _CLUSTERS if _smem_bytes(n, m, with_v, c) <= _MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(
            f"jacobi_rotations: unsupported shape n={n}, m={m}: the slices of a cluster of "
            f"{_CLUSTERS[-1]} exceed {_MAX_SMEM_BYTES} bytes a CTA{' with V' if with_v else ''}"
        )
    one_wave = [c for c in fits if b <= max_active(c)]
    return one_wave[-1] if one_wave else fits[0]


@functools.lru_cache(maxsize=None)
def _max_active_clusters(index: int, n: int, m: int, with_v: bool, c: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K5 on card ``index``."""
    lib = _build.library("jacobi_svd")
    with torch.cuda.device(index):
        count = lib.tcng_jacobi_max_clusters(n, m, int(with_v), c)
    if count < 0:
        _build.check("jacobi_svd", -count, "jacobi_rotations: cluster occupancy")
    return count


def cluster_size(dev: torch.device, b: int, n: int, m: int, with_v: bool) -> int:
    """The cluster size K5 takes on CUDA device ``dev`` for a (b, n, m) batch."""
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    return _cluster_size(b, n, m, with_v, lambda c: _max_active_clusters(index, n, m, with_v, c))


def jacobi_rotations_plain(
    xr: torch.Tensor, xi: torch.Tensor, sweeps: int, with_v: bool
) -> Tuple[torch.Tensor, ...]:
    """K5's plain version: the Pallas ``_jacobi_kernel`` round by round.

    ``xr/xi`` (B, n, m) float32 transposed planes (row j = column j), n
    even.  Returns the rotated planes and, with ``with_v``, V's transposed
    planes (B, n, n), every row back in its starting slot.
    """
    b, n, m = xr.shape
    h = n // 2
    f32 = torch.float32
    xtr, xbr = xr[:, :h], xr[:, h:]
    xti, xbi = xi[:, :h], xi[:, h:]
    if with_v:
        eye = torch.eye(n, dtype=f32, device=xr.device).expand(b, n, n)
        vtr, vbr = eye[:, :h], eye[:, h:]
        vti = torch.zeros_like(vtr)
        vbi = torch.zeros_like(vbr)

    def shuffle(top, bot):
        # Brent-Luk: new_top = [top0, bot0, top1..top_{h-2}],
        #            new_bot = [bot1..bot_{h-1}, top_{h-1}]
        nt = torch.cat([top[:, :1], bot[:, :1], top[:, 1 : h - 1]], dim=1)
        nb = torch.cat([bot[:, 1:], top[:, h - 1 :]], dim=1)
        return nt, nb

    for _ in range(sweeps * (n - 1)):
        app = torch.sum(xtr * xtr + xti * xti, dim=2, keepdim=True)
        aqq = torch.sum(xbr * xbr + xbi * xbi, dim=2, keepdim=True)
        # a_pq = <p, q> (conjugate on p)
        pr = torch.sum(xtr * xbr + xti * xbi, dim=2, keepdim=True)
        pi = torch.sum(xtr * xbi - xti * xbr, dim=2, keepdim=True)
        mod2 = pr * pr + pi * pi
        # the epsilon is a NORMAL float32 (min normal 1.18e-38); 1/sqrt, as
        # K5 computes it, not torch.rsqrt, whose approximate CUDA version
        # leaves c^2 + s^2 off 1 by ulps, compounded over the rotations
        inv_mod = 1.0 / torch.sqrt(mod2 + 1e-36)
        cph = pr * inv_mod
        sph = pi * inv_mod
        tau = (aqq - app) * 0.5 * inv_mod
        # sign(0) = 0: an exactly tied pair is not rotated this round
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = c * t
        skip = mod2 <= 1e-24 * (app * aqq)
        c = torch.where(skip, 1.0, c)
        s = torch.where(skip, 0.0, s)
        scph = s * cph
        ssph = s * sph

        def rot(tr, ti, br, bi):
            # p' = c p - s e^{-i phi} q ;  q' = s e^{i phi} p + c q
            return (
                c * tr - scph * br - ssph * bi,
                c * ti - scph * bi + ssph * br,
                c * br + scph * tr - ssph * ti,
                c * bi + scph * ti + ssph * tr,
            )

        xtr, xti, xbr, xbi = rot(xtr, xti, xbr, xbi)
        xtr, xbr = shuffle(xtr, xbr)
        xti, xbi = shuffle(xti, xbi)
        if with_v:
            vtr, vti, vbr, vbi = rot(vtr, vti, vbr, vbi)
            vtr, vbr = shuffle(vtr, vbr)
            vti, vbi = shuffle(vti, vbi)
    out = (torch.cat([xtr, xbr], dim=1), torch.cat([xti, xbi], dim=1))
    if with_v:
        out += (torch.cat([vtr, vbr], dim=1), torch.cat([vti, vbi], dim=1))
    return out


def _launch_jacobi(xr, xi, sweeps: int, with_v: bool):
    dev = xr.device
    if dev.type != "cuda":
        raise ValueError(f"jacobi_rotations: no kernel for device {dev}")
    if xr.dim() != 3:
        raise ValueError(f"jacobi_rotations: planes must be (B, n, m), got {tuple(xr.shape)}")
    b, n, m = xr.shape
    for p in (xr, xi):
        if p.device != dev or p.dtype != torch.float32:
            raise ValueError(f"jacobi_rotations: planes must be float32 on {dev}, got {p.dtype} on {p.device}")
        if tuple(p.shape) != (b, n, m):
            raise ValueError(f"jacobi_rotations: plane shape {tuple(p.shape)}, expected {(b, n, m)}")
        if not p.is_contiguous():
            raise ValueError("jacobi_rotations: planes must be contiguous")
    if n < 2 or n % 2 or m > _MAX_M or 8 * n * m > _MAX_SMEM_BYTES:
        raise ValueError(
            f"jacobi_rotations: unsupported shape n={n}, m={m} (n even, m <= {_MAX_M}, "
            f"8*n*m <= {_MAX_SMEM_BYTES} bytes)"
        )
    c = cluster_size(dev, b, n, m, with_v)
    sweeps = int(sweeps)
    oxr = torch.empty_like(xr)
    oxi = torch.empty_like(xi)
    if with_v:
        ovr = torch.empty((b, n, n), dtype=torch.float32, device=dev)
        ovi = torch.empty_like(ovr)
    lib = _build.library("jacobi_svd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        jacobi_rotations.launches += 1
        err = lib.tcng_jacobi_svd(
            xr.data_ptr(), xi.data_ptr(), oxr.data_ptr(), oxi.data_ptr(),
            ovr.data_ptr() if with_v else None, ovi.data_ptr() if with_v else None,
            b, n, m, sweeps, c, stream,
        )
    _build.check("jacobi_svd", err, "jacobi_rotations")
    return (oxr, oxi, ovr, ovi) if with_v else (oxr, oxi)


def jacobi_rotations(
    xr: torch.Tensor, xi: torch.Tensor, sweeps: int, with_v: bool
) -> Tuple[torch.Tensor, ...]:
    """K5: ``sweeps * (n-1)`` Brent-Luk rounds of one-sided Jacobi on each
    matrix of the batch; the counterpart of the JAX ``_run_kernel``.

    ``xr/xi`` (B, n, m) float32 contiguous transposed planes.  Returns the
    rotated planes ``(B, n, m)`` (row j's norm is a singular value) and,
    with ``with_v``, V's transposed planes ``(B, n, n)``.  CUDA tensors
    launch the kernel (``jacobi_rotations.launches`` counts them); CPU
    tensors run :func:`jacobi_rotations_plain`.
    """
    if xr.device.type == "cpu":
        return jacobi_rotations_plain(xr, xi, sweeps, with_v)
    return _launch_jacobi(xr, xi, sweeps, with_v)


jacobi_rotations.launches = 0


def _take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of (B, k, w) ``x`` in the order of (B, j) ``order`` (exact)."""
    return torch.take_along_dim(x, order[..., None], dim=-2)


def jacobi_svd_nodiff(
    a: torch.Tensor,
    sweeps: int = 10,
    accumulate_v: bool = False,
    presort: bool = False,
    *,
    rotations: Callable[..., Tuple[torch.Tensor, ...]] = jacobi_rotations,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SVD of batched (..., m, n) complex matrices, m >= n, s
    descending, through K5 and without a gradient (``jacobi_svd_pallas``
    in the JAX package).  Returns (u, s, vh) of shapes (..., m, n), (..., n),
    (..., n, n).

    ``accumulate_v=False`` recovers ``vh = S^-1 U^H A`` by one matmul: it
    amplifies U's residual non-orthogonality by s_max/s_i, so truncation
    wants ``True``.  ``presort=True`` applies de Rijk column-norm pivoting
    before the kernel.  n is padded with zero columns to a multiple of 16,
    as the JAX package pads it (they take part in the tournament, so other
    padding would change the pairs); m needs no padding.  ``rotations`` is
    the rotation stage: K5's wrapper, or :func:`jacobi_rotations_plain` to
    hold the kernel against its plain version on the same CUDA inputs.
    """
    batch = a.shape[:-2]
    m, n = a.shape[-2], a.shape[-1]
    if m < n:
        raise ValueError("jacobi_svd_pallas requires m >= n (pass a.T instead)")
    n_pad = -(-max(n, 16) // 16) * 16
    cplx = a.is_complex()
    # transposed layout: (B, n, m) rows are columns of a
    at = a.reshape((-1, m, n)).transpose(-1, -2)
    ar = at.real.to(torch.float32)
    ai = (at.imag if cplx else torch.zeros_like(at)).to(torch.float32)
    pivot = None
    if presort:
        # de Rijk pivot: rows in descending column-norm order (stable sort)
        norms = torch.sum(ar * ar + ai * ai, dim=-1)
        pivot = torch.argsort(-norms, dim=-1, stable=True)
        ar = _take_rows(ar, pivot)
        ai = _take_rows(ai, pivot)
    pad = (0, 0, 0, n_pad - n)
    ar = torch.nn.functional.pad(ar, pad).contiguous()
    ai = torch.nn.functional.pad(ai, pad).contiguous()
    out = rotations(ar, ai, sweeps, accumulate_v)
    xr, xi = out[0], out[1]
    s = torch.sqrt(torch.sum(xr * xr + xi * xi, dim=-1))  # (B, n_pad)
    # stable, as jnp.argsort: tied (zero) columns keep their slot order
    order = torch.argsort(-s, dim=-1, stable=True)[..., :n]
    s_sorted = torch.take_along_dim(s, order, dim=-1)
    inv_s = torch.where(s_sorted > 1e-30, 1.0 / (s_sorted + 1e-30), 0.0)[..., None]
    ur = _take_rows(xr, order) * inv_s
    ui = _take_rows(xi, order) * inv_s
    u = (torch.complex(ur, ui) if cplx else ur).transpose(-1, -2).to(a.dtype)
    s_out = s_sorted.to(a.real.dtype)
    if accumulate_v:
        vhr = _take_rows(out[2], order)[..., :n]  # rows of V^T, sorted
        vhi = _take_rows(out[3], order)[..., :n]
        if pivot is not None:
            # un-pivot: A = A' P, so vh(A) = vh(A') P (exact permutation)
            inv = torch.argsort(pivot, dim=-1)
            vhr = torch.take_along_dim(vhr, inv[..., None, :], dim=-1)
            vhi = torch.take_along_dim(vhi, inv[..., None, :], dim=-1)
        vh = (torch.complex(vhr, -vhi) if cplx else vhr).to(a.dtype)  # vh = conj(V^T)
    else:
        a_flat = a.reshape((-1, m, n))
        vh = inv_s.to(a.dtype) * torch.matmul(u.conj().transpose(-1, -2), a_flat)  # S^-1 U^H A
    return u.reshape(batch + (m, n)), s_out.reshape(batch + (n,)), vh.reshape(batch + (n, n))


#: the JAX package's name of :func:`jacobi_svd_nodiff`
jacobi_svd_pallas = jacobi_svd_nodiff


class _JacobiSVD(torch.autograd.Function):
    @staticmethod
    def forward(a, sweeps, accumulate_v, presort):
        return jacobi_svd_nodiff(a, sweeps, accumulate_v, presort)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], *output)

    @staticmethod
    def backward(ctx, du, ds, dvh):
        a, u, s, vh = ctx.saved_tensors
        du = torch.zeros_like(u) if du is None else du
        ds = torch.zeros_like(s) if ds is None else ds
        dvh = torch.zeros_like(vh) if dvh is None else dvh
        return _linalg._svd_bwd_conjconv(a, u, s, vh, du, ds, dvh), None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        # batched already: the batch in front, one call (one K5 launch)
        return front_vmap(info, in_dims, _JacobiSVD.apply, args)


def jacobi_svd(
    a: torch.Tensor, sweeps: int = 10, accumulate_v: bool = False, presort: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AD-aware :func:`jacobi_svd_nodiff` (degenerate-safe SVD adjoint)."""
    return _JacobiSVD.apply(a, sweeps, accumulate_v, presort)


def jacobi_svd_warm(
    a: torch.Tensor, sweeps: int, accumulate_v: bool, vh0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`jacobi_svd` warm-started by a previous decomposition's ``vh0``.

    Consecutive TEBD thetas on a bond differ by O(dt): pre-rotating
    ``a @ vh0^H`` starts the iteration near its fixed point, so fewer sweeps
    match a cold start.  ``vh0`` is a hint only (no gradient flows through
    it); the result satisfies ``a = u @ diag(s) @ vh`` like the cold path.
    """
    vh0 = torch.as_tensor(vh0, device=a.device).detach()
    aw = torch.matmul(a, vh0.conj().transpose(-1, -2))
    u, s, vhp = jacobi_svd(aw, sweeps, accumulate_v)
    return u, s, torch.matmul(vhp, vh0)


# ---------------------------------------------------------------------------
# Truncated SVD by subspace iteration + K5 on the compressed panel (opt-in,
# SVD_MODE="subspace" in models/tebd.py).
# ---------------------------------------------------------------------------

#: Newton-Schulz orthonormalization rounds after column normalization; only
#: accurate for near-orthogonal panels (the warm path's)
NS_ITERS = 8
#: captured directions beyond chi (randomized-SVD oversampling)
OVERSAMPLE = 16


def _ns_orth(vr, vi, iters: int = NS_ITERS):
    """Orthonormalize batched (B, n, k) complex planes: V <- V(3I - V^H V)/2,
    after per-column normalization and a certified spectral prescale."""
    cn = torch.sqrt(torch.sum(vr * vr + vi * vi, dim=-2, keepdim=True))
    vr = vr / (cn + 1e-30)
    vi = vi / (cn + 1e-30)
    k = vr.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=vr.device)

    def gram(vr, vi):
        gr = torch.einsum("bnk,bnl->bkl", vr, vr) + torch.einsum("bnk,bnl->bkl", vi, vi)
        gi = torch.einsum("bnk,bnl->bkl", vr, vi) - torch.einsum("bnk,bnl->bkl", vi, vr)
        return gr, gi

    # sigma_max^2 <= ||G||_1: NS diverges outside (0, sqrt(3))
    g0r, g0i = gram(vr, vi)
    bound = torch.amax(torch.sum(torch.sqrt(g0r * g0r + g0i * g0i), dim=-2), dim=-1)
    scale = (0.99 / torch.sqrt(bound + 1e-30))[:, None, None]
    vr = vr * scale
    vi = vi * scale
    for _ in range(iters):
        gr, gi = gram(vr, vi)
        ar = 1.5 * eye - 0.5 * gr
        ai = -0.5 * gi
        vr, vi = (
            torch.einsum("bnk,bkl->bnl", vr, ar) - torch.einsum("bnk,bkl->bnl", vi, ai),
            torch.einsum("bnk,bkl->bnl", vr, ai) + torch.einsum("bnk,bkl->bnl", vi, ar),
        )
    return vr, vi


def _mm(xr, xi, yr, yi, sub: str):
    """Complex product in planes."""
    return (
        torch.einsum(sub, xr, yr) - torch.einsum(sub, xi, yi),
        torch.einsum(sub, xr, yi) + torch.einsum(sub, xi, yr),
    )


def subspace_svd(
    a: torch.Tensor,
    chi: int,
    sweeps: int = 10,
    refine: int = 2,
    v0: Optional[torch.Tensor] = None,
    oversample: int = OVERSAMPLE,
    inject: int = 0,
    return_basis: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Truncated SVD of batched (B, m, n) complex ``a``: top-``chi`` triple.

    1. capture the top right-singular subspace V (n, chi+p): warm ``v0``,
       refined by ``refine`` rounds of U = orth(A V), V = orth(A^H U);
    2. compress B = A V (m, chi+p) and run K5 on the panel;
    3. lift vh = W^H V^H and keep the top chi.

    Cold (``v0=None``) runs the full-width :func:`jacobi_svd` instead.
    ``inject`` widens a warm panel with that many fixed random range-finder
    probes (``A^H Om``) orthogonalized against ``v0``.  Returns
    (u (B,m,chi), s (B,chi), vh (B,chi,n)) and, with ``return_basis``, the
    next step's warm basis (B, n, k).
    """
    b, m, n = a.shape
    k = min(n, chi + oversample)
    if v0 is None:
        u, s, vh = jacobi_svd(a, sweeps, True)
        out = (u[..., :, :chi], s[..., :chi], vh[..., :chi, :])
        if return_basis:
            return out + (vh.conj().transpose(-1, -2)[..., :, :k].detach().resolve_conj(),)
        return out
    ar = a.real.to(torch.float32)
    ai = a.imag.to(torch.float32)
    v0 = torch.as_tensor(v0, device=a.device).detach()
    vr = v0.real.to(torch.float32)
    vi = v0.imag.to(torch.float32)
    art, ait = ar.transpose(-1, -2), -ai.transpose(-1, -2)  # planes of A^H
    if inject:
        p = min(inject, n - vr.shape[-1])
        if p > 0:
            # range-finder probes Y = A^H Om for a fixed Gaussian Om (the
            # JAX package's numpy seed, so both packages probe alike)
            rng = np.random.default_rng(20260819)
            om = [
                torch.as_tensor(rng.standard_normal((m, p), dtype=np.float32), device=a.device).expand(b, m, p)
                for _ in range(2)
            ]
            yr, yi = _mm(art, ait, om[0], om[1], "bnm,bmp->bnp")
            # project out span(v0): Y' = Y - V (V^H Y)
            pr, pi = _mm(vr.transpose(-1, -2), -vi.transpose(-1, -2), yr, yi, "bkn,bnp->bkp")
            dr, di = _mm(vr, vi, pr, pi, "bnk,bkp->bnp")
            yr, yi = _ns_orth(yr - dr, yi - di)
            vr = torch.cat([vr, yr], dim=-1)
            vi = torch.cat([vi, yi], dim=-1)
    for _ in range(refine):
        ur, ui = _ns_orth(*_mm(ar, ai, vr, vi, "bmn,bnk->bmk"))
        vr, vi = _ns_orth(*_mm(art, ait, ur, ui, "bnm,bmk->bnk"))
    br_, bi_ = _mm(ar, ai, vr, vi, "bmn,bnk->bmk")
    panel = torch.complex(br_, bi_).to(a.dtype)
    u, s, wh = jacobi_svd(panel, sweeps, True)
    v = torch.complex(vr, vi).to(a.dtype)
    vh = torch.matmul(wh, v.conj().transpose(-1, -2))
    out = (u[..., :, :chi], s[..., :chi], vh[..., :chi, :])
    if return_basis:
        # the basis rotated by W: its leading columns track the singular order
        v_sorted = torch.matmul(v, wh.conj().transpose(-1, -2))[..., :, :k]
        return out + (v_sorted.detach(),)
    return out
