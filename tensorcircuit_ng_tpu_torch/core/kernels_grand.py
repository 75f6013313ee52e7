"""The whole L-layer zzrx stack, forward and adjoint, one kernel call each.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_grand.py``.
``grand_zzrx_fwd`` is the wrapper of kernel K2 (``csrc/zzrx_fwd.cu``,
``tcng_grand_zzrx_fwd``), which replaces the Pallas ``grand_zzrx_fwd``:
each layer is K1's zz phase + row rx + lane matmul, the post-lane state is
streamed out as the residual ``ks[l]``, then the outer ``(D, D)`` matrix
mixes the ``G = D`` row blocks; it runs on the forward row stage and the
product of ``csrc/adjoint_stages.cuh`` (K9's) and a coalesced outer pass,
and ``grand_zzrx_fwd_plan`` / ``grand_zzrx_fwd_card_plan`` give their
plan.  ``grand_zzrx_bwd`` is the wrapper of
kernel K4 (``csrc/zzrx_bwd.cu``, ``tcng_grand_zzrx_bwd``), which replaces
the Pallas ``grand_zzrx_bwd``: the layers in reverse, each the outer
transpose walk with dθ_outer, then K3's adjoint with the lane matrix, on
the adjoint stages of ``csrc/adjoint_stages.cuh`` (shared with K10).  A
CPU tensor runs the plain versions :func:`grand_zzrx_fwd_plain` and
:func:`grand_zzrx_bwd_plain`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _build
from . import kernels_rowlayer as krl

__all__ = [
    "grand_zzrx_fwd",
    "grand_zzrx_fwd_plain",
    "grand_zzrx_fwd_plan",
    "grand_zzrx_fwd_card_plan",
    "grand_zzrx_bwd",
    "grand_zzrx_bwd_plain",
]

#: K2's largest outer dim D (``MAX_D`` in ``csrc/zzrx_fwd.cu``)
MAX_GRAND_OUTER = 32
_LANE_BITS = 7
_GRAND_OWN = {"fwd_row_zz": ("tile", "bits"), "fwd_row_hi": ("tile", "bits"), "fwd_lane": ("rows", "cols"),
              "outer": ("d", "nouter"), "transpose": ("layers", "planes")}


def grand_zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
    """K2's plain version: a loop over layers of K1's plain version with
    the lane planes, then the outer matmul."""
    L = th.shape[0]
    ks_r, ks_i = [], []
    xr, xi = sr, si
    for l in range(L):
        xr, xi = krl.zzrx_fwd_plain(pairs, n, zzth[l], th[l], xr, xi, mlr[l], mli[l])
        ks_r.append(xr)
        ks_i.append(xi)
        xr, xi = krl._outer_apply(mor[l], moi[l], xr, xi)
    return torch.stack(ks_r), torch.stack(ks_i), xr, xi


def grand_zzrx_fwd_plan(r: int, nkernel: int, npairs: int, L: int) -> dict:
    """K2's stage plan at r rows of 128 lanes, computed as
    ``csrc/zzrx_fwd.cu`` makes it (no card needed): the forward row passes
    ``"fwd_row_zz"`` (the phase and the low 6 walked bits, first) and
    ``"fwd_row_hi"`` (the rest; 0 CTAs with one pass) and the product
    ``"fwd_lane"``, as K9's on the nkernel low row bits; the outer pass
    ``"outer"`` (a thread an in-block position, 2^nkernel · 128 of them)
    and the transpose of the L lane matrices ``"transpose"`` (CTAs a
    launch, two launches a call), each ``ctas``, ``threads`` and ``smem``
    (dynamic shared bytes) and two of its own: a pass's ``tile`` elements
    and walked row ``bits``, the product's tile ``rows`` and ``cols``, the
    outer ``d`` and ``nouter``, the transpose's ``layers`` and ``planes``.
    r must be a power of two and D = r >> nkernel at most 32."""
    nrb = r.bit_length() - 1
    error = f"grand_zzrx_fwd_plan: unsupported shape r={r}, nkernel={nkernel}, npairs={npairs}, L={L}"
    if (r < 1 or r != 1 << nrb or not 0 <= nkernel <= nrb or npairs < 0 or L < 1
            or r >> nkernel > MAX_GRAND_OUTER):
        raise ValueError(error)
    d = r >> nkernel
    positions = (1 << _LANE_BITS) << nkernel
    return {
        **krl._fwd_records(nrb, _LANE_BITS, nkernel, npairs, error),
        "outer": {"ctas": -(-positions // krl._THREADS), "threads": krl._THREADS, "smem": 0, "d": d,
                  "nouter": d.bit_length() - 1},
        "transpose": {"ctas": 16 * L, "threads": 256, "smem": 0, "layers": L, "planes": 2},
    }


def grand_zzrx_fwd_card_plan(r: int, nkernel: int, npairs: int, L: int) -> dict:
    """The same plan as the card's C code reports it
    (``tcng_grand_zzrx_fwd_plan``), with each stage kernel's
    ``ctas_per_sm``, ``registers`` and ``local_bytes`` a thread besides.
    Needs the card."""
    return krl._card_records("zzrx_fwd", "tcng_grand_zzrx_fwd_plan", _GRAND_OWN, r, nkernel, npairs, L)


def _launch_grand(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"grand_zzrx_fwd: no kernel for device {dev}")
    L, nkernel = th.shape
    r, lanes = sr.shape
    d = r >> nkernel
    krl._check_shape("grand_zzrx_fwd", r, lanes, n, nkernel)
    krl._check_planes("grand_zzrx_fwd", dev, (r, lanes), sr, si)
    krl._check_planes("grand_zzrx_fwd outer", dev, (L, d, d), mor, moi)
    krl._check_planes("grand_zzrx_fwd lane", dev, (L, lanes, lanes), mlr, mli)
    zzth = krl._f32(zzth, dev)
    th = krl._f32(th, dev)
    if tuple(zzth.shape) != (L, len(pairs)):
        raise ValueError(f"grand_zzrx_fwd: zzth shape {tuple(zzth.shape)}, expected {(L, len(pairs))}")
    shifts = krl._pair_shifts(tuple(pairs), n, str(dev))
    lib = _build.library("zzrx_fwd")
    # the kernel's one check of the outer dim: D = r >> nkernel <= 32
    floats = lib.tcng_grand_zzrx_fwd_scratch(r, nkernel, len(pairs), L)
    if floats < 0:
        raise ValueError(f"grand_zzrx_fwd: unsupported shape r={r}, nkernel={nkernel}, L={L}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    ksr = torch.empty((L, r, lanes), dtype=torch.float32, device=dev)
    ksi = torch.empty_like(ksr)
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        grand_zzrx_fwd.launches += 1
        err = lib.tcng_grand_zzrx_fwd(
            sr.data_ptr(), si.data_ptr(), ksr.data_ptr(), ksi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), zzth.data_ptr(), shifts.data_ptr(),
            len(pairs), th.data_ptr(), nkernel, L, mor.data_ptr(), moi.data_ptr(),
            mlr.data_ptr(), mli.data_ptr(), scratch.data_ptr(), r, stream,
        )
    _build.check("zzrx_fwd", err, "grand_zzrx_fwd")
    return ksr, ksi, yr, yi


def grand_zzrx_fwd(
    pairs: Sequence[Tuple[int, int]], n: int, zzth, th, sr, si, mor, moi, mlr, mli
):
    """K2: the L-layer stack.  Returns ``(ksr, ksi, yr, yi)``.

    ``sr/si`` (r, 128) float32 planes; ``zzth`` (L, npairs); ``th``
    (L, nkernel) kernel-row angles; ``mor/moi`` (L, D, D) outer planes, a
    general matrix (D = r / 2^nkernel); ``mlr/mli`` (L, 128, 128) lane
    planes (right-multiplied).  ``ksr/ksi`` (L, r, 128) are the per-layer
    post-lane, pre-outer states.  CUDA tensors launch the kernel
    (``grand_zzrx_fwd.launches`` counts them); CPU tensors run
    :func:`grand_zzrx_fwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if sr.device.type == "cpu":
        return grand_zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli)
    return _launch_grand(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli)


grand_zzrx_fwd.launches = 0


def grand_zzrx_bwd_plain(pairs, n, zzth, th, ksr, ksi, ctr, cti, mor, moi, mlr, mli):
    """K4's plain version: the layers in reverse, each the outer transpose
    walk ``w = mo^T ct`` with dθ_outer from the partner-swapped residual,
    then K3's plain version with the lane planes on ``w``."""
    L = th.shape[0]
    r, lanes = ctr.shape
    d = mor.shape[1]
    nouter = d.bit_length() - 1
    rows = torch.arange(d, device=ctr.device)
    cr, ci = ctr, cti
    dzz, dth, dtho, dmr, dmi = [], [], [], [], []
    for l in range(L - 1, -1, -1):
        wr, wi = krl._outer_walk(mor[l], moi[l], cr.reshape(d, -1), ci.reshape(d, -1))
        kr, ki = ksr[l].reshape(d, -1), ksi[l].reshape(d, -1)
        # d(mo)/dθ_q = mo·(-i/2 X_q) for an rx kron, so dθ_q pairs w with the
        # residual whose outer bit q is flipped
        tho = []
        for q in range(nouter):
            flip = rows ^ (d >> (q + 1))
            tho.append(0.5 * (torch.sum(wr * ki[flip]) + torch.sum(wi * kr[flip])))
        dtho.append(torch.stack(tho))
        cr, ci, dz, dt, gr, gi = krl.zzrx_bwd_plain(
            pairs, n, zzth[l], th[l], ksr[l], ksi[l],
            wr.reshape(r, lanes), wi.reshape(r, lanes), mlr[l], mli[l],
        )
        dzz.append(dz)
        dth.append(dt)
        dmr.append(gr)
        dmi.append(gi)
    rev = lambda xs: torch.stack(xs[::-1])
    return cr, ci, rev(dzz), rev(dth), rev(dtho), rev(dmr), rev(dmi)


def _launch_grand_bwd(pairs, n, zzth, th, ksr, ksi, ctr, cti, mor, moi, mlr, mli):
    _build.refuse_trace("grand_zzrx_bwd")
    dev = ctr.device
    if dev.type != "cuda":
        raise ValueError(f"grand_zzrx_bwd: no kernel for device {dev}")
    L, nkernel = th.shape
    r, lanes = ctr.shape
    npairs = len(pairs)
    d = r >> nkernel
    krl._check_shape("grand_zzrx_bwd", r, lanes, n, nkernel)
    # the kernel itself rejects an outer dim D outside its outer stage (2..16)
    nouter = d.bit_length() - 1
    krl._check_planes("grand_zzrx_bwd", dev, (r, lanes), ctr, cti)
    krl._check_planes("grand_zzrx_bwd residual", dev, (L, r, lanes), ksr, ksi)
    krl._check_planes("grand_zzrx_bwd outer", dev, (L, d, d), mor, moi)
    krl._check_planes("grand_zzrx_bwd lane", dev, (L, lanes, lanes), mlr, mli)
    zzth = krl._f32(zzth, dev)
    th = krl._f32(th, dev)
    if tuple(zzth.shape) != (L, npairs):
        raise ValueError(f"grand_zzrx_bwd: zzth shape {tuple(zzth.shape)}, expected {(L, npairs)}")
    shifts = krl._pair_shifts(tuple(pairs), n, str(dev))
    ds = torch.empty((2, r, lanes), dtype=torch.float32, device=dev)
    grads = torch.empty((L, npairs + nkernel + nouter), dtype=torch.float32, device=dev)
    dm = torch.empty((2, L, lanes, lanes), dtype=torch.float32, device=dev)
    # the lane stage copies 16-byte chunks of the residuals, the seed and
    # the lane planes
    ksr, ksi, ctr, cti, mlr, mli = (krl._aligned16(t) for t in (ksr, ksi, ctr, cti, mlr, mli))
    lib = _build.library("zzrx_bwd")
    scratch = krl._bwd_scratch("grand_zzrx_bwd", lib, r, nkernel, npairs, 2, 0, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        grand_zzrx_bwd.launches += 1
        err = lib.tcng_grand_zzrx_bwd(
            ksr.data_ptr(), ksi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), grads.data_ptr(), dm.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), npairs, th.data_ptr(), nkernel, L,
            mor.data_ptr(), moi.data_ptr(), mlr.data_ptr(), mli.data_ptr(),
            scratch.data_ptr(), r, stream,
        )
    _build.check("zzrx_bwd", err, "grand_zzrx_bwd")
    k = npairs + nkernel
    return ds[0], ds[1], grads[:, :npairs], grads[:, npairs:k], grads[:, k:], dm[0], dm[1]


def grand_zzrx_bwd(
    pairs: Sequence[Tuple[int, int]], n: int, zzth, th, ksr, ksi, ctr, cti, mor, moi, mlr, mli
):
    """K4: the adjoint of the L-layer stack of :func:`grand_zzrx_fwd`.

    ``ksr/ksi`` (L, r, 128) post-lane residuals; ``ctr/cti`` (r, 128) seed
    cotangent planes ``(dL/dyr, -dL/dyi)``; ``mor/moi`` (L, D, D) outer
    planes, which must be rx krons (dθ_outer uses their derivative);
    ``mlr/mli`` (L, 128, 128) unitary lane planes.  Returns ``(dsr, dsi,
    dzz (L, npairs), dth (L, nkernel), dtho (L, nouter), dmlr, dmli)`` with
    the lane cotangents in K3's planes ``(dL/dmr, -dL/dmi)``.  CUDA tensors
    launch the kernel (``grand_zzrx_bwd.launches`` counts them); CPU
    tensors run :func:`grand_zzrx_bwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if ctr.device.type == "cpu":
        return grand_zzrx_bwd_plain(pairs, n, zzth, th, ksr, ksi, ctr, cti, mor, moi, mlr, mli)
    return _launch_grand_bwd(pairs, n, zzth, th, ksr, ksi, ctr, cti, mor, moi, mlr, mli)


grand_zzrx_bwd.launches = 0
