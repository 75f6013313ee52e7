"""The whole L-layer zzrx stack forward in one kernel call.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_grand.py``, forward.
``grand_zzrx_fwd`` is the wrapper of kernel K2 (``csrc/zzrx_fwd.cu``,
``tcng_grand_zzrx_fwd``), which replaces the Pallas ``grand_zzrx_fwd``:
each layer is K1's zz phase + row rx + lane matmul, the post-lane state is
streamed out as the residual ``ks[l]``, then the outer ``(D, D)`` matrix
mixes the ``G = D`` row blocks.  A CPU tensor runs the plain version
:func:`grand_zzrx_fwd_plain`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _build
from . import kernels_rowlayer as krl

__all__ = ["grand_zzrx_fwd", "grand_zzrx_fwd_plain"]


def grand_zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
    """K2's plain version: a loop over layers of K1's plain version with
    the lane planes, then the outer matmul."""
    from .kernels_stack import _outer_apply

    L = th.shape[0]
    ks_r, ks_i = [], []
    xr, xi = sr, si
    for l in range(L):
        xr, xi = krl.zzrx_fwd_plain(pairs, n, zzth[l], th[l], xr, xi, mlr[l], mli[l])
        ks_r.append(xr)
        ks_i.append(xi)
        xr, xi = _outer_apply(mor[l], moi[l], xr, xi)
    return torch.stack(ks_r), torch.stack(ks_i), xr, xi


def _launch_grand(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"grand_zzrx_fwd: no kernel for device {dev}")
    L, nkernel = th.shape
    r, lanes = sr.shape
    rb = 1 << nkernel
    d = r // rb
    if (
        lanes != krl._LANES or r % rb or n > 31
        or n != (r * lanes).bit_length() - 1
    ):
        raise ValueError(
            f"grand_zzrx_fwd: unsupported shape r={r}, lanes={lanes}, n={n}, nkernel={nkernel}"
        )
    # the kernel itself rejects an outer dim D above its tile (B_ROWS)
    krl._check_planes("grand_zzrx_fwd", dev, (r, lanes), sr, si)
    krl._check_planes("grand_zzrx_fwd outer", dev, (L, d, d), mor, moi)
    krl._check_planes("grand_zzrx_fwd lane", dev, (L, lanes, lanes), mlr, mli)
    zzth = krl._f32(zzth, dev)
    th = krl._f32(th, dev)
    if tuple(zzth.shape) != (L, len(pairs)):
        raise ValueError(f"grand_zzrx_fwd: zzth shape {tuple(zzth.shape)}, expected {(L, len(pairs))}")
    shifts = krl._pair_shifts(tuple(pairs), n, str(dev))
    ksr = torch.empty((L, r, lanes), dtype=torch.float32, device=dev)
    ksi = torch.empty_like(ksr)
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    lib = _build.library("zzrx_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        grand_zzrx_fwd.launches += 1
        err = lib.tcng_grand_zzrx_fwd(
            sr.data_ptr(), si.data_ptr(), ksr.data_ptr(), ksi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), zzth.data_ptr(), shifts.data_ptr(),
            len(pairs), th.data_ptr(), nkernel, L, mor.data_ptr(), moi.data_ptr(),
            mlr.data_ptr(), mli.data_ptr(), r, stream,
        )
    _build.check("zzrx_fwd", err, "grand_zzrx_fwd")
    return ksr, ksi, yr, yi


class _GrandZzrxFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
        return _launch_grand(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "grand_zzrx_fwd backward: the grand backward kernel (counterpart "
            "of kernels_grand.grand_zzrx_bwd) is not ported yet"
        )


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
    return _GrandZzrxFwd.apply(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli)


grand_zzrx_fwd.launches = 0
