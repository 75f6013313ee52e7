"""One fused TFIM layer (zz phase + row rx, optionally the lane matmul) on
the ``(r, 128)`` float32 plane pair of a complex64 state, and its adjoint.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_rowlayer.py``, the zzrx
subset.  ``zzrx_fwd`` is the wrapper of kernel K1 (``csrc/zzrx_fwd.cu``,
``tcng_zzrx_fwd``), which replaces the Pallas ``_pallas_zzrx_fwd``;
``zzrx_bwd`` the wrapper of kernel K3 (``csrc/zzrx_bwd.cu``,
``tcng_zzrx_bwd``), which replaces ``_pallas_zzrx_bwd``.  On a CUDA tensor
a wrapper launches its kernel, on a CPU tensor it runs the plain version
(``zzrx_fwd_plain``, ``zzrx_bwd_plain``: ordinary torch ops).  The wrappers
are plain launch functions; the autograd boundary is ``zzrx_row_layer``
here and the stack boundaries of ``kernels_stack``, as in the JAX package.
Qubit q is bit ``n-1-q`` of the flat index ``row * 128 + lane``; rx acts on
the ``nkernel`` lowest row bits, ``th[0]`` on the most significant of them.
Cotangent planes follow the JAX package: ``(dL/dyr, -dL/dyi)``, the
conjugate of torch's gradient of a complex tensor.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "zzrx_fwd",
    "zzrx_fwd_plain",
    "zzrx_bwd",
    "zzrx_bwd_plain",
    "zzrx_row_layer",
    "MAX_KERNEL_QUBITS_ZZRX",
]

#: row qubits one kernel block covers (the rest are "outer" qubits)
MAX_KERNEL_QUBITS_ZZRX = 10

_LANES = 128


def _rx_gates(thetas: torch.Tensor) -> torch.Tensor:
    """(k, 2, 2) complex64 rx matrices."""
    c = torch.cos(thetas / 2).to(torch.complex64)
    s = (-1j * torch.sin(thetas / 2)).to(torch.complex64)
    return torch.stack(
        [torch.stack([c, s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _row_layer_reference(state2d: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Gate k on the bit of stride 2^(ng-1-k) of the (r, lanes) view."""
    ng = gates.shape[0]
    r, lanes = state2d.shape
    psi = state2d
    for q in range(ng):
        s = (2**ng) >> (q + 1)
        v = torch.reshape(psi, (r // (2 * s), 2, s, lanes))
        v = torch.einsum("ab,xbsl->xasl", gates[q].to(psi.dtype), v)
        psi = torch.reshape(v, (r, lanes))
    return psi


def _zz_signs(pairs, n: int, r: int, lanes: int, device):
    """1 - 2 (bit_a ^ bit_b) on the (r, lanes) layout, one pair at a time."""
    idx = torch.arange(r * lanes, device=device).reshape(r, lanes)
    for a, b in pairs:
        xor = ((idx >> (n - 1 - a)) ^ (idx >> (n - 1 - b))) & 1
        yield 1.0 - 2.0 * xor.to(torch.float32)


def _zz_phase_dense(
    state2d: torch.Tensor, pairs: Sequence[Tuple[int, int]], n: int, zz_thetas: torch.Tensor
) -> torch.Tensor:
    """exp(-i/2 Σ_k θ_k Z_a Z_b) on the (r, lanes) layout, exponent in f32."""
    r, lanes = state2d.shape
    zz = zz_thetas.to(torch.float32)
    expo = torch.zeros((r, lanes), dtype=torch.float32, device=state2d.device)
    for k, sign in enumerate(_zz_signs(pairs, n, r, lanes, state2d.device)):
        expo = expo + zz[k] * sign
    phase = torch.polar(torch.ones_like(expo), -0.5 * expo)
    return state2d * phase.to(state2d.dtype)


def _lane_apply(mr, mi, xr, xi):
    """planes <- x @ m on the last axis (m is the pre-transposed kron)."""
    return xr @ mr - xi @ mi, xr @ mi + xi @ mr


def _lane_walk(mr, mi, cr, ci):
    """Cotangent planes <- ct @ m^T on the last axis."""
    return cr @ mr.T - ci @ mi.T, cr @ mi.T + ci @ mr.T


def _outer_apply(mor, moi, xr, xi):
    """Planes <- complex left-matmul by mo on the leading (D) axis."""
    d = mor.shape[0]
    fr = xr.reshape(d, -1)
    fi = xi.reshape(d, -1)
    yr = mor @ fr - moi @ fi
    yi = mor @ fi + moi @ fr
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


def _outer_walk(mor, moi, cr, ci):
    """Cotangent planes <- mo^T @ ct on the leading (D) axis."""
    d = mor.shape[0]
    fr = cr.reshape(d, -1)
    fi = ci.reshape(d, -1)
    nr = mor.T @ fr - moi.T @ fi
    ni = mor.T @ fi + moi.T @ fr
    return nr.reshape(cr.shape), ni.reshape(ci.shape)


def zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mr=None, mi=None):
    """K1's plain version: dense zz phase, row rx reference, lane matmul."""
    psi = torch.complex(sr, si)
    psi = _zz_phase_dense(psi, pairs, n, zzth)
    psi = _row_layer_reference(psi, _rx_gates(th))
    yr, yi = psi.real.contiguous(), psi.imag.contiguous()
    if mr is not None:
        yr, yi = _lane_apply(mr, mi, yr, yi)
    return yr, yi


@lru_cache(maxsize=64)
def _pair_shifts(pairs: Tuple[Tuple[int, int], ...], n: int, device: str) -> torch.Tensor:
    """(npairs, 2) int32 bit positions (n-1-a, n-1-b) on ``device``."""
    if any(not (0 <= q < n) for pair in pairs for q in pair):
        raise ValueError(f"pair qubits must lie in [0, {n}): {pairs}")
    sh = np.array([(n - 1 - a, n - 1 - b) for a, b in pairs], dtype=np.int32)
    return torch.as_tensor(sh.reshape(-1, 2)).to(device)


def _check_planes(what: str, device: torch.device, shape, *planes: torch.Tensor) -> None:
    for p in planes:
        if p.device != device or p.dtype != torch.float32:
            raise ValueError(f"{what}: planes must be float32 on {device}, got {p.dtype} on {p.device}")
        if tuple(p.shape) != tuple(shape):
            raise ValueError(f"{what}: plane shape {tuple(p.shape)}, expected {tuple(shape)}")
        if not p.is_contiguous():
            raise ValueError(f"{what}: planes must be contiguous")


def _check_shape(what: str, r: int, lanes: int, n: int, nkernel: int, ok: bool = True) -> None:
    """The layouts the kernels take: 128 lanes, whole row blocks, and
    ``n`` consistent with the planes (flat indices fit 32 bits)."""
    if (
        not ok or lanes != _LANES or r % (1 << nkernel) or n > 31
        or n != (r * lanes).bit_length() - 1
    ):
        raise ValueError(f"{what}: unsupported shape r={r}, lanes={lanes}, n={n}, nkernel={nkernel}")


def _f32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"zzrx_fwd: no kernel for device {dev}")
    r, lanes = sr.shape
    nkernel = th.shape[0]
    _check_shape("zzrx_fwd", r, lanes, n, nkernel, th.dim() == 1)
    _check_planes("zzrx_fwd", dev, (r, lanes), sr, si)
    if mr is not None:
        _check_planes("zzrx_fwd lane", dev, (lanes, lanes), mr, mi)
    zzth = _f32(zzth, dev)
    th = _f32(th, dev)
    if tuple(zzth.shape) != (len(pairs),):
        raise ValueError(f"zzrx_fwd: zzth shape {tuple(zzth.shape)}, expected {(len(pairs),)}")
    shifts = _pair_shifts(tuple(pairs), n, str(dev))
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    lib = _build.library("zzrx_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        zzrx_fwd.launches += 1
        err = lib.tcng_zzrx_fwd(
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), len(pairs), th.data_ptr(), nkernel,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            r, stream,
        )
    _build.check("zzrx_fwd", err, "zzrx_fwd")
    return yr, yi


def zzrx_fwd(
    pairs: Sequence[Tuple[int, int]],
    n: int,
    zzth: torch.Tensor,
    th: torch.Tensor,
    sr: torch.Tensor,
    si: torch.Tensor,
    mr: Optional[torch.Tensor] = None,
    mi: Optional[torch.Tensor] = None,
):
    """K1: zz phase over all n qubits, rx(th) on the nkernel in-block row
    bits, then ``y = x @ (mr + i mi)`` when the lane planes are given.

    ``sr/si`` (r, 128) float32 planes; ``zzth`` (npairs,); ``th``
    (nkernel,).  CUDA tensors launch the kernel (``zzrx_fwd.launches``
    counts the launches); CPU tensors run :func:`zzrx_fwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if sr.device.type == "cpu":
        return zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mr, mi)
    return _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi)


zzrx_fwd.launches = 0


def _partner(x: torch.Tensor, s: int) -> torch.Tensor:
    """x with rows i and i ^ s swapped (s a power of two below the rows)."""
    r, lanes = x.shape
    return torch.flip(torch.reshape(x, (r // (2 * s), 2, s, lanes)), (1,)).reshape(r, lanes)


def zzrx_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr=None, mi=None):
    """K3's plain version: the adjoint of K1 in torch ops, stage by stage as
    the JAX ``_zzrx_bwd_kernel`` takes them.

    ``(yr, yi)`` is the layer's output (post-lane when ``mr/mi`` are given,
    which must then be unitary) and ``(ctr, cti)`` the cotangent planes
    ``(dL/dyr, -dL/dyi)``.  Returns ``(dsr, dsi, dzz, dth)`` and, with the
    lane planes, ``(dmr, dmi) = (dL/dmr, -dL/dmi)``.
    """
    lane = mr is not None
    if lane:
        # psi = y @ conj(M)^T; dM = psi^T ct; ct <- ct @ M^T
        sr = yr @ mr.T + yi @ mi.T
        si = yi @ mr.T - yr @ mi.T
        dmr = sr.T @ ctr - si.T @ cti
        dmi = sr.T @ cti + si.T @ ctr
        cr, ci = _lane_walk(mr, mi, ctr, cti)
    else:
        sr, si, cr, ci = yr, yi, ctr, cti
    nkernel = th.shape[0]
    th = th.to(torch.float32)
    cos, sin = torch.cos(th / 2), torch.sin(th / 2)
    dth = [None] * nkernel
    for q in range(nkernel - 1, -1, -1):
        s = (1 << nkernel) >> (q + 1)
        c, sn = cos[q], sin[q]
        sr, si = c * sr - sn * _partner(si, s), c * si + sn * _partner(sr, s)
        pcr, pci = _partner(cr, s), _partner(ci, s)
        dth[q] = -0.5 * sn * torch.sum(cr * sr - ci * si) + 0.5 * c * torch.sum(pcr * si + pci * sr)
        cr, ci = c * cr + sn * pci, c * ci - sn * pcr
    h = cr * si + ci * sr
    r, lanes = yr.shape
    dzz = [0.5 * torch.sum(h * sg) for sg in _zz_signs(pairs, n, r, lanes, yr.device)]
    ds = _zz_phase_dense(torch.complex(cr, ci), pairs, n, zzth)
    empty = torch.zeros(0, dtype=torch.float32, device=yr.device)
    out = (
        ds.real.contiguous(),
        ds.imag.contiguous(),
        torch.stack(dzz) if dzz else empty,
        torch.stack(dth) if dth else empty,
    )
    return out + (dmr, dmi) if lane else out


def _launch_zzrx_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi):
    dev = yr.device
    if dev.type != "cuda":
        raise ValueError(f"zzrx_bwd: no kernel for device {dev}")
    r, lanes = yr.shape
    nkernel = th.shape[0]
    npairs = len(pairs)
    _check_shape("zzrx_bwd", r, lanes, n, nkernel, th.dim() == 1)
    _check_planes("zzrx_bwd", dev, (r, lanes), yr, yi, ctr, cti)
    lane = mr is not None
    if lane:
        _check_planes("zzrx_bwd lane", dev, (lanes, lanes), mr, mi)
    zzth = _f32(zzth, dev)
    th = _f32(th, dev)
    if tuple(zzth.shape) != (npairs,):
        raise ValueError(f"zzrx_bwd: zzth shape {tuple(zzth.shape)}, expected {(npairs,)}")
    shifts = _pair_shifts(tuple(pairs), n, str(dev))
    ds = torch.empty((2, r, lanes), dtype=torch.float32, device=dev)
    grads = torch.empty(npairs + nkernel, dtype=torch.float32, device=dev)
    dm = torch.empty((2, lanes, lanes), dtype=torch.float32, device=dev) if lane else None
    lib = _build.library("zzrx_bwd")
    scratch = torch.empty(
        lib.tcng_zzrx_bwd_scratch(r, nkernel, npairs, int(lane)), dtype=torch.float32, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        zzrx_bwd.launches += 1
        err = lib.tcng_zzrx_bwd(
            yr.data_ptr(), yi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), grads.data_ptr(),
            None if dm is None else dm.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), npairs, th.data_ptr(), nkernel,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            scratch.data_ptr(), r, stream,
        )
    _build.check("zzrx_bwd", err, "zzrx_bwd")
    out = (ds[0], ds[1], grads[:npairs], grads[npairs:])
    return out + (dm[0], dm[1]) if lane else out


def zzrx_bwd(
    pairs: Sequence[Tuple[int, int]],
    n: int,
    zzth: torch.Tensor,
    th: torch.Tensor,
    yr: torch.Tensor,
    yi: torch.Tensor,
    ctr: torch.Tensor,
    cti: torch.Tensor,
    mr: Optional[torch.Tensor] = None,
    mi: Optional[torch.Tensor] = None,
):
    """K3: the adjoint of :func:`zzrx_fwd` from its output ``(yr, yi)``
    and the cotangent planes ``(dL/dyr, -dL/dyi)``.

    Returns ``(dsr, dsi, dzz (npairs,), dth (nkernel,))``, plus the lane
    cotangent planes ``(dmr, dmi)`` (128, 128) when the (unitary) lane
    planes are given.  CUDA tensors launch the kernel (``zzrx_bwd.launches``
    counts the launches); CPU tensors run :func:`zzrx_bwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if yr.device.type == "cpu":
        return zzrx_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi)
    return _launch_zzrx_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi)


zzrx_bwd.launches = 0


def conj_planes(g: torch.Tensor):
    """The (real, imag) planes of the JAX package's cotangent for torch's
    gradient ``g`` of a complex output: JAX's is ``conj(g)``."""
    return g.real.to(torch.float32).contiguous(), (-g.imag).to(torch.float32).contiguous()


def grad_of_planes(dr: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """torch's gradient of a complex input from the JAX cotangent planes
    ``(dr, di)``: the conjugate of ``dr + i di``."""
    return torch.complex(dr, -di)


class _ZzrxRowLayer(torch.autograd.Function):
    """Counterpart of the JAX ``zzrx_row_layer`` custom VJP: K1 forward,
    K3 (without the lane matrix) backward; the residual is the output."""

    @staticmethod
    def forward(ctx, pairs, n, state2d, zz_thetas, rx_thetas):
        ctx.pairs, ctx.n = pairs, n
        yr, yi = zzrx_fwd(
            pairs, n, zz_thetas, rx_thetas,
            state2d.real.contiguous(), state2d.imag.contiguous(),
        )
        ctx.save_for_backward(yr, yi, zz_thetas, rx_thetas)
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        yr, yi, zz, rx = ctx.saved_tensors
        ctr, cti = conj_planes(g)
        dsr, dsi, dzz, dth = zzrx_bwd(ctx.pairs, ctx.n, zz, rx, yr, yi, ctr, cti)
        return None, None, grad_of_planes(dsr, dsi).to(g.dtype), dzz.to(zz.dtype), dth.to(rx.dtype)


def zzrx_row_layer(
    pairs: Sequence[Tuple[int, int]],
    n: int,
    state2d: torch.Tensor,
    zz_thetas: torch.Tensor,
    rx_thetas: torch.Tensor,
) -> torch.Tensor:
    """exp(-i/2 Σ θ_k Z_a Z_b) then rx(φ_q) on the kernel row qubits of a
    complex64 ``(r, 128)`` state; differentiable in all three tensors
    through K3 (the JAX ``zzrx_row_layer``)."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _ZzrxRowLayer.apply(pairs, n, state2d, zz_thetas, rx_thetas)
