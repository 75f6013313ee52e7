"""One fused TFIM layer (zz phase + row rx, optionally the lane matmul) on
the ``(r, 128)`` float32 plane pair of a complex64 state.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_rowlayer.py``, forward
subset.  ``zzrx_fwd`` is the wrapper of kernel K1 (``csrc/zzrx_fwd.cu``,
``tcng_zzrx_fwd``), which replaces the Pallas ``_pallas_zzrx_fwd``: on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
version ``zzrx_fwd_plain`` (ordinary torch ops, differentiable by
autograd).  Qubit q is bit ``n-1-q`` of the flat index ``row * 128 + lane``;
rx acts on the ``nkernel`` lowest row bits, ``th[0]`` on the most
significant of them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["zzrx_fwd", "zzrx_fwd_plain", "zzrx_row_layer", "MAX_KERNEL_QUBITS_ZZRX"]

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


def _zz_phase_dense(
    state2d: torch.Tensor, pairs: Sequence[Tuple[int, int]], n: int, zz_thetas: torch.Tensor
) -> torch.Tensor:
    """exp(-i/2 Σ_k θ_k Z_a Z_b) on the (r, lanes) layout, exponent in f32."""
    r, lanes = state2d.shape
    idx = torch.arange(r * lanes, device=state2d.device).reshape(r, lanes)
    zz = zz_thetas.to(torch.float32)
    expo = torch.zeros((r, lanes), dtype=torch.float32, device=state2d.device)
    for k, (a, b) in enumerate(pairs):
        xor = ((idx >> (n - 1 - a)) ^ (idx >> (n - 1 - b))) & 1
        expo = expo + zz[k] * (1.0 - 2.0 * xor.to(torch.float32))
    phase = torch.polar(torch.ones_like(expo), -0.5 * expo)
    return state2d * phase.to(state2d.dtype)


def _lane_apply(mr, mi, xr, xi):
    """planes <- x @ m on the last axis (m is the pre-transposed kron)."""
    return xr @ mr - xi @ mi, xr @ mi + xi @ mr


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


def _f32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"zzrx_fwd: no kernel for device {dev}")
    r, lanes = sr.shape
    nkernel = th.shape[0]
    if (
        th.dim() != 1 or lanes != _LANES or r % (1 << nkernel) or n > 31
        or n != (r * lanes).bit_length() - 1
    ):
        raise ValueError(f"zzrx_fwd: unsupported shape r={r}, lanes={lanes}, n={n}, nkernel={nkernel}")
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


class _ZzrxFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pairs, n, zzth, th, sr, si, mr, mi):
        return _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "zzrx_fwd backward: the zzrx backward kernel (counterpart of "
            "kernels_rowlayer._pallas_zzrx_bwd) is not ported yet"
        )


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
    return _ZzrxFwd.apply(pairs, n, zzth, th, sr, si, mr, mi)


zzrx_fwd.launches = 0


def zzrx_row_layer(
    pairs: Sequence[Tuple[int, int]],
    n: int,
    state2d: torch.Tensor,
    zz_thetas: torch.Tensor,
    rx_thetas: torch.Tensor,
) -> torch.Tensor:
    """exp(-i/2 Σ θ_k Z_a Z_b) then rx(φ_q) on the kernel row qubits of a
    complex64 ``(r, 128)`` state (forward of the JAX ``zzrx_row_layer``)."""
    sr = state2d.real.contiguous()
    si = state2d.imag.contiguous()
    yr, yi = zzrx_fwd(pairs, n, zz_thetas, rx_thetas, sr, si)
    return torch.complex(yr, yi)
