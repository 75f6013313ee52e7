"""Whole-block multi-layer zzrx: L layers of [zz phase; rx on every row
qubit; lane matmul] on one ``(2^nrow, 2^nlane)`` float32 plane pair, in one
kernel call each way.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_multilayer.py``.  The
wrappers and the kernels they launch on a CUDA tensor:

- ``ml_fwd``: K9 (``csrc/multilayer.cu``, ``tcng_ml_fwd``), replaces the
  Pallas ``_pallas_ml_fwd``; its row stage is the forward pass pair of
  ``csrc/adjoint_stages.cuh`` on K10's row-stage plan (``ml_fwd_plan``
  computes it without a card, ``ml_plan`` reads it from the card);
- ``ml_bwd``: K10 (``tcng_ml_bwd``), replaces ``_pallas_ml_bwd``.

A CPU tensor runs the plain versions ``ml_fwd_plain`` / ``ml_bwd_plain``,
which compute the zz exponent as the JAX kernels do, by the sign matrices
``(Srow * θ) @ Slaneᵀ`` (:func:`_sign_matrices`); the CUDA kernels take the
sign of each pair from the XOR of two index bits instead.  Row bit q (rx
angle q) has stride ``2^(nrow-1-q)``; the lane matrices ``M_l`` are the
right-multiplication matrices (the transposed krons of the lane gates) and
must be unitary, since the backward rebuilds every state by un-application.
The autograd boundary is :func:`zzrx_multilayer` (the JAX custom VJP); its
backward returns theta-native dzz and dθ_row and the dense dM, whose chain
to the lane angles autograd takes through the kron builder outside.
:func:`zzrx_multilayer_xla` is the kernel-free variant of plain matmuls.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from . import kernels_rowlayer as krl
from ..ops.gates import rx_matrix

__all__ = [
    "MAX_ML_ROW_QUBITS",
    "MAX_ML_PAIRS",
    "ml_fwd",
    "ml_fwd_plain",
    "ml_bwd",
    "ml_bwd_plain",
    "ml_plan",
    "ml_fwd_plan",
    "zzrx_multilayer",
    "zzrx_multilayer_xla",
]

#: row qubits of the whole-block path (the dispatch's limit, as in the JAX
#: package); the lanes take the rest
MAX_ML_ROW_QUBITS = 12
#: zz pairs the whole-block path takes
MAX_ML_PAIRS = 128
#: lane widths the kernels take: 2^7 .. 2^10
_LANE_BITS = (7, 10)
#: shared bytes of K9's product (``prod_smem<1>``: two buffered chunks of
#: four 64 x 36-float planes)
_FWD_PROD_SMEM = 4 * 2 * 4 * 64 * 36


@lru_cache(maxsize=64)
def _sign_matrices(pairs, n, nrow, lanes, p_cols=None):
    """(Srow, Slane) float32 numpy sign factors, columns padded to ``p_cols``
    (default ``MAX_ML_PAIRS``): for pair k, ``z_a z_b = Srow[row, k] *
    Slane[lane, k]`` at flat index ``row * lanes + lane``, qubit a at bit
    ``n-1-a``.  Callers must not write to them (cached)."""
    lane_bits = int(math.log2(lanes))
    npairs = len(pairs)
    if p_cols is None:
        p_cols = MAX_ML_PAIRS
    if npairs > p_cols:
        raise ValueError(f"{npairs} pairs exceed the {p_cols} sign columns")
    srow = np.zeros((2**nrow, p_cols), np.float32)
    slane = np.zeros((lanes, p_cols), np.float32)
    rows = np.arange(2**nrow)
    cols = np.arange(lanes)
    for k, (a, b) in enumerate(pairs):
        sr = np.ones(2**nrow, np.float32)
        sl = np.ones(lanes, np.float32)
        for q in (a, b):
            p = n - 1 - q
            if p < lane_bits:
                sl *= 1.0 - 2.0 * ((cols >> p) & 1)
            else:
                sr *= 1.0 - 2.0 * ((rows >> (p - lane_bits)) & 1)
        srow[:, k] = sr
        slane[:, k] = sl
    return srow, slane


@lru_cache(maxsize=64)
def _sign_tensors(pairs, n, nrow, lanes, device: str):
    """The unpadded sign factors (2^nrow, npairs), (lanes, npairs) on ``device``."""
    srow, slane = _sign_matrices(pairs, n, nrow, lanes, max(len(pairs), 1))
    k = len(pairs)
    return torch.as_tensor(srow[:, :k]).to(device), torch.as_tensor(slane[:, :k]).to(device)


def _phase(pairs, n, zz, r, lanes, device):
    """(cos, -sin) of half the zz exponent ``(Srow * θ) @ Slaneᵀ``."""
    srow, slane = _sign_tensors(pairs, n, r.bit_length() - 1, lanes, str(device))
    expo = (srow * zz.to(torch.float32)) @ slane.T
    return torch.cos(0.5 * expo), -torch.sin(0.5 * expo)


def _cos_sin(th: torch.Tensor):
    th = th.to(torch.float32)
    return torch.cos(th / 2), torch.sin(th / 2)


def ml_fwd_plain(pairs, n, zzth, th, sr, si, mr, mi):
    """K9's plain version, as the JAX ``_ml_fwd_kernel`` takes each layer:
    the zz phase by the sign matrices, rx(θ_q) on the row bit of stride
    ``r >> (q+1)``, then ``x @ (mr[l] + i mi[l])``."""
    L, nrow = th.shape
    r, lanes = sr.shape
    cr, ci = sr, si
    for l in range(L):
        pc, ps = _phase(pairs, n, zzth[l], r, lanes, sr.device)
        cr, ci = pc * cr - ps * ci, pc * ci + ps * cr
        cos, sin = _cos_sin(th[l])
        for q in range(nrow):
            s = r >> (q + 1)
            pr, pi = krl._partner(cr, s), krl._partner(ci, s)
            cr, ci = cos[q] * cr + sin[q] * pi, cos[q] * ci - sin[q] * pr
        cr, ci = krl._lane_apply(mr[l], mi[l], cr, ci)
    return cr.contiguous(), ci.contiguous()


def ml_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi):
    """K10's plain version: the adjoint of :func:`ml_fwd_plain` from its
    output ``(yr, yi)`` and the cotangent planes ``(dL/dyr, -dL/dyi)``,
    layers in reverse as the JAX ``_ml_bwd_kernel`` takes them: un-lane
    ``psi = y @ conj(M)ᵀ``, ``dM = psiᵀ ct``, ``ct <- ct @ Mᵀ``; per row bit
    in reverse the rx un-apply, dθ and the ct walk; dzz by the sign
    matrices, the phase walk of ct and its un-apply from the state.

    Returns ``(dsr, dsi, dzz (L, npairs), dth (L, nrow), dmr, dmi (L, lanes,
    lanes))``, dM in the planes ``(dL/dmr, -dL/dmi)``."""
    L, nrow = th.shape
    r, lanes = yr.shape
    sr, si, cr, ci = yr, yi, ctr, cti
    dzz, dth, dmr, dmi = [None] * L, [None] * L, [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        m_r, m_i = mr[l], mi[l]
        sr, si = sr @ m_r.T + si @ m_i.T, si @ m_r.T - sr @ m_i.T
        dmr[l] = sr.T @ cr - si.T @ ci
        dmi[l] = sr.T @ ci + si.T @ cr
        cr, ci = krl._lane_walk(m_r, m_i, cr, ci)
        cos, sin = _cos_sin(th[l])
        dt = [None] * nrow
        for q in range(nrow - 1, -1, -1):
            s = r >> (q + 1)
            c, sn = cos[q], sin[q]
            sr, si = c * sr - sn * krl._partner(si, s), c * si + sn * krl._partner(sr, s)
            pcr, pci = krl._partner(cr, s), krl._partner(ci, s)
            dt[q] = -0.5 * sn * torch.sum(cr * sr - ci * si) + 0.5 * c * torch.sum(pcr * si + pci * sr)
            cr, ci = c * cr + sn * pci, c * ci - sn * pcr
        dth[l] = torch.stack(dt)
        srow, slane = _sign_tensors(pairs, n, nrow, lanes, str(yr.device))
        dzz[l] = 0.5 * torch.sum(srow * ((cr * si + ci * sr) @ slane), dim=0)
        pc, ps = _phase(pairs, n, zzth[l], r, lanes, yr.device)
        cr, ci = pc * cr - ps * ci, pc * ci + ps * cr
        sr, si = pc * sr + ps * si, pc * si - ps * sr
    return (
        cr.contiguous(), ci.contiguous(), torch.stack(dzz), torch.stack(dth),
        torch.stack(dmr), torch.stack(dmi),
    )


def _ml_setup(what, pairs, n, zzth, th, sr, mr, mi, *planes):
    """Checks of a K9/K10 launch: the shapes the kernels take, or raise."""
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    L, nrow = th.shape
    r, lanes = sr.shape
    lo, hi = _LANE_BITS
    if (
        not 1 <= nrow <= MAX_ML_ROW_QUBITS or r != 1 << nrow or lanes & (lanes - 1)
        or not 1 << lo <= lanes <= 1 << hi or n != (r * lanes).bit_length() - 1
        or len(pairs) > MAX_ML_PAIRS
    ):
        raise ValueError(
            f"{what}: unsupported shape r={r}, lanes={lanes}, nrow={nrow}, n={n}, npairs={len(pairs)}"
        )
    krl._check_planes(what, dev, (r, lanes), sr, *planes)
    krl._check_planes(f"{what} lane", dev, (L, lanes, lanes), mr, mi)
    zzth = krl._f32(zzth, dev)
    if tuple(zzth.shape) != (L, len(pairs)):
        raise ValueError(f"{what}: zzth shape {tuple(zzth.shape)}, expected {(L, len(pairs))}")
    shifts = krl._pair_shifts(tuple(pairs), n, str(dev))
    return dev, L, nrow, r, lanes, zzth, krl._f32(th, dev), shifts


def ml_plan(r: int, lanes: int, nrow: int, npairs: int) -> dict:
    """The stage kernels' plan on the card at these shapes, as the C code
    chooses it: for K10's product pair ``"bwd_lane"``, K9's product
    ``"fwd_lane"``, K10's dM ``"dm"``, its two row passes ``"row_hi"``
    (0 CTAs when nrow <= 6: one pass) and ``"row_lo"`` (with the zz stage),
    and K9's two row passes ``"fwd_row_zz"`` (the phase and the low row
    bits, first) and ``"fwd_row_hi"`` (0 CTAs with one pass), each
    ``ctas``, ``threads``, ``smem`` bytes, ``ctas_per_sm``, ``registers``
    and ``local_bytes`` a thread, and two of its own: the products' tile
    ``rows`` and ``cols``, dM's ``chunks`` and ``chunk_rows``, a row pass's
    ``tile`` elements and row ``bits``.  Needs the card."""
    tile = ("tile", "bits")
    own = {"bwd_lane": ("rows", "cols"), "fwd_lane": ("rows", "cols"), "dm": ("chunks", "chunk_rows"),
           "row_hi": tile, "row_lo": tile, "fwd_row_zz": tile, "fwd_row_hi": tile}
    return krl._card_records("multilayer", "tcng_ml_plan", own, r, lanes, nrow, npairs)


def ml_fwd_plan(r: int, lanes: int, nrow: int, npairs: int) -> dict:
    """K9's stage plan at these shapes, computed as ``csrc/multilayer.cu``
    makes it (no card needed): the product ``"fwd_lane"`` and the row
    passes ``"fwd_row_zz"`` and ``"fwd_row_hi"`` with the keys of
    :func:`ml_plan` but the card's own three.  The passes walk every row bit
    on K10's row-stage plan; their shared bytes are the exchange tile of
    two planes (past 3 bits), cos/sin of 6 bits, 8 slot offsets and, in the
    zz pass, a 16-byte record a pair."""
    lo_b, hi_b = _LANE_BITS
    lw = lanes.bit_length() - 1
    error = f"ml_fwd_plan: unsupported shape r={r}, lanes={lanes}, nrow={nrow}, npairs={npairs}"
    if (not 1 <= nrow <= MAX_ML_ROW_QUBITS or r != 1 << nrow or lanes != 1 << lw or not lo_b <= lw <= hi_b
            or not 0 <= npairs <= MAX_ML_PAIRS):
        raise ValueError(error)
    tb, ctas, threads, hi, lo = krl._row_stage(nrow, lw, nrow, error)

    def smem(nb, zz):
        return 4 * ((2 << tb if nb > 3 else 0) + 2 * krl._RP_MAXB + 8) + (16 * npairs if zz else 0)

    rows = krl._pass_records(ctas, threads, tb, hi, lo, smem)
    return {
        "fwd_lane": {"ctas": -(-r // krl._P_T) * (lanes // krl._P_T), "threads": krl._THREADS,
                     "smem": _FWD_PROD_SMEM, "rows": krl._P_T, "cols": krl._P_T},
        "fwd_row_zz": rows["row_lo"],
        "fwd_row_hi": rows["row_hi"],
    }


def _launch_ml_fwd(pairs, n, zzth, th, sr, si, mr, mi):
    dev, L, nrow, r, lanes, zzth, th, shifts = _ml_setup("ml_fwd", pairs, n, zzth, th, sr, mr, mi, si)
    sr, si, mr, mi = (krl._aligned16(t) for t in (sr, si, mr, mi))
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    lib = _build.library("multilayer")
    scratch = torch.empty(
        lib.tcng_ml_scratch(r, lanes, nrow, len(pairs), L, 0), dtype=torch.float32, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ml_fwd.launches += 1
        err = lib.tcng_ml_fwd(
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), len(pairs), th.data_ptr(), nrow, L,
            mr.data_ptr(), mi.data_ptr(), scratch.data_ptr(), r, lanes, stream,
        )
    _build.check("multilayer", err, "ml_fwd")
    return yr, yi


def ml_fwd(pairs: Sequence[Tuple[int, int]], n: int, zzth, th, sr, si, mr, mi):
    """K9: L layers of [zz phase over all n qubits; rx(th[l, q]) on every
    row bit; ``@ (mr[l] + i mi[l])``] on the ``(2^nrow, lanes)`` planes
    ``sr/si``.  ``zzth`` (L, npairs <= 128), ``th`` (L, nrow <= 12), lanes
    128-1024.  CUDA tensors launch the kernel (``ml_fwd.launches`` counts
    the launches); CPU tensors run :func:`ml_fwd_plain`."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if sr.device.type == "cpu":
        return ml_fwd_plain(pairs, n, zzth, th, sr, si, mr, mi)
    return _launch_ml_fwd(pairs, n, zzth, th, sr, si, mr, mi)


ml_fwd.launches = 0


def _launch_ml_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi):
    dev, L, nrow, r, lanes, zzth, th, shifts = _ml_setup(
        "ml_bwd", pairs, n, zzth, th, yr, mr, mi, yi, ctr, cti
    )
    yr, yi, ctr, cti, mr, mi = (krl._aligned16(t) for t in (yr, yi, ctr, cti, mr, mi))
    npairs = len(pairs)
    ds = torch.empty((2, r, lanes), dtype=torch.float32, device=dev)
    grads = torch.empty((L, npairs + nrow), dtype=torch.float32, device=dev)
    dm = torch.empty((2, L, lanes, lanes), dtype=torch.float32, device=dev)
    lib = _build.library("multilayer")
    scratch = torch.empty(
        lib.tcng_ml_scratch(r, lanes, nrow, npairs, L, 1), dtype=torch.float32, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ml_bwd.launches += 1
        err = lib.tcng_ml_bwd(
            yr.data_ptr(), yi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), grads.data_ptr(), dm.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), npairs, th.data_ptr(), nrow, L,
            mr.data_ptr(), mi.data_ptr(), scratch.data_ptr(), r, lanes, stream,
        )
    _build.check("multilayer", err, "ml_bwd")
    return ds[0], ds[1], grads[:, :npairs], grads[:, npairs:], dm[0], dm[1]


def ml_bwd(pairs: Sequence[Tuple[int, int]], n: int, zzth, th, yr, yi, ctr, cti, mr, mi):
    """K10: the adjoint of :func:`ml_fwd` from its output ``(yr, yi)`` and
    the cotangent planes ``(dL/dyr, -dL/dyi)``; the (unitary) lane planes
    ``mr/mi`` (L, lanes, lanes).  Returns ``(dsr, dsi, dzz (L, npairs), dth
    (L, nrow), dmr, dmi)``.  CUDA tensors launch the kernel
    (``ml_bwd.launches`` counts the launches); CPU tensors run
    :func:`ml_bwd_plain`."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if yr.device.type == "cpu":
        return ml_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi)
    return _launch_ml_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi)


ml_bwd.launches = 0


def _ml_reference(pairs, n, state2d, zz_thetas, rx_row_thetas, mlane):
    """The JAX ``_ml_reference``: per layer the dense zz phase, the row rx
    einsums and the lane matmul, on a complex state."""
    psi = state2d
    for l in range(zz_thetas.shape[0]):
        psi = krl._zz_phase_dense(psi, pairs, n, zz_thetas[l])
        psi = krl._row_layer_reference(psi, krl._rx_gates(rx_row_thetas[l]))
        psi = psi @ mlane[l].to(psi.dtype)
    return psi


class _Multilayer(torch.autograd.Function):
    """Counterpart of the JAX ``zzrx_multilayer`` custom VJP: K9 forward,
    K10 backward; the residual is the output."""

    @staticmethod
    def forward(ctx, pairs, n, state2d, zz_thetas, rx_row_thetas, mlane):
        mr, mi = krl._state_planes(mlane.detach())
        yr, yi = ml_fwd(pairs, n, zz_thetas, rx_row_thetas, *krl._state_planes(state2d), mr, mi)
        ctx.pairs, ctx.n = pairs, n
        ctx.save_for_backward(yr, yi, zz_thetas, rx_row_thetas, mr, mi)
        ctx.mdtype = mlane.dtype
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        yr, yi, zz, rx, mr, mi = ctx.saved_tensors
        dsr, dsi, dzz, dth, dmr, dmi = ml_bwd(
            ctx.pairs, ctx.n, zz, rx, yr, yi, *krl.conj_planes(g), mr, mi
        )
        return (
            None, None, krl.grad_of_planes(dsr, dsi).to(g.dtype), dzz.to(zz.dtype),
            dth.to(rx.dtype), krl.grad_of_planes(dmr, dmi).to(ctx.mdtype),
        )


def zzrx_multilayer(
    pairs: Sequence[Tuple[int, int]],
    n: int,
    state2d: torch.Tensor,
    zz_thetas: torch.Tensor,
    rx_row_thetas: torch.Tensor,
    mlane: torch.Tensor,
) -> torch.Tensor:
    """L layers of [zz phase over all n qubits; rx on the row qubits;
    ``@ mlane[l]`` on the lane axis] on the complex64 ``(2^nrow, lanes)``
    view, nrow = every row qubit (<= ``MAX_ML_ROW_QUBITS``); ``zz_thetas``
    (L, npairs <= 128), ``rx_row_thetas`` (L, nrow), ``mlane`` (L, lanes,
    lanes) unitary right-multiplication matrices.  Differentiable in all four
    through K10 (the JAX ``zzrx_multilayer``)."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _Multilayer.apply(pairs, n, state2d, zz_thetas, rx_row_thetas, mlane)


def zzrx_multilayer_xla(pairs, n, state, zz_thetas, rx_thetas, split=(7, 7)):
    """L zzrx layers on the flat state by plain matmuls (the JAX package's
    XLA variant; no kernel, native autograd).  ``split = (g_bits, c_bits)``:
    the top g_bits on axis 0, the bottom c_bits on axis 2, the rest in the
    middle; rx on each axis applies as the kron of its gates."""
    L = zz_thetas.shape[0]
    gb, cb = split
    mb = n - gb - cb
    G, M, C = 2**gb, 2**mb, 2**cb
    # the zz exponent and the rx krons at the state's own precision
    rdt = torch.float64 if state.dtype == torch.complex128 else torch.float32
    srow, slane = _sign_matrices(tuple(pairs), n, gb + mb, C)
    srow = torch.as_tensor(srow, device=state.device).to(rdt)
    slane = torch.as_tensor(slane, device=state.device).to(rdt)
    npairs = len(pairs)
    psi = torch.reshape(state, (G * M, C))
    for l in range(L):
        th = torch.nn.functional.pad(zz_thetas[l].to(rdt), (0, MAX_ML_PAIRS - npairs))
        expo = (srow * th[None, :]) @ slane.T
        psi = psi * torch.polar(torch.ones_like(expo), -0.5 * expo).to(psi.dtype)
        v = torch.reshape(psi, (G, M, C))
        if gb:
            v = torch.einsum("ab,bmc->amc", _sub_kron(rx_thetas[l, :gb], psi.dtype), v)
        if mb:
            v = torch.einsum("ab,gbc->gac", _sub_kron(rx_thetas[l, gb:gb + mb], psi.dtype), v)
        if cb:
            v = torch.einsum("ab,gmb->gma", _sub_kron(rx_thetas[l, gb + mb:], psi.dtype), v)
        psi = torch.reshape(v, (G * M, C))
    return torch.reshape(psi, (-1,))


def _sub_kron(th: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """kron(rx(θ_0), ..., rx(θ_{k-1})), each gate built in ``dtype`` (not in
    complex64 and cast up, which costs 1e-8 under complex128)."""
    gates = rx_matrix(th, dtype=str(dtype).replace("torch.", ""))
    m = gates[0]
    for g in gates[1:]:
        m = torch.kron(m, g)
    return m
