"""Row layers on the ``(r, 128)`` float32 plane pair of a complex64 state,
and their adjoints: one arbitrary 2x2 gate per kernel row qubit, and the
fused TFIM layer (zz phase + row rx), each optionally with the lane matmul.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_rowlayer.py``.  The
wrappers and the kernels they launch on a CUDA tensor:

- ``row_fwd``: K6 (``csrc/row_layer.cu``, ``tcng_row_fwd``), replaces the
  Pallas ``_pallas_row_fwd``; it runs on the forward row passes of
  ``csrc/adjoint_stages.cuh`` with a general gate a walked bit (K9's passes
  without the phase) and, with the lane, on K9's product, and
  ``row_fwd_plan`` / ``row_fwd_card_plan`` give their plan;
- ``row_bwd``: K7 (``tcng_row_bwd``), replaces ``_pallas_row_bwd``; it
  runs on the adjoint lane stage and on the gate row passes of
  ``csrc/adjoint_stages.cuh`` (the row stage that K3, K4 and K10 share),
  and ``row_bwd_plan`` / ``row_bwd_card_plan`` give their plan;
- ``row_bwd_const``: K8 (``tcng_row_bwd_const``), replaces
  ``_pallas_row_bwd_const``; it runs on K6's passes with each gate
  transposed, and ``row_bwd_const_plan`` / ``row_bwd_const_card_plan``
  give them;
- ``zzrx_fwd``: K1 (``csrc/zzrx_fwd.cu``, ``tcng_zzrx_fwd``), replaces
  ``_pallas_zzrx_fwd``; it is one layer of K2 without the outer pass: the
  forward row stage of ``csrc/adjoint_stages.cuh`` (the phase with the low
  walked bits, then the high ones) and, with the lane, K2's product, and
  ``zzrx_fwd_plan`` / ``zzrx_fwd_card_plan`` give their plan;
- ``zzrx_bwd``: K3 (``csrc/zzrx_bwd.cu``, ``tcng_zzrx_bwd``), replaces
  ``_pallas_zzrx_bwd``; its lane and row stages are the adjoint stages of
  ``csrc/adjoint_stages.cuh`` that K4 and K10 share, and
  ``zzrx_bwd_plan`` / ``zzrx_bwd_card_plan`` give their plan;
- ``rowm_fwd`` / ``rowm_bwd``: K1 / K3 with the row-kron planes M7, whose
  stages K13 and K14 (``csrc/rowm.cuh``, register-blocked products with M7
  in shared memory, launched from ``tcng_zzrx_fwd`` / ``tcng_zzrx_bwd``)
  replace the ``rmx > 0`` branch of those Pallas kernels
  (``_rowm_fwd_stage``, ``_rowm_bwd_stage``); ``rowm_plan`` reports their
  tiles, grid and occupancy on the card;
- ``rotx_fwd``: K11 (``csrc/row_layer.cu``, ``tcng_rotx_fwd``), replaces
  ``_pallas_rotx_fwd``; it runs on K9's forward row passes without the
  phase, and ``rotx_fwd_plan`` / ``rotx_fwd_card_plan`` give them;
- ``rotx_bwd``: K12 (``tcng_rotx_bwd``), replaces ``_pallas_rotx_bwd``; it
  runs on K10's rx row passes without the zz stage (``csrc/adjoint_stages.cuh``,
  on K7's plan), and ``rotx_bwd_plan`` / ``rotx_bwd_card_plan`` give them.

On a CPU tensor a wrapper runs its plain version (``row_fwd_plain``, ...:
ordinary torch ops, stage by stage as the kernel takes them).  The
wrappers are plain launch functions; the autograd boundaries are
``row_layer``, ``row_layer_lane``, ``row_layer_const``, ``rotx_row_layer``
and ``zzrx_row_layer`` here and the stack boundaries of ``kernels_stack``, as
in the JAX package.  Qubit q is bit ``n-1-q`` of the flat index
``row * 128 + lane``; the row kernels act on the ``nkernel`` lowest row
bits, gate (or angle) 0 on the most significant of them, of stride
``2^nkernel >> 1``.  Gates are planes ``(nkernel, 2, 2)`` (or
``(nkernel, 4)``: g00, g01, g10, g11), unitary, since the backward rebuilds
states by un-application.  Cotangent planes follow the JAX package:
``(dL/dyr, -dL/dyi)``, the conjugate of torch's gradient of a complex
tensor.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "row_fwd",
    "row_fwd_plain",
    "row_bwd",
    "row_bwd_plain",
    "row_bwd_const",
    "row_bwd_const_plain",
    "row_layer",
    "row_layer_lane",
    "row_layer_const",
    "MAX_KERNEL_QUBITS",
    "zzrx_fwd",
    "zzrx_fwd_plain",
    "zzrx_bwd",
    "zzrx_bwd_plain",
    "rowm_fwd",
    "rowm_bwd",
    "rowm_apply_plain",
    "rowm_plan",
    "row_fwd_plan",
    "row_fwd_card_plan",
    "row_bwd_const_plan",
    "row_bwd_const_card_plan",
    "zzrx_fwd_plan",
    "zzrx_fwd_card_plan",
    "rotx_fwd_plan",
    "rotx_fwd_card_plan",
    "zzrx_bwd_plan",
    "zzrx_bwd_card_plan",
    "row_bwd_plan",
    "row_bwd_card_plan",
    "rotx_bwd_plan",
    "rotx_bwd_card_plan",
    "MAX_ROWM_QUBITS",
    "zzrx_row_layer",
    "MAX_KERNEL_QUBITS_ZZRX",
    "rotx_fwd",
    "rotx_fwd_plain",
    "rotx_bwd",
    "rotx_bwd_plain",
    "rotx_row_layer",
    "MAX_KERNEL_QUBITS_ROTX",
]

#: row qubits one block of the row-layer kernels covers (the rest are
#: "outer" qubits); also with the lane matrix, as in the JAX package
MAX_KERNEL_QUBITS = 11
#: row qubits one block of the zzrx kernels covers
MAX_KERNEL_QUBITS_ZZRX = 10
#: row qubits of the theta-native rx layer (the JAX package's dispatch limit)
MAX_KERNEL_QUBITS_ROTX = 10

_LANES = 128


def _rx_gates(thetas: torch.Tensor) -> torch.Tensor:
    """(k, 2, 2) complex64 rx matrices."""
    c = torch.cos(thetas / 2).to(torch.complex64)
    s = (-1j * torch.sin(thetas / 2)).to(torch.complex64)
    return torch.stack(
        [torch.stack([c, s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _row_layer_reference(state2d: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Gate k on the bit of stride 2^(ng-1-k) of the (r, lanes) view: one
    einsum a gate (the JAX reference, not a kernel's plain version)."""
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


def _rowm_view(x: torch.Tensor, nkernel: int, R: int) -> torch.Tensor:
    """The (blocks, R, rb/R, 128) view of an (r, 128) plane: each block of
    rb = 2^nkernel rows as an R x (rb/R, 128) matrix, its top rmx row bits
    on the R axis."""
    r, lanes = x.shape
    return torch.reshape(x, (r >> nkernel, R, (1 << nkernel) // R, lanes))


def _rowm_bits(th: torch.Tensor, m7r: Optional[torch.Tensor]) -> int:
    """rmx, the top row bits that the (R, R) row-kron planes carry (0 without)."""
    if m7r is None:
        return 0
    R = m7r.shape[0]
    rmx = R.bit_length() - 1
    if R != 1 << rmx or not 1 <= rmx <= th.shape[0] or tuple(m7r.shape) != (R, R):
        raise ValueError(f"row-kron planes of shape {tuple(m7r.shape)} for {th.shape[0]} kernel row bits")
    return rmx


def rowm_apply_plain(m7: torch.Tensor, x: torch.Tensor, nkernel: int) -> torch.Tensor:
    """Stage K13's plain version: ``y[b, i, g, c] = Σ_j M7[i, j] x[b, j, g,
    c]`` on the (R, rb/R, 128) view of each block of rb = 2^nkernel rows of
    the complex (r, 128) state ``x``; returns the (r, 128) result."""
    return torch.reshape(torch.einsum("ij,bjgc->bigc", m7, _rowm_view(x, nkernel, m7.shape[0])), x.shape)


#: the largest row kron the stages K13/K14 take (R = 2^7 = 128: M7's planes
#: fill most of a CTA's shared memory)
MAX_ROWM_QUBITS = 7


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned (the row-
    kron stages copy 16-byte chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_rowm(what: str, rmx: int) -> None:
    if rmx > MAX_ROWM_QUBITS:
        raise ValueError(f"{what}: the row-kron stages take rmx <= {MAX_ROWM_QUBITS}, got {rmx}")


def rowm_plan(rmx: int, r: int) -> dict:
    """The row-kron stages' plan on the card at R = 2^rmx and r rows, as
    the C code chooses it: K13 and K14a (``cw`` columns a tile, ``tiles``,
    persistent ``grid``, ``smem`` bytes, ``ctas_per_sm``, ``registers`` and
    ``local_bytes`` a thread) and K14b's dM7 (``tile`` edge, ``tiles``,
    ``chunks``, ``chunk_cols``, ``smem``, ``ctas_per_sm``, ``registers``,
    ``local_bytes``).  Needs the card."""
    apply_keys = ("cw", "tiles", "grid", "smem", "ctas_per_sm", "registers", "local_bytes")
    dm_keys = ("tile", "tiles", "chunks", "chunk_cols", "smem", "ctas_per_sm", "registers", "local_bytes")
    fwd = (ctypes.c_long * 7)()
    _build.check("zzrx_fwd", _build.library("zzrx_fwd").tcng_rowm_fwd_plan(rmx, r, fwd), "rowm_plan fwd")
    bwd = (ctypes.c_long * 15)()
    _build.check("zzrx_bwd", _build.library("zzrx_bwd").tcng_rowm_bwd_plan(rmx, r, bwd), "rowm_plan bwd")
    return {
        "fwd": dict(zip(apply_keys, fwd[:7])),
        "bwd": dict(zip(apply_keys, bwd[:7])),
        "dm": dict(zip(dm_keys, bwd[7:15])),
    }


#: the adjoint stages' constants (``csrc/adjoint_stages.cuh``): product
#: tile edge and shared bytes of the pair and of the forward's one product
#: (``prod_smem<2>``, ``prod_smem<1>``: two buffered chunks of six or four
#: 64 x 36-float planes), dM's rows a stage, shared bytes and CTAs, the row
#: passes' tile bits and walked bits a pass
_P_T, _PAIR_SMEM, _FWD_PROD_SMEM, _D_KC, _DM_SMEM, _DM_CTAS = 64, 110592, 73728, 32, 65536, 256
_RP_TB, _RP_MAXB, _THREADS = 11, 6, 256
_PLAN_KEYS = ("ctas", "threads", "smem", "ctas_per_sm", "registers", "local_bytes")
_PLAN_OWN = {"lane": ("rows", "cols"), "dm": ("chunks", "chunk_rows"), "row_hi": ("tile", "bits"),
             "row_lo": ("tile", "bits"), "outer": ("d", "nouter")}


def _card_records(name: str, fn: str, own: dict, *args) -> dict:
    """The stage records the C plan entry point ``fn`` of library ``name``
    writes for ``args``: 8 longs a stage, in the order of ``own`` (stage ->
    its two own keys), after the common ``_PLAN_KEYS``."""
    out = (ctypes.c_long * (8 * len(own)))()
    _build.check(name, getattr(_build.library(name), fn)(*args, out), fn)
    return {k: dict(zip(_PLAN_KEYS + o, out[8 * i:8 * i + 8])) for i, (k, o) in enumerate(own.items())}


def _row_stage(nrb: int, lw: int, nwalk: int, error: str):
    """The row stage's plan on (2^nrb, 2^lw) planes walking the low nwalk
    row bits, as ``row_stage_plan`` (``csrc/adjoint_stages.cuh``) makes it:
    ``(tb, ctas, threads, hi_bits, lo_bits)``, the tile bits, the CTAs and
    threads of each pass, and the walked bits of the first pass (0 with
    one pass) and of the last; ``ValueError(error)`` for a shape it does
    not take."""
    total = nrb + lw
    if not 0 <= nwalk <= min(nrb, 2 * _RP_MAXB) or not 8 <= total <= 31:
        raise ValueError(error)
    tb = min(total, _RP_TB)
    hi = nwalk - _RP_MAXB if nwalk > _RP_MAXB else 0
    return tb, 1 << (total - tb), 1 << (tb - 3), hi, min(nwalk, _RP_MAXB)


def _pass_records(ctas, threads, tb, hi, lo, smem) -> dict:
    """The ``row_hi`` and ``row_lo`` records of a row stage; ``smem(nb,
    last)`` gives a pass's shared bytes, and with one pass the first
    record is that pass's, with 0 CTAs and 0 bits."""
    return {
        "row_hi": {"ctas": ctas if hi else 0, "threads": threads, "smem": smem(hi or lo, False),
                   "tile": 1 << tb, "bits": hi},
        "row_lo": {"ctas": ctas, "threads": threads, "smem": smem(lo, True), "tile": 1 << tb, "bits": lo},
    }


def _fwd_records(nrb: int, lw: int, nwalk: int, npairs: int, error: str) -> dict:
    """The forward row passes of K1, K2 and K9 (``fwd_row_stage``) on (2^nrb,
    2^lw) planes walking the low nwalk row bits, and their product on those
    planes: ``"fwd_row_zz"`` (the phase and the low bits, first),
    ``"fwd_row_hi"`` (0 CTAs with one pass) and ``"fwd_lane"``.  A pass's
    shared bytes are the exchange tile of two planes (past 3 bits), cos/sin
    of 6 bits, 8 slot offsets and, in the zz pass, a 16-byte record a
    pair."""
    tb, ctas, threads, hi, lo = _row_stage(nrb, lw, nwalk, error)

    def smem(nb, zz):
        return 4 * ((2 << tb if nb > 3 else 0) + 2 * _RP_MAXB + 8) + (16 * npairs if zz else 0)

    rows = _pass_records(ctas, threads, tb, hi, lo, smem)
    return {
        "fwd_row_zz": rows["row_lo"],
        "fwd_row_hi": rows["row_hi"],
        "fwd_lane": {"ctas": -(-(1 << nrb) // _P_T) * ((1 << lw) // _P_T), "threads": _THREADS,
                     "smem": _FWD_PROD_SMEM, "rows": _P_T, "cols": _P_T},
    }


def _lane_records(r: int, lane: bool = True) -> dict:
    """The adjoint lane stage's records at r rows of 128 lanes: the pair and
    split-K dM (0 CTAs without the lane)."""
    nc = max(1, min(_DM_CTAS // 4, r // _D_KC))
    return {
        "lane": {"ctas": -(-r // _P_T) * 2 if lane else 0, "threads": _THREADS, "smem": _PAIR_SMEM,
                 "rows": _P_T, "cols": _P_T},
        "dm": {"ctas": 4 * nc if lane else 0, "threads": _THREADS, "smem": _DM_SMEM, "chunks": nc,
               "chunk_rows": r // nc},
    }


def zzrx_bwd_plan(r: int, nkernel: int, npairs: int, rmx: int = 0) -> dict:
    """K3/K4's stage plan at r rows of 128 lanes, computed as
    ``csrc/zzrx_bwd.cu`` makes it (no card needed): for the lane pair
    ``"lane"``, dM ``"dm"``, the row stage's first pass ``"row_hi"`` (0 CTAs
    with one pass) and its last ``"row_lo"``, and K4's outer stage
    ``"outer"`` (0 CTAs where K4 has none), each ``ctas``, ``threads`` and
    ``smem`` (dynamic shared bytes) and two of its own: the pair's tile
    ``rows`` and ``cols``, dM's ``chunks`` and ``chunk_rows``, a pass's
    ``tile`` elements and walked row ``bits``, the outer ``d`` and
    ``nouter``.  The row stage walks the low ``nkernel - rmx`` row bits."""
    nrb, nwalk = r.bit_length() - 1, nkernel - rmx
    error = f"zzrx_bwd_plan: unsupported shape r={r}, nkernel={nkernel}, rmx={rmx}"
    if r != 1 << nrb or nwalk < 0 or npairs < 0:
        raise ValueError(error)
    tb, ctas, threads, hi, lo = _row_stage(nrb, 7, nwalk, error)

    def smem(nb, last):
        floats = (4 << tb if nb > 3 else 0) + threads // 32 * (_RP_MAXB + npairs) + 2 * _RP_MAXB + 8
        return 4 * floats + (16 * npairs if last else 0)

    d = r >> nkernel
    outer = rmx == 0 and 2 <= d <= 16
    return {
        **_lane_records(r),
        **_pass_records(ctas, threads, tb, hi, lo, smem),
        "outer": {"ctas": -(-(_LANES << nkernel) // _THREADS) if outer else 0, "threads": _THREADS,
                  "smem": 0, "d": d, "nouter": d.bit_length() - 1 if outer else 0},
    }


def zzrx_bwd_card_plan(r: int, nkernel: int, npairs: int, rmx: int = 0) -> dict:
    """The same plan as the card's C code reports it
    (``tcng_zzrx_bwd_plan``), with each stage kernel's ``ctas_per_sm``,
    ``registers`` and ``local_bytes`` a thread besides.  Needs the card."""
    return _card_records("zzrx_bwd", "tcng_zzrx_bwd_plan", _PLAN_OWN, r, nkernel, npairs, rmx)


def _bwd_scratch(what: str, lib, r: int, nkernel: int, npairs: int, mode: int, rmx: int, dev) -> torch.Tensor:
    """The scratch a backward entry point needs, or raise for a shape its
    stages do not take."""
    floats = lib.tcng_zzrx_bwd_scratch(r, nkernel, npairs, mode, rmx)
    if floats < 0:
        raise ValueError(f"{what}: unsupported shape r={r}, nkernel={nkernel}, rmx={rmx}")
    return torch.empty(floats, dtype=torch.float32, device=dev)


def zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mr=None, mi=None, m7r=None, m7i=None):
    """K1's plain version: dense zz phase, row rx reference, lane matmul.

    With the (R, R) row-kron planes ``m7r/m7i`` (R = 2^rmx) the rx
    butterflies cover only the low nkernel - rmx bits (``th[rmx:]``), and
    M7 is applied as given: ``y[i, g, c] = Σ_j M7[i, j] x[j, g, c]`` on the
    (R, rb/R, 128) view of each block (K13), before the lane matmul."""
    rmx = _rowm_bits(th, m7r)
    psi = torch.complex(sr, si)
    psi = _zz_phase_dense(psi, pairs, n, zzth)
    psi = _row_layer_reference(psi, _rx_gates(th[rmx:]))
    if rmx:
        psi = rowm_apply_plain(torch.complex(m7r, m7i), psi, th.shape[0])
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


_K1_OWN = {"fwd_row_zz": ("tile", "bits"), "fwd_row_hi": ("tile", "bits"), "transpose": ("layers", "planes"),
           "fwd_lane": ("rows", "cols")}


def zzrx_fwd_plan(r: int, nkernel: int, npairs: int, lane: bool = False, rmx: int = 0) -> dict:
    """K1's stage plan at r rows of 128 lanes, computed as
    ``csrc/zzrx_fwd.cu`` makes it (no card needed): the forward row passes
    ``"fwd_row_zz"`` (the phase and the low 6 walked bits, first) and
    ``"fwd_row_hi"`` (the rest; 0 CTAs with one pass), as K2's a layer, on
    the low ``nkernel - rmx`` row bits (K13 takes the top rmx); with the
    lane the transpose of M ``"transpose"`` (CTAs a launch, two launches a
    call) and the product ``"fwd_lane"``, both 0 CTAs without it.  Each
    ``ctas``, ``threads`` and ``smem`` (dynamic shared bytes) and two of its
    own: a pass's ``tile`` elements and walked row ``bits``, the
    transpose's ``layers`` and ``planes``, the product's tile ``rows`` and
    ``cols``.  r must be a power of two."""
    nrb = r.bit_length() - 1
    error = f"zzrx_fwd_plan: unsupported shape r={r}, nkernel={nkernel}, npairs={npairs}, rmx={rmx}"
    if r < 1 or r != 1 << nrb or not 0 <= rmx <= min(nkernel, MAX_ROWM_QUBITS) or nkernel > nrb or npairs < 0:
        raise ValueError(error)
    stages = _fwd_records(nrb, 7, nkernel - rmx, npairs, error)
    prod = stages["fwd_lane"]
    return {
        "fwd_row_zz": stages["fwd_row_zz"],
        "fwd_row_hi": stages["fwd_row_hi"],
        "transpose": {"ctas": 16 if lane else 0, "threads": 256, "smem": 0, "layers": 1, "planes": 2},
        "fwd_lane": {**prod, "ctas": prod["ctas"] if lane else 0},
    }


def zzrx_fwd_card_plan(r: int, nkernel: int, npairs: int, lane: bool = False, rmx: int = 0) -> dict:
    """The same plan as the card's C code reports it (``tcng_zzrx_fwd_plan``),
    with each stage kernel's ``ctas_per_sm``, ``registers`` and
    ``local_bytes`` a thread besides.  Needs the card."""
    return _card_records("zzrx_fwd", "tcng_zzrx_fwd_plan", _K1_OWN, r, nkernel, npairs, int(lane), rmx)


def _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi, m7r, m7i):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"zzrx_fwd: no kernel for device {dev}")
    r, lanes = sr.shape
    nkernel = th.shape[0]
    _check_shape("zzrx_fwd", r, lanes, n, nkernel, th.dim() == 1)
    _check_planes("zzrx_fwd", dev, (r, lanes), sr, si)
    lane = mr is not None
    if lane:
        _check_planes("zzrx_fwd lane", dev, (lanes, lanes), mr, mi)
        mr, mi = _aligned16(mr), _aligned16(mi)
    rmx = _rowm_bits(th, m7r)
    if rmx:
        _check_rowm("zzrx_fwd", rmx)
        _check_planes("zzrx_fwd row kron", dev, (1 << rmx, 1 << rmx), m7r, m7i)
        m7r, m7i = _aligned16(m7r), _aligned16(m7i)
    zzth = _f32(zzth, dev)
    th = _f32(th, dev)
    if tuple(zzth.shape) != (len(pairs),):
        raise ValueError(f"zzrx_fwd: zzth shape {tuple(zzth.shape)}, expected {(len(pairs),)}")
    shifts = _pair_shifts(tuple(pairs), n, str(dev))
    lib = _build.library("zzrx_fwd")
    # the row stage takes r = 2^nrb rows only
    floats = lib.tcng_zzrx_fwd_scratch(r, nkernel, len(pairs), int(lane), rmx)
    if floats < 0:
        raise ValueError(f"zzrx_fwd: unsupported shape r={r}, nkernel={nkernel}, rmx={rmx}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        zzrx_fwd.launches += 1
        if rmx:
            rowm_fwd.launches += 1
        err = lib.tcng_zzrx_fwd(
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), len(pairs), th.data_ptr(), nkernel,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            None if m7r is None else m7r.data_ptr(),
            None if m7i is None else m7i.data_ptr(),
            rmx, scratch.data_ptr(), r, stream,
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
    m7r: Optional[torch.Tensor] = None,
    m7i: Optional[torch.Tensor] = None,
):
    """K1: zz phase over all n qubits, rx(th) on the nkernel in-block row
    bits, then ``y = x @ (mr + i mi)`` when the lane planes are given.

    ``sr/si`` (r, 128) float32 planes; ``zzth`` (npairs,); ``th``
    (nkernel,).  With the (R, R) row-kron planes ``m7r/m7i`` (R = 2^rmx,
    the ``FUSE_ROWM`` branch) the top rmx row bits of each block are one
    left-matmul by M7 (stage K13) instead of butterflies, which then use
    ``th[rmx:]``.  On the card r must be a power of two.  CUDA tensors
    launch the kernel (``zzrx_fwd.launches`` counts the launches,
    ``rowm_fwd.launches`` those with M7); CPU tensors run
    :func:`zzrx_fwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if sr.device.type == "cpu":
        return zzrx_fwd_plain(pairs, n, zzth, th, sr, si, mr, mi, m7r, m7i)
    return _launch_zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi, m7r, m7i)


zzrx_fwd.launches = 0


def rowm_fwd(pairs, n, zzth, th, sr, si, m7r, m7i, mr=None, mi=None):
    """K1 with its row-kron stage K13: :func:`zzrx_fwd` with the (R, R)
    planes ``m7r/m7i`` required (``rowm_fwd.launches`` counts K13)."""
    if m7r is None or m7i is None:
        raise ValueError("rowm_fwd: the row-kron planes are required")
    return zzrx_fwd(pairs, n, zzth, th, sr, si, mr, mi, m7r, m7i)


rowm_fwd.launches = 0


def _partner(x: torch.Tensor, s: int) -> torch.Tensor:
    """x with rows i and i ^ s swapped (s a power of two below the rows)."""
    r, lanes = x.shape
    return torch.flip(torch.reshape(x, (r // (2 * s), 2, s, lanes)), (1,)).reshape(r, lanes)


def zzrx_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr=None, mi=None, m7r=None, m7i=None):
    """K3's plain version: the adjoint of K1 in torch ops, stage by stage as
    the JAX ``_zzrx_bwd_kernel`` takes them.

    ``(yr, yi)`` is the layer's output (post-lane when ``mr/mi`` are given,
    which must then be unitary) and ``(ctr, cti)`` the cotangent planes
    ``(dL/dyr, -dL/dyi)``.  Returns ``(dsr, dsi, dzz, dth)`` and, with the
    lane planes, ``(dmr, dmi) = (dL/dmr, -dL/dmi)``.  With the unitary
    row-kron planes ``m7r/m7i`` (K14) the row stage un-applies M7 (x =
    M7† y), takes ``dM7 = Σ ct·x^T`` over all blocks and walks ct by M7^T;
    ``dth`` then holds the low nkernel - rmx angles and ``(dm7r, dm7i)``
    ends the tuple.
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
    rmx = _rowm_bits(th, m7r)
    if rmx:
        # x = M7† y; dM7 = ct x^T (non-conjugating); ct <- M7^T ct
        v = lambda p: _rowm_view(p, th.shape[0], m7r.shape[0])
        tmul = lambda m, p: torch.einsum("ji,bjgc->bigc", m, v(p))
        xr = tmul(m7r, sr) + tmul(m7i, si)
        xi = tmul(m7r, si) - tmul(m7i, sr)
        dot = lambda a, b: torch.einsum("bigc,bjgc->ij", v(a), b)
        dm7r = dot(cr, xr) - dot(ci, xi)
        dm7i = dot(cr, xi) + dot(ci, xr)
        cr, ci = tmul(m7r, cr) - tmul(m7i, ci), tmul(m7r, ci) + tmul(m7i, cr)
        sr, si, cr, ci = (torch.reshape(p, yr.shape) for p in (xr, xi, cr, ci))
    nkernel = th.shape[0] - rmx
    th = th[rmx:].to(torch.float32)
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
    if lane:
        out += (dmr, dmi)
    return out + (dm7r, dm7i) if rmx else out


def _launch_zzrx_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi, m7r, m7i):
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
    rmx = _rowm_bits(th, m7r)
    R = 1 << rmx
    if rmx:
        _check_rowm("zzrx_bwd", rmx)
        _check_planes("zzrx_bwd row kron", dev, (R, R), m7r, m7i)
        m7r, m7i = _aligned16(m7r), _aligned16(m7i)
    if lane or rmx:  # the lane and row-kron stages copy 16-byte chunks
        yr, yi, ctr, cti = (_aligned16(t) for t in (yr, yi, ctr, cti))
    if lane:
        mr, mi = _aligned16(mr), _aligned16(mi)
    zzth = _f32(zzth, dev)
    th = _f32(th, dev)
    if tuple(zzth.shape) != (npairs,):
        raise ValueError(f"zzrx_bwd: zzth shape {tuple(zzth.shape)}, expected {(npairs,)}")
    shifts = _pair_shifts(tuple(pairs), n, str(dev))
    ds = torch.empty((2, r, lanes), dtype=torch.float32, device=dev)
    grads = torch.empty(npairs + nkernel - rmx, dtype=torch.float32, device=dev)
    dm = torch.empty((2, lanes, lanes), dtype=torch.float32, device=dev) if lane else None
    dm7 = torch.empty((2, R, R), dtype=torch.float32, device=dev) if rmx else None
    lib = _build.library("zzrx_bwd")
    scratch = _bwd_scratch("zzrx_bwd", lib, r, nkernel, npairs, int(lane), rmx, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        zzrx_bwd.launches += 1
        if rmx:
            rowm_bwd.launches += 1
        err = lib.tcng_zzrx_bwd(
            yr.data_ptr(), yi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), grads.data_ptr(),
            None if dm is None else dm.data_ptr(),
            None if dm7 is None else dm7.data_ptr(),
            zzth.data_ptr(), shifts.data_ptr(), npairs, th.data_ptr(), nkernel,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            None if m7r is None else m7r.data_ptr(),
            None if m7i is None else m7i.data_ptr(),
            rmx, scratch.data_ptr(), r, stream,
        )
    _build.check("zzrx_bwd", err, "zzrx_bwd")
    out = (ds[0], ds[1], grads[:npairs], grads[npairs:])
    if lane:
        out += (dm[0], dm[1])
    return out + (dm7[0], dm7[1]) if rmx else out


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
    m7r: Optional[torch.Tensor] = None,
    m7i: Optional[torch.Tensor] = None,
):
    """K3: the adjoint of :func:`zzrx_fwd` from its output ``(yr, yi)``
    and the cotangent planes ``(dL/dyr, -dL/dyi)``.

    Returns ``(dsr, dsi, dzz (npairs,), dth (nkernel,))``, plus the lane
    cotangent planes ``(dmr, dmi)`` (128, 128) when the (unitary) lane
    planes are given.  With the unitary (R, R) row-kron planes ``m7r/m7i``
    (stage K14) ``dth`` holds the low nkernel - rmx angles and the tuple
    ends with ``(dm7r, dm7i)`` = ``(dL/dm7r, -dL/dm7i)``, as the JAX
    kernel returns them.  CUDA tensors launch the kernel
    (``zzrx_bwd.launches`` counts the launches, ``rowm_bwd.launches`` those
    with M7); CPU tensors run :func:`zzrx_bwd_plain`.
    """
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    if yr.device.type == "cpu":
        return zzrx_bwd_plain(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi, m7r, m7i)
    return _launch_zzrx_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi, m7r, m7i)


zzrx_bwd.launches = 0


def rowm_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, m7r, m7i, mr=None, mi=None):
    """K3 with its row-kron stage K14: :func:`zzrx_bwd` with the (R, R)
    planes ``m7r/m7i`` required (``rowm_bwd.launches`` counts K14)."""
    if m7r is None or m7i is None:
        raise ValueError("rowm_bwd: the row-kron planes are required")
    return zzrx_bwd(pairs, n, zzth, th, yr, yi, ctr, cti, mr, mi, m7r, m7i)


rowm_bwd.launches = 0


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


# ---------------------------------------------------------------------------
# the generic row layer: K6 forward, K7 backward, K8 constant-gate backward
# ---------------------------------------------------------------------------


def _gate_scalars(gr: torch.Tensor, gi: torch.Tensor, q: int):
    """(g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i) of gate q."""
    a, b = gr.reshape(-1, 4)[q], gi.reshape(-1, 4)[q]
    return a[0], b[0], a[1], b[1], a[2], b[2], a[3], b[3]


def _lo_rows(r: int, s: int, device) -> torch.Tensor:
    """(r, 1) bool: the rows whose bit of stride s is 0."""
    return ((torch.arange(r, device=device) // s) % 2 == 0)[:, None]


def _butterfly(cr: torch.Tensor, ci: torch.Tensor, s: int, m):
    """The 2x2 complex matrix m (8 scalars, row-major re/im) on the row bit
    of stride s: lo' = m00 lo + m01 hi, hi' = m10 lo + m11 hi."""
    m00r, m00i, m01r, m01i, m10r, m10i, m11r, m11i = m
    pr, pi = _partner(cr, s), _partner(ci, s)
    lo = _lo_rows(cr.shape[0], s, cr.device)
    lo_r = m00r * cr - m00i * ci + m01r * pr - m01i * pi
    lo_i = m00r * ci + m00i * cr + m01r * pi + m01i * pr
    hi_r = m10r * pr - m10i * pi + m11r * cr - m11i * ci
    hi_i = m10r * pi + m10i * pr + m11r * ci + m11i * cr
    return torch.where(lo, lo_r, hi_r), torch.where(lo, lo_i, hi_i)


def row_fwd_plain(gr, gi, sr, si, mr=None, mi=None):
    """K6's plain version: gate q's butterfly for q = 0..nkernel-1 on the
    planes, then ``y = x @ (mr + i mi)`` when the lane planes are given."""
    nk = gr.reshape(-1, 4).shape[0]
    cr, ci = sr, si
    for q in range(nk):
        cr, ci = _butterfly(cr, ci, (1 << nk) >> (q + 1), _gate_scalars(gr, gi, q))
    if mr is not None:
        cr, ci = _lane_apply(mr, mi, cr, ci)
    return cr.contiguous(), ci.contiguous()


def row_bwd_plain(gr, gi, yr, yi, ctr, cti, mr=None, mi=None):
    """K7's plain version: the adjoint of K6 from its output, stage by stage
    as the JAX ``_bwd_kernel`` takes them.

    ``(yr, yi)`` is the layer's output (post-lane when the unitary lane
    planes ``mr/mi`` are given) and ``(ctr, cti)`` the cotangent planes
    ``(dL/dyr, -dL/dyi)``.  Returns ``(dsr, dsi, dgr, dgi)`` with the gate
    cotangent planes (nkernel, 2, 2), ``dg[q, a, b] = Σ_{rows, bit=a}
    ct[r]·s[r with bit=b]`` (plain products), and, with the lane planes,
    ``(dmr, dmi)``."""
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
    nk = gr.reshape(-1, 4).shape[0]
    r = yr.shape[0]
    dgr, dgi = [None] * nk, [None] * nk
    for q in range(nk - 1, -1, -1):
        s = (1 << nk) >> (q + 1)
        g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = _gate_scalars(gr, gi, q)
        # 1) un-apply: s <- g^dagger s
        sr, si = _butterfly(sr, si, s, (g00r, -g00i, g10r, -g10i, g01r, -g01i, g11r, -g11i))
        # 2) dg[a, b]: the partner cotangent pct[r] = ct[r ^ s] turns the
        # cross sums over bit-a rows into sums over the other half
        pcr, pci = _partner(cr, s), _partner(ci, s)
        lo_b = _lo_rows(r, s, yr.device)
        lo = lo_b.to(torch.float32)
        hi = 1.0 - lo
        same_r, same_i = cr * sr - ci * si, cr * si + ci * sr
        cross_r, cross_i = pcr * sr - pci * si, pcr * si + pci * sr
        dgr[q] = torch.stack([torch.sum(lo * same_r), torch.sum(hi * cross_r),
                              torch.sum(lo * cross_r), torch.sum(hi * same_r)]).reshape(2, 2)
        dgi[q] = torch.stack([torch.sum(lo * same_i), torch.sum(hi * cross_i),
                              torch.sum(lo * cross_i), torch.sum(hi * same_i)]).reshape(2, 2)
        # 3) walk: ct <- g^T ct, with the partner values already fetched
        cr, ci = (
            torch.where(lo_b, g00r * cr - g00i * ci + g10r * pcr - g10i * pci,
                        g01r * pcr - g01i * pci + g11r * cr - g11i * ci),
            torch.where(lo_b, g00r * ci + g00i * cr + g10r * pci + g10i * pcr,
                        g01r * pci + g01i * pcr + g11r * ci + g11i * cr),
        )
    out = (cr.contiguous(), ci.contiguous(), torch.stack(dgr), torch.stack(dgi))
    return out + (dmr, dmi) if lane else out


def row_bwd_const_plain(gr, gi, ctr, cti):
    """K8's plain version: the cotangent walk ``ct <- g^T ct`` for gate q =
    nkernel-1..0, no gate cotangent."""
    nk = gr.reshape(-1, 4).shape[0]
    cr, ci = ctr, cti
    for q in range(nk - 1, -1, -1):
        g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = _gate_scalars(gr, gi, q)
        cr, ci = _butterfly(cr, ci, (1 << nk) >> (q + 1),
                            (g00r, g00i, g10r, g10i, g01r, g01i, g11r, g11i))
    return cr.contiguous(), ci.contiguous()


def _row_setup(what: str, gr, gi, sr, *planes):
    """Device checks of a row-kernel launch; the gates as (nkernel, 4)
    float32 planes on the card."""
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    gr, gi = _f32(gr, dev).reshape(-1, 4), _f32(gi, dev).reshape(-1, 4)
    nk = gr.shape[0]
    r, lanes = sr.shape
    if lanes != _LANES or not 1 <= nk <= MAX_KERNEL_QUBITS or r % (1 << nk) or gi.shape != gr.shape:
        raise ValueError(f"{what}: unsupported shape r={r}, lanes={lanes}, nkernel={nk}")
    _check_planes(what, dev, (r, lanes), sr, *planes)
    return dev, gr, gi, nk, r


def _bfly_records(what: str, r: int, nkernel: int, gate: bool) -> dict:
    """The row passes of K6 and K8 (``gate``) or K11 (``bfly_row_stage``,
    ``csrc/adjoint_stages.cuh``) at r rows of 128 lanes: ``"row_hi"`` (0
    CTAs with one pass) and ``"row_lo"`` (the low walked bits, launched
    first), each ``ctas``, ``threads``, ``smem``, ``tile`` elements and
    walked row ``bits``, on K7's plan: the nkernel low row bits walked, r a
    power of two.  A pass's shared bytes: the exchange tile of two planes
    (past 3 bits), the coefficients of 6 bits (a gate's 8 floats, or rx's
    cos/sin) and 8 slot offsets."""
    nrb = r.bit_length() - 1
    error = f"{what}: unsupported shape r={r}, nkernel={nkernel}"
    if r < 1 or r != 1 << nrb or not 1 <= nkernel <= MAX_KERNEL_QUBITS:
        raise ValueError(error)
    tb, ctas, threads, hi, lo = _row_stage(nrb, 7, nkernel, error)
    coef = 8 if gate else 2

    def smem(nb, last):
        return 4 * ((2 << tb if nb > 3 else 0) + coef * _RP_MAXB + 8)

    return _pass_records(ctas, threads, tb, hi, lo, smem)


def row_fwd_plan(r: int, nkernel: int, lane: bool = False) -> dict:
    """K6's stage plan at r rows of 128 lanes, computed as
    ``csrc/row_layer.cu`` makes it (no card needed): the lane product
    ``"lane"`` (0 CTAs without the lane; the forward product of K2 and K9,
    its tile ``rows`` and ``cols``) and the row passes ``"row_hi"`` and
    ``"row_lo"`` (:func:`_bfly_records` with the gates), each ``ctas``,
    ``threads`` and ``smem`` (dynamic shared bytes) and two of its own.  r
    must be a power of two."""
    rows = _bfly_records("row_fwd_plan", r, nkernel, True)
    return {
        "lane": {"ctas": -(-r // _P_T) * (_LANES // _P_T) if lane else 0, "threads": _THREADS,
                 "smem": _FWD_PROD_SMEM, "rows": _P_T, "cols": _P_T},
        **rows,
    }


def row_bwd_const_plan(r: int, nkernel: int) -> dict:
    """K8's row passes at r rows of 128 lanes, computed as
    ``csrc/row_layer.cu`` makes it (no card needed): K6's passes
    (:func:`_bfly_records` with the gates), which K8 runs with each gate
    transposed."""
    return _bfly_records("row_bwd_const_plan", r, nkernel, True)


def row_bwd_const_card_plan(r: int, nkernel: int) -> dict:
    """The same plan as the card's C code reports it
    (``tcng_row_bwd_const_plan``), with each pass's ``ctas_per_sm``,
    ``registers`` and ``local_bytes`` a thread besides.  Needs the card."""
    own = {k: _PLAN_OWN[k] for k in ("row_hi", "row_lo")}
    return _card_records("row_layer", "tcng_row_bwd_const_plan", own, r, nkernel)


def row_fwd_card_plan(r: int, nkernel: int, lane: bool = False) -> dict:
    """The same plan as the card's C code reports it (``tcng_row_fwd_plan``),
    with each stage kernel's ``ctas_per_sm``, ``registers`` and
    ``local_bytes`` a thread besides.  Needs the card."""
    own = {k: _PLAN_OWN[k] for k in ("lane", "row_hi", "row_lo")}
    return _card_records("row_layer", "tcng_row_fwd_plan", own, r, nkernel, int(lane))


def _launch_row_fwd(gr, gi, sr, si, mr, mi):
    dev, gr, gi, nk, r = _row_setup("row_fwd", gr, gi, sr, si)
    lane = mr is not None
    if lane:
        _check_planes("row_fwd lane", dev, (_LANES, _LANES), mr, mi)
        # the lane product copies 16-byte chunks
        sr, si, mr, mi = (_aligned16(t) for t in (sr, si, mr, mi))
    lib = _build.library("row_layer")
    floats = lib.tcng_row_fwd_scratch(r, nk, int(lane))
    if floats < 0:  # the row stage takes r = 2^nrb rows only
        raise ValueError(f"row_fwd: unsupported shape r={r}, nkernel={nk}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        row_fwd.launches += 1
        err = lib.tcng_row_fwd(
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), nk,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            None if scratch is None else scratch.data_ptr(), r, stream,
        )
    _build.check("row_layer", err, "row_fwd")
    return yr, yi


def row_fwd(gr, gi, sr, si, mr=None, mi=None):
    """K6: gate q = 0..nkernel-1 (``gr/gi`` (nkernel, 2, 2) or (nkernel, 4)
    planes) on the in-block row bit of stride ``2^nkernel >> (q+1)`` of the
    (r, 128) planes ``sr/si`` (on the card r a power of two), then ``y = x @
    (mr + i mi)`` when the lane planes are given.

    CUDA tensors launch the kernel (``row_fwd.launches`` counts the
    launches); CPU tensors run :func:`row_fwd_plain`."""
    if sr.device.type == "cpu":
        return row_fwd_plain(gr, gi, sr, si, mr, mi)
    return _launch_row_fwd(gr, gi, sr, si, mr, mi)


row_fwd.launches = 0


def row_bwd_plan(r: int, nkernel: int, lane: bool = False) -> dict:
    """K7's stage plan at r rows of 128 lanes, computed as
    ``csrc/row_layer.cu`` makes it (no card needed): the adjoint lane pair
    ``"lane"`` and dM ``"dm"`` (0 CTAs without the lane), the gate row
    stage's first pass ``"row_hi"`` (0 CTAs with one pass) and its last
    ``"row_lo"``, each ``ctas``, ``threads`` and ``smem`` (dynamic shared
    bytes) and two of its own, as :func:`zzrx_bwd_plan`'s.  The row stage
    walks the nkernel low row bits; r must be a power of two."""
    nrb = r.bit_length() - 1
    error = f"row_bwd_plan: unsupported shape r={r}, nkernel={nkernel}"
    if r != 1 << nrb or not 1 <= nkernel <= MAX_KERNEL_QUBITS:
        raise ValueError(error)
    tb, ctas, threads, hi, lo = _row_stage(nrb, 7, nkernel, error)
    # both passes take the larger one's bytes: the exchange tile of four
    # planes (past 3 bits), the warps' dg sums and the gates, 48 floats each
    smem = 4 * ((4 << tb if lo > 3 else 0) + (threads // 32 + 1) * 8 * _RP_MAXB)
    return {**_lane_records(r, lane), **_pass_records(ctas, threads, tb, hi, lo, lambda nb, last: smem)}


def row_bwd_card_plan(r: int, nkernel: int, lane: bool = False) -> dict:
    """The same plan as the card's C code reports it (``tcng_row_bwd_plan``),
    with each stage kernel's ``ctas_per_sm``, ``registers`` and
    ``local_bytes`` a thread besides.  Needs the card."""
    own = {k: _PLAN_OWN[k] for k in ("lane", "dm", "row_hi", "row_lo")}
    return _card_records("row_layer", "tcng_row_bwd_plan", own, r, nkernel, int(lane))


def rotx_fwd_plan(r: int, nkernel: int) -> dict:
    """K11's row passes at r rows of 128 lanes, computed as
    ``csrc/row_layer.cu`` makes it (no card needed): :func:`_bfly_records`
    with rx, K9's forward passes without the phase on K7's plan."""
    return _bfly_records("rotx_fwd_plan", r, nkernel, False)


def rotx_fwd_card_plan(r: int, nkernel: int) -> dict:
    """The same plan as the card's C code reports it (``tcng_rotx_fwd_plan``),
    with each pass's ``ctas_per_sm``, ``registers`` and ``local_bytes`` a
    thread besides.  Needs the card."""
    own = {k: _PLAN_OWN[k] for k in ("row_hi", "row_lo")}
    return _card_records("row_layer", "tcng_rotx_fwd_plan", own, r, nkernel)


def rotx_bwd_plan(r: int, nkernel: int) -> dict:
    """K12's row passes at r rows of 128 lanes, computed as
    ``csrc/row_layer.cu`` makes it (no card needed): the first pass
    ``"row_hi"`` (0 CTAs with one pass) and the last ``"row_lo"``, each
    ``ctas``, ``threads``, ``smem`` (dynamic shared bytes), ``tile``
    elements and walked row ``bits``, on K7's plan: the nkernel low row
    bits walked, r a power of two.  A pass's shared bytes are K3's row
    pass's with no pairs: the exchange tile of four planes (past 3 bits),
    a warp's 6 dθ sums, cos/sin of 6 bits and 8 slot offsets."""
    nrb = r.bit_length() - 1
    error = f"rotx_bwd_plan: unsupported shape r={r}, nkernel={nkernel}"
    if r < 1 or r != 1 << nrb or not 1 <= nkernel <= MAX_KERNEL_QUBITS:
        raise ValueError(error)
    tb, ctas, threads, hi, lo = _row_stage(nrb, 7, nkernel, error)

    def smem(nb, last):
        return 4 * ((4 << tb if nb > 3 else 0) + threads // 32 * _RP_MAXB + 2 * _RP_MAXB + 8)

    return _pass_records(ctas, threads, tb, hi, lo, smem)


def rotx_bwd_card_plan(r: int, nkernel: int) -> dict:
    """The same plan as the card's C code reports it (``tcng_rotx_bwd_plan``),
    with each pass's ``ctas_per_sm``, ``registers`` and ``local_bytes`` a
    thread besides.  Needs the card."""
    own = {k: _PLAN_OWN[k] for k in ("row_hi", "row_lo")}
    return _card_records("row_layer", "tcng_rotx_bwd_plan", own, r, nkernel)


def _launch_row_bwd(gr, gi, yr, yi, ctr, cti, mr, mi):
    dev, gr, gi, nk, r = _row_setup("row_bwd", gr, gi, yr, yi, ctr, cti)
    lane = mr is not None
    if lane:
        _check_planes("row_bwd lane", dev, (_LANES, _LANES), mr, mi)
        # the adjoint lane stage copies 16-byte chunks
        yr, yi, ctr, cti, mr, mi = (_aligned16(t) for t in (yr, yi, ctr, cti, mr, mi))
    ds = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)
    dg = torch.empty((2, nk, 4), dtype=torch.float32, device=dev)
    dm = torch.empty((2, _LANES, _LANES), dtype=torch.float32, device=dev) if lane else None
    lib = _build.library("row_layer")
    floats = lib.tcng_row_bwd_scratch(r, nk, int(lane))
    if floats < 0:  # the row stage takes r = 2^nrb rows only
        raise ValueError(f"row_bwd: unsupported shape r={r}, nkernel={nk}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        row_bwd.launches += 1
        err = lib.tcng_row_bwd(
            yr.data_ptr(), yi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), dg.data_ptr(),
            None if dm is None else dm.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), nk,
            None if mr is None else mr.data_ptr(),
            None if mi is None else mi.data_ptr(),
            scratch.data_ptr(), r, stream,
        )
    _build.check("row_layer", err, "row_bwd")
    out = (ds[0], ds[1], dg[0].reshape(nk, 2, 2), dg[1].reshape(nk, 2, 2))
    return out + (dm[0], dm[1]) if lane else out


def row_bwd(gr, gi, yr, yi, ctr, cti, mr=None, mi=None):
    """K7: the adjoint of :func:`row_fwd` from its output ``(yr, yi)`` and
    the cotangent planes ``(dL/dyr, -dL/dyi)``.

    Returns ``(dsr, dsi, dgr, dgi)``, the gate cotangent planes (nkernel,
    2, 2), plus the lane cotangent planes ``(dmr, dmi)`` (128, 128) when
    the (unitary) lane planes are given.  CUDA tensors launch the kernel
    (``row_bwd.launches`` counts the launches); CPU tensors run
    :func:`row_bwd_plain`."""
    if yr.device.type == "cpu":
        return row_bwd_plain(gr, gi, yr, yi, ctr, cti, mr, mi)
    return _launch_row_bwd(gr, gi, yr, yi, ctr, cti, mr, mi)


row_bwd.launches = 0


def _launch_row_bwd_const(gr, gi, ctr, cti):
    dev, gr, gi, nk, r = _row_setup("row_bwd_const", gr, gi, ctr, cti)
    if r & (r - 1):  # the row stage takes r = 2^nrb rows only
        raise ValueError(f"row_bwd_const: unsupported shape r={r}, nkernel={nk}")
    dsr = torch.empty_like(ctr)
    dsi = torch.empty_like(cti)
    lib = _build.library("row_layer")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        row_bwd_const.launches += 1
        err = lib.tcng_row_bwd_const(
            ctr.data_ptr(), cti.data_ptr(), dsr.data_ptr(), dsi.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), nk, r, stream,
        )
    _build.check("row_layer", err, "row_bwd_const")
    return dsr, dsi


def row_bwd_const(gr, gi, ctr, cti):
    """K8: the cotangent walk of :func:`row_fwd` without the lane matrix
    and without the gate cotangent (constant gates): ``ct <- g^T ct`` for
    gate q = nkernel-1..0 (on the card r a power of two).  CUDA tensors
    launch the kernel
    (``row_bwd_const.launches`` counts the launches); CPU tensors run
    :func:`row_bwd_const_plain`."""
    if ctr.device.type == "cpu":
        return row_bwd_const_plain(gr, gi, ctr, cti)
    return _launch_row_bwd_const(gr, gi, ctr, cti)


row_bwd_const.launches = 0


def _row_bwd_reference(y: torch.Tensor, gates: torch.Tensor, ct: torch.Tensor):
    """The JAX ``_row_bwd_reference``: (ds, dg) of :func:`_row_layer_reference`
    from its output y and the JAX cotangent ct, one einsum a step (not a
    kernel's plain version; the tests hold the plain versions against it)."""
    nk = gates.shape[0]
    r, lanes = y.shape
    cur_s, cur_ct = y, ct
    dgs = [None] * nk
    for q in range(nk - 1, -1, -1):
        s = (2**nk) >> (q + 1)
        gdag = torch.conj(gates[q].T).to(y.dtype)
        v = torch.reshape(cur_s, (r // (2 * s), 2, s, lanes))
        cur_s = torch.reshape(torch.einsum("ab,xbsl->xasl", gdag, v), (r, lanes))
        a_exp = torch.reshape(cur_ct, (r // (2 * s), 2, s * lanes))
        b_exp = torch.reshape(cur_s, (r // (2 * s), 2, s * lanes))
        dgs[q] = torch.einsum("xay,xby->ab", a_exp, b_exp)
        v = torch.reshape(cur_ct, (r // (2 * s), 2, s, lanes))
        cur_ct = torch.reshape(torch.einsum("ab,xbsl->xasl", gates[q].T.to(y.dtype), v), (r, lanes))
    return cur_ct, torch.stack(dgs)


def _gate_planes(gates: torch.Tensor):
    """(nkernel, 4) float32 real and imaginary planes of a gate stack."""
    g = gates.detach().to(torch.complex64).reshape(-1, 4)
    return g.real.contiguous(), g.imag.contiguous()


def _state_planes(state2d: torch.Tensor):
    return state2d.real.to(torch.float32).contiguous(), state2d.imag.to(torch.float32).contiguous()


class _RowLayer(torch.autograd.Function):
    """Counterpart of the JAX ``row_layer`` custom VJP: K6 forward, K7
    backward; the residual is the output."""

    @staticmethod
    def forward(ctx, state2d, gates):
        gr, gi = _gate_planes(gates)
        yr, yi = row_fwd(gr, gi, *_state_planes(state2d))
        ctx.save_for_backward(yr, yi, gr, gi)
        ctx.gdtype = gates.dtype
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        yr, yi, gr, gi = ctx.saved_tensors
        dsr, dsi, dgr, dgi = row_bwd(gr, gi, yr, yi, *conj_planes(g))
        return grad_of_planes(dsr, dsi).to(g.dtype), grad_of_planes(dgr, dgi).to(ctx.gdtype)


class _RowLayerLane(torch.autograd.Function):
    """Counterpart of the JAX ``row_layer_lane`` custom VJP: K6 with the
    lane matrix forward, K7 with it backward."""

    @staticmethod
    def forward(ctx, state2d, gates, mlane):
        gr, gi = _gate_planes(gates)
        mr, mi = _state_planes(mlane.detach())
        yr, yi = row_fwd(gr, gi, *_state_planes(state2d), mr, mi)
        ctx.save_for_backward(yr, yi, gr, gi, mr, mi)
        ctx.dtypes = (gates.dtype, mlane.dtype)
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        yr, yi, gr, gi, mr, mi = ctx.saved_tensors
        dsr, dsi, dgr, dgi, dmr, dmi = row_bwd(gr, gi, yr, yi, *conj_planes(g), mr, mi)
        return (
            grad_of_planes(dsr, dsi).to(g.dtype),
            grad_of_planes(dgr, dgi).to(ctx.dtypes[0]),
            grad_of_planes(dmr, dmi).to(ctx.dtypes[1]),
        )


class _RowLayerConst(torch.autograd.Function):
    """Counterpart of the JAX ``row_layer_const`` custom VJP: K6 forward,
    K8 backward; the gate cotangent is zero."""

    @staticmethod
    def forward(ctx, state2d, gates):
        gr, gi = _gate_planes(gates)
        yr, yi = row_fwd(gr, gi, *_state_planes(state2d))
        ctx.save_for_backward(gr, gi)
        ctx.gates_like = (gates.shape, gates.dtype)
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        gr, gi = ctx.saved_tensors
        dsr, dsi = row_bwd_const(gr, gi, *conj_planes(g))
        dg = None
        if ctx.needs_input_grad[1]:
            shape, dtype = ctx.gates_like
            dg = torch.zeros(shape, dtype=dtype, device=g.device)
        return grad_of_planes(dsr, dsi).to(g.dtype), dg


def row_layer(state2d: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Apply ``gates[k]`` on the k-th of the ng lowest row bits of a
    ``(r, 128)`` complex view (gate k of stride ``2^(ng-1-k)``); UNITARY
    gates only (the backward un-applies them), ``ng <= MAX_KERNEL_QUBITS``.
    Differentiable in both through K7 (the JAX ``row_layer``)."""
    return _RowLayer.apply(state2d, gates)


def row_layer_lane(state2d: torch.Tensor, gates: torch.Tensor, mlane: torch.Tensor) -> torch.Tensor:
    """Row butterflies then ``@ mlane`` (the (128, 128) right-multiplication
    matrix, the transposed kron of the lane gates) in one kernel; gates and
    ``mlane`` unitary.  Differentiable in all three through K7 with the lane
    (the JAX ``row_layer_lane``)."""
    return _RowLayerLane.apply(state2d, gates, mlane)


def row_layer_const(state2d: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """:func:`row_layer` for constant gates: the backward is the cotangent
    walk alone (K8), the gate cotangent zero (the JAX ``row_layer_const``)."""
    return _RowLayerConst.apply(state2d, gates)


# ---------------------------------------------------------------------------
# the theta-native rx layer: K11 forward, K12 backward (dθ directly)
# ---------------------------------------------------------------------------


def rotx_fwd_plain(th, sr, si):
    """K11's plain version: rx(th[q]) = [[c, -i s], [-i s, c]] for q =
    0..nkernel-1 on the in-block row bit of stride ``2^nkernel >> (q+1)``."""
    nk = th.shape[0]
    cos, sin = torch.cos(th.to(torch.float32) / 2), torch.sin(th.to(torch.float32) / 2)
    cr, ci = sr, si
    for q in range(nk):
        s = (1 << nk) >> (q + 1)
        pr, pi = _partner(cr, s), _partner(ci, s)
        cr, ci = cos[q] * cr + sin[q] * pi, cos[q] * ci - sin[q] * pr
    return cr.contiguous(), ci.contiguous()


def rotx_bwd_plain(th, yr, yi, ctr, cti):
    """K12's plain version: from the layer's output ``(yr, yi)`` and the
    cotangent planes ``(dL/dyr, -dL/dyi)``, per row bit in reverse the rx
    un-apply, dθ_q = -½ sin·Re S1 + ½ cos·Im S2 (S1 = Σ ct·s, S2 = Σ pct·s,
    plain products, pct the partner rows' cotangent) and the ct walk by
    rx^T = rx, as the JAX ``_rotx_bwd_kernel`` takes them.  Returns
    ``(dsr, dsi, dth (nkernel,))``."""
    nk = th.shape[0]
    cos, sin = torch.cos(th.to(torch.float32) / 2), torch.sin(th.to(torch.float32) / 2)
    sr, si, cr, ci = yr, yi, ctr, cti
    dth = [None] * nk
    for q in range(nk - 1, -1, -1):
        s = (1 << nk) >> (q + 1)
        c, sn = cos[q], sin[q]
        sr, si = c * sr - sn * _partner(si, s), c * si + sn * _partner(sr, s)
        pcr, pci = _partner(cr, s), _partner(ci, s)
        dth[q] = -0.5 * sn * torch.sum(cr * sr - ci * si) + 0.5 * c * torch.sum(pcr * si + pci * sr)
        cr, ci = c * cr + sn * pci, c * ci - sn * pcr
    dth = torch.stack(dth) if dth else torch.zeros(0, dtype=torch.float32, device=yr.device)
    return cr.contiguous(), ci.contiguous(), dth


def _rotx_setup(what, th, sr, *planes):
    """Device and shape checks of a rotx launch; the angles as float32 on
    the card."""
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    th = _f32(th, dev)
    nk = th.shape[0]
    r, lanes = sr.shape
    if th.dim() != 1 or lanes != _LANES or not 1 <= nk <= MAX_KERNEL_QUBITS or r % (1 << nk):
        raise ValueError(f"{what}: unsupported shape r={r}, lanes={lanes}, nkernel={nk}")
    _check_planes(what, dev, (r, lanes), sr, *planes)
    return dev, th, nk, r


def _launch_rotx_fwd(th, sr, si):
    dev, th, nk, r = _rotx_setup("rotx_fwd", th, sr, si)
    if r & (r - 1):  # the row stage takes r = 2^nrb rows only
        raise ValueError(f"rotx_fwd: unsupported shape r={r}, nkernel={nk}")
    yr = torch.empty_like(sr)
    yi = torch.empty_like(si)
    lib = _build.library("row_layer")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rotx_fwd.launches += 1
        err = lib.tcng_rotx_fwd(
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(), th.data_ptr(), nk, r, stream
        )
    _build.check("row_layer", err, "rotx_fwd")
    return yr, yi


def rotx_fwd(th, sr, si):
    """K11: rx(th[q]) for q = 0..nkernel-1 (``th`` (nkernel,)) on the
    in-block row bit of stride ``2^nkernel >> (q+1)`` of the (r, 128)
    planes ``sr/si`` (on the card r a power of two).  CUDA tensors launch the kernel (``rotx_fwd.launches``
    counts the launches); CPU tensors run :func:`rotx_fwd_plain`."""
    if sr.device.type == "cpu":
        return rotx_fwd_plain(th, sr, si)
    return _launch_rotx_fwd(th, sr, si)


rotx_fwd.launches = 0


def _launch_rotx_bwd(th, yr, yi, ctr, cti):
    dev, th, nk, r = _rotx_setup("rotx_bwd", th, yr, yi, ctr, cti)
    ds = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)
    dth = torch.empty(nk, dtype=torch.float32, device=dev)
    lib = _build.library("row_layer")
    floats = lib.tcng_rotx_bwd_scratch(r, nk)
    if floats < 0:  # the row stage takes r = 2^nrb rows only
        raise ValueError(f"rotx_bwd: unsupported shape r={r}, nkernel={nk}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rotx_bwd.launches += 1
        err = lib.tcng_rotx_bwd(
            yr.data_ptr(), yi.data_ptr(), ctr.data_ptr(), cti.data_ptr(),
            ds[0].data_ptr(), ds[1].data_ptr(), dth.data_ptr(), th.data_ptr(), nk,
            scratch.data_ptr(), r, stream,
        )
    _build.check("row_layer", err, "rotx_bwd")
    return ds[0], ds[1], dth


def rotx_bwd(th, yr, yi, ctr, cti):
    """K12: the adjoint of :func:`rotx_fwd` from its output ``(yr, yi)``
    and the cotangent planes ``(dL/dyr, -dL/dyi)``: ``(dsr, dsi, dth)``,
    two sums a qubit.  CUDA tensors launch the kernel
    (``rotx_bwd.launches`` counts the launches); CPU tensors run
    :func:`rotx_bwd_plain`."""
    if yr.device.type == "cpu":
        return rotx_bwd_plain(th, yr, yi, ctr, cti)
    return _launch_rotx_bwd(th, yr, yi, ctr, cti)


rotx_bwd.launches = 0


class _RotxRowLayer(torch.autograd.Function):
    """Counterpart of the JAX ``rotx_row_layer`` custom VJP: K11 forward,
    K12 backward; the residual is the output."""

    @staticmethod
    def forward(ctx, state2d, thetas):
        th = thetas.detach().to(torch.float32)
        yr, yi = rotx_fwd(th, *_state_planes(state2d))
        ctx.save_for_backward(yr, yi, th)
        ctx.tdtype = thetas.dtype
        return torch.complex(yr, yi).to(state2d.dtype)

    @staticmethod
    def backward(ctx, g):
        yr, yi, th = ctx.saved_tensors
        dsr, dsi, dth = rotx_bwd(th, yr, yi, *conj_planes(g))
        return grad_of_planes(dsr, dsi).to(g.dtype), dth.to(ctx.tdtype)


def rotx_row_layer(state2d: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """rx(thetas[k]) on the k-th of the nkernel lowest row bits of a
    complex64 ``(r, 128)`` view; differentiable in both through K12, which
    returns dθ directly (the JAX ``rotx_row_layer``)."""
    return _RotxRowLayer.apply(state2d, thetas)
