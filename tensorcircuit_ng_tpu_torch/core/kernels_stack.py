"""L stacked zzrx layers threading float32 planes, plus the fused Ising
energy readout (forward).

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_stack.py``.  Layer
structure (n qubits, layout index = row * 128 + lane, nrow = n - 7 row
qubits split into nouter outer and nkernel kernel qubits):

  x --zzrx (zz phase over ALL qubits + rx on the nkernel row bits)--> k
  k --outer: kron of rx on the top nouter row bits, left matmul--> o
  o --lane: kron of rx on the 7 lane bits, right matmul--> x'

On a CUDA state the lane matmul rides inside kernel K1 (``FUSE_LANE``
topology; the residual ``ks[l]`` is then the post-lane state, since outer
and lane act on disjoint axes), and an even number of layers with
1 <= nouter and nrow <= ``MAX_GRAND_ROW_QUBITS`` runs as ONE call of kernel
K2 (``kernels_grand.grand_zzrx_fwd``).  On a CPU state every stage is
plain torch (the JAX package's CPU branch) and differentiates by autograd.
The per-layer outer and unfused lane matmuls are plain ``torch.matmul``, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from functools import lru_cache
import numpy as np
import torch

from . import kernels_grand as kg
from . import kernels_rowlayer as krl

__all__ = [
    "zzrx_stack_core",
    "zzrx_stack_energy",
    "zzrx_stack_energy_theta",
    "MAX_GRAND_ROW_QUBITS",
]

_LANE_QUBITS = 7

#: row qubits of the grand (one-call) path; above it the stack runs per layer
MAX_GRAND_ROW_QUBITS = 14


def _shapes(n: int):
    nlane = _LANE_QUBITS
    nrow = n - nlane
    nkernel = min(nrow, krl.MAX_KERNEL_QUBITS_ZZRX)
    nouter = nrow - nkernel
    return nrow, nkernel, nouter, nlane


def _rx_kron(th: torch.Tensor) -> torch.Tensor:
    """(L, k) angles -> (L, 2^k, 2^k) complex64 kron(rx(θ_0), ..., rx(θ_{k-1})),
    θ_0 on the most significant bit."""
    L, k = th.shape
    g = krl._rx_gates(th.to(torch.float32))  # (L, k, 2, 2)
    m = torch.ones((L, 1, 1), dtype=torch.complex64, device=th.device)
    for q in range(k):
        d = m.shape[-1]
        m = (m[:, :, None, :, None] * g[:, q, None, :, None, :]).reshape(L, 2 * d, 2 * d)
    return m


def _rx_kron_planes(th: torch.Tensor):
    """(real, imag) float32 planes of :func:`_rx_kron` for (L, k) angles."""
    m = _rx_kron(th)
    return m.real.contiguous(), m.imag.contiguous()


def _lane_kron_planes_T(th: torch.Tensor):
    """Planes of kron(rx(θ_0), ..).T, the lane right-multiply convention."""
    m = _rx_kron(th).transpose(-1, -2)
    return m.real.contiguous(), m.imag.contiguous()


def _theta_kron_mats(n: int, rx_thetas: torch.Tensor):
    """(mout, mlane) complex64 matrices of a (L, n) angle grid."""
    nrow, nkernel, nouter, nlane = _shapes(n)
    mout = _rx_kron(rx_thetas[:, :nouter])
    mlane = _rx_kron(rx_thetas[:, nrow:]).transpose(-1, -2)
    return mout, mlane


def _outer_apply(mor, moi, xr, xi):
    """Planes <- complex left-matmul by mo on the leading (D) axis."""
    d = mor.shape[0]
    fr = xr.reshape(d, -1)
    fi = xi.reshape(d, -1)
    yr = mor @ fr - moi @ fi
    yi = mor @ fi + moi @ fr
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


_lane_apply = krl._lane_apply


def _planes(z: torch.Tensor):
    return z.real.to(torch.float32).contiguous(), z.imag.to(torch.float32).contiguous()


def _stack_fwd_impl(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane):
    """Returns ``(yr, yi, ks, fused)``: output planes, the per-layer
    residual planes and whether the lane matmul rode inside the kernel."""
    nrow, nkernel, nouter, nlane = _shapes(n)
    r, lanes = state2d.shape
    L = zz_thetas.shape[0]
    fused = state2d.is_cuda
    sr, si = _planes(state2d)
    mor, moi = _planes(mout)
    mlr, mli = _planes(mlane)
    zz_thetas = zz_thetas.to(torch.float32)
    rx_kernel_thetas = rx_kernel_thetas.to(torch.float32)
    if fused and nouter >= 1 and L % 2 == 0 and nrow <= MAX_GRAND_ROW_QUBITS:
        ksr, ksi, yr, yi = kg.grand_zzrx_fwd(
            pairs, n, zz_thetas, rx_kernel_thetas, sr, si, mor, moi, mlr, mli
        )
        return yr, yi, tuple((ksr[l], ksi[l]) for l in range(L)), fused
    ks = []
    for l in range(L):
        if fused:
            sr, si = krl.zzrx_fwd(
                pairs, n, zz_thetas[l], rx_kernel_thetas[l], sr, si, mlr[l], mli[l]
            )
        else:
            sr, si = krl.zzrx_fwd(pairs, n, zz_thetas[l], rx_kernel_thetas[l], sr, si)
        ks.append((sr, si))
        if nouter:
            sr, si = _outer_apply(mor[l], moi[l], sr, si)
        else:
            # degenerate outer stage: mout is a (1, 1) complex scalar
            ar, ai = mor[l, 0, 0], moi[l, 0, 0]
            sr, si = ar * sr - ai * si, ar * si + ai * sr
        if not fused:
            sr, si = _lane_apply(mlr[l], mli[l], sr, si)
    return sr, si, tuple(ks), fused


def zzrx_stack_core(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane):
    """L stacked [zz phase; rx on kernel rows; outer kron; lane matmul].

    ``state2d`` (2^nrow, 128) complex64; ``zz_thetas`` (L, npairs);
    ``rx_kernel_thetas`` (L, nkernel); ``mout`` (L, D, D) complex left-mul
    matrices on the top nouter row bits; ``mlane`` (L, 128, 128) complex
    right-mul matrices on the lane bits (the fused path requires them
    unitary, as the JAX package does)."""
    yr, yi, _, _ = _stack_fwd_impl(
        pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane
    )
    return torch.complex(yr, yi).to(state2d.dtype)


def _np_kron_all(ms):
    out = ms[0]
    for m in ms[1:]:
        out = np.kron(out, m)
    return out


@lru_cache(maxsize=16)
def _readout_consts(spec, n, nrow_s):
    """(mask (r, lanes) f64, sxl (lanes, lanes) f64, row blocks [(pos, b, m)]).

    ``spec = (diag_terms, x_terms)``: Z-strings ``((qubits...), w)`` and
    transverse fields ``(q, w)``.  Qubit q's bit of the flat index x is
    ``(x >> (n-1-q)) & 1``; rows hold qubits [0, nrow_s), lanes the rest.
    """
    diag_terms, x_terms = spec
    nlane = n - nrow_s
    r, lanes = 2**nrow_s, 2**nlane
    idx = np.arange(2**n, dtype=np.int64)
    w = np.zeros(2**n, dtype=np.float64)
    for qubits, wt in diag_terms:
        zprod = np.ones(2**n, dtype=np.float64)
        for q in qubits:
            zprod *= 1 - 2 * ((idx >> (n - 1 - int(q))) & 1)
        w += float(wt) * zprod
    mask = w.reshape(r, lanes)
    x2 = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.float64)
    e2 = np.eye(2, dtype=np.float64)
    xw = {int(q): float(wt) for q, wt in x_terms}
    sxl = np.zeros((lanes, lanes), dtype=np.float64)
    for j in range(nlane):
        wt = xw.get(nrow_s + j, 0.0)
        if wt:
            sxl += wt * _np_kron_all([x2 if jj == j else e2 for jj in range(nlane)])
    blocks = []
    pos = 0
    while pos < nrow_s:
        b = min(_LANE_QUBITS, nrow_s - pos)
        m = np.zeros((2**b, 2**b), dtype=np.float64)
        hit = False
        for j in range(b):
            wt = xw.get(pos + j, 0.0)
            if wt:
                hit = True
                m += wt * _np_kron_all([x2 if jj == j else e2 for jj in range(b)])
        if hit:
            blocks.append((pos, b, m))
        pos += b
    return mask, sxl, tuple(blocks)


@lru_cache(maxsize=16)
def _readout_tensors(spec, n, nrow_s, device: str, dtype):
    """:func:`_readout_consts` as tensors of ``dtype`` on ``device``."""
    mask, sxl, blocks = _readout_consts(spec, n, nrow_s)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(mask), t(sxl), bool(np.any(sxl)),
            tuple((p0, b0, t(m0)) for p0, b0, m0 in blocks))


def _x_sum_apply(plane, sxl, use_lanes, blocks, r, lanes):
    """S_X plane with S_X = Σ_q w_q X_q as real weighted blocks."""
    out = plane @ sxl if use_lanes else torch.zeros_like(plane)
    for pos, b, m in blocks:
        v = torch.reshape(plane, (2**pos, 2**b, -1))
        out = out + torch.reshape(torch.einsum("ab,xby->xay", m, v), (r, lanes))
    return out


def _readout_energy(sr, si, n, spec):
    """⟨H⟩ of the planes and its seed planes ``(e, br, bi)``:
    E = Σ sr·br + si·bi with B = mask ⊙ S + S_X S."""
    r, lanes = sr.shape
    nrow_s = int(round(math.log2(r)))
    diag_terms, x_terms = spec
    mask, sxl, use_lanes, blocks = _readout_tensors(spec, n, nrow_s, str(sr.device), sr.dtype)
    br = torch.zeros_like(sr)
    bi = torch.zeros_like(si)
    if diag_terms:
        br = br + mask * sr
        bi = bi + mask * si
    if x_terms:
        br = br + _x_sum_apply(sr, sxl, use_lanes, blocks, r, lanes)
        bi = bi + _x_sum_apply(si, sxl, use_lanes, blocks, r, lanes)
    return torch.sum(sr * br) + torch.sum(si * bi), br, bi


def _stack_energy_fwd(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec):
    """Returns ``(e, (ks, br, bi))``: the energy and what the backward of
    the JAX package saves (the per-layer residuals and readout seeds)."""
    yr, yi, ks, _ = _stack_fwd_impl(
        pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane
    )
    e, br, bi = _readout_energy(yr, yi, n, spec)
    return e, (ks, br, bi)


def zzrx_stack_energy(
    pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec=((), ())
) -> torch.Tensor:
    """Real float32 ⟨H⟩ after L stacked zzrx layers, for the readout
    ``spec = (diag_terms, x_terms)``: H = Σ w_s Π_{q∈s} Z_q + Σ w_q X_q."""
    return _stack_energy_fwd(
        pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec
    )[0]


def zzrx_stack_energy_theta(pairs, n, state2d, zz_thetas, rx_thetas, spec=((), ())):
    """Real float32 ⟨H⟩ after L stacked zzrx layers, angle-level boundary.

    ``rx_thetas`` is the full (L, n) angle grid (outer + kernel + lane
    qubits); the outer and lane matrices are built here.  The JAX package
    attaches the grand backward kernel at this boundary."""
    nrow, nkernel, nouter, nlane = _shapes(n)
    mout, mlane = _theta_kron_mats(n, rx_thetas)
    return _stack_energy_fwd(
        pairs, n, state2d, zz_thetas, rx_thetas[:, nouter:nrow], mout, mlane, spec
    )[0]
