"""L stacked zzrx layers threading float32 planes, plus the fused Ising
energy readout, with their hand-walked adjoint.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels_stack.py``.  Layer
structure (n qubits, layout index = row * 128 + lane, nrow = n - 7 row
qubits split into nouter outer and nkernel kernel qubits):

  x --zzrx (zz phase over ALL qubits + rx on the nkernel row bits)--> k
  k --outer: kron of rx on the top nouter row bits, left matmul--> o
  o --lane: kron of rx on the 7 lane bits, right matmul--> x'

The mode is decided in one place, :func:`_stack_mode`, from the module
switches of the JAX package (same names, same defaults): with
``FUSE_LANE`` on a CUDA state the lane matmul rides inside kernel K1 (the
residual ``ks[l]`` is then the post-lane state, since outer and lane act on
disjoint axes), and with ``FUSE_ROWM`` as well the top rmx =
:func:`_rowm_qubits` row bits of each block ride as one (2^rmx)^2 rx-kron
left-matmul (K1's stage K13, K3's stage K14).  With ``FUSE_GRAND``, no
ROWM, an even number of layers, 1 <= nouter and nrow <=
``MAX_GRAND_ROW_QUBITS`` the forward runs as ONE call of kernel K2
(``kernels_grand.grand_zzrx_fwd``); ``FUSE_GRAND_BWD`` sends the energy to
the angle-level boundary, whose backward is K4 (the gate sits in
``kernels.fused_zzrx_multilayer_energy``).  ``FUSE_LANE = False``, or a CPU
state, takes the unfused topology (on a CPU state the JAX package's CPU
branch, through the plain versions).  The mode is captured at forward time
on the autograd node, so flipping a switch before the backward changes
nothing.  The per-layer outer and unfused lane matmuls are plain
``torch.matmul``, as the JAX package leaves them to XLA.

The JAX custom VJPs become ``torch.autograd.Function``s with the same
inputs and gradients: ``zzrx_stack_core`` and ``zzrx_stack_energy``
(matrix level; the backward walks :func:`_adjoint_chain`, K3 once a layer
on a CUDA state, and returns matrix cotangents that autograd chains to the
angles through the kron builders) and ``zzrx_stack_energy_theta`` (angle
level, always the fused topology without ROWM; the backward is K4, then
the lane chain dM -> dθ_lane by ``torch.autograd.grad`` through the lane
kron builder).
At every boundary torch's gradient of a complex tensor is the conjugate of
the JAX cotangent the kernels take and return.  The residuals live on the
autograd node, so when autograd records nothing (``torch.no_grad``, or no
input that requires grad) they are freed as the call returns.
"""

from __future__ import annotations

import math
from functools import lru_cache
import numpy as np
import torch

from .. import config
from . import kernels_grand as kg
from . import kernels_rowlayer as krl
from .transform_rules import each, loop_vmap

__all__ = [
    "zzrx_stack_core",
    "zzrx_stack_energy",
    "zzrx_stack_energy_theta",
    "MAX_GRAND_ROW_QUBITS",
]

_LANE_QUBITS = 7

#: the lane matmul inside K1/K3 (needs a unitary lane matrix)
FUSE_LANE = True
#: the top row bits of each block as one rx-kron left-matmul (K13/K14);
#: off by default, as in the JAX package
FUSE_ROWM = False
ROWM_QUBITS = 7
#: the whole L-layer forward as one K2 call
FUSE_GRAND = True
#: the energy's backward as one K4 call (the angle-level boundary)
FUSE_GRAND_BWD = True

#: row qubits of the grand (one-call) path; above it the stack runs per layer
MAX_GRAND_ROW_QUBITS = 14


def _shapes(n: int):
    nlane = _LANE_QUBITS
    nrow = n - nlane
    nkernel = min(nrow, krl.MAX_KERNEL_QUBITS_ZZRX)
    nouter = nrow - nkernel
    return nrow, nkernel, nouter, nlane


def _rowm_qubits(nkernel: int) -> int:
    """Top row bits in the row kron: at least 3 butterfly bits stay, and
    the kron is at most 128 x 128 (the JAX package's rule)."""
    return max(0, min(ROWM_QUBITS, nkernel - 3))


def _stack_mode(n: int, state2d: torch.Tensor):
    """``(fused, rmx)`` of a stack on ``state2d``: the lane inside the
    kernels (``FUSE_LANE`` on a CUDA state, the JAX package's "on a TPU"),
    and the row bits in the row kron (``FUSE_ROWM``, fused only)."""
    fused = FUSE_LANE and state2d.is_cuda
    rmx = _rowm_qubits(_shapes(n)[1]) if fused and FUSE_ROWM else 0
    return fused, rmx


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


_outer_apply = krl._outer_apply
_outer_walk = krl._outer_walk
_lane_apply = krl._lane_apply
_lane_walk = krl._lane_walk


def _planes(z: torch.Tensor):
    return z.real.to(torch.float32).contiguous(), z.imag.to(torch.float32).contiguous()


def _stack_fwd_impl(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mo, ml, fused, rmx):
    """Returns ``(yr, yi, ksr, ksi)``: the output planes and the per-layer
    residual planes ``(ksr[l], ksi[l])`` (K2's (L, r, 128) outputs, or
    tuples of L planes).  ``mo``/``ml`` are the (real, imag) float32 planes
    of the outer and lane matrices.  ``fused``: the lane matmul rides inside
    the kernel (the residual is then the post-lane state); ``rmx``: the top
    row bits that ride in the row kron (fused only)."""
    nrow, nkernel, nouter, nlane = _shapes(n)
    L = zz_thetas.shape[0]
    sr, si = _planes(state2d)
    mor, moi = mo
    mlr, mli = ml
    zz_thetas = zz_thetas.to(torch.float32)
    rx_kernel_thetas = rx_kernel_thetas.to(torch.float32)
    if (
        FUSE_GRAND and fused and not rmx and nouter >= 1 and L % 2 == 0
        and nrow <= MAX_GRAND_ROW_QUBITS
    ):
        ksr, ksi, yr, yi = kg.grand_zzrx_fwd(
            pairs, n, zz_thetas, rx_kernel_thetas, sr, si, mor, moi, mlr, mli
        )
        return yr, yi, ksr, ksi
    ksr, ksi = [], []
    for l in range(L):
        if fused:
            m7r = m7i = None
            if rmx:
                m7r, m7i = (m[0] for m in _rx_kron_planes(rx_kernel_thetas[l:l + 1, :rmx]))
            sr, si = krl.zzrx_fwd(
                pairs, n, zz_thetas[l], rx_kernel_thetas[l], sr, si, mlr[l], mli[l], m7r, m7i
            )
        else:
            sr, si = krl.zzrx_fwd(pairs, n, zz_thetas[l], rx_kernel_thetas[l], sr, si)
        ksr.append(sr)
        ksi.append(si)
        if nouter:
            sr, si = _outer_apply(mor[l], moi[l], sr, si)
        else:
            # degenerate outer stage: mout is a (1, 1) complex scalar
            ar, ai = mor[l, 0, 0], moi[l, 0, 0]
            sr, si = ar * sr - ai * si, ar * si + ai * sr
        if not fused:
            sr, si = _lane_apply(mlr[l], mli[l], sr, si)
    return sr, si, tuple(ksr), tuple(ksi)


def _adjoint_chain(pairs, n, ksr, ksi, zz_thetas, rx_kernel_thetas, mout, mlane, cr, ci, fused, rmx):
    """Walk the L-layer adjoint from the output cotangent planes
    ``(cr, ci) = (dL/dyr, -dL/dyi)``.

    Returns ``(dsr, dsi, dzz, dth, (dmor, dmoi), (dmlr, dmli))``, every
    complex cotangent as planes in the same convention.  ``fused`` and
    ``rmx`` are the forward's mode: fused residuals are post-lane and
    pre-outer, unfused ones the kernel's output before the outer and lane
    matmuls; with rmx, K3 takes the row kron and dM7 chains to the top rmx
    angles through the kron builder.
    """
    nrow, nkernel, nouter, nlane = _shapes(n)
    L = zz_thetas.shape[0]
    d = 2**nouter
    mor, moi = _planes(mout)
    mlr, mli = _planes(mlane)
    zz_thetas = zz_thetas.to(torch.float32)
    rx_kernel_thetas = rx_kernel_thetas.to(torch.float32)
    dzz, dth, dmo, dml = [], [], [], []
    for l in range(L - 1, -1, -1):
        kr, ki = ksr[l], ksi[l]
        if not fused:
            # lane stage x' = o @ m with o = outer(k) recomputed: dm = o^T ct
            if nouter:
                o_r, o_i = _outer_apply(mor[l], moi[l], kr, ki)
            else:
                ar, ai = mor[l, 0, 0], moi[l, 0, 0]
                o_r, o_i = ar * kr - ai * ki, ar * ki + ai * kr
            dml.append((o_r.T @ cr - o_i.T @ ci, o_r.T @ ci + o_i.T @ cr))
            cr, ci = _lane_walk(mlr[l], mli[l], cr, ci)
        if nouter:
            # outer stage o = mo @ k: dmo = ct @ k^T over the flattened rows
            fc_r, fc_i = cr.reshape(d, -1), ci.reshape(d, -1)
            fk_r, fk_i = kr.reshape(d, -1), ki.reshape(d, -1)
            dmo.append((fc_r @ fk_r.T - fc_i @ fk_i.T, fc_r @ fk_i.T + fc_i @ fk_r.T))
            cr, ci = _outer_walk(mor[l], moi[l], cr, ci)
        else:
            # o = a k for the complex scalar a: g_a = sum g_o k, g_k = a g_o
            ar, ai = mor[l, 0, 0], moi[l, 0, 0]
            gar = torch.sum(cr * kr) - torch.sum(ci * ki)
            gai = torch.sum(cr * ki) + torch.sum(ci * kr)
            dmo.append((gar.reshape(1, 1), gai.reshape(1, 1)))
            cr, ci = ar * cr - ai * ci, ar * ci + ai * cr
        if fused and rmx:
            th7 = rx_kernel_thetas[l, :rmx]
            m7r, m7i = (m[0] for m in _rx_kron_planes(th7[None]))
            cr, ci, dz, dt_low, gmr, gmi, dm7r, dm7i = krl.zzrx_bwd(
                pairs, n, zz_thetas[l], rx_kernel_thetas[l], kr, ki, cr, ci, mlr[l], mli[l], m7r, m7i
            )
            dml.append((gmr, gmi))
            # dM7 -> dθ_top through the kron builder; the planes are
            # (dL/dm7r, -dL/dm7i), so the imaginary cotangent flips sign
            with torch.enable_grad():
                t7 = th7.detach().requires_grad_()
                pr, pi = _rx_kron_planes(t7[None])
                (dt7,) = torch.autograd.grad((pr, pi), t7, (dm7r[None], -dm7i[None]))
            dt = torch.cat([dt7, dt_low])
        elif fused:
            cr, ci, dz, dt, gmr, gmi = krl.zzrx_bwd(
                pairs, n, zz_thetas[l], rx_kernel_thetas[l], kr, ki, cr, ci, mlr[l], mli[l]
            )
            dml.append((gmr, gmi))
        else:
            cr, ci, dz, dt = krl.zzrx_bwd(
                pairs, n, zz_thetas[l], rx_kernel_thetas[l], kr, ki, cr, ci
            )
        dzz.append(dz)
        dth.append(dt)

    def stack(xs):
        return torch.stack(xs[::-1])

    return (
        cr, ci, stack(dzz), stack(dth),
        (stack([x[0] for x in dmo]), stack([x[1] for x in dmo])),
        (stack([x[0] for x in dml]), stack([x[1] for x in dml])),
    )


def _matrix_grads(ctx, zz_thetas, rx_kernel_thetas, mout, mlane, ks, cr, ci):
    """torch gradients of (state2d, zz, rx_kernel, mout, mlane) of a
    matrix-level boundary from its output cotangent planes (the adjoint
    chain's kernels through :func:`transform_rules.each`)."""
    pairs, n, fused, rmx, nks = ctx.pairs, ctx.n, ctx.fused, ctx.rmx, ctx.nks

    def chain(zz, th, mo, ml, cr, ci, *ks):
        dsr, dsi, dzz, dth, dmo, dml = _adjoint_chain(
            pairs, n, *_unpack_ks(ks, nks), zz, th, mo, ml, cr, ci, fused, rmx
        )
        return (dsr, dsi, dzz, dth) + dmo + dml

    dsr, dsi, dzz, dth, dmor, dmoi, dmlr, dmli = each(
        chain, zz_thetas, rx_kernel_thetas, mout, mlane, cr, ci, *ks
    )
    return (
        krl.grad_of_planes(dsr, dsi).to(ctx.state_dtype),
        dzz.to(zz_thetas.dtype),
        dth.to(rx_kernel_thetas.dtype),
        krl.grad_of_planes(dmor, dmoi).to(mout.dtype),
        krl.grad_of_planes(dmlr, dmli).to(mlane.dtype),
    )


def _pack_ks(ksr, ksi) -> tuple:
    """The residual states as flat extra outputs of a forward: K2's two
    stacked (L, r, 128) planes, or the per-layer planes of each part."""
    if torch.is_tensor(ksr):
        return (ksr, ksi)
    return tuple(ksr) + tuple(ksi)


def _unpack_ks(ks, nks):
    """``(ksr, ksi)`` of :func:`_pack_ks`'s outputs (``nks`` planes a part):
    K2's stacked planes, or tuples of the per-layer ones."""
    if nks == 1 and ks[0].dim() == 3:
        return ks[0], ks[1]
    return tuple(ks[:nks]), tuple(ks[nks:])


def _save_stack(ctx, pairs, n, state2d, ks) -> None:
    """The node's non-tensor state of a stack boundary; the residuals
    ``ks`` (:func:`_pack_ks`) ride as saved tensors.  The mode is the
    forward's: :func:`_stack_mode` reads it the same way just after."""
    ctx.pairs, ctx.n = pairs, n
    ctx.fused, ctx.rmx = _stack_mode(n, state2d)
    ctx.nks = len(ks) // 2
    ctx.state_dtype = state2d.dtype
    ctx.mark_non_differentiable(*ks)


class _StackCore(torch.autograd.Function):
    """Counterpart of the JAX ``zzrx_stack_core`` custom VJP."""

    @staticmethod
    def forward(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane):
        fused, rmx = _stack_mode(n, state2d)
        yr, yi, ksr, ksi = _stack_fwd_impl(
            pairs, n, state2d, zz_thetas, rx_kernel_thetas, _planes(mout), _planes(mlane), fused, rmx
        )
        # the residuals are intermediates (neither inputs nor the result):
        # extra outputs, so that a transform's node keeps them
        return (torch.complex(yr, yi).to(state2d.dtype),) + _pack_ks(ksr, ksi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane = inputs
        ks = output[1:]
        _save_stack(ctx, pairs, n, state2d, ks)
        ctx.save_for_backward(zz_thetas, rx_kernel_thetas, mout, mlane, *ks)

    @staticmethod
    def backward(ctx, g, *_):
        zz, th, mo, ml, *ks = ctx.saved_tensors
        cr, ci = krl.conj_planes(g)
        return (None, None) + _matrix_grads(ctx, zz, th, mo, ml, ks, cr, ci)

    @staticmethod
    def vmap(info, in_dims, *args):
        return loop_vmap(info, in_dims, _StackCore.apply, args)


def zzrx_stack_core(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane):
    """L stacked [zz phase; rx on kernel rows; outer kron; lane matmul].

    ``state2d`` (2^nrow, 128) complex64; ``zz_thetas`` (L, npairs);
    ``rx_kernel_thetas`` (L, nkernel); ``mout`` (L, D, D) complex left-mul
    matrices on the top nouter row bits; ``mlane`` (L, 128, 128) complex
    right-mul matrices on the lane bits.  On a CUDA state under
    ``FUSE_LANE`` the lane matmul rides inside the kernels, and then
    ``mlane`` must be unitary, as in the JAX package.  Differentiable in every tensor: the backward walks
    :func:`_adjoint_chain` (K3 on a CUDA state)."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _StackCore.apply(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane)[0]


def _np_kron_all(ms):
    out = ms[0]
    for m in ms[1:]:
        out = np.kron(out, m)
    return out


@lru_cache(maxsize=16)
def _readout_consts(spec, n, nrow_s):
    """(sxl (lanes, lanes) f64, row blocks [(pos, b, m)]) of the transverse
    fields; ``spec = (diag_terms, x_terms)``: Z-strings ``((qubits...), w)``
    and transverse fields ``(q, w)``; rows hold qubits [0, nrow_s), lanes
    the rest."""
    diag_terms, x_terms = spec
    nlane = n - nrow_s
    lanes = 2**nlane
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
    return sxl, tuple(blocks)


def _readout_mask(diag_terms, n, nrow_s, device: str) -> torch.Tensor:
    """(r, lanes) float64 Σ_s w_s Π_{q∈s} Z_q on ``device``; qubit q's bit
    of the flat index x is ``(x >> (n-1-q)) & 1``.  Built there: on the
    host it would be O(terms · 2^n) numpy passes (minutes at n=28)."""
    idx = torch.arange(2**n, device=device)
    w = torch.zeros(2**n, dtype=torch.float64, device=device)
    for qubits, wt in diag_terms:
        zprod = torch.ones(2**n, dtype=torch.float64, device=device)
        for q in qubits:
            zprod *= 1 - 2 * ((idx >> (n - 1 - int(q))) & 1)
        w += float(wt) * zprod
    return w.reshape(2**nrow_s, -1)


@config.tensor_cache(maxsize=16)
def _readout_tensors(spec, n, nrow_s, device: str, dtype):
    """The Z-string mask and :func:`_readout_consts` as tensors of
    ``dtype`` on ``device``."""
    sxl, blocks = _readout_consts(spec, n, nrow_s)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (_readout_mask(spec[0], n, nrow_s, device).to(dtype), t(sxl), bool(np.any(sxl)),
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


class _StackEnergy(torch.autograd.Function):
    """Counterpart of the JAX ``zzrx_stack_energy`` custom VJP: the
    readout's seed planes ``(br, bi)`` come from the forward, so its
    backward is one scale, ``ct = (2 g br, -2 g bi)``."""

    @staticmethod
    def forward(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec):
        fused, rmx = _stack_mode(n, state2d)
        yr, yi, ksr, ksi = _stack_fwd_impl(
            pairs, n, state2d, zz_thetas, rx_kernel_thetas, _planes(mout), _planes(mlane), fused, rmx
        )
        e, br, bi = _readout_energy(yr, yi, n, spec)
        return (e, br, bi) + _pack_ks(ksr, ksi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec = inputs
        _, br, bi, *ks = output
        _save_stack(ctx, pairs, n, state2d, ks)
        ctx.mark_non_differentiable(br, bi)
        ctx.save_for_backward(zz_thetas, rx_kernel_thetas, mout, mlane, br, bi, *ks)

    @staticmethod
    def backward(ctx, g, *_):
        zz, th, mo, ml, br, bi, *ks = ctx.saved_tensors
        s = 2.0 * g.to(torch.float32)
        return (None, None) + _matrix_grads(ctx, zz, th, mo, ml, ks, s * br, -s * bi) + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        return loop_vmap(info, in_dims, _StackEnergy.apply, args)


def zzrx_stack_energy(
    pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec=((), ())
) -> torch.Tensor:
    """Real float32 ⟨H⟩ after L stacked zzrx layers, for the readout
    ``spec = (diag_terms, x_terms)``: H = Σ w_s Π_{q∈s} Z_q + Σ w_q X_q.
    Matrix-level boundary: differentiable in every tensor, the matrix
    cotangents chained to the angles by autograd outside."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _StackEnergy.apply(pairs, n, state2d, zz_thetas, rx_kernel_thetas, mout, mlane, spec)[0]


class _StackEnergyTheta(torch.autograd.Function):
    """Counterpart of the JAX ``zzrx_stack_energy_theta`` custom VJP: the
    forward is K2 under ``FUSE_GRAND`` (and an even L), else K1 a layer;
    the backward is K4 (:func:`kernels_grand.grand_zzrx_bwd`), then the lane
    chain dM -> dθ_lane through the kron builder."""

    @staticmethod
    def forward(pairs, n, state2d, zz_thetas, rx_thetas, spec):
        nrow, nkernel, nouter, nlane = _shapes(n)
        th = rx_thetas.detach().to(torch.float32)
        mo = _rx_kron_planes(th[:, :nouter])
        ml = _lane_kron_planes_T(th[:, nrow:])
        # always the fused topology without ROWM (the JAX package asserts
        # it here); FUSE_GRAND picks K2 or per-layer K1
        yr, yi, ksr, ksi = _stack_fwd_impl(
            pairs, n, state2d, zz_thetas, th[:, nouter:nrow], mo, ml, True, 0
        )
        e, br, bi = _readout_energy(yr, yi, n, spec)
        return (e, br, bi) + mo + ml + _pack_ks(ksr, ksi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pairs, n, state2d, zz_thetas, rx_thetas, spec = inputs
        rest = output[1:]
        ctx.pairs, ctx.n, ctx.nks = pairs, n, (len(rest) - 6) // 2
        ctx.state_dtype = state2d.dtype
        ctx.mark_non_differentiable(*rest)
        ctx.save_for_backward(zz_thetas, rx_thetas, *rest)

    @staticmethod
    def backward(ctx, g, *_):
        zz_thetas, rx_thetas, br, bi, mor, moi, mlr, mli, *ks = ctx.saved_tensors
        pairs, n, nks = ctx.pairs, ctx.n, ctx.nks
        nrow, nkernel, nouter, nlane = _shapes(n)
        s = 2.0 * g.to(torch.float32)

        def adjoint(zz, rx, ctr, cti, mor, moi, mlr, mli, *ks):
            th = rx.detach().to(torch.float32)
            # K2's residuals come stacked; per-layer K1 ones (odd L) are stacked here
            ksr, ksi = (k if torch.is_tensor(k) else torch.stack(k) for k in _unpack_ks(ks, nks))
            dsr, dsi, dzz, dthk, dtho, dmlr, dmli = kg.grand_zzrx_bwd(
                pairs, n, zz, th[:, nouter:nrow].contiguous(), ksr, ksi, ctr, cti, mor, moi, mlr, mli,
            )
            # lane chain: the kernel's dM planes are (dL/dmr, -dL/dmi)
            with torch.enable_grad():
                thl = th[:, nrow:].detach().requires_grad_()
                lr, li = _lane_kron_planes_T(thl)
                (dthl,) = torch.autograd.grad((lr, li), thl, (dmlr, -dmli))
            return dsr, dsi, dzz, torch.cat([dtho, dthk, dthl], dim=1)

        dsr, dsi, dzz, dth = each(adjoint, zz_thetas, rx_thetas, s * br, -s * bi, mor, moi, mlr, mli, *ks)
        grad_state = krl.grad_of_planes(dsr, dsi).to(ctx.state_dtype)
        return None, None, grad_state, dzz.to(zz_thetas.dtype), dth.to(rx_thetas.dtype), None

    @staticmethod
    def vmap(info, in_dims, *args):
        return loop_vmap(info, in_dims, _StackEnergyTheta.apply, args)


def zzrx_stack_energy_theta(pairs, n, state2d, zz_thetas, rx_thetas, spec=((), ())):
    """Real float32 ⟨H⟩ after L stacked zzrx layers, angle-level boundary.

    ``rx_thetas`` is the full (L, n) angle grid (outer + kernel + lane
    qubits); the outer and lane matrices are built here.  Needs
    1 <= nouter <= 4.  Always the fused topology, on a CPU state too
    (through the plain versions); the backward is K4."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _StackEnergyTheta.apply(pairs, n, state2d, zz_thetas, rx_thetas, spec)[0]
