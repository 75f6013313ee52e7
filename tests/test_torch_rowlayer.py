"""The port's row-layer kernels and fused single-qubit layers against the
JAX package, on the CPU.

The plain versions of K6 (``kernels_rowlayer.row_fwd``), K7 (``row_bwd``)
and K8 (``row_bwd_const``) are held against the JAX Pallas kernels
``_pallas_row_fwd``, ``_pallas_row_bwd`` and ``_pallas_row_bwd_const`` run in
interpret mode, on the same numpy-seeded inputs, with and without the lane
matrix; the autograd boundaries ``row_layer``, ``row_layer_lane`` and
``row_layer_const`` against the JAX custom VJPs; the plain versions of K11
(``rotx_fwd``) and K12 (``rotx_bwd``) against ``_pallas_rotx_fwd`` and
``_pallas_rotx_bwd`` in interpret mode, K6's, K8's, K11's and K12's pass
order on the card against ``_pallas_row_fwd``, ``_pallas_row_bwd_const``,
``_pallas_rotx_fwd`` and ``_pallas_rotx_bwd``, and ``rotx_row_layer``
against its JAX
custom VJP; ``fused_single_qubit_layer`` and ``fused_rx_layer`` (with
and without ``USE_ROTX``) against the JAX dispatch layer.  The kernels
themselves run only on a CUDA card (``tests/test_torch_cuda.py``).

Tolerance: both sides compute in float32, in another order, on unit-norm
states and unitary gates (the backward rebuilds states by un-application):
1e-5 absolute on every output, the planes, the gate cotangent dg and the
lane cotangent dM (each of those a sum of 2^n products of size ~2^-n).
The fused layers at n <= 18: state 2e-6 and gradients 1e-5 absolute; at
n=20, where each gradient entry is a float32 sum over 2^20 amplitudes
taken in another order, 1e-4.  complex128 keeps the per-qubit formulation
on both sides: 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
from tensorcircuit_ng_tpu.core import kernels as jkernels
from tensorcircuit_ng_tpu.core import kernels_rowlayer as jkrl

from tensorcircuit_ng_tpu_torch.core import kernels
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


def _interpret(fn):
    jkernels.set_interpret_mode(True)
    try:
        return fn()
    finally:
        jkernels.set_interpret_mode(False)


def _unitaries(rng, k, dim):
    """k Haar-like unitaries (dim, dim) by numpy QR."""
    a = rng.standard_normal((k, dim, dim)) + 1j * rng.standard_normal((k, dim, dim))
    return np.linalg.qr(a)[0]


def _state(rng, size):
    psi = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    return psi / np.linalg.norm(psi)


def _planes(z):
    z = np.asarray(z).reshape(-1, 128)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _row_inputs(nkernel, blocks, seed):
    """Unit-norm state planes, unitary gates (nkernel, 2, 2) and lane
    matrix, and a cotangent, as float32 numpy planes."""
    rng = np.random.default_rng(seed)
    r = blocks * 2**nkernel
    g = _unitaries(rng, nkernel, 2)
    m = _unitaries(rng, 1, 128)[0]
    return {
        "s": _planes(_state(rng, r * 128)),
        "ct": _planes(_state(rng, r * 128)),
        "g": (g.real.astype(np.float32), g.imag.astype(np.float32)),
        "m": _planes(m),
    }


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_all_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


CASES = [(nk, blocks, lane) for nk in (3, 5) for blocks in (2, 4) for lane in (False, True)]


@pytest.mark.parametrize("nkernel,blocks,lane", CASES)
def test_row_fwd_plain_matches_pallas(nkernel, blocks, lane):
    x = _row_inputs(nkernel, blocks, seed=10 * nkernel + blocks)
    lane_args = list(x["m"]) if lane else []
    want = _interpret(lambda: jkrl._pallas_row_fwd(*_j(*x["g"], *x["s"], *lane_args)))
    got = krl.row_fwd_plain(*_t(*x["g"], *x["s"], *lane_args))
    _assert_all_close(got, want)
    # the CPU wrapper is the plain version
    _assert_all_close(krl.row_fwd(*_t(*x["g"], *x["s"], *lane_args)), want)


@pytest.mark.parametrize("nkernel,blocks,lane", CASES)
def test_row_bwd_plain_matches_pallas(nkernel, blocks, lane):
    x = _row_inputs(nkernel, blocks, seed=20 * nkernel + blocks)
    lane_args = list(x["m"]) if lane else []
    # the layer's output: the backward rebuilds its input from it
    y = [t.numpy() for t in krl.row_fwd_plain(*_t(*x["g"], *x["s"], *lane_args))]
    want = _interpret(lambda: jkrl._pallas_row_bwd(*_j(*x["g"], *y, *x["ct"], *lane_args)))
    got = krl.row_bwd_plain(*_t(*x["g"], *y, *x["ct"], *lane_args))
    assert len(got) == (6 if lane else 4)
    _assert_all_close(got, want)  # ds planes, dg planes (nkernel, 2, 2), dM planes


def _row_bwd_in_pass_order(gr, gi, yr, yi, ctr, cti):
    """K7's row stage in the order the card's gate passes take it, in plain
    torch: the passes of ``row_bwd_plan``, the first (the high walked bits)
    before the last (the low ones), each from its lowest bit; per bit the
    un-apply of g^dagger, the dg sums and the ct walk by g^T."""
    nk, r = gr.shape[0], yr.shape[0]
    plan = krl.row_bwd_plan(r, nk)
    hi, lo = plan["row_hi"]["bits"], plan["row_lo"]["bits"]
    sr, si, cr, ci = yr, yi, ctr, cti
    dg = [None] * nk
    for w in [lo + i for i in range(hi)] + list(range(lo)):
        q, s = nk - 1 - w, 1 << w
        g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = krl._gate_scalars(gr, gi, q)
        sr, si = krl._butterfly(sr, si, s, (g00r, -g00i, g10r, -g10i, g01r, -g01i, g11r, -g11i))
        # dg[a, b] = Σ ct[row with bit a] s[row with bit b], over the pairs
        lo_rows = krl._lo_rows(r, s, yr.device)[:, 0]
        c = torch.complex(cr, ci)
        z = torch.complex(sr, si)
        dg[q] = torch.stack([
            torch.stack([torch.sum(c[lo_rows] * z[lo_rows]), torch.sum(c[lo_rows] * z[~lo_rows])]),
            torch.stack([torch.sum(c[~lo_rows] * z[lo_rows]), torch.sum(c[~lo_rows] * z[~lo_rows])]),
        ])
        cr, ci = krl._butterfly(cr, ci, s, (g00r, g00i, g10r, g10i, g01r, g01i, g11r, g11i))
    dg = torch.stack(dg)
    return cr, ci, dg.real, dg.imag


@pytest.mark.parametrize("nkernel,blocks", [(5, 2), (8, 2), (11, 1)])
def test_row_bwd_pass_order_matches_pallas(nkernel, blocks):
    """The card's order of K7's gates (one pass of 5 bits; passes of 2 and
    6, and of 5 and 6 bits) against the JAX ``_pallas_row_bwd`` in
    interpret mode, which walks the gates from the lowest bit up in one
    block: the gates act on distinct bits and commute, so ds and dg agree
    to rounding (``ATOL``)."""
    x = _row_inputs(nkernel, blocks, seed=60 * nkernel + blocks)
    y = [t.numpy() for t in krl.row_fwd_plain(*_t(*x["g"], *x["s"]))]
    want = _interpret(lambda: jkrl._pallas_row_bwd(*_j(*x["g"], *y, *x["ct"])))
    got = _row_bwd_in_pass_order(*_t(x["g"][0].reshape(nkernel, 4), x["g"][1].reshape(nkernel, 4), *y,
                                     *x["ct"]))
    _assert_all_close(got, want)


def _fwd_pass_bits(plan):
    """The walked bits (from the lowest) in the order the card's forward
    passes take them: the last pass (the low bits) first, then the first
    pass (the high ones); a pass of more than 3 bits takes its bits 3..5
    in registers before its bits 0..2, each group from its lowest."""
    hi, lo = plan["row_hi"]["bits"], plan["row_lo"]["bits"]

    def order(nb, base):
        return [base + i for i in list(range(3, nb)) + list(range(min(nb, 3)))]

    return order(lo, 0) + order(hi, lo)


def _row_fwd_in_pass_order(gr, gi, sr, si):
    """K6's row stage in the order the card's passes take it, in plain
    torch (:func:`_fwd_pass_bits` of ``row_fwd_plan``): gate q = nkernel-1-w
    on walked bit w."""
    nk = gr.shape[0]
    cr, ci = sr, si
    for w in _fwd_pass_bits(krl.row_fwd_plan(sr.shape[0], nk)):
        cr, ci = krl._butterfly(cr, ci, 1 << w, krl._gate_scalars(gr, gi, nk - 1 - w))
    return cr, ci


@pytest.mark.parametrize("nkernel,blocks", [(5, 2), (8, 2), (11, 1)])
def test_row_fwd_pass_order_matches_pallas(nkernel, blocks):
    """The card's order of K6's gates (one pass of 5 bits; passes of 6 and
    2, and of 6 and 5 bits, the low pass first) against the JAX
    ``_pallas_row_fwd`` in interpret mode, which applies gate 0 (the
    highest bit) first in one block: the gates act on distinct bits and
    commute, so the planes agree to rounding (``ATOL``)."""
    x = _row_inputs(nkernel, blocks, seed=80 * nkernel + blocks)
    want = _interpret(lambda: jkrl._pallas_row_fwd(*_j(*x["g"], *x["s"])))
    got = _row_fwd_in_pass_order(*_t(x["g"][0].reshape(nkernel, 4), x["g"][1].reshape(nkernel, 4), *x["s"]))
    _assert_all_close(got, want)


@pytest.mark.parametrize("nkernel,blocks,order", [(5, 2, [3, 4, 0, 1, 2]), (8, 2, [3, 4, 5, 0, 1, 2, 6, 7]),
                                                  (11, 1, [3, 4, 5, 0, 1, 2, 9, 10, 6, 7, 8])])
def test_fwd_pass_bits_by_hand(nkernel, blocks, order):
    """The card's order of the forward passes' walked bits: the low pass's
    register bits 3.. before 0..2, then the high pass's, the same way."""
    assert _fwd_pass_bits(krl.row_fwd_plan(blocks << nkernel, nkernel)) == order
    assert _fwd_pass_bits(krl.row_bwd_const_plan(blocks << nkernel, nkernel)) == order
    assert _fwd_pass_bits(krl.rotx_fwd_plan(blocks << nkernel, nkernel)) == order


def _row_bwd_const_in_pass_order(gr, gi, ctr, cti):
    """K8's row stage in the order the card's passes take it, in plain
    torch (:func:`_fwd_pass_bits` of ``row_bwd_const_plan``, K6's order):
    the transpose of gate q = nkernel-1-w on walked bit w."""
    nk = gr.shape[0]
    cr, ci = ctr, cti
    for w in _fwd_pass_bits(krl.row_bwd_const_plan(ctr.shape[0], nk)):
        g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = krl._gate_scalars(gr, gi, nk - 1 - w)
        cr, ci = krl._butterfly(cr, ci, 1 << w, (g00r, g00i, g10r, g10i, g01r, g01i, g11r, g11i))
    return cr, ci


@pytest.mark.parametrize("nkernel,blocks", [(5, 2), (8, 2), (11, 1)])
def test_row_bwd_const_pass_order_matches_pallas(nkernel, blocks):
    """The card's order of K8's transposed gates (one pass of 5 bits;
    passes of 6 and 2, and of 6 and 5 bits, the low pass first) against the
    JAX ``_pallas_row_bwd_const`` in interpret mode, which walks gate
    nkernel-1 (the lowest bit) first in one block: the gates act on
    distinct bits and commute, so the planes agree to rounding
    (``ATOL``)."""
    x = _row_inputs(nkernel, blocks, seed=90 * nkernel + blocks)
    want = _interpret(lambda: jkrl._pallas_row_bwd_const(*_j(*x["g"], *x["ct"])))
    got = _row_bwd_const_in_pass_order(*_t(x["g"][0].reshape(nkernel, 4), x["g"][1].reshape(nkernel, 4),
                                           *x["ct"]))
    _assert_all_close(got, want)


@pytest.mark.parametrize("nkernel,blocks", [(3, 2), (3, 4), (5, 2), (5, 4)])
def test_row_bwd_const_plain_matches_pallas(nkernel, blocks):
    x = _row_inputs(nkernel, blocks, seed=30 * nkernel + blocks)
    want = _interpret(lambda: jkrl._pallas_row_bwd_const(*_j(*x["g"], *x["ct"])))
    got = krl.row_bwd_const_plain(*_t(*x["g"], *x["ct"]))
    _assert_all_close(got, want)


@pytest.mark.parametrize("nkernel,blocks", [(3, 4), (5, 2)])
def test_plain_versions_match_the_einsum_references(nkernel, blocks):
    """K6/K7's plain versions against the port's own einsum references."""
    x = _row_inputs(nkernel, blocks, seed=40 * nkernel + blocks)
    gates = torch.complex(*_t(*x["g"]))
    s = torch.complex(*_t(*x["s"]))
    ct = torch.complex(*_t(*x["ct"]))
    yr, yi = krl.row_fwd_plain(*_t(*x["g"], *x["s"]))
    _assert_all_close([torch.complex(yr, yi)], [krl._row_layer_reference(s, gates).numpy()])
    y = torch.complex(yr, yi)
    ds, dg = krl._row_bwd_reference(y, gates, ct)
    dsr, dsi, dgr, dgi = krl.row_bwd_plain(*_t(*x["g"]), yr, yi, *_t(*x["ct"]))
    _assert_all_close([dsr, dsi, dgr, dgi], [ds.real, ds.imag, dg.real, dg.imag])


def _boundary(kind, mod, state2d, gates, mlane):
    if kind == "lane":
        return mod.row_layer_lane(state2d, gates, mlane)
    return getattr(mod, {"row": "row_layer", "const": "row_layer_const"}[kind])(state2d, gates)


@pytest.mark.parametrize("kind", ["row", "lane", "const"])
def test_row_layer_boundaries_match_jax_vjp(kind):
    """Value and gradients of L = Re Σ conj(w) · layer(s, g[, M]); torch's
    gradient of a complex input is the conjugate of the JAX package's."""
    rng = np.random.default_rng({"row": 1, "lane": 2, "const": 3}[kind])
    nk, r = 4, 32
    s = _state(rng, r * 128).reshape(r, 128).astype(np.complex64)
    g = _unitaries(rng, nk, 2).astype(np.complex64)
    m = _unitaries(rng, 1, 128)[0].astype(np.complex64)
    w = (rng.standard_normal((r, 128)) + 1j * rng.standard_normal((r, 128))).astype(np.complex64)

    def jloss(s_, g_, m_):
        return jnp.real(jnp.sum(jnp.conj(w) * _boundary(kind, jkrl, s_, g_, m_)))

    jv, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*_j(s, g, m))
    ts, tg, tm = (torch.as_tensor(a).requires_grad_() for a in (s, g, m))
    tv = torch.real(torch.sum(torch.conj(torch.as_tensor(w)) * _boundary(kind, krl, ts, tg, tm)))
    grads = torch.autograd.grad(tv, (ts, tg, tm), allow_unused=True)
    assert abs(tv.item() - float(jv)) <= ATOL * max(1.0, abs(float(jv)))
    for got, want in zip(grads, jgrads):
        want = np.asarray(want)
        if kind != "lane" and want.shape == (128, 128):
            assert got is None  # M feeds only the lane boundary
            continue
        np.testing.assert_allclose(np.conj(got.numpy()), want, rtol=0, atol=ATOL)


def _layer_inputs(n, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return _state(rng, 2**n).astype(dtype), _unitaries(rng, n, 2).astype(dtype), rng


@pytest.mark.parametrize(
    "n,constant,fuse_lane",
    [
        (8, False, False), (8, True, False), (8, False, True),  # nouter 0, nkernel 1
        (12, False, False), (12, True, False), (12, False, True),  # nkernel 5
        (18, False, False), (18, True, False), (18, False, True),  # nkernel 11, nouter 0
        (20, False, False),  # nkernel 11, nouter 2: the path's shape
    ],
)
def test_fused_single_qubit_layer_matches_jax(n, constant, fuse_lane):
    """State and gradients (in the input state and in the gates) of
    L = Re Σ conj(w) · layer(psi, gates)."""
    psi, g, rng = _layer_inputs(n, seed=n + 2 * constant + 4 * fuse_lane)
    w = _state(rng, 2**n).astype(np.complex64)

    def jloss(p, gg):
        out = jkernels.fused_single_qubit_layer_pallas(p, gg, fuse_lane=fuse_lane, constant=constant)
        return jnp.real(jnp.sum(jnp.conj(w) * out)), out

    (jv, jout), (jdp, jdg) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(*_j(psi, g))
    tp, tg = (torch.as_tensor(a).requires_grad_() for a in (psi, g))
    out = kernels.fused_single_qubit_layer_pallas(tp, tg, fuse_lane=fuse_lane, constant=constant)
    tv = torch.real(torch.sum(torch.conj(torch.as_tensor(w)) * out))
    dp, dg = torch.autograd.grad(tv, (tp, tg))
    gtol = 1e-4 if n >= 20 else 1e-5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.conj(dp.numpy()), np.asarray(jdp), rtol=0, atol=gtol)
    np.testing.assert_allclose(np.conj(dg.numpy()), np.asarray(jdg), rtol=0, atol=gtol)
    if not (constant or fuse_lane):  # the default entry point takes the same path
        again = kernels.fused_single_qubit_layer(torch.as_tensor(psi), torch.as_tensor(g))
        np.testing.assert_allclose(again.numpy(), np.asarray(jout), rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [8, 12, 18])
def test_fused_rx_layer_matches_jax(n):
    rng = np.random.default_rng(50 + n)
    psi = _state(rng, 2**n).astype(np.complex64)
    th = (rng.standard_normal(n) * 0.7).astype(np.float32)
    w = _state(rng, 2**n).astype(np.complex64)

    def jloss(t):
        return jnp.real(jnp.sum(jnp.conj(w) * jkernels.fused_rx_layer(jnp.asarray(psi), t)))

    jv, jdth = jax.value_and_grad(jloss)(jnp.asarray(th))
    tth = torch.as_tensor(th).requires_grad_()
    tv = torch.real(torch.sum(torch.conj(torch.as_tensor(w)) * kernels.fused_rx_layer(torch.as_tensor(psi), tth)))
    (dth,) = torch.autograd.grad(tv, tth)
    assert abs(tv.item() - float(jv)) <= 2e-6 * 2**(n / 2)
    np.testing.assert_allclose(dth.numpy(), np.asarray(jdth), rtol=0, atol=1e-5)


@pytest.mark.parametrize("nkernel,blocks", [(2, 4), (10, 2)])
def test_rotx_plain_versions_match_pallas(nkernel, blocks):
    """K11/K12's plain versions against ``_pallas_rotx_fwd`` /
    ``_pallas_rotx_bwd`` in interpret mode: the planes and dθ."""
    x = _row_inputs(nkernel, blocks, seed=60 + nkernel)
    th = (np.random.default_rng(nkernel).standard_normal(nkernel) * 0.7).astype(np.float32)
    y = _interpret(lambda: jkrl._pallas_rotx_fwd(*_j(th, *x["s"])))
    want_b = _interpret(lambda: jkrl._pallas_rotx_bwd(*_j(th, *y, *x["ct"])))
    _assert_all_close(krl.rotx_fwd_plain(*_t(th, *x["s"])), y)
    _assert_all_close(krl.rotx_fwd(*_t(th, *x["s"])), y)  # the CPU wrapper
    got_b = krl.rotx_bwd(*_t(th, *[np.array(a) for a in y], *x["ct"]))
    assert len(got_b) == 3 and got_b[2].shape == (nkernel,)
    _assert_all_close(got_b, want_b)


def _rotx_bwd_in_pass_order(th, yr, yi, ctr, cti):
    """K12 in the order the card's passes take it, in plain torch: the
    passes of ``rotx_bwd_plan``, the first (the high walked bits) before
    the last (the low ones), each from its lowest bit; per bit the rx
    un-apply, dθ_q = -½ sin·Re S1 + ½ cos·Im S2 and the ct walk."""
    nk, r = th.shape[0], yr.shape[0]
    plan = krl.rotx_bwd_plan(r, nk)
    hi, lo = plan["row_hi"]["bits"], plan["row_lo"]["bits"]
    sr, si, cr, ci = yr, yi, ctr, cti
    dth = [None] * nk
    for w in [lo + i for i in range(hi)] + list(range(lo)):
        q, s = nk - 1 - w, 1 << w
        c, sn = torch.cos(th[q] / 2), torch.sin(th[q] / 2)
        sr, si = c * sr - sn * krl._partner(si, s), c * si + sn * krl._partner(sr, s)
        pcr, pci = krl._partner(cr, s), krl._partner(ci, s)
        dth[q] = -0.5 * sn * torch.sum(cr * sr - ci * si) + 0.5 * c * torch.sum(pcr * si + pci * sr)
        cr, ci = c * cr + sn * pci, c * ci - sn * pcr
    return cr, ci, torch.stack(dth)


@pytest.mark.parametrize("nkernel,blocks", [(5, 2), (8, 2), (10, 2)])
def test_rotx_bwd_pass_order_matches_pallas(nkernel, blocks):
    """The card's order of K12's bits (one pass of 5; passes of 2 and 6,
    and of 4 and 6 bits) against the JAX ``_pallas_rotx_bwd`` in interpret
    mode, which walks them from the lowest bit up in one block: the rx
    gates act on distinct bits and commute, so ds and dθ agree to rounding
    (``ATOL``)."""
    x = _row_inputs(nkernel, blocks, seed=70 * nkernel + blocks)
    th = (np.random.default_rng(3 * nkernel).standard_normal(nkernel) * 0.7).astype(np.float32)
    y = [t.numpy() for t in krl.rotx_fwd_plain(*_t(th, *x["s"]))]
    want = _interpret(lambda: jkrl._pallas_rotx_bwd(*_j(th, *y, *x["ct"])))
    got = _rotx_bwd_in_pass_order(*_t(th, *y, *x["ct"]))
    _assert_all_close(got, want)


def _rotx_fwd_in_pass_order(th, sr, si):
    """K11 in the order the card's passes take it, in plain torch
    (:func:`_fwd_pass_bits` of ``rotx_fwd_plan``): rx(th[q]) with q =
    nkernel-1-w on walked bit w."""
    nk = th.shape[0]
    cr, ci = sr, si
    for w in _fwd_pass_bits(krl.rotx_fwd_plan(sr.shape[0], nk)):
        q, s = nk - 1 - w, 1 << w
        c, sn = torch.cos(th[q] / 2), torch.sin(th[q] / 2)
        pr, pi = krl._partner(cr, s), krl._partner(ci, s)
        cr, ci = c * cr + sn * pi, c * ci - sn * pr
    return cr, ci


@pytest.mark.parametrize("nkernel,blocks", [(5, 2), (8, 2), (10, 1)])
def test_rotx_fwd_pass_order_matches_pallas(nkernel, blocks):
    """The card's order of K11's bits (one pass of 5; passes of 6 and 2,
    and of 6 and 4 bits, the low pass first) against the JAX
    ``_pallas_rotx_fwd`` in interpret mode, which takes angle 0 (the
    highest bit) first in one block: the rx gates act on distinct bits and
    commute, so the planes agree to rounding (``ATOL``)."""
    x = _row_inputs(nkernel, blocks, seed=90 * nkernel + blocks)
    th = (np.random.default_rng(5 * nkernel).standard_normal(nkernel) * 0.7).astype(np.float32)
    want = _interpret(lambda: jkrl._pallas_rotx_fwd(*_j(th, *x["s"])))
    _assert_all_close(_rotx_fwd_in_pass_order(*_t(th, *x["s"])), want)


def test_rotx_row_layer_matches_jax_vjp():
    """Value and gradients (state and angles) of Re Σ conj(w) · rotx_row_layer."""
    rng = np.random.default_rng(4)
    nk, r = 5, 64
    s = _state(rng, r * 128).reshape(r, 128).astype(np.complex64)
    th = (rng.standard_normal(nk) * 0.7).astype(np.float32)
    w = _state(rng, r * 128).reshape(r, 128).astype(np.complex64)

    def jloss(s_, t_):
        return jnp.real(jnp.sum(jnp.conj(w) * jkrl.rotx_row_layer(s_, t_)))

    jv, (jds, jdth) = jax.value_and_grad(jloss, argnums=(0, 1))(*_j(s, th))
    ts, tth = (torch.as_tensor(a).requires_grad_() for a in (s, th))
    tv = torch.real(torch.sum(torch.conj(torch.as_tensor(w)) * krl.rotx_row_layer(ts, tth)))
    ds, dth = torch.autograd.grad(tv, (ts, tth))
    assert abs(tv.item() - float(jv)) <= ATOL
    np.testing.assert_allclose(np.conj(ds.numpy()), np.asarray(jds), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dth.numpy(), np.asarray(jdth), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [9, 20])
def test_fused_rx_layer_rotx_matches_jax(n, monkeypatch):
    """``fused_rx_layer`` under ``USE_ROTX`` in both packages: n=9 puts 2
    row qubits in the rotx layer, n=20 puts 10 there and 3 outside it
    (nouter); state and dθ, 1e-4 at n=20 (float32 sums over 2^20
    amplitudes in another order)."""
    rng = np.random.default_rng(80 + n)
    psi = _state(rng, 2**n).astype(np.complex64)
    th = (rng.standard_normal(n) * 0.7).astype(np.float32)
    w = _state(rng, 2**n).astype(np.complex64)
    monkeypatch.setattr(jkernels, "USE_ROTX", True)
    monkeypatch.setattr(kernels, "USE_ROTX", True)

    def jloss(t):
        out = jkernels.fused_rx_layer(jnp.asarray(psi), t)
        return jnp.real(jnp.sum(jnp.conj(w) * out)), out

    (jv, jout), jdth = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(th))
    tth = torch.as_tensor(th).requires_grad_()
    out = kernels.fused_rx_layer(torch.as_tensor(psi), tth)
    tv = torch.real(torch.sum(torch.conj(torch.as_tensor(w)) * out))
    (dth,) = torch.autograd.grad(tv, tth)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=2e-6)
    np.testing.assert_allclose(dth.numpy(), np.asarray(jdth), rtol=0, atol=1e-4 if n >= 20 else ATOL)


def test_fused_rx_layer_rotx_keeps_complex128_per_qubit(monkeypatch):
    """A rule of the dtype, decided for the port: under ``USE_ROTX`` a
    complex128 state keeps the per-qubit formulation in float64 (the rotx
    kernels compute in float32 planes), where the JAX package sends it
    through float32 gates (``kernels_rowlayer._rx_gates`` casts to
    complex64): the port equals its own default path to 1e-12 and the JAX
    package to float32 gate precision, 1e-6."""
    def refuse(*args, **kws):
        raise AssertionError("a complex128 state reached the float32 rotx kernels")

    monkeypatch.setattr(krl, "rotx_row_layer", refuse)
    rng = np.random.default_rng(91)
    n = 12
    psi = _state(rng, 2**n)
    th = rng.standard_normal(n) * 0.7
    monkeypatch.setattr(kernels, "USE_ROTX", True)
    got = kernels.fused_rx_layer(torch.as_tensor(psi), torch.as_tensor(th))
    assert got.dtype == torch.complex128
    monkeypatch.setattr(kernels, "USE_ROTX", False)
    want = kernels.fused_rx_layer(torch.as_tensor(psi), torch.as_tensor(th))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    monkeypatch.setattr(jkernels, "USE_ROTX", True)
    tc.set_dtype("complex128")
    try:
        jwant = jkernels.fused_rx_layer(jnp.asarray(psi), jnp.asarray(th))
    finally:
        tc.set_dtype("complex64")
    assert np.asarray(jwant).dtype == np.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=1e-6)


def test_block_kron_layer_matches_jax():
    psi, g, _ = _layer_inputs(10, seed=61)
    want = jkernels.block_kron_layer(jnp.asarray(psi), jnp.asarray(g), block=4)
    got = kernels.block_kron_layer(torch.as_tensor(psi), torch.as_tensor(g), block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_complex128_takes_the_per_qubit_formulation(monkeypatch):
    """A rule of the dtype: the row kernels compute in float32 planes, so a
    complex128 state never reaches them, on any device."""
    def refuse(*args, **kws):
        raise AssertionError("a complex128 state reached a float32 row kernel")

    for name in ("row_layer", "row_layer_lane", "row_layer_const"):
        monkeypatch.setattr(krl, name, refuse)
    psi, g, _ = _layer_inputs(12, seed=71, dtype=np.complex128)
    for fuse_lane, constant in ((False, False), (True, False), (False, True)):
        got = kernels.fused_single_qubit_layer_pallas(
            torch.as_tensor(psi), torch.as_tensor(g), fuse_lane=fuse_lane, constant=constant
        )
        assert got.dtype == torch.complex128
        want = kernels._apply_layer_reference(torch.as_tensor(psi), torch.as_tensor(g))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    tc.set_dtype("complex128")  # the JAX package's own switch to float64
    try:
        jwant = jkernels._apply_layer_reference(jnp.asarray(psi), jnp.asarray(g))
    finally:
        tc.set_dtype("complex64")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=1e-10)
