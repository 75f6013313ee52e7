"""The port's whole-block multilayer path and the QAOA slice against the JAX
package, on the CPU.

The plain versions of K9 (``kernels_multilayer.ml_fwd``) and K10
(``ml_bwd``) are held against the JAX Pallas kernels ``_pallas_ml_fwd`` and
``_pallas_ml_bwd`` run in interpret mode, on the same numpy-seeded inputs
(n=9 and n=12, L=2, non-adjacent pairs, unitary lane matrices); the
autograd boundary ``zzrx_multilayer`` against the JAX custom VJP (its CPU
path); ``fused_zzrx_multilayer`` under every ``ML_MODE`` against the JAX
package under the same mode, with the shapes each mode hands to the
per-layer path; the QAOA MaxCut cost of ``chip_smoke.qaoa_energy`` in both
of its forms (zzrx_layer under ``ML_MODE="pallas"``, rzz_product + rx_layer
under ``USE_ROTX``) against the JAX package and against each other.  The
kernels themselves run only on a CUDA card (``tests/test_torch_cuda.py``).

Tolerance: both sides compute in float32, in another order, on unit-norm
states and unitary matrices: 1e-5 absolute on every kernel output (the
planes, dzz, dθ and dM, each a sum of 2^n products of size ~2^-n).  At the
boundary, values 2e-6 and gradients 1e-5 at n=12; at n=20, where each
gradient entry is a float32 sum over 2^20 amplitudes taken in another
order, 1e-4.  The QAOA cost (|E| ~ 3, a sum of 21 weighted terms) within
2e-5 of the JAX package and 1e-5 relative between the forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
from chip_smoke import _ml_stage_work, _ml_work, qaoa_energy, qaoa_graph
from tensorcircuit_ng_tpu.core import kernels as jkernels
from tensorcircuit_ng_tpu.core import kernels_multilayer as jkml

import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels
from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(rng, shape):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return z / np.linalg.norm(z)


def _ml_inputs(n, L, npairs, seed):
    """The whole-block view (2^nrow, lanes), non-adjacent pairs, angles and
    unitary lane matrices, complex64 / float32 numpy."""
    rng = np.random.default_rng(seed)
    nrow = min(n - 7, kml.MAX_ML_ROW_QUBITS)
    r, lanes = 2**nrow, 2 ** (n - nrow)
    cand = [(a, b) for a in range(n) for b in range(a + 2, n)]
    pairs = tuple(cand[i] for i in rng.choice(len(cand), size=npairs, replace=False))
    m = np.linalg.qr(rng.standard_normal((L, lanes, lanes)) + 1j * rng.standard_normal((L, lanes, lanes)))[0]
    return {
        "pairs": pairs,
        "psi": _unit(rng, (r, lanes)).astype(np.complex64),
        "ct": _unit(rng, (r, lanes)).astype(np.complex64),
        "zz": (rng.standard_normal((L, npairs)) * 0.5).astype(np.float32),
        "rx": (rng.standard_normal((L, nrow)) * 0.5).astype(np.float32),
        "m": m.astype(np.complex64),
    }


@pytest.mark.parametrize("n,L", [(12, 3), (20, 4)])
def test_ml_stage_work_adds_up_to_k10(n, L):
    """``chip_smoke``'s per-stage work of K10 (its stage bounds) against the
    whole kernel's (its bound): the flops add up exactly over L layers; the
    bytes add up once the planes the stages hand each other are taken out."""
    nrow = min(n - 7, kml.MAX_ML_ROW_QUBITS)
    r, lanes, npairs = 2**nrow, 2 ** (n - nrow), 37
    amps = r * lanes
    stages = _ml_stage_work(r, lanes, npairs, nrow)
    assert set(stages) == {"lane pair", "dM", "row"}
    nbytes, flops = _ml_work(r, lanes, npairs, nrow, L, "bwd")
    assert L * sum(f for _, f in stages.values()) == flops
    # a layer: psi and w written (2 planes of 8 B an amplitude), psi read
    # again by dM, psi and w by the row stage, ct again by dM (48 B an
    # amplitude); between layers x and ds written and read (32 B); layer 0's
    # x, counted in the row stage, is not written; the shifts are read each
    # layer but counted once for the kernel
    handoff = 48 * L * amps + 32 * (L - 1) * amps + 8 * amps + 8 * (L - 1) * npairs
    assert L * sum(b for b, _ in stages.values()) == nbytes + handoff


@pytest.mark.parametrize("n,npairs", [(9, 5), (12, 11)])
def test_ml_plain_versions_match_pallas(n, npairs):
    """K9/K10's plain versions against ``_pallas_ml_fwd`` / ``_pallas_ml_bwd``
    in interpret mode, every output."""
    x = _ml_inputs(n, 2, npairs, seed=n)
    pairs = x["pairs"]
    sr, si, zzth, cs, srow, slane, mr, mi = jkml._ml_prep(
        pairs, n, *(jnp.asarray(x[k]) for k in ("psi", "zz", "rx", "m"))
    )
    ct = x["ct"]
    jkernels.set_interpret_mode(True)
    try:
        yr, yi = jkml._pallas_ml_fwd(zzth, cs, srow, slane, mr, mi, sr, si)
        want_b = jkml._pallas_ml_bwd(
            zzth, cs, srow, slane, mr, mi, yr, yi, jnp.asarray(ct.real), jnp.asarray(ct.imag)
        )
    finally:
        jkernels.set_interpret_mode(False)
    zz, rx = _t(x["zz"]), _t(x["rx"])
    got_f = kml.ml_fwd_plain(pairs, n, zz, rx, _t(sr), _t(si), _t(mr), _t(mi))
    # the CPU wrapper is the plain version
    again = kml.ml_fwd(pairs, n, zz, rx, _t(sr), _t(si), _t(mr), _t(mi))
    for g, a, w in zip(got_f, again, (yr, yi)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
        assert torch.equal(g, a)
    # and the port's einsum reference (the dense phase, row einsums, lane matmul)
    ref = kml._ml_reference(pairs, n, _t(x["psi"]), zz, rx, _t(x["m"]))
    np.testing.assert_allclose(torch.complex(*got_f).numpy(), ref.numpy(), rtol=0, atol=ATOL)
    got_b = kml.ml_bwd(pairs, n, zz, rx, _t(yr), _t(yi), _t(ct.real), _t(ct.imag), _t(mr), _t(mi))
    # the Pallas dzz is (L, 1, 128) with padded columns, dθ (L, 1, nrow)
    want_b = (want_b[0], want_b[1], np.asarray(want_b[2])[:, 0, :npairs], np.asarray(want_b[3])[:, 0],
              want_b[4], want_b[5])
    assert len(got_b) == 6
    for g, w in zip(got_b, want_b):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_sign_matrices_match_jax():
    pairs = ((0, 5), (2, 11), (9, 10), (3, 4))
    for nrow, lanes in ((5, 128), (12, 256)):
        n = nrow + lanes.bit_length() - 1
        for got, want in zip(kml._sign_matrices(pairs, n, nrow, lanes),
                             jkml._sign_matrices(pairs, n, nrow, lanes)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,L", [(12, 3), (20, 2)])
def test_zzrx_multilayer_matches_jax_vjp(n, L):
    """Value and the gradients in state, zz, rx_row and the lane matrices of
    L = Re Σ conj(w) · zzrx_multilayer(...); torch's gradient of a complex
    input is the conjugate of the JAX package's."""
    x = _ml_inputs(n, L, 9, seed=100 + n)
    w = x["ct"]
    args = [x[k] for k in ("psi", "zz", "rx", "m")]

    def jloss(*a):
        return jnp.real(jnp.sum(jnp.conj(w) * jkml.zzrx_multilayer(x["pairs"], n, *a)))

    jv, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_() for a in args]
    y = kml.zzrx_multilayer(x["pairs"], n, *targs)
    tv = torch.real(torch.sum(torch.conj(_t(w)) * y))
    grads = torch.autograd.grad(tv, targs)
    gtol = 1e-4 if n >= 20 else ATOL
    assert abs(tv.item() - float(jv)) <= 2e-6
    for g, want in zip(grads, jgrads):
        got = g.numpy()
        got = np.conj(got) if np.iscomplexobj(got) else got
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=gtol)


def _loss_inputs(n, L, npairs, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    cand = [(a, b) for a in range(n) for b in range(a + 1, n)]
    pairs = [cand[i % len(cand)] for i in rng.permutation(max(npairs, len(cand)))[:npairs]]
    return (
        pairs,
        _unit(rng, 2**n).astype(dtype),
        (rng.standard_normal((L, npairs)) * 0.3).astype(np.float32),
        (rng.standard_normal((L, n)) * 0.3).astype(np.float32),
        _unit(rng, 2**n).astype(dtype),
    )


def _both_modes(mode, pairs, psi, zz, rx, w, monkeypatch):
    """Value and (dzz, drx) of Re Σ conj(w)·y + Im Σ conj(w)·y² under
    ``mode`` in both packages."""
    monkeypatch.setattr(jkernels, "ML_MODE", mode)
    monkeypatch.setattr(kernels, "ML_MODE", mode)

    def jloss(z, r):
        y = jkernels.fused_zzrx_multilayer(jnp.asarray(psi), pairs, z, r)
        return jnp.real(jnp.vdot(w, y)) + jnp.imag(jnp.vdot(w, y * y))

    if psi.dtype == np.complex128:
        tc.set_dtype("complex128")  # the JAX package's own switch to float64
    try:
        jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(zz), jnp.asarray(rx))
    finally:
        tc.set_dtype("complex64")
    tz, tr = _t(zz).requires_grad_(), _t(rx).requires_grad_()
    y = kernels.fused_zzrx_multilayer(_t(psi), pairs, tz, tr)
    tw = _t(w)
    tv = torch.real(torch.vdot(tw, y)) + torch.imag(torch.vdot(tw, y * y))
    return (float(jv), jg), (tv, torch.autograd.grad(tv, (tz, tr)))


@pytest.mark.parametrize("mode", ["stack", "pallas", "xla", "perlayer"])
def test_fused_zzrx_multilayer_modes_match_jax(mode, monkeypatch):
    """Each ML_MODE at n=12, L=2 (the whole-block path: nrow 5, 128 lanes)
    against the JAX package under the same mode."""
    pairs, psi, zz, rx, w = _loss_inputs(12, 2, 11, seed=12)
    (jv, jg), (tv, tg) = _both_modes(mode, pairs, psi, zz, rx, w, monkeypatch)
    assert abs(tv.item() - jv) <= 2e-6
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "mode,n,npairs,dtype",
    [
        ("pallas", 8, 130, np.complex64),  # more than MAX_ML_PAIRS pairs
        ("pallas", 8, 9, np.complex128),  # the kernels compute in float32 planes
        ("pallas", 7, 6, np.complex64),  # nrow = 0
        ("xla", 9, 8, np.complex64),  # n < 10
        ("xla", 10, 130, np.complex64),  # more than MAX_ML_PAIRS pairs
    ],
)
def test_fused_zzrx_multilayer_per_layer_cases(mode, n, npairs, dtype, monkeypatch):
    """The shapes that a mode hands to the per-layer path, as the JAX
    package does: the whole-block and XLA variants are never reached."""
    def refuse(*args, **kws):
        raise AssertionError(f"{mode} reached its variant at n={n}, {npairs} pairs, {dtype}")

    monkeypatch.setattr(kml, "zzrx_multilayer", refuse)
    monkeypatch.setattr(kml, "zzrx_multilayer_xla", refuse)
    pairs, psi, zz, rx, w = _loss_inputs(n, 1, npairs, seed=n + npairs, dtype=dtype)
    (jv, jg), (tv, tg) = _both_modes(mode, pairs, psi, zz, rx, w, monkeypatch)
    wide = dtype == np.complex128  # both packages keep float64 there
    assert abs(tv.item() - jv) <= (1e-10 if wide else 2e-6)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=1e-10 if wide else ATOL)


def test_convert_planes_take_the_lane_width():
    """``convert.planes`` at 256 lanes: the JAX package's reshape of the
    state to (2^n / 256, 256)."""
    rng = np.random.default_rng(5)
    psi = _unit(rng, 2**12).astype(np.complex64)
    want = jnp.reshape(jnp.asarray(psi), (-1, 256))
    sr, si = convert.planes(psi, "cpu", lanes=256)
    assert sr.shape == si.shape == (16, 256)
    np.testing.assert_array_equal(sr.numpy(), np.real(np.asarray(want)))
    np.testing.assert_array_equal(si.numpy(), np.imag(np.asarray(want)))
    assert convert.planes(psi, "cpu")[0].shape == (32, 128)


def _jarr(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _tarr(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("form,mode,rotx", [("zzrx", "pallas", False), ("rzz_rx", "stack", True)])
def test_qaoa_forms_match_jax(form, mode, rotx, monkeypatch):
    """The QAOA MaxCut cost at n=12, p=2 and its gradient in the 4 angles:
    form (a) under ML_MODE="pallas", form (b) under USE_ROTX, each against
    the JAX package under the same switches."""
    n = 12
    edges, params = qaoa_graph(n, 2)
    for mod in (jkernels, kernels):
        monkeypatch.setattr(mod, "ML_MODE", mode)
        monkeypatch.setattr(mod, "USE_ROTX", rotx)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: qaoa_energy(tc, _jarr, n, edges, p, form)))(jnp.asarray(params))
    p = _t(params).requires_grad_()
    tv = qaoa_energy(tct, _tarr, n, edges, p, form, device="cpu")
    (tg,) = torch.autograd.grad(tv, p)
    assert abs(tv.item() - float(jv)) <= 2e-5
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=ATOL)


def test_qaoa_forms_agree(monkeypatch):
    """(a) under "pallas", (b) under USE_ROTX and (a) under the default
    "stack" compute one function: energies within 1e-5 relative, gradients
    within 1e-5."""
    n = 12
    edges, params = qaoa_graph(n, 2)
    out = []
    for form, mode, rotx in (("zzrx", "pallas", False), ("rzz_rx", "stack", True), ("zzrx", "stack", False)):
        monkeypatch.setattr(kernels, "ML_MODE", mode)
        monkeypatch.setattr(kernels, "USE_ROTX", rotx)
        p = _t(params).requires_grad_()
        e = qaoa_energy(tct, _tarr, n, edges, p, form, device="cpu")
        out.append((e.item(), torch.autograd.grad(e, p)[0].numpy()))
    (ea, ga), (eb, gb), (es, gs) = out
    assert abs(ea - eb) <= 1e-5 * abs(es) and abs(ea - es) <= 1e-5 * abs(es)
    np.testing.assert_allclose(ga, gs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gb, gs, rtol=0, atol=ATOL)
