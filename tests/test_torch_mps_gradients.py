"""Gradients of the port's ``MPSCircuit`` through truncation, on the CPU:
the angles' real gradient against the JAX package's (``jax.grad`` under
``jax.jit``) at chi = 2 and 4 (binding at n=6) and 8 (the exact regime), at
complex64 and complex128, and the card's Gram-eigh route
(``core/linalg.USE_GRAM_SVD``) run here: right-canonical chains, the
gradient of phase 16's step equal to the exact SVD's (also through ten
layers of sweeps at n=16, chi=64), and the Gram adjoint of a
rank-deficient matrix equal to the exact SVD's, where the JAX package's is
not (Queue 3 F8 of ``ROADMAP.md``); and the exact SVD's adjoint held to a
central difference, on phase 16's step where chi binds (n=20, chi=32,
depth 10, complex128, two angles, on 1 and 4 BLAS threads) and on one truncated matrix
with kept values near the cut, where the JAX package's adjoint is not
(Queue 3 F9).

Tolerances: complex64 1e-5, complex128 1e-10; the Gram route against the
exact SVD at complex128: the energy 1e-9, the gradient 1e-6 of its largest
entry (n=16: 1e-6 relative; at complex64 1e-4: 4e-6 measured), the
rank-deficient adjoint 1e-8 of its largest entry; the exact SVD's
gradient of phase 16's step against the central difference 1e-8 (7e-10
measured; the JAX package's rule is 3e-4 to 1.4e-2 of the largest entry
off, as the thread count moves it),
the truncated matrix's directional derivative 1e-5 relative (6e-7
measured, the difference's own error at h=1e-7; the JAX package's 38 %
off).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import chip_smoke as cs
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.models.mpscircuit import MPSCircuit as JMPS
from tensorcircuit_ng_tpu_torch.core import linalg as TL

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}
N = 6


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: xdist runs six modules at once, and
    these small decompositions, on eight threads each, oversubscribe the
    cores (10-40x their time alone under the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["complex64", "complex128"])
def dtype(request):
    tc.set_dtype(request.param)
    try:
        with tct.set_dtype(request.param), tct.set_device("cpu"):
            yield request.param
    finally:
        tc.set_dtype("complex64")


@pytest.fixture
def cpu():
    with tct.set_device("cpu"):
        yield


def _loss(mod, p, chi, cast):
    """``tests/test_mpscircuit.py::test_mps_jit_grad``'s loss at n=6 with a
    non-adjacent rzz (the SWAP network): <Z_0 Z_1> + <X_3>."""
    m = (tct.MPSCircuit if mod is tct else JMPS)(N, split={"max_singular_values": chi})
    for i in range(N):
        m.h(i)
        m.rx(i, theta=p[0, i])
    for i in range(N - 1):
        m.cnot(i, i + 1)
    m.rzz(1, 3, theta=p[1, 0])
    for i in range(N):
        m.ry(i, theta=p[1, i])
    return cast(m.expectation_ps(z=[0, 1])) + cast(m.expectation_ps(x=[3]))


def _params(chi, dtype):
    return (np.random.default_rng(chi).normal(size=(2, N)) * 0.7).astype(RDT[dtype])


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(chi, dtype):
    tc.set_dtype(dtype)
    vj, gj = jax.jit(jax.value_and_grad(lambda p: _loss(tc, p, chi, jnp.real)))(jnp.asarray(_params(chi, dtype)))
    return float(vj), np.asarray(gj)


@pytest.mark.parametrize("chi", [2, 4, 8])
def test_gradients_through_truncation_match_jax(dtype, chi):
    pt = torch.as_tensor(_params(chi, dtype)).requires_grad_()
    vt = _loss(tct, pt, chi, lambda x: x.real)
    (gt,) = torch.autograd.grad(vt, pt)
    vj, gj = _jax_value_and_grad(chi, dtype)
    np.testing.assert_allclose(vt.item(), vj, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=TOL[dtype])


def test_gram_route_gives_right_canonical_chains_and_exact_gradients(cpu, monkeypatch):
    """The card's route (``USE_GRAM_SVD``) on the CPU from a product
    state: ``position(0)``, ``compress``, ``wavefunction_to_tensors`` and
    the sampler's chain are right-canonical, and the angles' gradient is
    the exact SVD's, though the thetas are rank-deficient."""
    n, chi = 8, 4
    g0 = cs.mps_vqe_angles(n, 3)
    with tct.set_dtype("complex128"):
        monkeypatch.setattr(TL, "USE_GRAM_SVD", False)
        e0, g_exact, e1, _, _ = cs.mps_vqe_step(tct, "cpu", g0, n, chi)
        monkeypatch.setattr(TL, "USE_GRAM_SVD", True)
        e, g_gram, e1g, _, c = cs.mps_vqe_step(tct, "cpu", g0, n, chi)
        assert abs(e.item() - e0.item()) < 1e-9 and abs(e1g.item() - e1.item()) < 1e-7
        assert (g_gram - g_exact).abs().max().item() < 1e-6 * g_exact.abs().max().item()
        m = tct.MPSCircuit(n, split={"max_singular_values": chi})
        for i in range(n - 1):
            m.cnot(i, i + 1)
        f = tct.FiniteMPS(m.tensors, center_position=m.get_center_position(), canonicalize=False)
        f.position(0)
        assert f.check_canonical() < 1e-12
        c.compress(max_singular_values=2)
        c.position(0)
        assert tct.FiniteMPS(c.tensors, canonicalize=False).check_canonical() < 1e-12
        w = tct.MPSCircuit(n, wavefunction=c.wavefunction(), split={"max_singular_values": chi})
        w.position(0)
        assert tct.FiniteMPS(w.tensors, canonicalize=False).check_canonical() < 1e-12
        assert tct.FiniteMPS(w._right_canonical(), canonicalize=False).check_canonical() < 1e-12


@pytest.mark.parametrize("dtype,tol", [("complex128", 1e-6), ("complex64", 1e-4)])
def test_gram_route_gradient_stays_bounded_through_many_sweeps(cpu, monkeypatch, dtype, tol):
    """Phase 16 (a)'s step at n=16, chi=64, depth 10 (at most 4 live
    singular values a bond of up to 128): through the Gram route the
    gradient is the exact SVD's (before the truncation set the noise floor
    to zero it grew to 1e16, NaN at complex64, through the QR sweeps'
    adjoints; with the complex64 chain's SVDs and QRs in single precision
    it was 0.17-0.47 off)."""
    g0 = cs.mps_vqe_angles(16, 10)
    with tct.set_dtype("complex128"):
        monkeypatch.setattr(TL, "USE_GRAM_SVD", False)
        e0, g_exact, _, _, _ = cs.mps_vqe_step(tct, "cpu", g0, 16, 64)
    monkeypatch.setattr(TL, "USE_GRAM_SVD", True)
    with tct.set_dtype(dtype):
        e, g, _, _, _ = cs.mps_vqe_step(tct, "cpu", g0, 16, 64)
    assert torch.isfinite(g).all()
    assert abs(e.item() - e0.item()) <= tol * abs(e0.item())
    assert (g.double() - g_exact).abs().max().item() <= tol * g_exact.abs().max().item()


def test_gram_gradient_of_a_rank_deficient_matrix(cpu, monkeypatch):
    """The truncation's Gram route against the exact SVD's adjoint on a
    rank-3 8x8 matrix truncated to 3 (the kept triple is well defined),
    and the JAX package's Gram adjoint, which is not (Queue 3 F8)."""
    from tensorcircuit_ng_tpu.core import linalg as JL

    rng = np.random.default_rng(0)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    a, w, b = c(8, 3) @ c(3, 8), c(8, 8), c(8, 8)

    def loss(svd, xp, cast):
        wx, bx = cast(w), cast(b)

        def f(x):
            u, s, vh = svd(x)
            u, s, vh = u[:, :3], s[:3], vh[:3]
            return xp.real(xp.sum(((u * s[None, :]) @ (vh @ wx)) * xp.conj(bx)))
        return f

    grads = []
    for fn in (TL.adaware_svd, TL.gram_svd):
        x = torch.as_tensor(a).requires_grad_()
        (g,) = torch.autograd.grad(loss(fn, torch, torch.as_tensor)(x), x)
        grads.append(g.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-8 * np.abs(grads[0]).max())
    tc.set_dtype("complex128")
    try:
        gj = np.conj(np.asarray(jax.grad(loss(JL.gram_svd, jnp, jnp.asarray))(jnp.asarray(a))))
        ge = np.conj(np.asarray(jax.grad(loss(JL.adaware_svd, jnp, jnp.asarray))(jnp.asarray(a))))
    finally:
        tc.set_dtype("complex64")
    np.testing.assert_allclose(ge, grads[0], rtol=0, atol=1e-8 * np.abs(grads[0]).max())
    assert np.abs(gj - grads[0]).max() > 0.1 * np.abs(grads[0]).max()


#: phase 16 (a)'s step where chi binds at a test's size, and the angles at
#: which the exact SVD's gradient under the JAX package's adjoint rule is
#: furthest off: (3, 1, 14), where it differed most from the Gram route's
#: (``tools/mps_gram_drift.py``'s search at this size, one thread: 0.452058
#: against the central difference's 0.451736), and (5, 1, 9), where it
#: differs most from the port's on four threads (0.380225 against 0.393931)
#: (Queue 3 F9)
F9_SIZE = {"n": 20, "chi": 32, "depth": 10}
F9_ANGLES = ((3, 1, 14), (5, 1, 9))


@pytest.mark.parametrize("threads", [1, 4])
def test_exact_svd_gradient_of_phase16_step_matches_central_difference(cpu, monkeypatch, threads):
    """The exact SVD's gradient of phase 16 (a)'s step (complex128, every
    middle bond truncated to chi) at :data:`F9_ANGLES` against a central
    difference of the energy (h=1e-5), on 1 and 4 BLAS threads."""
    n, chi, depth = F9_SIZE["n"], F9_SIZE["chi"], F9_SIZE["depth"]
    g0 = cs.mps_vqe_angles(n, depth)
    monkeypatch.setattr(TL, "USE_GRAM_SVD", False)
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with threadpoolctl.threadpool_limits(threads), tct.set_dtype("complex128"):
            _, g, _, _, c = cs.mps_vqe_step(tct, "cpu", g0, n, chi)
            assert max(c.get_bond_dimensions()) == chi
            h = 1e-5
            for angle in F9_ANGLES:
                e = []
                with torch.no_grad():
                    for sign in (1.0, -1.0):
                        p = g0.copy()
                        p[angle] += sign * h
                        e.append(cs.tfim_energy_ps(cs.mps_vqe_circuit(tct, torch.as_tensor(p), n, chi), n).item())
                assert abs(g[angle].item() - (e[0] - e[1]) / (2 * h)) < 1e-8, angle
    finally:
        torch.set_num_threads(saved)


def test_exact_svd_adjoint_near_a_truncation_cut(cpu):
    """A rank-4 truncation of an 8x8 complex128 matrix whose kept and
    discarded singular values near the cut lie 1e-3 apart: the exact SVD's
    directional derivative against a central difference, and the JAX
    package's, whose absolute 1e-12 in 1/(s_j² - s_i²) is 38 % off there
    (Queue 3 F9)."""
    from tensorcircuit_ng_tpu.core import linalg as JL

    rng = np.random.default_rng(0)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    u0, v0 = np.linalg.qr(c(8, 8))[0], np.linalg.qr(c(8, 8))[0]
    a = (u0 * np.array([1.0, 0.6, 0.3, 2.0e-3, 1.5e-3, 1.2e-3, 1e-3, 5e-4])) @ v0.conj().T
    w, b, e = c(8, 8), c(8, 8), c(8, 8)

    def loss(svd, xp, cast):
        wx, bx = cast(w), cast(b)

        def f(x):
            u, s, vh = svd(x)
            u, s, vh = u[:, :4], s[:4], vh[:4]
            return xp.real(xp.sum(((u * s[None, :]) @ (vh @ wx)) * xp.conj(bx)))
        return f

    f = loss(TL.adaware_svd, torch, torch.as_tensor)
    x = torch.as_tensor(a).requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    got = np.real(np.sum(np.conj(g.numpy()) * e))
    h = 1e-7
    with torch.no_grad():
        want = (f(torch.as_tensor(a + h * e)).item() - f(torch.as_tensor(a - h * e)).item()) / (2 * h)
    assert abs(got - want) < 1e-5 * abs(want)
    tc.set_dtype("complex128")
    try:
        gj = np.asarray(jax.grad(loss(JL.adaware_svd, jnp, jnp.asarray))(jnp.asarray(a)))
    finally:
        tc.set_dtype("complex64")
    assert abs(np.real(np.sum(gj * e)) - want) > 0.1 * abs(want)
