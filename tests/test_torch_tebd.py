"""The TEBD slice of the port against the JAX package: K5's plain version
(``kernels_jacobi``) against the Pallas Jacobi kernel in interpret mode, and
``ParallelTEBD`` against the JAX engine and a dense oracle, on the same
numpy-seeded inputs.

Tolerances.  The plain Jacobi and the interpret kernel run the same rounds
in float32 with sums in another order: singular values within 1e-5 of the
largest, u and vh entries within 5e-5 and
reconstructions within 5e-5, the JAX package's own bounds for its kernel
(``tests/test_kernels.py``).  ``ParallelTEBD`` in complex128 (Gram SVD on
both sides): lambda within 1e-6 and the other quantities within 1e-7: the
port stores lambda in float32, as the JAX engine does when it runs
eagerly, while the compiled JAX engine keeps float64 (6e-8 relative).  In complex64 the float32 Gram SVD
loses every singular value below sqrt(eps) s_max ~ 3e-4, and the two
packages' eigh fill that tail with different noise, which feeds back into
the trajectory: there only the weighty Schmidt values are compared, within
1e-3 (the run shows 2.7e-4), and physical quantities within 5e-3 (the run
shows 1.0e-3), below the float32 Gram run's own error against complex128
(1.0e-2 in <Z_i> at n=60 after 10 steps, ``chip_smoke.py``).  The JAX
side runs under ``jax.jit`` (the traced write-back of its engine, the path
its benchmark takes), which compiles a case once instead of op by op.
"""

import numpy as np
import pytest
import scipy.linalg as sl
import jax
import jax.numpy as jnp
import torch

import tensorcircuit_ng_tpu as tc
from tensorcircuit_ng_tpu.core import kernels_jacobi as JKJ
from tensorcircuit_ng_tpu.models import tebd as JT

import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as KJ
from tensorcircuit_ng_tpu_torch.models import tebd as TT

X = np.array([[0, 1], [1, 0.0]])
Z = np.diag([1.0, -1.0])
ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")

#: the JAX oracles, compiled once a shape (interpret mode is read at trace)
_jax_svd = jax.jit(JKJ.jacobi_svd_pallas, static_argnums=(1, 2, 3))
_jax_warm = jax.jit(JKJ.jacobi_svd_warm, static_argnums=(1, 2))
_jax_subspace = jax.jit(JKJ.subspace_svd, static_argnums=(1,), static_argnames=(
    "sweeps", "refine", "oversample", "return_basis"))


@jax.jit
def _jax_step(gammas, lambdas, even, odd):
    """One trotter step of the JAX engine."""
    e = JT.ParallelTEBD.from_state(gammas, lambdas)
    e.trotter_step(even, odd)
    return e.gammas, e.lambdas


@jax.jit
def _jax_canonicalize(gammas, lambdas):
    e = JT.ParallelTEBD.from_state(gammas, lambdas)
    e.canonicalize()
    return e.gammas, e.lambdas


@pytest.fixture
def interpret():
    old = JKJ._INTERPRET
    JKJ._INTERPRET = True
    try:
        yield
    finally:
        JKJ._INTERPRET = old


@pytest.fixture
def highp():
    tc.set_dtype("complex128")
    try:
        yield
    finally:
        tc.set_dtype("complex64")


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _decaying(rng, shape):
    """Rank-deficient with a decaying spectrum: rank 10 of n."""
    a = _cplx(rng, shape)
    s = np.where(np.arange(shape[-1]) < 10, np.exp(-np.linspace(0, 6, shape[-1])), 0.0)
    return (a @ np.diag(s)).astype(np.complex64)


def _same_svd(got, want, a):
    (u, s, vh), (uj, sj, vj) = ([np.asarray(x) for x in t] for t in (got, want))
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-5 * sj.max())
    np.testing.assert_allclose(u, uj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(vh, vj, rtol=0, atol=ATOL)
    np.testing.assert_allclose((u * s[..., None, :]) @ vh, a, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["16x16", "2x32x32", "24x16", "decaying 2x32x32"])
def test_jacobi_plain_matches_pallas_interpret(interpret, case):
    """``jacobi_svd_nodiff`` on the CPU (K5's plain version) against
    ``jacobi_svd_pallas``, with V in the kernel and without it."""
    rng = np.random.default_rng(3)
    if case.startswith("decaying"):
        a = _decaying(rng, (2, 32, 32))
    else:
        a = _cplx(rng, tuple(int(x) for x in case.split("x")))
    for acc_v in (True, False):
        want = _jax_svd(jnp.asarray(a), 10, acc_v, False)
        got = [x.numpy() for x in KJ.jacobi_svd_nodiff(torch.as_tensor(a), 10, acc_v)]
        _same_svd(got, want, a)
    with pytest.raises(ValueError, match="m >= n"):
        KJ.jacobi_svd_nodiff(torch.ones((4, 8), dtype=torch.complex64))


def test_jacobi_presort_warm_and_gradient_match_jax(interpret):
    rng = np.random.default_rng(4)
    a = _decaying(rng, (2, 32, 32))
    want = _jax_svd(jnp.asarray(a), 10, True, True)
    got = [x.numpy() for x in KJ.jacobi_svd_nodiff(torch.as_tensor(a), 10, True, presort=True)]
    _same_svd(got, want, a)
    # warm start from the previous decomposition of a nearby matrix
    b = a + 1e-3 * _cplx(rng, a.shape)
    vh0 = np.asarray(_jax_svd(jnp.asarray(a), 10, True, False)[2])
    want = _jax_warm(jnp.asarray(b), 4, True, jnp.asarray(vh0))
    got = [x.numpy() for x in KJ.jacobi_svd_warm(torch.as_tensor(b), 4, True, torch.as_tensor(vh0))]
    _same_svd(got, want, b)
    # jacobi_svd's adjoint on a gauge-invariant loss: conj(torch) == jax
    c = _cplx(rng, (16, 16))
    w = np.arange(256, dtype=np.float32).reshape(16, 16)

    def loss(xp, svd):
        def f(x):
            u, s, vh = svd(x, 10, False)
            rec = (u[:, :6] * s[None, :6]) @ vh[:6, :]
            return xp.real(xp.sum(s[:6]) + xp.sum(xp.asarray(w) * xp.abs(rec) ** 2))

        return f

    gj = np.asarray(jax.jit(jax.grad(loss(jnp, JKJ.jacobi_svd)))(jnp.asarray(c)))
    t = torch.as_tensor(c).requires_grad_()
    loss(torch, KJ.jacobi_svd)(t).backward()
    np.testing.assert_allclose(np.conj(t.grad.numpy()), gj, rtol=0, atol=1e-5 * np.abs(gj).max())


def test_subspace_svd_matches_jax_on_a_warm_panel(interpret):
    """Warm ``subspace_svd``: K5 on a (32, 16) panel, one refine round."""
    rng = np.random.default_rng(5)
    a = _decaying(rng, (2, 32, 32))
    v0 = np.linalg.svd(a + 1e-3 * _cplx(rng, a.shape))[2].conj().swapaxes(-1, -2)[..., :16]
    v0 = np.ascontiguousarray(v0.astype(np.complex64))
    kw = dict(sweeps=10, refine=1, oversample=8, return_basis=True)
    want = [np.asarray(x) for x in _jax_subspace(jnp.asarray(a), 8, v0=jnp.asarray(v0), **kw)]
    got = [x.numpy() for x in KJ.subspace_svd(torch.as_tensor(a), 8, v0=torch.as_tensor(v0), **kw)]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5 * want[1].max())
    rec = lambda u, s, vh: (u * s[..., None, :]) @ vh
    np.testing.assert_allclose(rec(*got[:3]), rec(*want[:3]), rtol=0, atol=ATOL)
    assert got[3].shape == want[3].shape == (2, 32, 16)
    # cold: the full-width Jacobi, its right basis handed back
    cold = KJ.subspace_svd(torch.as_tensor(a), 8, return_basis=True)
    np.testing.assert_allclose(cold[1].numpy(), want[1], rtol=0, atol=1e-5 * want[1].max())


def _gates(n, seed):
    """Per-bond (nb, 4, 4) unitary stacks: exp(-i dt h_b) with random
    couplings, one stack a parity."""
    rng = np.random.default_rng(seed)

    def stack(parity):
        out = []
        for _ in range(parity, n - 1, 2):
            j, hx, hz = rng.normal(size=3)
            h = j * np.kron(X, X) + np.kron(Z, Z) + hx * np.kron(X, np.eye(2)) + hz * np.kron(np.eye(2), Z)
            out.append(sl.expm(-0.1j * h))
        return np.stack(out)

    return stack(0), stack(1)


def _jax_run(ej, steps, even, odd):
    """``steps`` trotter steps of a JAX engine, compiled."""
    g, lam = jnp.asarray(ej.gammas), jnp.asarray(ej.lambdas)
    for _ in range(steps):
        g, lam = _jax_step(g, lam, jnp.asarray(even), jnp.asarray(odd))
    return JT.ParallelTEBD.from_state(g, lam)


def _run_both(n, chi, steps, dtype, seed=0, canon=False):
    even, odd = (g.astype(dtype) for g in _gates(n, seed))
    ej = _jax_run(JT.ParallelTEBD(n, chi, initial="neel", dtype=dtype), steps, even, odd)
    et = tct.ParallelTEBD(n, chi, initial="neel", dtype=dtype, device="cpu")
    for _ in range(steps):
        et.trotter_step(even, odd)
    if canon:
        ej = JT.ParallelTEBD.from_state(*_jax_canonicalize(ej.gammas, ej.lambdas))
        et.canonicalize()
    return ej, et


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _physics(ej, et, n, tol):
    assert _overlap(ej.wavefunction(), et.wavefunction().numpy()) > 1 - tol
    for i in (0, n // 2, n - 1):
        zj = complex(ej.expectation_single(Z, i))
        zt = complex(et.expectation_single(Z, i).item())
        assert abs(zj - zt) <= tol, (i, zj, zt)
    zzj = complex(ej.expectation_two_site(np.kron(Z, Z), n // 2 - 1))
    zzt = complex(et.expectation_two_site(np.kron(Z, Z), n // 2 - 1).item())
    assert abs(zzj - zzt) <= tol
    sj = float(ej.entanglement_entropy(n // 2))
    assert abs(sj - et.entanglement_entropy(n // 2).item()) <= tol and sj > 0


@pytest.mark.parametrize("canon", [False, True])
def test_tebd_matches_jax_complex128(highp, canon):
    """n=6, chi=4 (truncating), per-bond gate stacks, Gram mode on both
    sides; then ``canonicalize``."""
    n = 6
    ej, et = _run_both(n, 4, 5, "complex128", canon=canon)
    np.testing.assert_allclose(et.lambdas.numpy(), np.asarray(ej.lambdas), rtol=0, atol=1e-6)
    _physics(ej, et, n, 1e-7)


def test_tebd_matches_jax_complex64():
    n = 6
    ej, et = _run_both(n, 4, 4, "complex64", seed=1)
    assert et.gammas.dtype == torch.complex64 and et.lambdas.dtype == torch.float32
    lj, lt = np.asarray(ej.lambdas), et.lambdas.numpy()
    # the Schmidt values that carry weight; the rest is float32 Gram noise
    big = lj > 1e-2
    np.testing.assert_allclose(lt[big], lj[big], rtol=0, atol=1e-3)
    _physics(ej, et, n, 5e-3)


def test_pair_update_matches_jax(highp):
    rng = np.random.default_rng(6)
    chi, d = 4, 2
    g = [(rng.standard_normal((chi, d, chi)) + 1j * rng.standard_normal((chi, d, chi))) for _ in range(2)]
    lam = [np.sort(rng.random(chi))[::-1].copy() for _ in range(3)]
    gate = sl.expm(-0.3j * np.kron(X, X))
    outj = JT.ParallelTEBD._pair_update(*(jnp.asarray(x) for x in g + lam), jnp.asarray(gate), chi, d)
    outt = TT.ParallelTEBD._pair_update(*(torch.as_tensor(x) for x in g + lam), torch.as_tensor(gate), chi, d)
    np.testing.assert_allclose(outt[2].numpy(), np.asarray(outj[2]), rtol=0, atol=1e-10)
    # the new bond as a matrix, gauge-free
    for oj, ot, lr in ((outj, outt, lam[2]),):
        mj = np.einsum("aib,b,bjc->aijc", np.asarray(oj[0]), np.asarray(oj[2]), np.asarray(oj[1]) * lr)
        mt = np.einsum("aib,b,bjc->aijc", ot[0].numpy(), ot[2].numpy(), ot[1].numpy() * lr)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-9)


def _dense_oracle(n, gm, steps):
    def embed(g, i):
        return np.kron(np.kron(np.eye(2**i), g), np.eye(2 ** (n - i - 2)))

    psi = np.zeros(2**n, dtype=complex)
    psi[sum(1 << (n - 1 - i) for i in range(0, n, 2))] = 1.0
    for _ in range(steps):
        for i in range(0, n - 1, 2):
            psi = embed(gm, i) @ psi
        for i in range(1, n - 1, 2):
            psi = embed(gm, i) @ psi
    return psi / np.linalg.norm(psi), embed


def test_tebd_exact_regime_dense_oracle():
    """n=6, chi=16 = 2^(n/2): no truncation, so the engine is exact."""
    n, chi = 6, 16
    gm = sl.expm(-1j * 0.05 * (0.8 * np.kron(X, X) + np.kron(Z, Z)))
    psi, embed = _dense_oracle(n, gm, 5)
    eng = tct.ParallelTEBD(n, chi, initial="neel", device="cpu")
    for _ in range(5):
        eng.trotter_step(gm.astype(np.complex64))
    assert _overlap(psi, eng.wavefunction().numpy()) > 0.9999
    z_dense = np.real(psi.conj() @ embed(np.kron(Z, np.eye(2)), n // 2) @ psi)
    assert abs(eng.expectation_single(Z, n // 2).real.item() - z_dense) < 1e-3
    zz_dense = np.real(psi.conj() @ embed(np.kron(Z, Z), 2) @ psi)
    assert abs(eng.expectation_two_site(np.kron(Z, Z), 2).real.item() - zz_dense) < 1e-3
    assert eng.entanglement_entropy(n // 2).item() > 0


def test_tebd_inv_s_relative_floor(monkeypatch):
    """The INV_S_REL cases of the JAX package's test: the auto, zero and
    1e-6 floors all match the dense oracle in the exact regime; a floor of
    0.9 visibly truncates."""
    n, chi = 6, 16
    gm = sl.expm(-1j * 0.07 * (0.8 * np.kron(X, X) + np.kron(Z, Z)))
    psi, _ = _dense_oracle(n, gm, 6)

    def fidelity(rel):
        monkeypatch.setattr(TT, "INV_S_REL", rel)
        eng = tct.ParallelTEBD(n, chi, initial="neel", device="cpu")
        for _ in range(6):
            eng.trotter_step(gm.astype(np.complex64))
        return _overlap(psi, eng.wavefunction().numpy())

    for rel in (None, 0.0, 1e-6):
        assert fidelity(rel) > 0.9999, rel
    assert fidelity(0.9) < 0.999


def test_tebd_jacobi_mode_matches_jax_gram(monkeypatch):
    """The port in "jacobi" mode (K5's plain version on the CPU) against the
    JAX engine in Gram mode."""
    gate = sl.expm(-1j * 0.1 * (np.kron(Z, Z) + 0.5 * np.kron(X, np.eye(2)))).astype(np.complex64)
    even, odd = np.stack([gate] * 3), np.stack([gate] * 2)
    ej = _jax_run(JT.ParallelTEBD(6, 4, initial="neel"), 4, even, odd)
    monkeypatch.setattr(TT, "SVD_MODE", "jacobi")
    et = tct.ParallelTEBD(6, 4, initial="neel", device="cpu")
    for _ in range(4):
        et.trotter_step(gate)
    assert _overlap(ej.wavefunction(), et.wavefunction().numpy()) > 1 - 1e-5


def test_tebd_warm_and_subspace_modes_exact_regime(monkeypatch):
    """Warm-started Jacobi (``from_state(warm=...)``, 4 sweeps from the last
    step's V) and the subspace mode, in the exact regime (n=6, chi=16),
    against the dense oracle."""
    n, chi, steps = 6, 16, 4
    gm = sl.expm(-1j * 0.1 * (0.8 * np.kron(X, X) + np.kron(Z, Z) + 0.5 * np.kron(X, np.eye(2))))
    psi, _ = _dense_oracle(n, gm, steps)

    def evolve(mode):
        monkeypatch.setattr(TT, "SVD_MODE", mode)
        eng = tct.ParallelTEBD(n, chi, initial="neel", device="cpu")
        eng = tct.ParallelTEBD.from_state(eng.gammas, eng.lambdas, warm={})
        for _ in range(steps):
            eng.trotter_step(gm.astype(np.complex64))
            eng = tct.ParallelTEBD.from_state(eng.gammas, eng.lambdas, warm=eng.warm_state())
        assert set(eng._warm_in) == {0, 1}
        return eng.wavefunction().numpy()

    assert _overlap(psi, evolve("jacobi")) > 1 - 1e-5
    assert _overlap(psi, evolve("subspace")) > 1 - 1e-5


def test_tebd_state_carried_from_jax(highp):
    """A JAX engine's state crosses with ``convert.tebd_state``; both
    packages continue the same trajectory."""
    n = 6
    even, odd = _gates(n, 2)
    ej = _jax_run(JT.ParallelTEBD(n, 4, initial="neel"), 3, even, odd)
    g, lam = convert.tebd_state(np.asarray(ej.gammas), np.asarray(ej.lambdas), device="cpu")
    g0 = g.clone()
    et = tct.ParallelTEBD.from_state(g, lam)
    assert et.gammas.dtype == torch.complex128 and (et.n, et.chi, et.d) == (n, 4, 2)
    ej = _jax_run(ej, 3, even, odd)
    for _ in range(3):
        et.trotter_step(even, odd)
    np.testing.assert_allclose(et.lambdas.numpy(), np.asarray(ej.lambdas), rtol=0, atol=1e-6)
    assert _overlap(ej.wavefunction(), et.wavefunction().numpy()) > 1 - 1e-7
    # from_state copies: the engine's in-place updates leave its input alone
    assert torch.equal(g, g0)


def test_svd_mode_auto_decides_on_the_device(monkeypatch):
    """"auto" is Gram on a CPU tensor; "jacobi" runs K5's plain version
    there and launches nothing."""
    theta = torch.as_tensor(_cplx(np.random.default_rng(0), (3, 16, 16)))
    seen = []
    monkeypatch.setattr(TT._linalg, "gram_svd", lambda a: seen.append("gram") or TT._linalg.adaware_svd(a))
    TT._svd_batched(theta, 8)
    assert seen == ["gram"]
    monkeypatch.setattr(TT, "SVD_MODE", "jacobi")
    KJ.jacobi_rotations.launches = 0
    u, s, vh, rec = TT._svd_batched(theta, 8)
    assert KJ.jacobi_rotations.launches == 0 and rec is vh
    np.testing.assert_allclose(((u * s[..., None, :]) @ vh).numpy(), theta.numpy(), atol=ATOL)
    monkeypatch.setattr(TT, "SVD_MODE", "lapack")
    with pytest.raises(ValueError, match="SVD_MODE"):
        TT._svd_batched(theta, 8)
