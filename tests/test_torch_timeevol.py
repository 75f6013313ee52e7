"""The port's ``timeevol.py`` against the JAX package's.

Each engine on the same seeded inputs in both packages, the Hamiltonian as
a dense matrix, a COO matrix (``PauliStringSum2COO``) and a matrix-free
product (``PauliStringSum2MVP``): ``lanczos_iteration[_scan]``,
``krylov_evol``, ``hamiltonian_evol[_real]``, ``expm_multiply``,
``expm_multiply_evol`` and its parameters, ``chebyshev_evol`` (with a float
and with a tensor time, whose gradient goes through the Bessel
coefficients), the Bessel helpers, ``estimate_k``/``estimate_M``/
``estimate_spectral_bounds``.  Tolerances: complex64 1e-5 and complex128
1e-10, each relative to max(1, the largest entry).  The ODE engines
(``ode_evol_global``/``_local``: the JAX package's ``odeint`` Dormand-Prince
step against the port's torch copy of it) are held at the solver's
tolerance, 1e-5 at rtol = atol = 1.4e-7 for the states, and their
gradients in a Hamiltonian parameter (backpropagation through the steps in
the port, the continuous adjoint in JAX) within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import quantum as jq
from tensorcircuit_ng_tpu import timeevol as jte
from tensorcircuit_ng_tpu_torch import timeevol as te

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}
ODE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: xdist runs six modules at once."""
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


def _np(x):
    return x.detach().cpu().resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _tfim(n):
    ls, ws = [], []
    for i in range(n - 1):
        l = [0] * n
        l[i] = l[i + 1] = 3
        ls.append(l)
        ws.append(1.0)
    for i in range(n):
        l = [0] * n
        l[i] = 1
        ls.append(l)
        ws.append(-0.8)
    return ls, ws


def _state(n, dt, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    return (psi / np.linalg.norm(psi)).astype(dt)


def _forms(n, dt):
    """The Hamiltonian in three forms, for each package."""
    ls, ws = _tfim(n)
    dense = np.asarray(jq.PauliStringSum2Dense(ls, ws)).astype(dt)
    return {
        "dense": (torch.as_tensor(dense), jnp.asarray(dense)),
        "coo": (tct.PauliStringSum2COO(ls, ws, device="cpu"), jq.PauliStringSum2COO(ls, ws)),
        "mvp": (tct.PauliStringSum2MVP(ls, ws), jq.PauliStringSum2MVP(ls, ws)),
    }


@pytest.mark.parametrize("form", ["dense", "coo", "mvp"])
def test_lanczos_and_krylov_match_jax(dtype, form):
    n = 5
    th, jh = _forms(n, dtype)[form]
    psi = _state(n, dtype)
    t, v = te.lanczos_iteration(th, torch.as_tensor(psi), 8)
    tj, vj = jte.lanczos_iteration(jh, jnp.asarray(psi), 8)
    _close(t, tj, 10 * TOL[dtype])
    _close(v, vj, 10 * TOL[dtype])
    ts = np.array([0.2, 0.5, 0.9], dtype=RDT[dtype])
    got = te.krylov_evol(th, torch.as_tensor(psi), torch.as_tensor(ts), 16)
    want = jte.krylov_evol(jh, jnp.asarray(psi), jnp.asarray(ts), 16)
    _close(got, want, 10 * TOL[dtype])
    one = te.krylov_evol(th, torch.as_tensor(psi), 0.5, 16, callback=lambda s: torch.sum(torch.abs(s) ** 2))
    _close(one, jte.krylov_evol(jh, jnp.asarray(psi), jnp.asarray(0.5, dtype=RDT[dtype]), 16,
                                callback=lambda s: jnp.sum(jnp.abs(s) ** 2)), 10 * TOL[dtype])


def test_exact_evolutions_match_jax(dtype):
    n = 4
    th, jh = _forms(n, dtype)["dense"]
    psi = _state(n, dtype, 1)
    ts = np.array([0.0, 0.3, 1.1], dtype=RDT[dtype])
    _close(te.hamiltonian_evol(th, torch.as_tensor(psi), torch.as_tensor(ts)),
           jte.hamiltonian_evol(jh, jnp.asarray(psi), jnp.asarray(ts)), TOL[dtype])
    _close(te.ed_evol(th, torch.as_tensor(psi), torch.as_tensor(ts[1])),
           jte.ed_evol(jh, jnp.asarray(psi), jnp.asarray(ts[1])), TOL[dtype])
    real = te.hamiltonian_evol_real(torch.as_tensor(ts), th, torch.as_tensor(psi))
    _close(real, jte.hamiltonian_evol_real(jnp.asarray(ts), jh, jnp.asarray(psi)), TOL[dtype])
    cb = te.hamiltonian_evol_real(torch.as_tensor(ts), th, torch.as_tensor(psi),
                                  callback=lambda s: torch.real(torch.vdot(s, s)))
    _close(cb, np.ones(3), TOL[dtype])


@pytest.mark.parametrize("form", ["dense", "coo", "mvp"])
def test_expm_multiply_matches_jax(dtype, form):
    n = 4
    th, jh = _forms(n, dtype)[form]
    psi = _state(n, dtype, 2)
    _close(te.expm_multiply(th, torch.as_tensor(psi), t=0.5),
           jte.expm_multiply(jh, jnp.asarray(psi), t=0.5), TOL[dtype])
    _close(te.expm_multiply(th, torch.as_tensor(psi), t=0.3, prefactor=-1.0, m=20, s=3),
           jte.expm_multiply(jh, jnp.asarray(psi), t=0.3, prefactor=-1.0, m=20, s=3), TOL[dtype])
    exact = te.hamiltonian_evol_real(torch.tensor(0.5), _forms(n, dtype)["dense"][0], torch.as_tensor(psi))
    _close(te.expm_multiply(th, torch.as_tensor(psi), t=0.5), exact, 10 * TOL[dtype])


def test_expm_multiply_evol_and_parameters_match_jax(dtype):
    n = 4
    th, jh = _forms(n, dtype)["dense"]
    psi = _state(n, dtype, 3)
    assert te.estimate_expm_multiply_parameters(2.0, 9.0) == jte.estimate_expm_multiply_parameters(2.0, 9.0)
    assert te.estimate_expm_multiply_parameters(0.0, 9.0) == (0, 1)
    with pytest.raises(ValueError):
        te.estimate_expm_multiply_parameters(-1.0, 1.0)
    ts = np.array([0.1, 0.4])
    _close(te.expm_multiply_evol(th, torch.as_tensor(psi), ts), jte.expm_multiply_evol(jh, jnp.asarray(psi), ts),
           TOL[dtype])
    _close(te.expm_multiply_evol(th, torch.as_tensor(psi), 0.4, norm_bound=8.0),
           jte.expm_multiply_evol(jh, jnp.asarray(psi), 0.4, norm_bound=8.0), TOL[dtype])


@pytest.mark.parametrize("form", ["dense", "coo", "mvp"])
def test_chebyshev_matches_jax(dtype, form):
    n = 4
    th, jh = _forms(n, dtype)[form]
    psi = _state(n, dtype, 4)
    e = np.linalg.eigvalsh(_np(_forms(n, dtype)["dense"][0]))
    bounds = (float(e[-1]) + 0.1, float(e[0]) - 0.1)
    got = te.chebyshev_evol(th, torch.as_tensor(psi), 0.8, bounds)
    _close(got, jte.chebyshev_evol(jh, jnp.asarray(psi), 0.8, bounds), TOL[dtype])
    exact = te.hamiltonian_evol_real(torch.tensor(0.8, dtype=torch.float64), _forms(n, dtype)["dense"][0], torch.as_tensor(psi))
    _close(got, exact, 10 * TOL[dtype])
    assert te.estimate_k(0.8, bounds) == jte.estimate_k(0.8, bounds)
    assert te.estimate_M(0.8, bounds) == jte.estimate_M(0.8, bounds)
    if form == "dense":  # the JAX package's reads h.shape through jnp.asarray
        got_b = te.estimate_spectral_bounds(th, n_iter=12)
        want_b = jte.estimate_spectral_bounds(jh, n_iter=12)
        np.testing.assert_allclose(got_b, want_b, atol=1e-4)


def test_traced_time_chebyshev_and_bessel_match_jax():
    """A tensor time: the Bessel coefficients by Miller's recurrence and
    their derivative (J_{k-1} - J_{k+1}) / 2, the evolved state and the
    gradient of a fidelity in t, against the JAX package's traced path
    (float32, 1e-5 of the largest entry) and scipy."""
    from scipy.special import jv

    f = te.bessel_jn_traced(16)
    for x in (0.0, 0.4, 3.3, 12.0):
        got = f(torch.tensor(x))
        _close(got, jte.bessel_jn_traced(16)(jnp.asarray(x, jnp.float32)), 1e-5)
        _close(got, jv(np.arange(17), x), 1e-4)
    g = torch.func.jacrev(f)(torch.tensor(1.3))
    _close(g, jax.jacfwd(jte.bessel_jn_traced(16))(jnp.asarray(1.3, jnp.float32)), 1e-5)
    _close(tct.backend.special_jv(5, torch.tensor(2.0), 30), jv(np.arange(5), 2.0), 1e-5)
    n = 4
    h = np.asarray(jq.PauliStringSum2Dense(*_tfim(n))).astype(np.complex64)
    e = np.linalg.eigvalsh(h)
    bounds = (float(e[-1]) + 0.1, float(e[0]) - 0.1)
    psi = _state(n, np.complex64, 5)

    def fid(mod, xp, t):
        psi_t = mod.chebyshev_evol(h if mod is jte else torch.as_tensor(h), psi if mod is jte else
                                   torch.as_tensor(psi), t, bounds, M=24)
        return xp.abs(xp.vdot(xp.asarray(psi) if xp is jnp else torch.as_tensor(psi), psi_t)) ** 2

    t = torch.tensor(0.7, requires_grad=True)
    v = fid(te, torch, t)
    (gt,) = torch.autograd.grad(v, t)
    vj, gj = jax.value_and_grad(lambda s: fid(jte, jnp, s))(jnp.asarray(0.7, jnp.float32))
    _close(v, vj, 1e-5)
    _close(gt, gj, 1e-4)


def test_ode_evolutions_match_jax(dtype):
    """``ode_evol_global`` (dense, COO and a product; a grid starting at 0)
    and ``ode_evol_local`` against the JAX package and the exact
    evolution, at the solver's tolerance."""
    n = 3
    forms = _forms(n, dtype)
    psi = _state(n, dtype, 6)
    ts = np.array([0.0, 0.3, 0.6], dtype=RDT[dtype])
    exact = te.hamiltonian_evol_real(torch.as_tensor(ts[1:]), forms["dense"][0], torch.as_tensor(psi))
    want = jte.ode_evol_global(lambda t: forms["dense"][1], jnp.asarray(psi), jnp.asarray(ts))
    for form in ("dense", "coo", "mvp"):
        got = te.ode_evol_global(lambda t, h=forms[form][0]: h, torch.as_tensor(psi), ts)
        _close(got, want, ODE_TOL)
        _close(got[1:], exact, ODE_TOL)
    x = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=dtype)
    got = te.ode_evol_local(lambda t: 0.5 * torch.as_tensor(x) * torch.cos(t), torch.as_tensor(psi), [0.4, 0.9], [1])
    want = jte.ode_evol_local(lambda t: 0.5 * jnp.asarray(x) * jnp.cos(t), jnp.asarray(psi), jnp.asarray([0.4, 0.9]),
                              [1])
    _close(got, want, ODE_TOL)
    single = te.evol_global(lambda t: forms["dense"][0], torch.as_tensor(psi), 0.3,
                            callback=lambda s: torch.real(torch.vdot(s, s)))
    _close(single, 1.0, ODE_TOL)


def test_ode_gradient_matches_jax():
    """d/dg of <Z_0> after i dψ/dt = (H0 + g sin(t) X_1) ψ (complex64):
    backpropagation through the port's steps against JAX's adjoint."""
    n = 3
    h0 = np.asarray(jq.PauliStringSum2Dense(*_tfim(n))).astype(np.complex64)
    x1 = np.kron(np.kron(np.eye(2), [[0, 1], [1, 0]]), np.eye(2)).astype(np.complex64)
    z0 = np.kron(np.diag([1.0, -1.0]), np.eye(4)).astype(np.complex64)
    psi = _state(n, np.complex64, 7)

    def obs(mod, xp, g):
        h = (lambda t, a: torch.as_tensor(h0) + a * torch.sin(t) * torch.as_tensor(x1)) if xp is torch else \
            (lambda t, a: jnp.asarray(h0) + a * jnp.sin(t) * jnp.asarray(x1))
        s = mod.ode_evol_global(h, psi if xp is jnp else torch.as_tensor(psi), 0.5, g)
        zz = torch.as_tensor(z0) if xp is torch else jnp.asarray(z0)
        return xp.real(xp.vdot(s, zz @ s))

    g = torch.tensor(0.7, requires_grad=True)
    v = obs(te, torch, g)
    (gt,) = torch.autograd.grad(v, g)
    vj, gj = jax.value_and_grad(lambda a: obs(jte, jnp, a))(jnp.asarray(0.7, jnp.float32))
    _close(v, vj, ODE_TOL)
    _close(gt, gj, 1e-4)
