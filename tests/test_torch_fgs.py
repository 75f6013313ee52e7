"""The port's free-fermion simulator (``models/fgs.py``) against the JAX
package's and against the dense Jordan-Wigner oracle.

``alpha`` is defined only up to a unitary on its right, which QR and
``eigh`` pick differently in each library, so the comparisons are of
gauge-free quantities: the correlation matrix after each ``evol_*`` (1e-5 at
complex64, 1e-10 at complex128), the measurements and post-selection, the
entropies, charge moments, the asymmetry with a given status, ``overlap``,
the Majorana and covariance matrices and ``expectation_4body``; the port
against ``FGSTestSimulator`` at L <= 6; the gradient of a hopping energy
through a chain of ``evol_hp`` against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.models.fgs import FGSSimulator as JFGS
from tensorcircuit_ng_tpu_torch.models.fgs import FGSSimulator as PFGS
from tensorcircuit_ng_tpu_torch.models.fgs import FGSTestSimulator as POracle

TOL = {"complex64": 1e-5, "complex128": 1e-10}


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


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def _bdg(L, seed, pairing=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(L, L)) + 1j * rng.normal(size=(L, L))
    h = (h + h.conj().T) / 2
    d = rng.normal(size=(L, L)) + 1j * rng.normal(size=(L, L))
    d = (d - d.T) / 2 if pairing else np.zeros((L, L))
    return h, d, PFGS.bdg(h, d)


def _pair(L, filled, dtype):
    return JFGS(L, filled=filled), PFGS(L, filled=filled, dtype=dtype)


EVOLUTIONS = [
    ("evol_hp", (0, 1, 0.3 + 0.2j)),
    ("evol_hp", (2, 5, -0.7)),
    ("evol_sp", (1, 2, 0.4 - 0.1j)),
    ("evol_cp", (3, 0.7)),
    ("evol_icp", (2, 0.5)),
    ("evol_hamiltonian", "h"),
    ("evol_ihamiltonian", "h"),
    ("evol_ghamiltonian", "g"),
]


def test_evolutions_against_jax(dtype):
    L = 6
    j, p = _pair(L, [0, 2, 4], dtype)
    _, _, m = _bdg(L, 3)
    g = m + 0.2j * np.diag(np.arange(2 * L) / L)  # non-hermitian
    for name, args in EVOLUTIONS:
        if args == "h":
            getattr(j, name)(m, 0.3)
            getattr(p, name)(m, 0.3)
        elif args == "g":
            getattr(j, name)(g, 0.1)
            getattr(p, name)(g, 0.1)
        else:
            getattr(j, name)(*args)
            getattr(p, name)(*args)
        _close(p.get_cmatrix(), j.get_cmatrix(), TOL[dtype])
    assert p.alpha.dtype == getattr(torch, dtype) and p.alpha.device.type == "cpu"
    _close(p.get_cmatrix(False, True), j.get_cmatrix(False, True), TOL[dtype])


def test_local_updates_equal_dense_generators(dtype):
    """``evol_hp``/``evol_sp``/``evol_cp`` are ``evol_hamiltonian`` of the
    generators, in the port as in the JAX package."""
    L = 5
    for local, dense in (
        (lambda f: f.evol_hp(1, 3, 0.4 + 0.3j), lambda f: f.evol_hamiltonian(PFGS.hopping(L, 1, 3, 0.4 + 0.3j))),
        (lambda f: f.evol_sp(0, 2, 0.5j), lambda f: f.evol_hamiltonian(PFGS.pairing(L, 0, 2, 0.5j))),
        (lambda f: f.evol_cp(4, 0.9), lambda f: f.evol_hamiltonian(PFGS.chemical_potential(L, 4, 0.9))),
    ):
        a, b = PFGS(L, filled=[1, 2], dtype=dtype), PFGS(L, filled=[1, 2], dtype=dtype)
        local(a)
        dense(b)
        _close(a.get_cmatrix(), b.get_cmatrix(), 10 * TOL[dtype])


def test_ground_state_and_diagonalization(dtype):
    L = 5
    _, _, m = _bdg(L, 11)
    j, p = JFGS(L, hc=m), PFGS(L, hc=m, dtype=dtype)
    _close(p.get_cmatrix(), j.get_cmatrix(), 10 * TOL[dtype])
    es_p, _, a_p = PFGS.fermion_diagonalization(m, L, device="cpu")
    es_j, _, _ = JFGS.fermion_diagonalization(jnp.asarray(m, dtype=dtype), L)
    _close(es_p, es_j, 10 * TOL[dtype])
    assert a_p.shape == (2 * L, L)
    es2, u2, a2 = PFGS.fermion_diagonalization_2(m, L)
    es2j, u2j, _ = JFGS.fermion_diagonalization_2(m, L)
    _close(es2, es2j, 1e-10)


@pytest.mark.parametrize("status", [[0.2, 0.9, 0.5, 0.05], [0.7, 0.1, 0.99, 0.4]])
def test_cond_measure_and_post_select_against_oracle(dtype, status):
    """Outcomes, probabilities and the collapsed correlation matrix against
    the dense oracle; the first outcome and probabilities also against the
    JAX package (its later states are off: F17)."""
    L = 5
    h, d, m = _bdg(L, 13)
    p, o, j = PFGS(L, filled=[0, 3], dtype=dtype), POracle(L, filled=[0, 3]), JFGS(L, filled=[0, 3])
    p.evol_hamiltonian(m, 0.3)
    o.evol_hamiltonian(h, d, 0.3)
    j.evol_hamiltonian(m, 0.3)
    kj, pj = j.cond_measure(2, status[0], with_prob=True)
    tol = 10 * TOL[dtype]
    for site, st in zip([2, 1, 4, 0], status):
        kp, pp = p.cond_measure(site, st, with_prob=True)
        ko, po = o.cond_measure(site, st, with_prob=True)
        assert float(kp) == ko
        _close(pp, po, tol)
        _close(p.get_cmatrix(), o.get_cmatrix(), tol)
        assert abs(float(p.occupation(site)) - ko) <= tol
        if site == 2:
            assert float(kp) == float(kj)
            _close(pp, pj, tol)
    keep = int(round(o.occupation(3)))  # an outcome of probability >= 1/2
    p.post_select(3, keep)
    o.post_select(3, keep)
    _close(p.get_cmatrix(), o.get_cmatrix(), tol)


@pytest.mark.parametrize("dt", ["complex64", "complex128"])
def test_f17_post_select_exact_where_jax_rounds(dt):
    """Queue 3 F17: the JAX package projects by the step e^{±30 n_i} and a QR,
    which rounds the other rows at e^{30} times their scale: at L=5 with
    pairing its correlation matrix after one projection is 0.61 off the
    oracle at complex64 and 1.8e-4 at complex128 (kept as a record); the
    port projects exactly."""
    L = 5
    h, d, m = _bdg(L, 13)
    tc.set_dtype(dt)
    try:
        j, o = JFGS(L, filled=[0, 3]), POracle(L, filled=[0, 3])
        with tct.set_dtype(dt):
            p = PFGS(L, filled=[0, 3], device="cpu")
        for s in (j, p):
            s.evol_hamiltonian(m, 0.3)
        o.evol_hamiltonian(h, d, 0.3)
        for s in (j, p, o):
            s.post_select(2, 0)
        err_jax = np.abs(np.asarray(j.get_cmatrix()) - o.get_cmatrix()).max()
        err_port = np.abs(_np(p.get_cmatrix()) - o.get_cmatrix()).max()
    finally:
        tc.set_dtype("complex64")
    assert err_jax > {"complex64": 0.5, "complex128": 1e-4}[dt]
    assert err_port <= TOL[dt]


def test_cond_measure_sign_zero_keeps_half():
    """status - P(0) + 1e-12 == 0 exactly (an occupied site, status
    -1e-12): sign(0) = 0 gives the outcome 0.5, as in the JAX package."""
    with tct.set_dtype("complex128"):
        p = PFGS(2, filled=[0], device="cpu")
        assert float(torch.real(p.get_cmatrix()[0, 0])) == 0.0
        before = p.get_cmatrix()
        assert float(p.cond_measure(0, -1e-12)) == 0.5
        assert torch.equal(p.get_cmatrix(), before)
    assert float(JFGS(2, filled=[0]).cond_measure(0, -1e-12)) == 0.5


def test_readouts_against_jax(dtype):
    L = 6
    j, p = _pair(L, [0, 1, 4], dtype)
    j2, p2 = _pair(L, [2, 3, 5], dtype)
    _, _, m = _bdg(L, 5)
    for a, b in ((j, p), (j2, p2)):
        a.evol_hamiltonian(m, 0.4)
        b.evol_hamiltonian(m, 0.4)
    tol = 10 * TOL[dtype]
    for region in ([0, 1, 2], [1, 4]):
        _close(p.entropy(region), j.entropy(region), tol)
        for k in (2, 3):
            _close(p.renyi_entropy(region, k), j.renyi_entropy(region, k), tol)
    _close(p.overlap(p2), j.overlap(j2), tol)
    _close(p.get_cmatrix_majorana(), j.get_cmatrix_majorana(), tol)
    _close(p.get_covariance_matrix(), j.get_covariance_matrix(), tol)
    _close(p.get_reduced_cmatrix([0, 5]), j.get_reduced_cmatrix([0, 5]), tol)
    for idx in ((0, 7, 2, 9), (6, 1, 8, 3)):
        _close(p.expectation_4body(*idx), j.expectation_4body(*idx), tol)
    _close(p.expectation_2body(7, 2), j.expectation_2body(7, 2), tol)
    _close(p.occupation(4), j.occupation(4), tol)
    u, v = p.get_bogoliubov_uv()
    assert u.shape == v.shape == (L, L)
    with pytest.raises(ValueError, match="traced out"):
        p.get_reduced_cmatrix(range(L))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_charge_moment_and_asymmetry_against_jax(dtype, n):
    """Against the JAX package at complex128: the port takes the charge
    moment's core in complex128 whatever the state's dtype (the JAX
    package's complex64 core rounds Z_n by 2.4e-4 to 3.7e-4 here)."""
    L = 6
    _, _, m = _bdg(L, 7)
    tc.set_dtype("complex128")
    try:
        j = JFGS(L, filled=[0, 2, 5])
        j.evol_hamiltonian(m, 0.5)
        p = PFGS(L, filled=[0, 2, 5], dtype=dtype)
        p.evol_hamiltonian(m, 0.5)
        trace = [4, 5]
        angles = np.random.default_rng(n).uniform(-np.pi, np.pi, size=n)
        zp = p.charge_moment(angles, n, trace)
        assert zp.dtype == getattr(torch, dtype)
        _close(zp, j.charge_moment(angles, n, trace), TOL[dtype])
        status = np.random.default_rng(10 + n).uniform(-np.pi, np.pi, size=(12, n))
        sp, stdp = p.renyi_entanglement_asymmetry(n, trace, status=status, with_std=True)
        sj, stdj = j.renyi_entanglement_asymmetry(n, trace, status=status, with_std=True)
    finally:
        tc.set_dtype("complex64")
    _close(sp, sj, TOL[dtype])
    _close(stdp, stdj, TOL[dtype])
    assert p.renyi_entanglement_asymmetry(n, trace, batch=4).shape == ()


def test_asymmetry_std_is_population_deviation():
    with tct.set_dtype("complex128"):
        p = PFGS(4, filled=[0, 3], device="cpu")
        p.evol_hamiltonian(_bdg(4, 29)[2], 0.6)
        status = np.random.default_rng(3).uniform(-np.pi, np.pi, size=(9, 2))
        saq, rel = p.renyi_entanglement_asymmetry(2, [3], status=status, with_std=True)
        m = p.get_reduced_cmatrix([3])
        gamma = 2 * m - torch.eye(m.shape[0], dtype=m.dtype)
        zs = _np(p._charge_moment_core(gamma, torch.as_tensor(status, dtype=m.dtype), 2))
        assert abs(float(rel) - abs(-np.std(zs, ddof=0) / float(saq))) <= 1e-12
        assert abs(float(rel) - abs(-np.std(zs, ddof=1) / float(saq))) > 1e-6


def test_against_dense_oracle():
    """The port against its own ``FGSTestSimulator`` (complex128)."""
    L = 5
    h, d, m = _bdg(L, 13)
    with tct.set_dtype("complex128"):
        p = PFGS(L, filled=[0, 3], device="cpu")
        o = POracle(L, filled=[0, 3])
        p.evol_hp(0, 2, 0.5 + 0.2j)
        o.evol_hp(0, 2, 0.5 + 0.2j)
        p.evol_sp(1, 3, 0.3 - 0.4j)
        o.evol_sp(1, 3, 0.3 - 0.4j)
        p.evol_cp(4, 0.6)
        o.evol_cp(4, 0.6)
        p.evol_hamiltonian(m, 0.3)
        o.evol_hamiltonian(h, d, 0.3)
        _close(p.get_cmatrix(), o.get_cmatrix(), 1e-10)
        _close(p.get_cmatrix_majorana(), o.get_cmatrix_majorana(), 1e-10)
        for region in ([0, 1], [2, 3, 4]):
            _close(p.entropy(region), o.entropy(region), 1e-9)
            _close(p.renyi_entropy(region, 2), o.renyi_entropy(region, 2), 1e-9)
        angles = [0.3, -1.1]
        _close(p.charge_moment(angles, 2, [3, 4]), o.charge_moment(angles, 2, [3, 4]), 1e-2)
        _close(p.expectation_4body(0, 6, 2, 8), o.expectation_4body(0, 6, 2, 8), 1e-10)
        _close(p.occupation(2), o.occupation(2), 1e-10)
        q, qo = PFGS(L, filled=[1, 2], device="cpu"), POracle(L, filled=[1, 2])
        q.evol_hamiltonian(m, 0.7)
        qo.evol_hamiltonian(h, d, 0.7)
        _close(p.overlap(q), o.overlap(qo), 1e-10)
        kp, prob = p.cond_measure(2, 0.35, with_prob=True)
        ko, probo = o.cond_measure(2, 0.35, with_prob=True)
        assert float(kp) == ko
        _close(prob, probo, 1e-10)
        _close(p.get_cmatrix(), o.get_cmatrix(), 1e-9)
        p.evol_icp(1, 0.4)
        o.evol_icp(1, 0.4)
        _close(p.get_cmatrix(), o.get_cmatrix(), 1e-9)
        p.evol_ihamiltonian(m, 0.2)
        o.evol_ihamiltonian(h, d, 0.2)
        _close(p.get_cmatrix(), o.get_cmatrix(), 1e-9)


def test_oracle_against_jax_oracle():
    from tensorcircuit_ng_tpu.models.fgs import FGSTestSimulator as JOracle

    L = 4
    h, d, _ = _bdg(L, 17)
    o, jo = POracle(L, filled=[1]), JOracle(L, filled=[1])
    for s in (o, jo):
        s.evol_hp(0, 1, 0.3)
        s.evol_hamiltonian(h, d, 0.5)
    _close(o.get_cmatrix(), jo.get_cmatrix(), 1e-12)
    _close(o.get_ot_cmatrix(POracle.init_state([1], L)), jo.get_ot_cmatrix(JOracle.init_state([1], L)), 1e-12)
    assert abs(o.charge_moment([0.2, 0.9], 2, [3]) - jo.charge_moment([0.2, 0.9], 2, [3])) <= 1e-6


def _hopping_energy_jax(params, L, layers, m):
    chi = params[0] + 1j * params[1]
    f = JFGS(L, filled=list(range(0, L, 2)))
    k = 0
    for layer in range(layers):
        for i in range(layer % 2, L - 1, 2):
            f.evol_hp(i, i + 1, chi[k])
            k += 1
    return jnp.real(jnp.trace(jnp.asarray(m) @ f.get_cmatrix())) / 2


def test_grad_through_evol_hp_chain(dtype):
    L, layers = 6, 3
    nchi = sum(len(range(layer % 2, L - 1, 2)) for layer in range(layers))
    params = np.random.default_rng(21).normal(size=(2, nchi)) * 0.5
    _, _, m = _bdg(L, 23, pairing=False)
    jdt = jnp.float64 if dtype == "complex128" else jnp.float32
    ej, gj = jax.jit(jax.value_and_grad(_hopping_energy_jax), static_argnums=(1, 2))(
        jnp.asarray(params, dtype=jdt), L, layers, m)
    rdt = torch.float64 if dtype == "complex128" else torch.float32
    pt = torch.tensor(params, dtype=rdt, requires_grad=True)
    f = PFGS(L, filled=list(range(0, L, 2)), dtype=dtype)
    chi = torch.complex(pt[0], pt[1])
    k = 0
    for layer in range(layers):
        for i in range(layer % 2, L - 1, 2):
            f.evol_hp(i, i + 1, chi[k])
            k += 1
    mt = torch.as_tensor(m, dtype=getattr(torch, dtype))
    e = torch.real(torch.sum(mt * f.get_cmatrix().T)) / 2
    (gp,) = torch.autograd.grad(e, pt)
    _close(e, ej, 10 * TOL[dtype])
    _close(gp, gj, 10 * TOL[dtype])


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.FGSSimulator(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.FGSSimulator(3, filled=[0], device="cuda")
    assert tct.FGSCircuit is tct.FGSSimulator and tct.fgs.FGSTestSimulator is POracle
