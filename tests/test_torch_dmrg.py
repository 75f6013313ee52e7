"""``dmrg.py`` of the port against the JAX package's, on the CPU, as
``tests/test_dmrg.py`` holds the JAX one: the MPO builders, two-site DMRG of
the staggered XXZ chain against the JAX package's run from the same seed
and against exact diagonalization, the truncated solve, a given initial
state, ``mps_energy`` and ``mps_overlap``, and the DMRG tensors fed into
``MPSCircuit``, ``FiniteMPS``, ``Circuit(mps_inputs=)`` and
``DMCircuit(mps_inputs=)``.

Tolerances: the sweeps run in complex128 in both packages: energies 1e-10
between them, 1e-7 to the exact ground energy (``tests/test_dmrg.py``'s);
the consumers at complex64 1e-5 and complex128 1e-10 (1e-9 for a sum of 15
terms of size ~1).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import dmrg as JD
from tensorcircuit_ng_tpu import quantum as jqu

D = tct.dmrg
TOL = {"complex64": 1e-5, "complex128": 1e-10}
Z = np.diag([1.0, -1.0])


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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _xxz_dense(n, delta, stag):
    ls, ws = [], []
    for i in range(n - 1):
        for p, w in ((1, 1.0), (2, 1.0), (3, delta)):
            l = [0] * n
            l[i] = l[i + 1] = p
            ls.append(l)
            ws.append(w)
    for i in range(n):
        l = [0] * n
        l[i] = 3
        ls.append(l)
        ws.append(stag * (-1) ** i)
    return np.asarray(jqu.PauliStringSum2Dense(ls, ws, numpy=True))


def test_mpo_builders_match_jax():
    for args in ((5, 1.0, 0.0), (6, 1.4, 0.2)):
        for a, b in zip(D.xxz_mpo(*args), JD.xxz_mpo(*args)):
            np.testing.assert_array_equal(a, b)
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    terms = ([(x, x, 0.5)], [(Z, lambda i: 0.1 * i)])
    for a, b in zip(D.nn_mpo(4, *terms), JD.nn_mpo(4, *terms)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def xxz8():
    """The JAX package's DMRG of the staggered XXZ chain at n=8 and its
    exact ground energy."""
    n, delta, stag = 8, 1.4, 0.2
    mpo = JD.xxz_mpo(n, delta, stag)
    e16, a16 = JD.dmrg(mpo, chi=16, sweeps=4)
    e4, a4 = JD.dmrg(mpo, chi=4, sweeps=4)
    return {"mpo": mpo, "e16": e16, "a16": a16, "e4": e4, "a4": a4,
            "exact": float(np.linalg.eigvalsh(_xxz_dense(n, delta, stag))[0])}


def test_dmrg_xxz_matches_jax_and_exact(cpu, xxz8):
    e, a = D.dmrg(D.xxz_mpo(8, 1.4, 0.2), chi=16, sweeps=4)
    assert all(t.dtype == torch.complex128 and t.device.type == "cpu" for t in a)
    assert [tuple(t.shape) for t in a] == [t.shape for t in xxz8["a16"]]
    np.testing.assert_allclose(e, xxz8["e16"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(e, xxz8["exact"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(D.mps_energy(a, xxz8["mpo"]), JD.mps_energy(xxz8["a16"], xxz8["mpo"]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(D.mps_energy(a, xxz8["mpo"]), xxz8["exact"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(abs(D.mps_overlap(a, a)), 1.0, rtol=0, atol=1e-8)
    # the same ground state up to a phase
    np.testing.assert_allclose(abs(D.mps_overlap(a, xxz8["a16"])), 1.0, rtol=0, atol=1e-8)
    ov = D.mps_overlap(xxz8["a4"], [_np(t) for t in a])
    np.testing.assert_allclose(ov, JD.mps_overlap(xxz8["a4"], [_np(t) for t in a]), rtol=0, atol=1e-12)


def test_truncated_dmrg_and_given_init_match_jax(cpu, xxz8):
    e4, a4 = D.dmrg(D.xxz_mpo(8, 1.4, 0.2), chi=4, sweeps=4)
    np.testing.assert_allclose(e4, xxz8["e4"], rtol=0, atol=1e-10)
    assert e4 >= xxz8["exact"] - 1e-9 and e4 - xxz8["exact"] < 0.05
    assert max(t.shape[2] for t in a4) == 4
    # from a given state: the JAX package's chi=4 tensors, one more sweep
    init = [np.asarray(t) for t in xxz8["a4"]]
    e_t, _ = D.dmrg(xxz8["mpo"], chi=8, sweeps=1, init=init)
    e_j, _ = JD.dmrg(xxz8["mpo"], chi=8, sweeps=1, init=init)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-10)
    e_s, _ = D.dmrg(xxz8["mpo"], chi=8, sweeps=2, seed=3)
    np.testing.assert_allclose(e_s, JD.dmrg(xxz8["mpo"], chi=8, sweeps=2, seed=3)[0], rtol=0, atol=1e-10)


def test_dmrg_tensors_feed_the_simulators(dtype):
    """``tests/test_dmrg.py::test_dmrg_mps_feeds_mpscircuit``, and the same
    tensors through FiniteMPS, Circuit(mps_inputs=) and
    DMCircuit(mps_inputs=), on both packages."""
    n = 6
    e, a = D.dmrg(D.xxz_mpo(n, 1.0, 0.0), chi=8, sweeps=3)
    ej, aj = JD.dmrg(JD.xxz_mpo(n, 1.0, 0.0), chi=8, sweeps=3)
    np.testing.assert_allclose(e, ej, rtol=0, atol=1e-10)
    tol = TOL[dtype]
    h = _xxz_dense(n, 1.0, 0.0)
    m = tct.MPSCircuit(n, tensors=a)
    psi = _np(m.wavefunction())
    assert m.tensors[0].dtype == tct.config.torch_dtype()
    np.testing.assert_allclose(np.real(psi.conj() @ h @ psi), e, rtol=0, atol=10 * tol)
    mj = tc.MPSCircuit(n, tensors=[t.astype(np.complex64 if dtype == "complex64" else np.complex128) for t in aj])
    np.testing.assert_allclose(_np(m.expectation_ps(z=[1, 2])), np.asarray(mj.expectation_ps(z=[1, 2])), rtol=0,
                               atol=tol)
    c = tct.Circuit(n, mps_inputs=a)
    np.testing.assert_allclose(np.abs(np.vdot(_np(c.state()), psi)), 1.0, rtol=0, atol=10 * tol)
    corr = tct.FiniteMPS(a).measure_two_body_correlator(Z, Z, 2, range(n))
    corr_j = tc.FiniteMPS(mj.tensors).measure_two_body_correlator(Z, Z, 2, range(n))
    for j in range(n):
        want = 1.0 if j == 2 else _np(c.expectation_ps(z=[2, j])).real
        np.testing.assert_allclose(_np(corr[j]).real, want, rtol=0, atol=10 * tol)
        np.testing.assert_allclose(_np(corr[j]), np.asarray(corr_j[j]), rtol=0, atol=10 * tol)
    dm = tct.DMCircuit(n, mps_inputs=a)
    np.testing.assert_allclose(_np(dm.densitymatrix()), np.outer(psi, psi.conj()), rtol=0, atol=tol)


def test_dmrg_runs_on_the_configured_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            D.dmrg(D.xxz_mpo(4), chi=4, sweeps=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            D.mps_energy([np.ones((1, 2, 1))] * 2, D.xxz_mpo(2))
    e, a = D.dmrg(D.xxz_mpo(4), chi=4, sweeps=1, device="cpu")
    assert a[0].device.type == "cpu" and isinstance(e, float)
    assert isinstance(D.mps_overlap(a, a, device="cpu"), complex)
