"""The port's detector machinery (``models/detectors.py``) against the JAX
package's.

``sample_detector`` with the same ``status``/``statusc`` gives the JAX
package's detector and observable bits on the four channel kinds whose
item sets the two packages keep alike (``general_kraus``, amplitude and
phase damping, the depolarizing family, ``unitary_kraus`` without
``prob``), and on fused layers: at complex128 every shot; at complex64
every shot whose uniforms lie 1e-6 or more from the cdf boundaries they
were searched in (float32 marginals summed in another order; none was
nearer here).  ``detector_probabilities_exact`` agrees with the JAX
package's (complex64 1e-5, complex128 1e-10) on programs whose detectors
read only records measured before them, each once.  F12 (Queue 3 of
``ROADMAP.md``): on its two probes the port's exact value equals its
trajectories, and the JAX package's wrong 0 and 1 are asserted as
records.  A ``unitary_kraus(prob=...)`` program (the port keeps √p_i U_i,
F5) is held to the port's ``DMCircuit`` (1e-6) and its trajectories (5σ).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch.models import detectors as pdet

TOL = {"complex64": 1e-5, "complex128": 1e-10}
BRACKET = 1e-6
SIGMAS = 5.0
KINDS = ["general_kraus", "amplitudedamping", "phasedamping", "depolarizing", "unitary_kraus"]
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


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


def noise(c, kind, q):
    """One channel site of ``kind`` on qubit q."""
    if kind == "general_kraus":
        c.general_kraus([np.sqrt(0.85) * np.eye(2), np.sqrt(0.15) * X], q)
    elif kind == "amplitudedamping":
        c.amplitudedamping(q, gamma=0.2, p=1.0)
    elif kind == "phasedamping":
        c.phasedamping(q, gamma=0.3)
    elif kind == "depolarizing":
        c.depolarizing(q, px=0.04, py=0.03, pz=0.05)
    else:  # unitary_kraus without prob: normalized Kraus operators
        c.unitary_kraus([np.sqrt(0.8) * np.eye(2), np.sqrt(0.2) * X], q)


def repetition(mod, kind, rounds=2, between=True, **kw):
    """The 3-bit repetition code on 5 qubits (data 0-2, measure 3-4), the
    data in |1>, noise of ``kind`` on the data each round, measure and
    reset of the measure qubits (a reset is a record too); detectors
    between rounds (``between``) or all at the end from absolute records."""
    c = mod.Circuit(5, **kw)
    for q in range(3):
        c.x(q)
    for r in range(rounds):
        for q in range(3):
            noise(c, kind, q)
        c.cnot(0, 3)
        c.cnot(1, 3)
        c.cnot(1, 4)
        c.cnot(2, 4)
        c.h(2)
        c.rx(1, theta=0.2)
        c.h(2)
        c.measure_instruction(3, 4)
        c.reset_instruction(3, 4)
        if between:
            if r:
                c.detector_instruction(-4, -8)
                c.detector_instruction(-3, -7)
            else:
                c.detector_instruction(-4)
                c.detector_instruction(-3)
    c.measure_instruction(0, 1, 2)
    if between:
        c.detector_instruction(-1, -2)
        c.detector_instruction(-2, -3)
    else:
        m = 4 * rounds
        c.detector_instruction(0)
        c.detector_instruction(1)
        for r in range(1, rounds):
            c.detector_instruction(4 * r, 4 * (r - 1))
            c.detector_instruction(4 * r + 1, 4 * (r - 1) + 1)
        c.detector_instruction(m, m + 1)
        c.detector_instruction(-3, -2)
    c.observable_instruction(-1)
    return c


def statuses(c, shots, seed):
    rng = np.random.default_rng(seed)
    return rng.random((shots, max(c._num_measures(), 1))), rng.random((shots, max(c._num_channels(), 1)))


def assert_bits_equal(dtype, got, want, margin):
    """Equal rows; at complex64 a row may differ only where a uniform lay
    within ``BRACKET`` of a cdf boundary."""
    differ = np.any(got != want, axis=1)
    if dtype == "complex128":
        assert not differ.any()
    else:
        assert not (differ & (margin > BRACKET)).any()


#: every kind at complex64, the mixed-unitary two at complex128 (the JAX
#: side compiles each program's vmapped trajectory anew: 2-14 s a case, the
#: most for general Kraus channels at complex128)
CASES = [(k, "complex64") for k in KINDS] + [("depolarizing", "complex128"), ("unitary_kraus", "complex128")]


@pytest.fixture
def case(request):
    kind, dt = request.param
    tc.set_dtype(dt)
    try:
        with tct.set_dtype(dt), tct.set_device("cpu"):
            yield kind, dt
    finally:
        tc.set_dtype("complex64")


@pytest.mark.parametrize("case", CASES, indirect=True, ids=[f"{k}-{d}" for k, d in CASES])
def test_detectors_against_jax(case):
    """The trajectories' bits with the same statuses, and the exact rates,
    on one program a channel kind (its detectors read records measured
    before them, each once)."""
    kind, dtype = case
    j, p = repetition(tc, kind, between=False), repetition(tct, kind, between=False)
    assert (p._num_measures(), p._num_channels()) == (j._num_measures(), j._num_channels()) == (11, 6)
    st, sc = statuses(j, 96, 3)
    jd, jo = j.sample_detector(96, status=st, statusc=sc, with_observable=True)
    pd, po, margin = p.sample_detector(96, status=st, statusc=sc, with_observable=True, with_margin=True)
    assert pd.dtype == torch.int32 and pd.shape == (96, 6) and po.shape == (96, 1)
    assert margin.dtype == torch.float64 and margin.shape == (96,)
    got = np.concatenate([pd.numpy(), po.numpy()], axis=1)
    want = np.concatenate([np.asarray(jd), np.asarray(jo)], axis=1)
    assert_bits_equal(dtype, got, want, margin.numpy())
    assert 0 < got.mean() < 1
    rate = p.detector_probabilities(96, status=st, statusc=sc)
    assert rate.dtype == torch.float32
    np.testing.assert_allclose(rate.numpy(), want[:, :6].mean(axis=0), atol=1e-6)
    exact = p.detector_probabilities_exact()
    assert exact.dtype == (torch.float64 if dtype == "complex128" else torch.float32) and exact.shape == (6,)
    np.testing.assert_allclose(exact.numpy(), np.asarray(j.detector_probabilities_exact()), atol=TOL[dtype])
    assert 0 < exact.numpy().max() < 1


def fused_program(mod, **kw):
    """A detector program on fused layers (h_layer, rzz_product, rx_layer)
    with channel sites between them."""
    c = mod.Circuit(5, **kw)
    c.h_layer()
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4)]
    c.rzz_product(pairs, np.array([0.3, -0.2, 0.5, 0.1]))
    c.depolarizing(1, px=0.05, py=0.05, pz=0.05)
    c.rx_layer(np.array([0.1, 0.2, 0.3, 0.4, 0.5]))
    c.measure_instruction(0, 1)
    c.detector_instruction(-1, -2)
    c.amplitudedamping(3, gamma=0.3, p=1.0)
    c.rzz_product(pairs, np.array([0.1, 0.2, 0.3, 0.4]))
    c.rx_layer(np.array([0.5, 0.4, 0.3, 0.2, 0.1]))
    c.measure_instruction(2, 3, 4)
    c.detector_instruction(-1)
    c.detector_instruction(-2, -3)
    c.observable_instruction(-1, -3)
    return c


def test_sample_detector_fused_layers():
    dtype = "complex128"
    tc.set_dtype(dtype)
    with tct.set_dtype(dtype), tct.set_device("cpu"):
        j, p = fused_program(tc), fused_program(tct)
        st, sc = statuses(j, 64, 5)
        jd, jo = j.sample_detector(64, status=st, statusc=sc, with_observable=True)
        pd, po, margin = p.sample_detector(64, status=st, statusc=sc, with_observable=True, with_margin=True)
    tc.set_dtype("complex64")
    got = np.concatenate([pd.numpy(), po.numpy()], axis=1)
    assert_bits_equal(dtype, got, np.concatenate([np.asarray(jd), np.asarray(jo)], axis=1), margin.numpy())


def test_chunked_shots_equal_one_chunk(monkeypatch):
    with tct.set_device("cpu"):
        p = repetition(tct, "depolarizing")
        st, sc = statuses(p, 50, 8)
        whole = p.sample_detector(50, status=st, statusc=sc, with_observable=True, with_margin=True)
        monkeypatch.setattr(pdet, "detector_chunk", lambda shots, dim, dtype, device: 7)
        parts = p.sample_detector(50, status=st, statusc=sc, with_observable=True, with_margin=True)
    # the bits equal; a margin is a float sum whose BLAS order may follow
    # the chunk's size
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    assert (whole[2] - parts[2]).abs().max().item() <= 1e-6


def test_detector_chunk_budget():
    dim = 2**17
    chunk = pdet.detector_chunk(1024, dim, torch.complex64, torch.device("cpu"))
    assert 1 <= chunk <= 1024
    assert pdet.detector_chunk(10**12, dim, torch.complex64, torch.device("cpu")) < 10**12


def test_sample_detector_draws_without_status():
    with tct.set_device("cpu"):
        p = repetition(tct, "general_kraus")
        tct.backend.set_random_state(3)
        a = p.sample_detector(32)
        tct.backend.set_random_state(3)
        b = p.sample_detector(32)
    assert a.shape == (32, 6) and torch.equal(a, b) and set(a.unique().tolist()) <= {0, 1}


def test_exact_probabilities_fused_layers():
    """Fused one-qubit layers and zz products unfold in the exact path
    (complex128)."""
    def prog(mod, **kw):
        c = mod.Circuit(4, **kw)
        c.h_layer()
        c.rzz_product([(0, 1), (2, 3)], np.array([0.4, -0.7]))
        c.depolarizing(0, px=0.1, py=0.0, pz=0.05)
        c.h_layer()
        c.measure_instruction(0, 1, 2, 3)
        c.detector_instruction(0, 1)
        c.detector_instruction(2, 3)
        c.detector_instruction(1, 2)
        return c

    tc.set_dtype("complex128")
    want = np.asarray(prog(tc).detector_probabilities_exact())
    tc.set_dtype("complex64")
    with tct.set_dtype("complex128"), tct.set_device("cpu"):
        got = prog(tct).detector_probabilities_exact().numpy()
    np.testing.assert_allclose(got, want, atol=TOL["complex128"])


def f12_probes(mod, **kw):
    c1 = mod.Circuit(2, **kw)
    c1.x(0)
    c1.measure_instruction(0)
    c1.detector_instruction(-1)
    c1.measure_instruction(1)
    c2 = mod.Circuit(2, **kw)
    c2.x(0)
    c2.measure_instruction(0)
    c2.detector_instruction(-1, -1)
    return c1, c2


def test_f12_exact_equals_trajectories():
    """Queue 3 F12: the port's exact rates equal its trajectories on both
    probes; the JAX package's exact path reads the wrong records (recorded)."""
    j1, j2 = f12_probes(tc)
    with tct.set_device("cpu"):
        p1, p2 = f12_probes(tct)
        for c, fire in ((p1, 1), (p2, 0)):
            traj = c.sample_detector(4, status=np.full((4, c._num_measures()), 0.3), statusc=np.zeros((4, 1)))
            assert traj.numpy().ravel().tolist() == [fire] * 4
            exact = c.detector_probabilities_exact()
            assert exact.numpy().tolist() == pytest.approx([float(fire)], abs=1e-6)
            assert c.detector_probabilities(4).numpy().tolist() == pytest.approx([float(fire)])
    assert np.asarray(j1.sample_detector(4, status=np.full((4, 2), 0.3), statusc=np.zeros((4, 1)))).ravel().tolist() \
        == [1] * 4
    assert np.asarray(j1.detector_probabilities_exact()).tolist() == pytest.approx([0.0], abs=1e-6)
    assert np.asarray(j2.sample_detector(4, status=np.full((4, 1), 0.3), statusc=np.zeros((4, 1)))).ravel().tolist() \
        == [0] * 4
    assert np.asarray(j2.detector_probabilities_exact()).tolist() == pytest.approx([1.0], abs=1e-6)


def test_exact_rec_out_of_range_raises():
    with tct.set_device("cpu"):
        c = tct.Circuit(2)
        c.measure_instruction(0)
        c.detector_instruction(-2)
        with pytest.raises(IndexError, match="out of range"):
            c.detector_probabilities_exact()
        c = tct.Circuit(2)
        c.detector_instruction(0)
        c.measure_instruction(0)
        with pytest.raises(IndexError):
            c.detector_probabilities_exact()


def test_exact_f12_program_between_rounds():
    """Detectors between rounds: exact against the port's own trajectories
    (5 sigma at 4096 shots) where the JAX package's resolution is wrong."""
    with tct.set_device("cpu"), tct.set_dtype("complex128"):
        c = repetition(tct, "amplitudedamping")
        exact = c.detector_probabilities_exact().numpy()
        rate = c.detector_probabilities(4096, *statuses(c, 4096, 1)).numpy()
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1e-4) / 4096)
    assert np.all(np.abs(rate - exact) <= SIGMAS * sigma)
    assert exact.max() > 0.05


def test_prob_channel_held_to_dmcircuit():
    """unitary_kraus(prob=...): the port's channel item keeps sqrt(p_i) U_i,
    so the exact rate equals its DMCircuit's and its trajectories follow
    the channel drawn from (Queue 3 F5)."""
    with tct.set_device("cpu"), tct.set_dtype("complex128"):
        c = tct.Circuit(3)
        c.h(1)
        c.unitary_kraus([np.eye(2), X, Z], 0, prob=[0.6, 0.3, 0.1])
        c.cnot(1, 2)
        c.unitary_kraus([np.eye(2), X], 2, prob=[0.75, 0.25])
        c.cnot(0, 1)
        c.measure_instruction(0, 1, 2)
        c.detector_instruction(0)
        c.detector_instruction(1, 2)
        exact = c.detector_probabilities_exact().numpy()
        rho = c.to_dm_circuit()
        want = [(1 - rho.expectation_ps(z=[0]).real.item()) / 2,
                (1 - rho.expectation_ps(z=[1, 2]).real.item()) / 2]
        np.testing.assert_allclose(exact, want, atol=1e-6)
        np.testing.assert_allclose(exact, [0.3, 0.4], atol=1e-6)
        rate = c.detector_probabilities(4096, *statuses(c, 4096, 2)).numpy()
    assert np.all(np.abs(rate - exact) <= SIGMAS * np.sqrt(exact * (1 - exact) / 4096))


def test_qudit_exact_raises():
    with tct.set_device("cpu"):
        c = tct.Circuit(2, dim=3)
        c.measure_instruction(0)
        c.detector_instruction(-1)
        with pytest.raises(NotImplementedError):
            c.detector_probabilities_exact()
        assert c.sample_detector(3, status=np.zeros((3, 1)), statusc=np.zeros((3, 1))).tolist() == [[0]] * 3


def test_no_detectors():
    with tct.set_device("cpu"):
        c = tct.Circuit(2)
        c.h(0)
        det, obs = c.sample_detector(5, with_observable=True)
        assert det.shape == (5, 0) and obs.shape == (5, 0)
        assert c.detector_probabilities_exact().shape == (0,)
