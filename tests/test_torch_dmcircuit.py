"""``DMCircuit`` of the port against the JAX package's, on the CPU, method
by method with the channels exact: the density matrix (from a state, from
a density-matrix input, of a Monte-Carlo circuit's QIR), its purity,
amplitudes, probabilities, the projected subsystem, the collapse of
``cond_measurement`` and its replay, ``measure_jit``, ``expectation`` and
``expectation_ps``, the inherited ``sample`` and ``sample_expectation_ps``,
the exact channel methods, ``to_circuit``, the checks, and the trajectory
mean of ``Circuit`` against the JAX ``DMCircuit`` (n=5, 400 trajectories,
3 sigma + 1e-3, as ``examples/noisy_qml_training.py`` checks).  The parts
once left to Queue 1 items 13-14 (``get_dm_as_quoperator``,
``mps_inputs=``) against ``densitymatrix()`` and the dense input's ρ.

Tolerances: complex64 1e-5, complex128 1e-10, n <= 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


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


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _dm(mod, n=4, channels=True, **kw):
    """Fused layers, dense and diagonal gates, a wide rzm and multicz, and
    (with ``channels``) every kind of exact channel item."""
    rng = np.random.default_rng(21)
    c = mod.DMCircuit(n, **kw)
    c.h_layer()
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], rng.normal(size=n - 1), rng.normal(size=n))
    c.ry_layer(rng.normal(size=n))
    c.cnot(0, 2)
    c.rzz(1, 3, theta=0.7)
    c.rzm(0, 1, 3, theta=0.4)
    c.multicz(0, 1, 2)
    if channels:
        c.depolarizing(1, px=0.1, py=0.05, pz=0.08)
        c.amplitudedamping(2, gamma=0.3, p=0.8)
        c.apply_general_kraus(mod.channels.phasedampingchannel(0.2), [(3,)])
        c.unitary_kraus([np.eye(2), X], 0, prob=[0.7, 0.3])
        c.generaldepolarizing(0, 3, p=0.02, num_qubits=2)
        c.thermalrelaxation(1, t1=100.0, t2=150.0, time=20.0)
    c.rx(2, theta=0.3)
    return c


def test_density_matrix_matches_jax(dtype):
    """ρ (flat and square), its trace, purity, ``wavefunction`` of a pure
    ρ, ``amplitude``, ``probability``, ``projected_subsystem``,
    ``expectation`` and ``expectation_ps`` (x/y/z and ``ps``)."""
    tol = TOL[dtype]
    c, jc = _dm(tct), _dm(tc)
    rho = c.densitymatrix()
    _close(rho, jc.densitymatrix(), tol)
    _close(c.state(form="flat"), jnp.reshape(jc.densitymatrix(), (-1,)), tol)
    _close(c.state(reuse=False), rho, tol)
    assert abs(torch.trace(rho).real.item() - 1) < 10 * tol
    _close(c.purity(), jc.purity(), tol)
    assert c.purity().item() < 1
    for l in ("0110", [1, 0, 1, 1]):
        _close(c.amplitude(l), jc.amplitude(l), tol)
    _close(c.probability(), jc.probability(), tol)
    _close(c.projected_subsystem(np.array([1, 0, 0, 1]), [1, 2]), jc.projected_subsystem(jnp.array([1, 0, 0, 1]), [1, 2]),
           tol)
    _close(c.expectation((Z, [1]), (X, [3])), jc.expectation((Z, [1]), (X, [3])), tol)
    _close(c.expectation_ps(x=[0], y=[2], z=[3]), jc.expectation_ps(x=[0], y=[2], z=[3]), tol)
    _close(c.expectation_ps(ps=[3, 1, 0, 3]), jc.expectation_ps(ps=[3, 1, 0, 3]), tol)
    pure, jpure = _dm(tct, channels=False), _dm(tc, channels=False)
    w, jw = _np(pure.wavefunction()), np.asarray(jpure.wavefunction())
    _close(np.abs(np.vdot(w, jw)), 1.0, 10 * tol if dtype == "complex128" else 1e-4)


def test_dm_inputs_and_monte_carlo_qir_match_jax(dtype):
    """A pure-state input, a density-matrix input, and ``to_dm_circuit`` of
    a ``Circuit`` whose channel items came from trajectories (they become
    exact channels); ``to_circuit`` keeps the unitary part; ``copy`` and
    the QIR round trip."""
    tol = TOL[dtype]
    n = 4
    rng = np.random.default_rng(4)
    v = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    v = (v / np.linalg.norm(v)).astype(np.dtype(dtype))
    rho0 = np.outer(v, v.conj())
    for kw, jkw in (({"inputs": v}, {"inputs": jnp.asarray(v)}), ({"dminputs": rho0}, {"dminputs": jnp.asarray(rho0)})):
        _close(_dm(tct, **kw).densitymatrix(), _dm(tc, **jkw).densitymatrix(), tol)

    def mc(mod):
        c = mod.Circuit(n)
        c.h(0)
        c.cnot(0, 1)
        c.amplitudedamping(1, gamma=0.4, p=0.9, status=0.8)
        c.depolarizing(2, px=0.2, py=0.1, pz=0.1, status=0.1)
        c.ry(3, theta=0.5)
        return c

    d, jd = mc(tct).to_dm_circuit(), mc(tc).to_dm_circuit()
    assert isinstance(d, tct.DMCircuit) and d.device == torch.device("cpu")
    _close(d.densitymatrix(), jd.densitymatrix(), tol)
    _close(d.copy().densitymatrix(), jd.densitymatrix(), tol)
    _close(tct.DMCircuit.from_qir(d.to_qir(), {"nqubits": n, "device": "cpu"}).densitymatrix(), jd.densitymatrix(), tol)
    back, jback = _dm(tct).to_circuit(), _dm(tc).to_circuit()
    assert isinstance(back, tct.Circuit)
    _close(back.state(), jback.state(), tol)


@pytest.mark.parametrize("s", [0.2, 0.7])
def test_cond_measurement_and_measure_jit_match_jax(dtype, s):
    """The collapse of ``cond_measurement`` (its outcome, ρ after it, and
    its replay by ``copy``), ``measure_jit`` with a status, and the
    inherited ``sample`` on both routes and ``sample_expectation_ps``
    (exact and with shots) through ``probability``."""
    tol = TOL[dtype]
    c, jc = _dm(tct), _dm(tc)
    m = c.cond_measurement(1, status=s)
    jm = jc.cond_measurement(1, status=jnp.asarray(s))
    assert m.dtype == torch.int32 and int(m) == int(jm)
    c.cnot(1, 0)
    jc.cnot(1, 0)
    _close(c.densitymatrix(), jc.densitymatrix(), tol)
    _close(c.copy().densitymatrix(), jc.densitymatrix(), tol)
    st = np.array([s, 1 - s, 0.5 * s], dtype=RDT[dtype])
    got, want = c.measure_jit(0, 2, 3, with_prob=True, status=st), jc.measure_jit(0, 2, 3, with_prob=True,
                                                                                   status=jnp.asarray(st))
    assert _np(got[0]).tolist() == np.asarray(want[0]).tolist()
    _close(got[1], want[1], tol)
    u = np.random.default_rng(3).random(64).astype(RDT[dtype])
    assert _np(c.sample(64, allow_state=True, status=u, format="sample_int")).tolist() == np.asarray(
        jc.sample(64, allow_state=True, status=jnp.asarray(u), format="sample_int")).tolist()
    big = np.random.default_rng(4).random((16, 4)).astype(RDT[dtype])
    assert _np(c.sample(16, status=big, format="sample_int")).tolist() == np.asarray(
        jc.sample(16, status=jnp.asarray(big), format="sample_int")).tolist()
    _close(c.sample_expectation_ps(x=[0], z=[2]), jc.sample_expectation_ps(x=[0], z=[2]), tol)
    _close(c.sample_expectation_ps(y=[3], shots=64, status=u), jc.sample_expectation_ps(y=[3], shots=64,
                                                                                        status=jnp.asarray(u)), tol)


def test_channel_methods_and_checks(cpu):
    """Each channel method of ``CHANNEL_NAMES`` on a ``DMCircuit`` applies
    the channel exactly (its ρ against ``evol_kraus`` of the one-qubit ρ),
    ``apply_general_kraus_delayed``, ``check_kraus`` and
    ``check_density_matrix``, ``unitary_kraus`` returning -1."""
    params = {"depolarizing": {"px": 0.1, "py": 0.2, "pz": 0.05}, "generaldepolarizing": {"p": 0.05},
              "isotropicdepolarizing": {"p": 0.2}, "amplitudedamping": {"gamma": 0.3, "p": 0.6},
              "phasedamping": {"gamma": 0.4}, "reset": {}, "thermalrelaxation": {"t1": 10.0, "t2": 8.0, "time": 3.0}}
    assert set(params) == set(tct.channels.CHANNEL_NAMES)
    rho1 = np.array([[0.6, 0.3 - 0.2j], [0.3 + 0.2j, 0.4]])
    for name, kw in params.items():
        c = tct.DMCircuit(1, dminputs=rho1)
        getattr(c, name)(0, **kw)
        want = tct.channels.evol_kraus(rho1.astype(np.complex64), tct.channels.CHANNEL_NAMES[name](**kw))
        _close(c.densitymatrix(), want, 1e-6)
        assert c.check_kraus(tct.channels.CHANNEL_NAMES[name](**kw))
    c = tct.DMCircuit(2)
    tct.DMCircuit.apply_general_kraus_delayed(tct.channels.resetchannel(), name="rst")(c, 1)
    assert c.to_qir()[-1]["name"] == "rst"
    assert int(c.unitary_kraus([np.eye(2), X], 0, prob=[0.5, 0.5])) == -1
    tct.DMCircuit.check_density_matrix(c.densitymatrix())
    with pytest.raises(ValueError, match="trace"):
        tct.DMCircuit.check_density_matrix(2 * c.densitymatrix())
    with pytest.raises(ValueError, match="trace"):
        tct.DMCircuit(1, dminputs=2 * rho1).densitymatrix(check=True)


def test_trajectory_mean_matches_jax_dmcircuit(cpu):
    """The mean of <Z_0> over 400 Monte-Carlo trajectories of the port's
    ``Circuit`` under a ``NoiseConf`` lies within 3 sigma + 1e-3 of the
    JAX ``DMCircuit``'s exact value of the same circuit and noise."""
    n, nmc = 5, 400
    rng = np.random.default_rng(9)
    w = rng.normal(size=(2, n))

    def build(mod):
        c = mod.Circuit(n)
        for q in range(n):
            c.ry(q, theta=w[0, q])
        for q in range(n - 1):
            c.cnot(q, q + 1)
        for q in range(n):
            c.rx(q, theta=w[1, q])
        return c

    def conf(mod):
        nc = mod.NoiseConf()
        nc.add_noise("cnot", mod.channels.depolarizingchannel(0.02, 0.02, 0.02))
        nc.add_noise("rx", mod.channels.amplitudedampingchannel(0.1, 1.0))
        return nc

    exact = float(jnp.real(tc.circuit_with_noise(build(tc).to_dm_circuit(), conf(tc)).expectation_ps(z=[0])))
    c, nc = build(tct), conf(tct)
    st = rng.random((nmc, nc.channel_count(c))).astype(np.float32)
    vals = np.array([tct.circuit_with_noise(c, nc, status=st[k]).expectation_ps(z=[0]).real.item() for k in range(nmc)])
    sigma = vals.std(ddof=1) / np.sqrt(nmc)
    assert abs(vals.mean() - exact) <= 3 * sigma + 1e-3
    mean = c.expectation_ps(z=[0], noise_conf=nc, status=st[:40])
    assert abs(mean.item() - vals[:40].mean()) < 1e-6
    _close(tct.circuit_with_noise(c.to_dm_circuit(), nc).expectation_ps(z=[0]).real, exact, 1e-5)


def test_unported_parts_raise(cpu):
    """The parts once left to Queue 1 items 13-14 now work:
    ``get_dm_as_quoperator`` is ``densitymatrix()`` as a QuOperator, and
    ``mps_inputs=`` starts from the MPS state's pure ρ (the JAX package's
    ``DMCircuit`` of the dense input; its own drops ``mps_inputs``, Queue 3
    F7); ``DMCircuit2`` (item 12's doubled network, ported) is a
    ``DMCircuit`` that keeps its dense readouts up to 14 qubits."""
    d2, d = tct.DMCircuit2(3), tct.DMCircuit(3)
    for c in (d2, d):
        c.h(0)
        c.cnot(0, 1)
        c.depolarizing(1, px=0.1, py=0.0, pz=0.0)
    assert isinstance(d2, tct.DMCircuit)
    _close(d2.expectation((Z, [1])), d.expectation((Z, [1])), 1e-6)
    _close(d2.probability(), d.probability(), 1e-6)
    qo = d.get_dm_as_quoperator()
    assert qo.out_dims == qo.in_dims == (2, 2, 2)
    _close(qo.eval_matrix(), d.densitymatrix(), 0)
    tensors = [np.array([[[1.0], [1.0]]]) / np.sqrt(2), np.array([[[0.0], [1.0]]])]
    want = tc.DMCircuit(2, inputs=jnp.asarray([0.0, 1.0, 0.0, 1.0]) / np.sqrt(2)).densitymatrix()
    _close(tct.DMCircuit(2, mps_inputs=tensors).densitymatrix(), want, 1e-6)
    assert tct.DensityMatrixCircuit is tct.DMCircuit
    for name in ("channels", "noisemodel", "NoiseConf", "circuit_with_noise", "DMCircuit"):
        assert hasattr(tc, name) and hasattr(tct, name), name
