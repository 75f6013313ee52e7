"""The noise API of the port against the JAX package, on the CPU: the
channel factories of ``ops/channels.py`` (float and tensor parameters,
completeness), the representation transforms, the Monte-Carlo channel
methods of ``Circuit``, ``NoiseConf`` with ``circuit_with_noise`` and the
two noisy estimators, the three ``noise_conf=`` entry points, the noisy TFIM
value and gradient (the per-layer path), the noise instructions, the state
kept for a QIR prefix, the two status checks, and ``chip_smoke.py``'s
phase 14 at a small size.

Inputs and statuses are numpy-seeded and handed to both packages, at
complex64 (values within 1e-5) and complex128 (1e-10), n <= 8.  A branch
is an index: equal in both packages.  The JAX package's estimators ``vmap``
the trajectories; the port runs them one at a time, so the means agree to
the tolerance of the sums.  ``Circuit.sample_expectation_ps(noise_conf=)``
of the JAX package raises TypeError (ROADMAP Queue 3, F4), so the port's
method is held against the JAX ``sample_expectation_ps_noisfy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import branch_miss, channel_branches, tfim_circuit
from tensorcircuit_ng_tpu import noisemodel as jn
from tensorcircuit_ng_tpu_torch import noisemodel as tn
from tensorcircuit_ng_tpu_torch.models.basecircuit import BaseCircuit

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
    """Both packages at the dtype, the port's circuits on the CPU."""
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


def _unitary(rng, dim):
    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    return np.linalg.qr(a)[0]


# ---------------------------------------------------------------------------
# ops/channels.py
# ---------------------------------------------------------------------------

_CHANNELS = {
    "depolarizing": lambda ch: ch.depolarizingchannel(0.1, 0.05, 0.02),
    "generaldepolarizing": lambda ch: ch.generaldepolarizingchannel(0.02, 1),
    "generaldepolarizing_2q": lambda ch: ch.generaldepolarizingchannel(0.01, 2),
    "generaldepolarizing_list": lambda ch: ch.generaldepolarizingchannel([0.01, 0.02, 0.03], 1),
    "isotropicdepolarizing_2q": lambda ch: ch.isotropicdepolarizingchannel(0.1, 2),
    "amplitudedamping": lambda ch: ch.amplitudedampingchannel(0.3, 0.8),
    "phasedamping": lambda ch: ch.phasedampingchannel(0.25),
    "reset": lambda ch: ch.resetchannel(),
    "thermalrelaxation_kraus": lambda ch: ch.thermalrelaxationchannel(100.0, 80.0, 10.0),
    "thermalrelaxation_excited": lambda ch: ch.thermalrelaxationchannel(100.0, 80.0, 10.0, excitedstatepopulation=0.2),
    "thermalrelaxation_choi": lambda ch: ch.thermalrelaxationchannel(100.0, 150.0, 10.0),
}


@pytest.mark.parametrize("name", sorted(_CHANNELS))
def test_channel_factories_match_jax(dtype, name):
    """Every factory of ``CHANNEL_NAMES`` (and the list and two-qubit
    forms) with float parameters: numpy Kraus operators with the JAX
    package's names, flags and matrices (the Choi-built one through its
    superoperator), and a complete set."""
    want, got = _CHANNELS[name](tc.channels), _CHANNELS[name](tct.channels)
    assert isinstance(got, tct.channels.KrausList)
    assert (got.name, got.is_unitary, len(got)) == (want.name, want.is_unitary, len(want))
    assert [g.name for g in got] == [g.name for g in want]
    assert all(isinstance(g.tensor, np.ndarray) and g.tensor.dtype == np.dtype(dtype) for g in got)
    if name.endswith("choi"):
        _close(tct.channels.kraus_to_super(got), tc.channels.kraus_to_super(want), TOL[dtype])
    else:
        for g, w in zip(got, want):
            _close(g.tensor, w.tensor, TOL[dtype])
    tct.channels.kraus_identity_check(got)
    assert tct.channels.is_unitary_kraus(got) == tc.channels.is_unitary_kraus(want)
    assert set(tct.channels.CHANNEL_NAMES) == set(tc.channels.CHANNEL_NAMES)


def test_channel_factories_keep_tensor_parameters(dtype):
    """A tensor parameter gives tensors on its device that keep its
    autograd, equal to the float parameter's numpy operators."""
    rdt = getattr(torch, "float64" if dtype == "complex128" else "float32")
    cases = [
        (lambda v: tct.channels.depolarizingchannel(v, 0.05, 0.02), 0.1),
        (lambda v: tct.channels.amplitudedampingchannel(v, 0.8), 0.3),
        (lambda v: tct.channels.amplitudedampingchannel(0.3, v), 0.8),
        (lambda v: tct.channels.phasedampingchannel(v), 0.25),
        (lambda v: tct.channels.generaldepolarizingchannel(v, 2), 0.01),
        (lambda v: tct.channels.isotropicdepolarizingchannel(v, 1), 0.06),
    ]
    for make, v in cases:
        t = torch.tensor(v, dtype=rdt, requires_grad=True)
        got, want = make(t), make(v)
        assert all(isinstance(g.tensor, torch.Tensor) and g.tensor.dtype == tct.config.torch_dtype() for g in got)
        assert any(g.tensor.requires_grad for g in got)
        for g, w in zip(got, want):
            _close(g.tensor, w.tensor, TOL[dtype])
        tct.channels.kraus_identity_check(got)
    ks = tct.channels.generaldepolarizingchannel(torch.tensor([0.01, 0.02, 0.03], dtype=rdt), 1)
    for g, w in zip(ks, tc.channels.generaldepolarizingchannel([0.01, 0.02, 0.03], 1)):
        _close(g.tensor, w.tensor, TOL[dtype])


@pytest.mark.parametrize("name", ["depolarizing", "amplitudedamping", "generaldepolarizing_2q", "thermalrelaxation_choi"])
def test_representation_transforms_match_jax(dtype, name):
    """Kraus -> superoperator -> Choi and back, against the JAX package;
    ``choi_to_kraus`` (host eigh, no fixed phase) and ``super_to_kraus``
    compared through their superoperator; ``evol_kraus`` against
    ``evol_superop`` and the JAX ``evol_kraus``; ``reshuffle``,
    ``check_rep_transformation`` and the converters."""
    tol = TOL[dtype]
    want, got = _CHANNELS[name](tc.channels), _CHANNELS[name](tct.channels)
    jc, tch = tc.channels, tct.channels
    s, js = tch.kraus_to_super(got), jc.kraus_to_super(want)
    _close(s, js, tol)
    _close(tch.kraus_to_super_gate(got), js, tol)
    _close(tch.super_to_choi(s), jc.super_to_choi(np.asarray(js)), tol)
    _close(tch.kraus_to_choi(got), jc.kraus_to_choi(want), tol)
    _close(tch.choi_to_super(tch.kraus_to_choi(got)), s, tol)
    _close(tch.kraus_to_super(tch.choi_to_kraus(tch.kraus_to_choi(got))), s, 10 * tol)
    _close(tch.kraus_to_super(tch.super_to_kraus(s)), s, 10 * tol)
    _close(tch.reshuffle(s, (0, 2, 1, 3)), jc.reshuffle(np.asarray(js), (0, 2, 1, 3)), tol)
    dim = got[0].matrix().shape[0]
    rng = np.random.default_rng(5)
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    rho = (np.outer(v, v.conj()) / np.vdot(v, v)).astype(np.dtype(dtype))
    out = tch.evol_kraus(rho, got)
    _close(out, jc.evol_kraus(rho, want), tol)
    _close(tch.evol_superop(rho, s), out, tol)
    out_t = tch.evol_kraus(torch.as_tensor(rho), got)
    assert isinstance(out_t, torch.Tensor)
    _close(out_t, out, tol)
    tch.check_rep_transformation(got, rho)
    assert tch.is_hermitian_matrix(rho) and not tch.is_hermitian_matrix(rho + 1j * np.eye(dim))
    mats = tch.krausgate_to_krausmatrix(got)
    _close(np.stack(mats), np.stack(jc.krausgate_to_krausmatrix(want)), tol)
    back = tch.krausmatrix_to_krausgate(mats)
    assert [g.name for g in back] == [g.name for g in jc.krausmatrix_to_krausgate(jc.krausgate_to_krausmatrix(want))]


def test_composedkraus_and_checks_match_jax(dtype):
    """``composedkraus`` (every product, its names and flags),
    ``kraus_identity_check`` raising on an incomplete set, and
    ``is_unitary_kraus``."""
    tol = TOL[dtype]
    a, b = tct.channels.depolarizingchannel(0.1, 0.05, 0.02), tct.channels.phasedampingchannel(0.3)
    ja, jb = tc.channels.depolarizingchannel(0.1, 0.05, 0.02), tc.channels.phasedampingchannel(0.3)
    for x, y, jx, jy in ((a, b, ja, jb), (a, a, ja, ja)):
        got, want = tct.channels.composedkraus(x, y), tc.channels.composedkraus(jx, jy)
        assert (got.name, got.is_unitary, [g.name for g in got]) == (want.name, want.is_unitary, [g.name for g in want])
        for g, w in zip(got, want):
            _close(g.tensor, w.tensor, tol)
        tct.channels.kraus_identity_check(got)
    with pytest.raises(AssertionError):
        tct.channels.kraus_identity_check([np.eye(2) * 0.5])
    assert tct.channels.is_unitary_kraus(a) and not tct.channels.is_unitary_kraus(b)


def test_energy_gradient_wrt_noise_strength_matches_jax(dtype):
    """d<Z_1 Z_2>/d(px, gamma) through the exact channels of a
    ``DMCircuit``, the strengths as tensors (torch autograd) and as JAX
    tracers (``jax.grad``)."""

    def build(mod, px, gamma):
        c = mod.DMCircuit(3)
        c.h(0)
        c.ry(1, theta=0.7)
        c.cnot(0, 1)
        c.depolarizing(1, px=px, py=0.03, pz=0.02)
        c.cnot(1, 2)
        c.amplitudedamping(2, gamma=gamma, p=0.9)
        c.rx(2, theta=0.4)
        return c

    def energy(mod, px, gamma):
        c = build(mod, px, gamma)
        return c.expectation((Z, [1]), (Z, [2])).real + c.expectation((X, [0]),).real

    jv, jg = jax.value_and_grad(lambda a: energy(tc, a[0], a[1]))(jnp.asarray([0.1, 0.3], dtype=RDT[dtype]))
    a = torch.tensor([0.1, 0.3], dtype=getattr(torch, str(np.dtype(RDT[dtype]))), requires_grad=True)
    v = energy(tct, a[0], a[1])
    (g,) = torch.autograd.grad(v, a)
    _close(v, jv, TOL[dtype])
    _close(g, jg, 10 * TOL[dtype])


# ---------------------------------------------------------------------------
# the Monte-Carlo methods of Circuit
# ---------------------------------------------------------------------------


def _base(mod, n, seed=3):
    rng = np.random.default_rng(seed)
    c = mod.Circuit(n)
    c.h_layer()
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], rng.normal(size=n - 1), rng.normal(size=n))
    c.ry_layer(rng.normal(size=n))
    c.any(1, 3, unitary=_unitary(rng, 4))
    return c


_METHODS = {
    "unitary_kraus": lambda m, c, s: c.unitary_kraus(m.channels.depolarizingchannel(0.2, 0.15, 0.1), 2, status=s),
    "unitary_kraus_prob": lambda m, c, s: c.unitary_kraus([np.eye(2), X, Z], 1, prob=[0.5, 0.3, 0.2], status=s),
    "unitary_kraus_2q": lambda m, c, s: c.unitary_kraus(m.channels.generaldepolarizingchannel(0.05, 2), 3, 1,
                                                        status=s),
    "unitary_kraus2": lambda m, c, s: c.unitary_kraus2(m.channels.depolarizingchannel(0.2, 0.15, 0.1), 2, status=s),
    "unitary_kraus2_prob": lambda m, c, s: c.unitary_kraus2([np.eye(2), X, Z], 0, prob=[0.5, 0.3, 0.2], status=s),
    "depolarizing": lambda m, c, s: c.depolarizing(2, px=0.2, py=0.15, pz=0.1, status=s),
    "depolarizing2": lambda m, c, s: c.depolarizing2(2, px=0.2, py=0.15, pz=0.1, status=s),
    "depolarizing_reference": lambda m, c, s: c.depolarizing_reference(2, px=0.2, py=0.15, pz=0.1, status=s),
    "amplitudedamping": lambda m, c, s: c.amplitudedamping(0, gamma=0.4, p=0.7, status=s),
    "phasedamping": lambda m, c, s: c.phasedamping(1, gamma=0.3, status=s),
    "reset": lambda m, c, s: c.reset(3, status=s),
    "thermalrelaxation": lambda m, c, s: c.thermalrelaxation(2, t1=100.0, t2=80.0, time=30.0, status=s),
    "generaldepolarizing": lambda m, c, s: c.generaldepolarizing(0, 1, p=0.05, num_qubits=2, status=s),
    "isotropicdepolarizing": lambda m, c, s: c.isotropicdepolarizing(2, p=0.3, status=s),
    "general_kraus_delayed": lambda m, c, s: m.Circuit.apply_general_kraus_delayed(
        m.channels.amplitudedampingchannel(0.5, 0.6), name="ad")(c, 1, status=s),
}
#: statuses at least 1e-3 from every cdf boundary of the channels above (a
#: uniform on a boundary picks either side by the rounding of the sums)
_MC_STATUSES = [0.031, 0.452, 0.833, 0.971]


@pytest.mark.parametrize("name", sorted(_METHODS))
def test_monte_carlo_methods_match_jax(dtype, name):
    """Each channel method on a 5-qubit state at four statuses: the branch
    the JAX package picks and the state after it and one more gate; then
    the channel item replayed through ``general_kraus`` (``copy``, and the
    light cone, which keeps a non-unitary branch: Queue 3 F11) held to the circuit itself, an oracle
    independent of both replays.  The JAX package replays ``unitary_kraus(prob=...)`` as
    another channel: its copy draws by [1/3, 1/3, 1/3] and has norm √3
    (Queue 3 F5); the port's replays the channel it drew from."""
    n = 5
    for s in _MC_STATUSES:
        jc = _base(tc, n)
        jb = _METHODS[name](tc, jc, jnp.asarray(s, dtype=RDT[dtype]))
        jc.rx(4, theta=0.3)
        c = _base(tct, n)
        b = _METHODS[name](tct, c, np.asarray(s, dtype=RDT[dtype]))
        c.rx(4, theta=0.3)
        assert isinstance(b, torch.Tensor) and b.dtype == torch.int32
        assert int(b) == int(jb), (name, s)
        _close(c.state(), jc.state(), TOL[dtype])
        _close(c.copy().state(), c.state(), TOL[dtype])
        for q in (0, 2):
            _close(c.expectation((Z, [q]), enable_lightcone=True), c.expectation((Z, [q])), 10 * TOL[dtype])
        if name == "unitary_kraus_prob":
            _close(np.linalg.norm(np.asarray(jc.copy().state())), np.sqrt(3.0), 10 * TOL[dtype])


def test_lightcone_keeps_a_non_unitary_branch():
    """Queue 3 F11: a reset outside the cone of ⟨Z_2⟩ still conditions the
    qubits entangled with its own.  The port's light cone keeps it and
    gives the state's value; the JAX package's drops it."""
    want = -0.355887
    with tct.set_dtype("complex128"), tct.set_device("cpu"):
        c = _base(tct, 5)
        c.reset(3, status=np.asarray(0.833))
        c.rx(4, theta=0.3)
        cone = complex(c.expectation((Z, [2]), enable_lightcone=True))
        dense = complex(c.expectation((Z, [2])))
    assert abs(dense - want) <= 1e-6 and abs(cone - want) <= 1e-6
    jc = _base(tc, 5)
    jc.reset(3, status=jnp.asarray(0.833))
    jc.rx(4, theta=0.3)
    assert abs(complex(np.asarray(jc.expectation((Z, [2]), enable_lightcone=True))) - (-0.262973)) <= 1e-5
    assert abs(complex(np.asarray(jc.expectation((Z, [2])))) - want) <= 1e-5


def test_measure_reference_draws_from_numpy_as_jax(dtype):
    """``measure_reference`` draws from numpy's global generator: seeded
    alike, both packages give the same string and probability."""
    n = 5
    for seed in range(4):
        np.random.seed(seed)
        want = _base(tc, n).measure_reference(0, 2, 4, with_prob=True)
        np.random.seed(seed)
        got = _base(tct, n).measure_reference(0, 2, 4, with_prob=True)
        assert got[0] == want[0]
        assert abs(got[1] - want[1]) <= TOL[dtype]
    assert _base(tct, n).measure_reference(1)[1] == -1.0


def test_channel_methods_draw_without_a_status(cpu):
    """Without a status the branch comes from the backend's generator on
    the circuit's device: seeded alike, the same branches."""
    out = []
    for _ in range(2):
        tct.backend.set_random_state(11)
        c = _base(tct, 4)
        out.append([int(c.depolarizing(q, px=0.3, py=0.3, pz=0.3)) for q in range(4)])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# noisemodel.py
# ---------------------------------------------------------------------------


def _noise_conf(mod):
    """Channels after a gate by name (one- and two-qubit, stacked), after
    a gate on given qubits, by a condition, and a readout error."""
    ch = mod.channels
    nc = mod.NoiseConf()
    nc.add_noise("zzrx_layer", ch.depolarizingchannel(0.05, 0.04, 0.03))
    nc.add_noise("h", ch.phasedampingchannel(0.2))
    nc.add_noise("h", ch.amplitudedampingchannel(0.3, 0.9))
    nc.add_noise("cnot", ch.generaldepolarizingchannel(0.02, 2))
    nc.add_noise("cnot", [ch.amplitudedampingchannel(0.2, 1.0), ch.resetchannel()], [[0, 1], [2, 3]])
    nc.add_noise_by_condition(lambda item: item.get("name") == "ry", ch.depolarizingchannel(0.1, 0.0, 0.1))
    nc.add_noise("readout", [[0.95, 0.9]] * 5)
    return nc


def _noisy_base(mod, n=5):
    rng = np.random.default_rng(8)
    c = mod.Circuit(n)
    c.h(0)
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], rng.normal(size=n - 1), rng.normal(size=n))
    c.cnot(0, 1)
    c.ry(2, theta=0.6)
    c.cnot(2, 3)
    c.h(n - 1)
    c.cnot(n - 1, 0)
    return c


def test_noise_conf_counts_and_qir_match_jax(dtype):
    """``channel_count`` (the method, the module function with and without
    a configuration), and the QIR of ``circuit_with_noise`` (names,
    indexes, statuses) and its state, against the JAX package; a
    ``DMCircuit`` gets the channels exactly."""
    n = 5
    nc, jnc = _noise_conf(tct), _noise_conf(tc)
    c, jc = _noisy_base(tct, n), _noisy_base(tc, n)
    num = jnc.channel_count(jc)
    assert num == nc.channel_count(c) == n + 3 + 1 + 1 + 1 + 2 + 3 + 1  # zzrx, h, 3 cnots, reset, ry
    assert tn.channel_count(c) == 0 and tn.channel_count(c, nc) == jn.channel_count(jc, jnc) == num
    assert nc.has_readout and nc.has_quantum
    st = np.random.default_rng(4).random(num).astype(RDT[dtype])
    got = tct.circuit_with_noise(c, nc, status=st)
    want = tc.circuit_with_noise(jc, jnc, status=jnp.asarray(st))
    assert [(it["name"], tuple(it["index"])) for it in got.to_qir()] == [
        (it["name"], tuple(it["index"])) for it in want.to_qir()]
    _close(np.stack([_np(it["channel_status"]) for it in got.to_qir() if it.get("is_channel")]), st, 0)
    assert tn.channel_count(got) == num
    _close(got.state(), want.state(), TOL[dtype])
    dm = tct.circuit_with_noise(tct.DMCircuit(n), nc)
    assert dm.to_qir() == [] and isinstance(dm, tct.DMCircuit)
    jdm = tc.circuit_with_noise(jc.to_dm_circuit(), jnc)
    _close(tct.circuit_with_noise(c.to_dm_circuit(), nc).densitymatrix(), jdm.densitymatrix(), TOL[dtype])
    out = tn.apply_qir_with_noise(tct.Circuit(n), c.to_qir(), nc, status=st)
    _close(out.state(), want.state(), TOL[dtype])


def _small_conf(mod, n):
    nc = mod.NoiseConf()
    nc.add_noise("zzrx_layer", mod.channels.depolarizingchannel(0.1, 0.05, 0.1))
    nc.add_noise("cnot", mod.channels.amplitudedampingchannel(0.3, 0.9))
    nc.add_noise("readout", [[0.95, 0.9]] * n)
    return nc


def test_noise_conf_entry_points_match_jax(dtype):
    """``expectation(noise_conf=)``, ``expectation_ps(noise_conf=)`` and
    ``sample_expectation_ps(noise_conf=)`` (exact and with shots, through
    the configuration's readout error) with the same statuses as the JAX
    package's vmapped estimators; the ``DMCircuit`` branch of both."""
    n, nmc, shots = 4, 3, 256
    tol = TOL[dtype]
    nc, jnc = _small_conf(tct, n), _small_conf(tc, n)
    c, jc = _noisy_base(tct, n), _noisy_base(tc, n)
    num = nc.channel_count(c)
    rng = np.random.default_rng(6)
    st = rng.random((nmc, num)).astype(RDT[dtype])
    u = rng.random(shots).astype(RDT[dtype])
    jst, ju = jnp.asarray(st), jnp.asarray(u)
    _close(c.expectation((Z, [1]), (X, [3]), noise_conf=nc, status=st),
           jc.expectation((Z, [1]), (X, [3]), noise_conf=jnc, status=jst), tol)
    _close(c.expectation_ps(x=[0], y=[2], z=[3], noise_conf=nc, status=st),
           jc.expectation_ps(x=[0], y=[2], z=[3], noise_conf=jnc, status=jst), tol)
    for kw in ({}, {"shots": shots}):
        got = c.sample_expectation_ps(x=[1], z=[3], noise_conf=nc, statusc=st, status=u if kw else None, **kw)
        want = jn.sample_expectation_ps_noisfy(jc, x=[1], z=[3], noise_conf=jnc, statusc=jst,
                                               status=ju if kw else None, **kw)
        _close(got, want, tol)
    with pytest.raises(TypeError):  # Queue 3, F4: the JAX method itself
        jc.sample_expectation_ps(z=[0], noise_conf=jnc, statusc=jst)
    dm, jdm = c.to_dm_circuit(), jc.to_dm_circuit()
    _close(tn.expectation_noisfy(dm, (Z, [1]), noise_conf=nc), jn.expectation_noisfy(jdm, (Z, [1]), noise_conf=jnc),
           tol)
    quiet = tct.NoiseConf()
    _close(c.expectation_ps(z=[1], noise_conf=quiet, nmc=0), c.expectation_ps(z=[1]), 0)


def test_noisy_tfim_value_and_grad_match_jax(dtype):
    """The loss of the card's phase 14 (a) at n=8, L=2 on the per-layer
    path: the mean over 2 trajectories of the noisy TFIM energy, and its
    gradient, against ``jax.value_and_grad`` of the same mean."""
    n, nl, nmc = 8, 2, 2
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)).astype(RDT[dtype])
    pairs = [(i, i + 1) for i in range(n - 1)]

    def conf(mod):
        nc = mod.NoiseConf()
        nc.add_noise("zzrx_layer", mod.channels.depolarizingchannel(0.05, 0.05, 0.05))
        return nc

    nc, jnc = conf(tct), conf(tc)
    st = np.random.default_rng(2).random((nmc, nl * n)).astype(RDT[dtype])

    def jloss(p):
        es = [tc.circuit_with_noise(tfim_circuit(tc, p, n, nl), jnc, status=jnp.asarray(st[k]))
              .expectation_zzx_energy(pairs, 1.0, -1.0) for k in range(nmc)]
        return jnp.mean(jnp.stack(es))

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(g0))
    p = torch.tensor(g0, requires_grad=True)
    e, g, branches = 0.0, 0.0, []
    for k in range(nmc):
        cn = tct.circuit_with_noise(tfim_circuit(tct, p, n, nl), nc, status=st[k])
        ek = cn.expectation_zzx_energy(pairs, 1.0, -1.0) / nmc
        e, g = e + ek.detach(), g + torch.autograd.grad(ek, p)[0]
        branches.append(channel_branches(cn))
    assert int(torch.stack(branches).ne(0).sum()) > 0  # some trajectory left the identity branch
    _close(e, jv, 10 * TOL[dtype])
    _close(g, jg, 10 * TOL[dtype])


# ---------------------------------------------------------------------------
# the state kept for a QIR prefix, the status checks, the instructions
# ---------------------------------------------------------------------------


def test_state_reuses_its_prefix(dtype, monkeypatch):
    """k ``general_kraus`` calls apply each QIR item once (the state of the
    prefix is kept); ``state()`` equals ``state(reuse=False)`` and the JAX
    package's state; ``replace_inputs`` and a QIR item replaced drop the
    kept state, and a state kept under ``no_grad`` is not reused with
    autograd on."""
    applied = []
    apply_item = BaseCircuit._apply_item
    monkeypatch.setattr(BaseCircuit, "_apply_item",
                        lambda self, psi, item: applied.append(item["name"]) or apply_item(self, psi, item))
    n = 5

    def build(mod, s):
        c = mod.Circuit(n)
        for q in range(n):
            c.ry(q, theta=0.3 + 0.1 * q)
            c.cnot(q, (q + 1) % n)
            c.amplitudedamping(q, gamma=0.3, p=0.8, status=s[q])
        c.rx(2, theta=0.5)
        return c

    s = np.random.default_rng(3).random(n).astype(RDT[dtype])
    c = build(tct, s)
    # every item once; the last channel item and the rx wait for the next state()
    assert len(applied) == len(c.to_qir()) - 2
    psi = c.state()
    assert len(applied) == len(c.to_qir())
    _close(psi, c.state(reuse=False), TOL[dtype])
    _close(psi, build(tc, jnp.asarray(s)).state(), TOL[dtype])
    applied.clear()
    c.state()
    assert applied == []
    c.replace_inputs(np.eye(2**n)[3])
    c.state()
    assert len(applied) == len(c.to_qir())
    applied.clear()
    c._qir[4] = dict(c._qir[4])  # a QIR item replaced
    c.state()
    assert len(applied) == len(c.to_qir())
    th = torch.tensor(0.4, requires_grad=True)
    c2 = tct.Circuit(3)
    c2.rx(0, theta=th)
    with torch.no_grad():
        c2.state()
    c2.cnot(0, 1)
    (g,) = torch.autograd.grad(c2.expectation_ps(z=[1]).real, th)
    assert abs(g.item() + np.sin(0.4)) < 1e-6


def test_status_checks_raise(cpu):
    """A status or ``statusc`` whose last dimension is not the channel
    count is a ValueError in both estimators (the JAX package checks only the
    first), and so is ``nmc < 1`` without a status."""
    nc = _noise_conf(tct)
    c = _noisy_base(tct)
    num = nc.channel_count(c)
    bad = np.random.default_rng(0).random((4, num + 1))
    with pytest.raises(ValueError, match="channel count"):
        c.expectation_ps(z=[0], noise_conf=nc, status=bad)
    with pytest.raises(ValueError, match="channel count"):
        c.sample_expectation_ps(z=[0], noise_conf=nc, statusc=bad)
    with pytest.raises(ValueError, match="channel count"):
        c.sample_expectation_ps(z=[0], noise_conf=nc, statusc=bad[:, :-2], shots=16)
    for call in (lambda: c.expectation_ps(z=[0], noise_conf=nc, nmc=0),
                 lambda: c.sample_expectation_ps(z=[0], noise_conf=nc, nmc=0)):
        with pytest.raises(ValueError, match="nmc"):
            call()
    tct.backend.set_random_state(2)
    v = c.expectation_ps(z=[0], noise_conf=nc, nmc=3)
    assert v.dtype == torch.float32 and -1 <= v.item() <= 1


def test_noise_instructions_recorded_as_jax(cpu):
    """The five noise instructions are recorded beside the QIR as the JAX
    package records them (not simulated)."""

    def build(mod):
        c = mod.Circuit(3)
        c.h(0)
        c.pauli_instruction(0, p=[0.1, 0.2, 0.3])
        c.pauli2_instruction(0, 1, p=[0.01] * 15)
        c.cnot(0, 1)
        c.depolarizing_instruction(2, p=0.05)
        c.depolarizing2_instruction(1, 2, p=0.02)
        c.mr_instruction(1, tag="x")
        return c

    got, want = build(tct), build(tc)
    assert got._extra_qir == want._extra_qir
    assert got.gate_count() == 2


def test_smoke_noise_checks_run_on_cpu(cpu):
    """``chip_smoke.py``'s phase 14 at a small size on the CPU (the card
    path and its reference are then one): every check of (a)-(d) passes;
    ``branch_miss`` finds a branch outside its interval."""
    from chip_smoke import _noise_checks

    got = _noise_checks(tct, "cpu", (), n=8, nl=2, nmc=6, hea_nmc=3, api_nmc=6, shots=2048, dm_n=5, dm_nmc=200,
                         cpu_traj=3, cpu_hea=2, cpu_api=3)
    assert got["c"].nqubits == 8
    probs = np.array([[0.7, 0.3, 0.0, 0.0]])
    assert branch_miss([0], [0.5], probs) < 0 and branch_miss([1], [0.5], probs) > 0.19
