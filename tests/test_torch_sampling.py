"""Sampling and randomness of the port against the JAX package, on the CPU:
the measurement helpers of ``quantum.py``, ``backend.probability_sample``,
``Circuit.sample`` on both routes in its six formats and its legacy output,
``readouterror_bs``, ``sample_expectation_ps``, ``general_kraus``,
``cond_measurement`` and ``conditional_gate`` (teleportation), a circuit
with a channel item through ``copy``, ``inverse``, remapping and the light
cone, the backend's generators and names, and the errors of what is not
ported.

Inputs are numpy-seeded and handed to both packages, at complex64 and at
complex128, with the same ``status`` of uniforms.  Outcomes: equal indices
at complex128; at complex64 the bracket check of ``chip_smoke.bracket_miss``
(each index within 1e-6 of its float64 cdf interval at n ≤ 10: a float32
cumsum may pick a neighbour by its rounding), and every format of the port's
indices equal to the JAX package's format of the same indices.  Values:
probabilities, states and expectations within 1e-6 (complex64) and 1e-12
(complex128).  Integer dtypes are held against the JAX package at complex64
(x64 off: int32).  Without a status the two packages draw other bits, so
those tests hold reproducibility and statistics only.  The JAX side of each
test runs under ``jax.jit`` once per dtype where it is jittable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import bracket_miss, trajectory_bracket_miss
from tensorcircuit_ng_tpu import quantum as jq
from tensorcircuit_ng_tpu.backend import backend as JK
from tensorcircuit_ng_tpu_torch import quantum as tq

TOL = {"complex64": 1e-6, "complex128": 1e-12}
BRACKET_TOL = 1e-6
RDT = {"complex64": np.float32, "complex128": np.float64}
FORMATS = [None, "sample_int", "sample_bin", "count_vector", "count_tuple", "count_dict_bin", "count_dict_int"]
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


def _same(got, want):
    """Equal values of any sample format (dicts, tuples, arrays)."""
    if isinstance(want, dict):
        assert got == want
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


_JAX = {}


def _jax_ref(name, dtype, fn, jit=True):
    """``fn()`` (under ``jax.jit`` unless ``jit`` is False) at the active
    dtype, once per (name, dtype), as numpy."""
    if (name, dtype) not in _JAX:
        out = jax.jit(fn)() if jit else fn()
        _JAX[name, dtype] = jax.tree_util.tree_map(np.asarray, out)
    return _JAX[name, dtype]


def _unitary(rng, dim):
    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    return np.linalg.qr(a)[0]


def _params(n, seed, rdt):
    rng = np.random.default_rng(seed)
    return {"zz": rng.normal(size=n - 1).astype(rdt), "rx": rng.normal(size=n).astype(rdt),
            "ry": rng.normal(size=n).astype(rdt), "u4": _unitary(rng, 4)}


def _circuit(mod, n, p):
    """h_layer, a zzrx_layer, an ry_layer, a cnot and a dense two-qubit gate."""
    c = mod.Circuit(n)
    c.h_layer()
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], p["zz"], p["rx"])
    c.ry_layer(p["ry"])
    c.cnot(0, n - 1)
    c.any(1, 3, unitary=p["u4"])
    return c


# ---------------------------------------------------------------------------
# quantum.py's measurement helpers
# ---------------------------------------------------------------------------

_HELPERS = {
    "sample_int2bin": lambda q, s, n, d: q.sample_int2bin(s, n, d),
    "sample_bin2int": lambda q, s, n, d: q.sample_bin2int(q.sample_int2bin(s, n, d), n, d),
    "sample2count": lambda q, s, n, d: q.sample2count(s, n, d),
    "sample2count_nonjit": lambda q, s, n, d: q.sample2count(s, n, d, jittable=False),
    "count_vector2dict_bin": lambda q, s, n, d: q.count_vector2dict(q.sample2count(s, n, d)[1], n, "bin", d),
    "count_vector2dict_int": lambda q, s, n, d: q.count_vector2dict(q.sample2count(s, n, d)[1], n, "int", d),
    "count_dict2vector": lambda q, s, n, d: q.count_dict2vector(
        q.count_vector2dict(q.sample2count(s, n, d)[1], n, "bin", d), n, d),
    "count_tuple2dict": lambda q, s, n, d: q.count_tuple2dict(q.sample2count(s, n, d, jittable=False), n, "bin", d),
    "int2basestr": lambda q, s, n, d: [q._int2basestr(int(i), n, d) for i in np.asarray(_np(s))[:5]],
    "count_s2d": lambda q, s, n, d: q.count_s2d(q.sample2count(s, n, d, jittable=False), n, d),
    "count_d2s": lambda q, s, n, d: q.count_d2s(q.sample2count(s, n, d)[1].astype(np.float32)
                                                if isinstance(s, jax.Array)
                                                else q.sample2count(s, n, d)[1].to(torch.float32)),
    "aliases": lambda q, s, n, d: (q.counts_v2t(q.count_t2v(q.sample2count(s, n, d)[1]), n, d),
                                   q.counts_t2v(q.sample2count(s, n, d, jittable=False), n, d)),
    **{f"sample2all_{f}": (lambda f: lambda q, s, n, d: q.sample2all(s, n, format=f, d=d))(f) for f in FORMATS[1:]},
}
_D2_ONLY = {
    "spin_by_basis": lambda q, s, n, d: [q.spin_by_basis(n, m) for m in range(n)],
    "correlation_from_samples_int": lambda q, s, n, d: q.correlation_from_samples([0, 2], s, n),
    "correlation_from_samples_bin": lambda q, s, n, d: q.correlation_from_samples(
        [1, 3, 4], q.sample_int2bin(s, n), n),
    "correlation_from_counts": lambda q, s, n, d: q.correlation_from_counts([0, 3], q.sample2count(s, n)[1]),
    "expectation_from_counts_z": lambda q, s, n, d: q.expectation_from_counts(
        q.sample2all(s, n, format="count_dict_bin"), z=[1, 2]),
    "expectation_from_counts_diag": lambda q, s, n, d: q.expectation_from_counts(
        q.sample2all(s, n, format="count_dict_bin"), diagonal_op=np.arange(2**n) / 2**n),
}


def _samples(n, d, seed=0, shots=200):
    return np.random.default_rng(seed).integers(0, d**n, size=shots).astype(np.int32)


@pytest.mark.parametrize("name,d", [(k, 2) for k in list(_HELPERS) + list(_D2_ONLY)] + [(k, 3) for k in _HELPERS])
def test_measurement_helpers_match_jax(dtype, name, d):
    n = 5
    fn = {**_HELPERS, **_D2_ONLY}[name]
    s = _samples(n, d)
    want = fn(jq, jnp.asarray(s), n, d)
    got = fn(tq, torch.as_tensor(s), n, d)
    if isinstance(want, float):
        assert got == pytest.approx(want, abs=TOL[dtype])
    elif name.startswith("correlation"):
        _close(got, want, TOL[dtype])
    else:
        _same(got, want)
    if dtype == "complex64":  # the JAX package's integer dtypes with x64 off
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            if isinstance(a, torch.Tensor) and not a.is_floating_point():
                assert str(a.dtype).replace("torch.", "") == str(np.asarray(b).dtype), name


def test_measurement_counts_matches_jax(dtype):
    """A state, a density matrix and a probability vector through
    ``measurement_counts`` with the same status, in every format, and the
    exact distribution with ``counts=None``."""
    n = 5
    p = _params(n, 3, RDT[dtype])
    psi = _np(_circuit(tct, n, p).state())
    rho = np.outer(psi, psi.conj())
    status = np.random.default_rng(4).random(64).astype(RDT[dtype])
    for inp, kw in ((psi, {}), (rho, {}), (np.abs(psi) ** 2, {"is_prob": True})):
        want_idx = jq.measurement_counts(jnp.asarray(inp), 64, format="sample_int", status=jnp.asarray(status), **kw)
        got_idx = tq.measurement_counts(torch.as_tensor(inp), 64, format="sample_int", status=status, **kw)
        if dtype == "complex128":
            _same(got_idx, want_idx)
        else:
            assert bracket_miss(_np(got_idx), status, np.abs(psi) ** 2) <= BRACKET_TOL
        for f in FORMATS[1:]:
            got = tq.measurement_results(torch.as_tensor(inp), 64, format=f, status=status, **kw)
            _same(got, jq.sample2all(jnp.asarray(_np(got_idx)), n, format=f))
        _close(tq.measurement_counts(torch.as_tensor(inp), None, **kw),
               jq.measurement_counts(jnp.asarray(inp), None, **kw), TOL[dtype])


def test_measurement_helpers_above_32_qubits(dtype):
    """n=34: no dense count vector; the sparse formats and the digits of
    indices past 2^31 (int64), against the JAX package (x64 on) and numpy's
    bits."""
    n = 34
    big = np.array([3, 2**33 + 5, 7, 3, 2**30 + 1], dtype=np.int64)
    s = big if dtype == "complex128" else big[big < 2**31].astype(np.int32)
    for f in ("sample_int", "count_tuple", "count_dict_bin", "count_dict_int"):
        _same(tq.sample2all(torch.as_tensor(s), n, format=f), jq.sample2all(jnp.asarray(s), n, format=f))
    bits = (s[:, None] >> np.arange(n - 1, -1, -1)) & 1
    got = tq.sample2all(torch.as_tensor(s), n, format="sample_bin")
    np.testing.assert_array_equal(_np(got), bits)
    np.testing.assert_array_equal(_np(tq.sample_bin2int(got, n)), s)
    assert tq.sample_bin2int(got, n).dtype == torch.int64
    for mod, arr in ((tq, torch.as_tensor(s)), (jq, jnp.asarray(s))):
        with pytest.raises(ValueError, match="count_vector"):
            mod.sample2all(arr, n, format="count_vector")
    with pytest.raises(NotImplementedError):
        tq.correlation_from_counts([0], (torch.as_tensor(s), torch.ones(len(s))))


# ---------------------------------------------------------------------------
# backend.probability_sample and Circuit.sample
# ---------------------------------------------------------------------------


def _probs(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return np.abs(a) ** 2


def _psample_jax(dtype):
    def fn():
        out = {}
        for n in range(3, 11):
            rdt = RDT[dtype]
            st = np.random.default_rng(n).random(300).astype(rdt)
            out[n] = JK.probability_sample(300, jnp.asarray(_probs(n, n).astype(rdt)), status=jnp.asarray(st))
        return out
    return _jax_ref("psample", dtype, fn)


@pytest.mark.parametrize("n", range(3, 11))
def test_probability_sample_matches_jax(dtype, n):
    rdt = RDT[dtype]
    p = _probs(n, n).astype(rdt)
    status = np.random.default_rng(n).random(300).astype(rdt)
    got = tct.backend.probability_sample(300, torch.as_tensor(p), status=status)
    assert got.dtype == torch.int32 and got.shape == (300,)
    want = _psample_jax(dtype)[n]
    if dtype == "complex128":
        np.testing.assert_array_equal(_np(got), want)
    assert bracket_miss(_np(got), status, p) <= BRACKET_TOL
    # the edges: u = 0 and u just below 1 stay inside [0, 2^n)
    edge = tct.backend.probability_sample(2, torch.as_tensor(p), status=np.array([0.0, 1 - 1e-7], rdt))
    assert 0 <= int(edge.min()) and int(edge.max()) < 2**n


_SAMPLE_CASES = [("state", "1d"), ("state", "2d"), ("traj", "2d")]
B = 16


def _status(n, route, sdim, batch, rdt):
    rng = np.random.default_rng({"state": 1, "traj": 2}[route] * 10 + (batch is None) + 2 * (sdim == "2d"))
    rows = 1 if batch is None else batch
    return rng.random((rows, n) if sdim == "2d" else (rows,)).astype(rdt)


def _sample_jax(dtype, n, p):
    """The JAX package's indices (``allow_state``) or (bits, probabilities)
    (trajectories) for every case, in one jit."""

    def fn():
        out = {}
        for route, sdim in _SAMPLE_CASES:
            for batch in (None, B):
                st = jnp.asarray(_status(n, route, sdim, batch, RDT[dtype]))
                c = _circuit(tc, n, p)
                if route == "state":
                    out[f"{route}-{sdim}-{batch}"] = c.sample(batch=batch, allow_state=True, status=st, format="sample_int")
                else:
                    res = c.sample(batch=batch, allow_state=False, status=st)
                    res = [res] if batch is None else res
                    out[f"{route}-{sdim}-{batch}"] = (jnp.stack([r[0] for r in res]), jnp.stack([r[1] for r in res]))
        return out

    return _jax_ref("sample", dtype, fn)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("batch", [None, B])
@pytest.mark.parametrize("route,sdim", _SAMPLE_CASES)
def test_sample_matches_jax(dtype, route, sdim, batch, fmt):
    n = 6
    p = _params(n, 7, RDT[dtype])
    want = _sample_jax(dtype, n, p)[f"{route}-{sdim}-{batch}"]
    ct = _circuit(tct, n, p)
    status = _status(n, route, sdim, batch, RDT[dtype])
    allow = route == "state"
    got = ct.sample(batch=batch, allow_state=allow, status=status, format=fmt)
    probs = _np(ct.probability()).astype(np.float64)
    if allow:
        idx = _np(ct.sample(batch=batch, allow_state=True, status=status, format="sample_int"))
        u = status[:, 0] if sdim == "2d" else status
        assert bracket_miss(idx, u, probs) <= BRACKET_TOL
        if dtype == "complex128":
            np.testing.assert_array_equal(idx, want)
    else:
        traj = ct.sample(batch=len(status), allow_state=False, status=status)
        bits = np.stack([_np(b) for b, _ in traj])
        pr = np.array([float(q) for _, q in traj])
        assert trajectory_bracket_miss(bits, status, probs) <= BRACKET_TOL
        np.testing.assert_allclose(pr, probs[bits @ (2 ** np.arange(n - 1, -1, -1))] / probs.sum(),
                                   rtol=10 * TOL[dtype])
        if dtype == "complex128":
            np.testing.assert_array_equal(bits, want[0])
            _close(pr, want[1], TOL[dtype])
        idx = bits @ (2 ** np.arange(n - 1, -1, -1))
    if fmt is None:  # legacy: (digits, probability) or a list of them
        rows = [got] if batch is None else got
        assert len(rows) == (1 if batch is None else batch)
        for k, (b, q) in enumerate(rows):
            assert b.dtype == torch.int32 and b.shape == (n,)
            np.testing.assert_array_equal(_np(b), (idx[k] >> np.arange(n - 1, -1, -1)) & 1)
            if allow:
                assert q == -1.0
    else:
        _same(got, jq.sample2all(jnp.asarray(idx.astype(np.int32)), n, format=fmt))


def test_readout_error_matches_jax(dtype):
    """``readouterror_bs`` and ``sample(readout_error=)``: the
    ``allow_state`` route samples the confused probabilities, the
    trajectory route ignores the argument, as in the JAX package."""
    n = 6
    p = _params(n, 8, RDT[dtype])
    err = [[0.98, 0.97], [0.9, 0.95]] + [[0.99, 0.985]] * (n - 2)
    st1 = np.random.default_rng(9).random(64).astype(RDT[dtype])
    st2 = np.random.default_rng(10).random((64, n)).astype(RDT[dtype])

    def fn():
        c = _circuit(tc, n, p)
        pj = c.probability()
        return {"bs": c.readouterror_bs(err, pj / jnp.sum(pj)),
                "state": c.sample(batch=64, allow_state=True, readout_error=err, status=jnp.asarray(st1),
                                  format="sample_int"),
                "traj": c.sample(batch=64, readout_error=err, status=jnp.asarray(st2), format="sample_int"),
                "traj_plain": c.sample(batch=64, status=jnp.asarray(st2), format="sample_int")}

    want = _jax_ref("readout", dtype, fn)
    ct = _circuit(tct, n, p)
    pt = ct.probability()
    bs = ct.readouterror_bs(err, pt / torch.sum(pt))
    _close(bs, want["bs"], TOL[dtype])
    _close(torch.sum(bs), 1.0, 10 * TOL[dtype])
    got = _np(ct.sample(batch=64, allow_state=True, readout_error=err, status=st1, format="sample_int"))
    assert bracket_miss(got, st1, _np(bs).astype(np.float64)) <= BRACKET_TOL
    traj = _np(ct.sample(batch=64, readout_error=err, status=st2, format="sample_int"))
    np.testing.assert_array_equal(traj, _np(ct.sample(batch=64, status=st2, format="sample_int")))
    np.testing.assert_array_equal(want["traj"], want["traj_plain"])
    if dtype == "complex128":
        np.testing.assert_array_equal(got, want["state"])
        np.testing.assert_array_equal(traj, want["traj"])
    assert ct.readouterror_bs(None, pt) is pt


_SEP = {
    "z01": {"z": [0, 1]}, "x2": {"x": [2]}, "y3z4": {"y": [3], "z": [4]}, "xyz": {"x": [0], "y": [5], "z": [2, 3]},
}


@pytest.mark.parametrize("case", sorted(_SEP))
def test_sample_expectation_ps_matches_jax(dtype, case):
    """Exact (``shots=None``), with shots and a status, and with a readout
    error; the exact value also against ``expectation_ps``."""
    n = 6
    p = _params(n, 11, RDT[dtype])
    kw = _SEP[case]
    status = np.random.default_rng(12).random(512).astype(RDT[dtype])
    err = [[0.97, 0.95]] * n

    def fn():
        out = {}
        for name, kws in _SEP.items():
            c = _circuit(tc, n, p)
            out[name] = {"exact": c.sample_expectation_ps(**kws), "ps": jnp.real(c.expectation_ps(**kws)),
                         "shots": c.sample_expectation_ps(**kws, shots=512, status=jnp.asarray(status)),
                         "readout": c.sample_expectation_ps(**kws, readout_error=err)}
        return out

    want = _jax_ref("sep", dtype, fn)[case]
    ct = _circuit(tct, n, p)
    exact = ct.sample_expectation_ps(**kw)
    _close(exact, want["exact"], TOL[dtype])
    _close(exact, torch.real(ct.expectation_ps(**kw)), 10 * TOL[dtype])
    _close(ct.sample_expectation_ps(**kw, readout_error=err), want["readout"], TOL[dtype])
    shots = ct.sample_expectation_ps(**kw, shots=512, status=status)
    if dtype == "complex128":
        _close(shots, want["shots"], TOL[dtype])
    assert abs(float(shots) - float(exact)) <= 5 * max(np.sqrt((1 - float(exact) ** 2) / 512), 1e-3)


# ---------------------------------------------------------------------------
# general_kraus, cond_measurement, conditional_gate
# ---------------------------------------------------------------------------

_GAMMA = 0.3
_KRAUS = [np.array([[1.0, 0.0], [0.0, np.sqrt(1 - _GAMMA)]]), np.array([[0.0, np.sqrt(_GAMMA)], [0.0, 0.0]])]
_STATUSES = [0.05, 0.35, 0.6, 0.95]


def _kraus_circuit(mod, n, p, s):
    """The test circuit, then an amplitude-damping trajectory on qubit 2, a
    measurement with collapse of qubit 0 and a gate picked by its outcome."""
    c = _circuit(mod, n, p)
    k = c.general_kraus(_KRAUS, 2, status=s, with_prob=True)
    m = c.cond_measurement(0, status=1 - s)
    c.conditional_gate(m, [np.eye(2), X], 4)
    c.rx(3, theta=0.4)
    return c, k, m


def _kraus_jax(dtype, n, p):
    def fn():
        out = {}
        for s in _STATUSES:
            c, (k, pk), m = _kraus_circuit(tc, n, p, jnp.asarray(s))
            out[s] = {"k": k, "p": pk, "m": m, "state": c.state(), "copy": c.copy().state(),
                      "inverse": c.inverse().state(), "mapped": c.initial_mapping({q: n - 1 - q for q in range(n)}).state(),
                      "dense": c.expectation((Z, [3]))}
        return out
    return _jax_ref("kraus", dtype, fn)


@pytest.mark.parametrize("s", _STATUSES)
def test_general_kraus_and_cond_measurement_match_jax(dtype, s):
    """Branches, their probabilities and the states through ``copy``,
    ``inverse`` (the channel items left out), ``initial_mapping`` and the
    light cone of a circuit with two channel items (held to the JAX
    package's dense expectation: its light cone drops the channels, F11)."""
    n = 6
    p = _params(n, 13, RDT[dtype])
    want = _kraus_jax(dtype, n, p)[s]
    c, (k, pk), m = _kraus_circuit(tct, n, p, s)
    assert k.dtype == torch.int32 and m.dtype == torch.int32
    assert int(k) == int(want["k"]) and int(m) == int(want["m"])
    _close(pk, want["p"], TOL[dtype])
    names = [it["name"] for it in c.to_qir()]
    assert names[-4:] == ["general_kraus", "cond_measurement", "select_gate", "rx"]
    assert sum(bool(it.get("is_channel")) for it in c.to_qir()) == 2
    tol = 10 * TOL[dtype]
    _close(c.state(), want["state"], tol)
    _close(torch.linalg.vector_norm(c.state()), 1.0, tol)
    cp = c.copy()
    assert [it["name"] for it in cp.to_qir()] == names
    _close(cp.state(), c.state(), tol)
    inv = c.inverse()
    assert not any(it.get("is_channel") for it in inv.to_qir())
    _close(inv.state(), want["inverse"], tol)
    _close(c.initial_mapping({q: n - 1 - q for q in range(n)}).state(), want["mapped"], tol)
    # the light cone keeps both non-unitary channel items (Queue 3 F11: the
    # JAX package's drops them), so it gives the state's value
    _close(c.expectation((Z, [3]), enable_lightcone=True), want["dense"], tol)


def _teleport(mod, gates, theta, phi, s0, s1):
    c = mod.Circuit(3)
    c.ry(0, theta=theta)
    c.rz(0, theta=phi)
    c.h(1)
    c.cnot(1, 2)
    c.cnot(0, 1)
    c.h(0)
    m0 = c.cond_measure(0, status=s0)
    m1 = c.cond_measure(1, status=s1)
    c.conditional_gate(m1, [gates.GATES["i"]().matrix(), gates.GATES["x"]().matrix()], 2)
    c.conditional_gate(m0, [gates.GATES["i"]().matrix(), gates.GATES["z"]().matrix()], 2)
    return c, m0, m1


_GRID = [(a, b) for a in (0.1, 0.45, 0.55, 0.9) for b in (0.2, 0.8)]


@pytest.mark.parametrize("s0,s1", _GRID)
def test_teleportation_matches_jax(dtype, s0, s1):
    """The teleportation of ``tests/test_refparity_circuit.py`` through
    ``cond_measure`` and ``conditional_gate``: outcomes and the final state
    against the JAX package, and qubit 2's Bloch vector against the input."""
    from tensorcircuit_ng_tpu.ops import gates as jgates
    from tensorcircuit_ng_tpu_torch.ops import gates as tgates

    theta, phi = 0.7, 0.4

    def fn():
        return {f"{a}-{b}": [(lambda r: (r[0].state(), r[1], r[2]))(_teleport(tc, jgates, theta, phi, jnp.asarray(a),
                                                                              jnp.asarray(b)))]
                for a, b in _GRID}

    want = _jax_ref("teleport", dtype, fn)[f"{s0}-{s1}"][0]
    c, m0, m1 = _teleport(tct, tgates, theta, phi, s0, s1)
    assert (int(m0), int(m1)) == (int(want[1]), int(want[2]))
    _close(c.state(), want[0], 10 * TOL[dtype])
    ref = tct.Circuit(1)
    ref.ry(0, theta=theta)
    ref.rz(0, theta=phi)
    for op in ("x", "z"):
        _close(torch.real(c.expectation_ps(**{op: [2]})), torch.real(ref.expectation_ps(**{op: [0]})),
               10 * TOL[dtype])


def test_select_gate_takes_a_tensor_and_matches_jax(dtype):
    """``select_gate`` with an int, a numpy int and a 0-d tensor picks the
    same matrix as the JAX package."""
    n = 4
    p = _params(n, 14, RDT[dtype])
    mats = [np.eye(4), p["u4"], np.kron(X, Z)]

    def fn():
        out = []
        for w in range(3):
            c = _circuit(tc, n, p)
            c.select_gate(jnp.asarray(w), mats, 2, 0)
            out.append(c.state())
        return out

    want = _jax_ref("select", dtype, fn)
    for w, which in enumerate((0, np.int64(1), torch.tensor(2))):
        c = _circuit(tct, n, p)
        c.select_gate(which, mats, 2, 0)
        assert c.to_qir()[-1]["name"] == "select_gate"
        _close(c.state(), want[w], 10 * TOL[dtype])


# ---------------------------------------------------------------------------
# randomness without a status, the backend, the errors
# ---------------------------------------------------------------------------


def _bell(mod):
    c = mod.Circuit(2)
    c.h(0)
    c.cnot(0, 1)
    return c


@pytest.mark.parametrize("allow_state", [True, False])
def test_seeded_generators_repeat(cpu, allow_state):
    """A seeded ``torch.Generator`` repeats; so does ``np.random.seed``
    followed by ``set_random_state()``, and a first use of the implicit
    generator, which seeds itself from ``np.random``."""
    c = _bell(tct)

    def draw(**kw):
        return _np(c.sample(batch=64, allow_state=allow_state, format="sample_int", **kw))

    g = lambda: tct.backend.get_random_state(5, device="cpu")  # noqa: E731
    np.testing.assert_array_equal(draw(random_generator=g()), draw(random_generator=g()))
    runs = []
    for _ in range(2):
        np.random.seed(21)
        tct.backend.set_random_state()
        runs.append((draw(), draw(), _np(c.measure_jit(0, 1)[0])))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][0], runs[0][1])
    fresh = tct.TorchBackend()
    np.random.seed(22)
    a = _np(fresh.implicit_randu([8], device="cpu"))
    np.random.seed(22)
    fresh.set_random_state()
    np.testing.assert_array_equal(a, _np(fresh.implicit_randu([8], device="cpu")))


@pytest.mark.parametrize("allow_state", [True, False])
def test_bell_pair_counts_pass_chi_square(cpu, allow_state):
    """8192 shots of a Bell pair: only 00 and 11, each half of the shots
    (chi-square of one degree of freedom below 15, p ≈ 1e-4)."""
    tct.backend.set_random_state(3)
    counts = _bell(tct).sample(batch=8192, allow_state=allow_state, format="count_dict_bin")
    assert set(counts) <= {"00", "11"} and sum(counts.values()) == 8192
    chi2 = sum((counts.get(k, 0) - 4096) ** 2 / 4096 for k in ("00", "11"))
    assert chi2 < 15


def test_backend_draws_and_names(cpu):
    """The backend's draws (dtype, shape, range, device) and the backend
    names of ``config``, beside the JAX package's exports."""
    K = tct.backend
    with tct.runtime_dtype("complex128"):
        assert K.implicit_randn([3, 2]).dtype == torch.float64
    u = K.implicit_randu((1000,), low=2.0, high=3.0)
    assert u.dtype == torch.float32 and bool(((u >= 2) & (u < 3)).all())
    g = K.get_random_state(1)
    assert g.device.type == "cpu"
    assert K.stateful_randn(g, 4, mean=1.0, stddev=0.0).tolist() == [1.0] * 4
    assert K.stateful_randu(g, [2, 3], dtype="float64").shape == (2, 3)
    ch = K.implicit_randc(4, shape=[200], p=[0.0, 0.5, 0.0, 0.5])
    assert set(ch.tolist()) <= {1, 3} and ch.shape == (200,)
    assert set(K.stateful_randc(g, [5, 7], shape=[3, 3]).reshape(-1).tolist()) <= {5, 7}
    for name in ("pytorch", "torch"):
        assert tct.set_backend(name) is tct.backend is tct.get_backend()
    for name in ("jax", "numpy", "tensorflow"):
        with pytest.raises(ValueError, match="'pytorch' \\(alias 'torch'\\)"):
            tct.set_backend(name)
    with tct.runtime_backend("torch") as b:
        assert b is tct.backend
    assert tct.config.set_function_backend("pytorch")(lambda: tct.get_backend())() is tct.backend
    for name in ("backend", "quantum", "set_backend", "get_backend", "runtime_backend"):
        assert hasattr(tc, name) and hasattr(tct, name), name
    assert isinstance(tct.backend, tct.TorchBackend)
    for name in ("sample2all", "measurement_counts", "count_d2s", "counts_v2t", "expectation_from_counts"):
        assert callable(getattr(tc.quantum, name)) and callable(getattr(tct.quantum, name))


def test_unported_routes_raise(cpu):
    """A 1-D status on the trajectory route and a status tensor on another
    device are ValueErrors.  ``sample`` above 2^30 amplitudes (Queue 1 item
    12, ported: ``tests/test_torch_einsum_routes.py`` holds it against the
    JAX package) draws through the einsum IR: |0...0> gives zeros.
    (``noise_conf`` is ported: the noise tests hold it.)"""
    zeros = tct.Circuit(31).sample(batch=4, status=np.full((4, 31), 0.5), format="sample_bin")
    assert zeros.shape == (4, 31) and not zeros.any()
    assert tct.DMCircuit2(2).probability().shape == (4,)
    c = _bell(tct)
    with pytest.raises(ValueError, match="trajectory route"):
        c.sample(batch=2, status=np.array([0.1, 0.2]))
    with pytest.raises(ValueError, match="meta"):
        c.sample(batch=2, status=torch.zeros((2, 2), device="meta"))


def test_smoke_sampling_checks_run_on_cpu(cpu):
    """``chip_smoke.py``'s phase 13 at a small size on the CPU (the card
    path and its reference are then one): every check of (a)-(e) passes."""
    from chip_smoke import _sampling_checks

    got = _sampling_checks(tct, "cpu", (), n=8, nl=2, shots=512, traj=64, bracket_tol=BRACKET_TOL)
    assert got["c"].nqubits == 8
