"""The port's ``results/`` against the JAX package's on the same counts and
seeds: the counts toolbox, ``ReadoutMit`` (local and global calibrations,
the inverse, the nnls least squares and the M3 solves, the expectation) and
``results/qem`` (folding and ZNE with each factory, dynamical decoupling
with both rules, randomized compiling under one ``random`` seed, the
benchmark circuits).

Both sides are host numpy on their package's circuits; the circuits here
run on the CPU.  The executors are exact: a circuit's Born probabilities
(complex64 states) through a known readout error, rounded to counts, or
its ⟨Z_0⟩ damped by a factor a gate.  Tolerances: counts, calibrations and
corrected counts from the same counts agree to 1e-9 (the same float64
arithmetic); values computed from the two packages' complex64 states to
1e-5; circuits compare item by item (name, wires, matrix within 1e-6).
"""

import random

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.results import counts as jcounts
from tensorcircuit_ng_tpu.results import qem as jqem
from tensorcircuit_ng_tpu.results import ReadoutMit as JReadoutMit
from tensorcircuit_ng_tpu_torch.results import counts as pcounts
from tensorcircuit_ng_tpu_torch.results import qem as pqem
from tensorcircuit_ng_tpu_torch.results import ReadoutMit as PReadoutMit

SAME = 1e-9
STATE_TOL = 1e-5
GATE_TOL = 1e-6
READOUT = [(0.97, 0.93), (0.95, 0.9), (0.99, 0.96), (0.94, 0.97)]


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_on_cpu():
    """One torch and one BLAS thread (xdist runs six modules at once); the
    port's circuits on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1), tct.set_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _probs(c):
    s = c.state()
    s = s.detach().cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
    return np.abs(s.astype(np.complex128)) ** 2


def _readout_counts(p, shots, readout=READOUT):
    """Counts of the probabilities ``p`` through each qubit's confusion
    ``[P(0|0), P(1|1)]``, rounded: deterministic, so both packages see the
    same counts of the same state."""
    n = int(round(np.log2(p.size)))
    t = np.reshape(p, (2,) * n)
    for q in range(n):
        p00, p11 = readout[q % len(readout)]
        a = np.array([[p00, 1 - p11], [1 - p00, p11]])
        t = np.moveaxis(np.tensordot(a, t, axes=([1], [q])), 0, q)
    v = np.round(np.reshape(t, (-1,)) * shots)
    return {format(i, f"0{n}b"): int(x) for i, x in enumerate(v) if x > 0}


def _execute(circuits, shots):
    return [_readout_counts(_probs(c), shots) for c in circuits]


def _ghz(mod, n):
    c = mod.Circuit(n)
    c.h(0)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    c.ry(1, theta=0.3)
    return c


def _same_dict(a, b, tol=SAME):
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= tol * max(1.0, abs(b[k])), k


# ----------------------------------------------------------------------
# counts
# ----------------------------------------------------------------------


def test_counts_toolbox_matches_jax():
    rng = np.random.default_rng(3)
    n = 4
    c1 = {format(i, f"0{n}b"): int(v) for i, v in enumerate(rng.integers(0, 50, size=2**n)) if v}
    c2 = {format(i, f"0{n}b"): int(v) for i, v in enumerate(rng.integers(0, 30, size=2**n)) if v}
    for name, args in (("normalized_count", (c1,)), ("sort_count", (c1,)), ("marginal_count", (c1, [2, 0])),
                       ("merge_count", (c1, c2)), ("reverse_count", (c1,))):
        got, want = getattr(pcounts, name)(*args), getattr(jcounts, name)(*args)
        _same_dict(got, want)
        if name == "sort_count":
            assert list(got) == list(want)
    assert np.array_equal(pcounts.count2vec(c1), jcounts.count2vec(c1))
    assert np.array_equal(pcounts.count2vec(c1, normalization=False), jcounts.count2vec(c1, normalization=False))
    v = pcounts.count2vec(c1)
    _same_dict(pcounts.vec2count(v, prune=True), jcounts.vec2count(v, prune=True))
    assert pcounts.kl_divergence(c1, c2) == jcounts.kl_divergence(c1, c2)
    dop = rng.normal(size=(n, 2))
    for kw in ({"z": [0, 3]}, {"diagonal_op": dop}, {"diagonal_op": rng.normal(size=2**n)}):
        assert pcounts.expectation(c1, **kw) == jcounts.expectation(c1, **kw)


# ----------------------------------------------------------------------
# readout mitigation
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cal", ["local", "global"])
def test_readout_mit_matches_jax(cal):
    n, shots = 4, 100000
    mits = {}
    for mod, cls in ((tc, JReadoutMit), (tct, PReadoutMit)):
        mit = cls(_execute)
        mit.cals_from_system(n, shots=shots, method=cal)
        mits[mod] = mit
    if cal == "local":
        for q in range(n):
            assert np.abs(mits[tct].single_qubit_cals[q] - mits[tc].single_qubit_cals[q]).max() < SAME
    else:
        assert np.abs(mits[tct].global_cal - mits[tc].global_cal).max() < SAME
    raw = {mod: _readout_counts(_probs(_ghz(mod, n)), shots) for mod in (tc, tct)}
    for k in raw[tc]:  # the two packages' complex64 states, rounded to counts
        assert abs(raw[tct].get(k, 0) - raw[tc][k]) <= 1
    counts = raw[tc]
    methods = ["inverse", "square"] + (["M3_direct", "M3_iterative", "M3_auto"] if cal == "local" else [])
    for method in methods:
        _same_dict(mits[tct].apply_correction(counts, method=method), mits[tc].apply_correction(counts, method=method),
                   tol=1e-7 if method == "M3_iterative" else SAME)
        for kw in ({"z": [0, 1]}, {"z": [2]}):
            got = mits[tct].expectation(counts, method=method, **kw)
            assert abs(got - mits[tc].expectation(counts, method=method, **kw)) < 1e-7
    exact = tct.Circuit(n)
    exact.append(_ghz(tct, n))
    want = float(np.real(exact.expectation_ps(z=[0, 1])))
    assert abs(mits[tct].expectation(counts, z=[0, 1], method="inverse") - want) < 1e-2


def test_readout_mit_helpers_match_jax():
    """The calibration circuits, the matrix, the probability mitigation and
    the mapping preprocess."""
    n = 3
    mits = {}
    for mod, cls in ((tc, JReadoutMit), (tct, PReadoutMit)):
        mit = cls(_execute)
        mit.set_local_cals({q: np.array([[p00, 1 - p11], [1 - p00, p11]])
                            for q, (p00, p11) in enumerate(READOUT[:n])})
        mits[mod] = mit
    for name in ("local_miti_readout_circ", "global_miti_readout_circ"):
        got, want = getattr(mits[tct], name)(), getattr(mits[tc], name)()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.abs(_probs(a) - _probs(b)).max() < STATE_TOL
    assert np.abs(mits[tct].get_matrix() - mits[tc].get_matrix()).max() < SAME
    p = np.random.default_rng(1).dirichlet(np.ones(2**n))
    for method in ("inverse", "square"):
        assert np.abs(mits[tct].mitigate_probability(p, method=method)
                      - mits[tc].mitigate_probability(p, method=method)).max() < SAME
    counts = _readout_counts(p, 5000)
    _same_dict(mits[tct].apply_readout_mitigation(counts), mits[tc].apply_readout_mitigation(counts))
    got = mits[tct].mapping_preprocess(counts, [2, 0, 1])
    want = mits[tc].mapping_preprocess(counts, [2, 0, 1])
    _same_dict(got[0], want[0])
    assert got[1] == want[1]


# ----------------------------------------------------------------------
# error mitigation: folding, ZNE, DD, RC, benchmark circuits
# ----------------------------------------------------------------------


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_qir(cp, cj):
    qp, qj = cp.to_qir(), cj.to_qir()
    assert [(it.get("name"), tuple(it["index"])) for it in qp] == [(it.get("name"), tuple(it["index"])) for it in qj]
    for a, b in zip(qp, qj):
        ma, mb = _host(a["gate"].tensor), _host(b["gate"].tensor)
        assert np.abs(ma.reshape(mb.shape) - mb).max() < GATE_TOL


def _workload(mod):
    c = mod.Circuit(4)
    c.h(0)
    c.cnot(0, 1)
    c.rx(2, theta=0.4)
    c.cz(1, 2)
    c.ry(3, theta=-0.7)
    c.cnot(2, 3)
    c.s(0)
    return c


def _z0(c):
    return float(np.real(_host(c.expectation_ps(z=[0]))))


def _damped(c):
    """⟨Z_0⟩ damped by 0.98 a gate: a noise model whose strength folding
    scales."""
    return _z0(c) * 0.98 ** len(c.to_qir())


def test_folding_matches_jax():
    for scale in (1.0, 3.0, 2.4):
        _same_qir(pqem.fold_global(_workload(tct), scale), jqem.fold_global(_workload(tc), scale))
    for scale, seed in ((3.0, 0), (2.5, 7), (4.2, 11)):
        cp = pqem.fold_gates_at_random(_workload(tct), scale, seed=seed)
        cj = jqem.fold_gates_at_random(_workload(tc), scale, seed=seed)
        _same_qir(cp, cj)
        assert abs(_z0(cp) - _z0(_workload(tct))) < STATE_TOL


@pytest.mark.parametrize("factory", ["LinearFactory", "RichardsonFactory", "PolyFactory", "ExpFactory"])
def test_zne_with_each_factory_matches_jax(factory):
    fp, fj = getattr(pqem, factory)(), getattr(jqem, factory)()
    for fold in ("fold_global", "fold_gates_at_random"):
        got = pqem.apply_zne(_workload(tct), _damped, factory=fp, scale_noise=getattr(pqem, fold))
        want = jqem.apply_zne(_workload(tc), _damped, factory=fj, scale_noise=getattr(jqem, fold))
        assert abs(got - want) < STATE_TOL
    assert abs(pqem.zne_option.RichardsonFactory([1, 2]).extrapolate([1, 2], [0.5, 0.4])
               - jqem.zne_option.RichardsonFactory([1, 2]).extrapolate([1, 2], [0.5, 0.4])) < SAME


def _idle(mod):
    c = mod.Circuit(3)
    c.h(0)
    for _ in range(4):
        c.cnot(0, 1)
        c.rx(1, theta=0.3)
    c.h(2)
    c.cnot(1, 2)
    return c


@pytest.mark.parametrize("rule", ["xx", "xyxy", ["x", "y", "x", "y"]])
def test_dynamical_decoupling_matches_jax(rule):
    rp = getattr(pqem.dd_option.rules, rule) if isinstance(rule, str) else rule
    rj = getattr(jqem.dd_option.rules, rule) if isinstance(rule, str) else rule
    if isinstance(rule, str):
        dp, dj = pqem.add_dd(_idle(tct), rp), jqem.add_dd(_idle(tc), rj)
        _same_qir(dp, dj)
        _same_qir(pqem.prune_ddcircuit(dp, [0, 1]), jqem.prune_ddcircuit(dj, [0, 1]))
        assert pqem.used_qubits(dp) == jqem.used_qubits(dj)
    for fulldd in (False, True):
        vp, cp = pqem.apply_dd(_idle(tct), _z0, rp, full_output=True, fulldd=fulldd)
        vj, cj = jqem.apply_dd(_idle(tc), _z0, rj, full_output=True, fulldd=fulldd)
        _same_qir(cp, cj)
        assert abs(vp - vj) < STATE_TOL
    count = lambda c: _readout_counts(_probs(c), 1000)  # noqa: E731
    _same_dict(pqem.apply_dd(_idle(tct), count, rp, iscount=True, num_trials=2),
               jqem.apply_dd(_idle(tc), count, rj, iscount=True, num_trials=2), tol=1.0)


def test_randomized_compiling_matches_jax():
    """Under one ``random`` seed both draw the same twirls: the same
    circuits, with the same unitary as the workload."""
    for seed in (0, 5):
        random.seed(seed)
        cp = pqem.rc_circuit(_workload(tct))
        random.seed(seed)
        cj = jqem.rc_circuit(_workload(tc))
        _same_qir(cp, cj)
        assert abs(_z0(cp) - _z0(_workload(tct))) < STATE_TOL
    cnot = tct.gates.cnot()
    assert pqem.rc_candidates(cnot) == jqem.rc_candidates(tc.gates.cnot())
    random.seed(3)
    vp, circuits = pqem.apply_rc(_workload(tct), _z0, num_to_average=3, simplify=False)
    random.seed(3)
    vj, _ = jqem.apply_rc(_workload(tc), _z0, num_to_average=3, simplify=False)
    assert abs(vp - vj) < STATE_TOL and len(circuits) == 3
    # the default simplify=True runs each twirl through compiler.simple_compile
    random.seed(7)
    vp, circuits = pqem.apply_rc(_workload(tct), _z0, num_to_average=2)
    random.seed(7)
    vj, jcircuits = jqem.apply_rc(_workload(tc), _z0, num_to_average=2)
    for cp, cj in zip(circuits, jcircuits):
        _same_qir(cp, cj)
    assert abs(vp - vj) < STATE_TOL and len(circuits) == 2


def test_benchmark_circuits_match_jax():
    for name, args in (("ghz_circuit", (5,)), ("w_circuit", (4,)), ("rb_circuit", (1, 12, 3))):
        (cp, ip), (cj, ij) = getattr(pqem, name)(*args), getattr(jqem, name)(*args)
        assert ip == ij
        assert np.abs(_probs(cp) - _probs(cj)).max() < STATE_TOL
    edges = [(0, 1), (1, 2), (2, 3)]
    (cp, ip), (cj, ij) = pqem.mirror_circuit(3, 0.5, edges, 4), jqem.mirror_circuit(3, 0.5, edges, 4)
    assert ip == ij
    _same_qir(cp, cj)
    params = np.random.default_rng(2).normal(size=(2, 2))
    cp = pqem.QAOA_circuit([(0, 1), (1, 2)], [1.0, 0.5], params)
    cj = jqem.QAOA_circuit([(0, 1), (1, 2)], [1.0, 0.5], params)
    assert np.abs(_probs(cp) - _probs(cj)).max() < STATE_TOL
