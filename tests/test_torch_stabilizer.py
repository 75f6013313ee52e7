"""The port's stabilizer simulator against the JAX package's.

The tableau planes (x, z, r) equal the JAX package's numpy ``Tableau`` and
``NativeTableau`` bit for bit after the same seeded random Clifford words
(n = 5, 12); the native samples of one seed are equal (the C++ source is the
JAX package's, byte for byte); ``StabilizerCircuit``'s expectations,
measurements with a status, entropies, inverse, dense states (the replayed
QIR exactly, the tableau's rebuild up to a global phase), samples and
``sample_detectors(seed)`` equal the JAX package's; ``tc2stim``/``stim2tc``
round trips.  F13 (Queue 3 of ``ROADMAP.md``): unseeded ``sample`` calls of
the port differ and ``np.random.seed`` reproduces one; the JAX package's
repeat is asserted as a record.  States: complex64 1e-6.
"""

from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

import chip_smoke
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.core import native_tableau as jnt
from tensorcircuit_ng_tpu.core import tableau as jtab
from tensorcircuit_ng_tpu.translation import stim2tc as jstim2tc
from tensorcircuit_ng_tpu.translation import tc2stim as jtc2stim
from tensorcircuit_ng_tpu_torch.core import native_tableau as pnt
from tensorcircuit_ng_tpu_torch.core import tableau as ptab

STATE_ATOL = 1e-6
NAMES1 = ["h", "s", "sd", "x_gate", "y_gate", "z_gate", "sx"]
NAMES2 = ["cnot", "cz", "cy", "swap", "iswap"]
CIRCUIT1 = {"x_gate": "x", "y_gate": "y", "z_gate": "z"}


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


@pytest.fixture(autouse=True)
def _cpu():
    with tct.set_device("cpu"):
        yield


def clifford_word(n, length, seed):
    """A seeded random word of tableau gate names and qubits."""
    rng = np.random.default_rng(seed)
    word = []
    for _ in range(length):
        if n == 1 or rng.random() < 0.5:
            word.append((NAMES1[rng.integers(len(NAMES1))], (int(rng.integers(n)),)))
        else:
            a, b = rng.choice(n, 2, replace=False)
            word.append((NAMES2[rng.integers(len(NAMES2))], (int(a), int(b))))
    return word


def clifford_circuit(mod, n, length, seed, **kw):
    """The word of :func:`clifford_word` as a ``StabilizerCircuit``."""
    c = mod.StabilizerCircuit(n, **kw)
    for name, idx in clifford_word(n, length, seed):
        getattr(c, CIRCUIT1.get(name, name))(*idx)
    return c


def planes(t):
    return t.x, t.z, t.r


@pytest.mark.parametrize("n", [5, 12])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tableau_planes_bit_for_bit(n, seed):
    tabs = [jtab.Tableau(n), jnt.NativeTableau(n), ptab.Tableau(n), pnt.NativeTableau(n)]
    for name, idx in clifford_word(n, 30 * n, seed):
        for t in tabs:
            getattr(t, name)(*idx)
    ref = planes(tabs[0])
    for t in tabs[1:]:
        for a, b in zip(planes(t), ref):
            assert a.dtype == np.uint8 and np.array_equal(a, b)
    for t in tabs[2:]:
        got = t.stabilizers()
        for a, b in zip(got, tabs[0].stabilizers()):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [5, 12])
def test_tableau_measure_expect_entropy(n):
    jt, pt = jtab.Tableau(n), ptab.Tableau(n)
    jn, pn = jnt.NativeTableau(n), pnt.NativeTableau(n)
    for name, idx in clifford_word(n, 20 * n, 7):
        for t in (jt, pt, jn, pn):
            getattr(t, name)(*idx)
    rng = np.random.default_rng(3)
    for _ in range(20):
        xs = list(rng.choice(n, 2, replace=False))
        zs = [int(rng.integers(n))]
        ys = [q for q in range(n) if q not in xs + zs][:1]
        assert pt.expectation_pauli(xs, zs, ys) == jt.expectation_pauli(xs, zs, ys)
        assert pn.expectation_pauli(xs, zs, ys) == jn.expectation_pauli(xs, zs, ys)
    region = list(range(n // 2))
    assert pt.entanglement_entropy(region) == jt.entanglement_entropy(region)
    assert pn.entanglement_entropy(region) == jn.entanglement_entropy(region)
    for q in range(n):
        st = float(rng.random())
        assert pt.is_random(q) == jt.is_random(q) and pn.is_random(q) == jn.is_random(q)
        assert pt.measure(q, status=st) == jt.measure(q, status=st)
        assert pn.measure(q, status=st) == jn.measure(q, status=st)
    for a, b in zip(planes(pt), planes(jt)):
        assert np.array_equal(a, b)
    for a, b in zip(planes(pn), planes(jn)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5, 2**40 + 3])
def test_native_sample_same_seed(seed):
    jn, pn = jnt.NativeTableau(12), pnt.NativeTableau(12)
    for name, idx in clifford_word(12, 200, 11):
        getattr(jn, name)(*idx)
        getattr(pn, name)(*idx)
    a, b = pn.sample(64, seed), jn.sample(64, seed)
    assert a.dtype == np.uint8 and a.shape == (64, 12) and np.array_equal(a, b)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; nothing falls back to the numpy engine."""
    bad = tmp_path / "tableau.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnt, "SOURCE", bad)
    monkeypatch.setattr(pnt, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pnt, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pnt.make_tableau(3)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tct.StabilizerCircuit(3)
    assert isinstance(pnt.make_tableau(3, prefer_native=False), ptab.Tableau)


def test_native_library_in_build_dir():
    assert pnt.native_tableau_available()
    lib = pnt.library_path()
    assert lib.exists() and lib.name.startswith("libtableau_") and lib.parent.parts[-2:] == ("build", "native")
    assert pnt.SOURCE.read_bytes() == (Path(jnt.__file__).resolve().parents[1] / "native" / "tableau.cpp").read_bytes()


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.StabilizerCircuit(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.StabilizerCircuit(3, device="cuda")


@pytest.mark.parametrize("n", [5, 8])
def test_expectation_ps_and_measure_with_status(n):
    jc, pc = clifford_circuit(tc, n, 15 * n, n), clifford_circuit(tct, n, 15 * n, n)
    rng = np.random.default_rng(n)
    for _ in range(25):
        ps = [int(v) for v in rng.integers(0, 4, size=n)]
        got = pc.expectation_ps(ps=ps)
        assert got.dtype == torch.float32 and got.device.type == "cpu" and got.ndim == 0
        assert got.item() == float(jc.expectation_ps(ps=ps))
    x, y, z = [0], [1], [2]
    assert pc.expectation_ps(x=x, y=y, z=z).item() == float(jc.expectation_ps(x=x, y=y, z=z))
    st = rng.random(n)
    a, pa = pc.measure(*range(n), with_prob=True, status=st)
    b, pb = jc.measure(*range(n), with_prob=True, status=st)
    assert np.array_equal(a, np.asarray(b)) and pa == pb
    st = rng.random((64, n))
    want = jc.sample_expectation_ps(x=[0], z=[1, 2], shots=64, status=st)
    got = pc.sample_expectation_ps(x=[0], z=[1, 2], shots=64, status=st)
    assert got.item() == pytest.approx(float(want), abs=1e-7)
    assert pc.sample_expectation_ps(z=[0]).item() == float(jc.sample_expectation_ps(z=[0]))


def test_cond_measurement_and_post_selection():
    jc, pc = clifford_circuit(tc, 6, 60, 9), clifford_circuit(tct, 6, 60, 9)
    for q, st in [(0, 0.7), (3, 0.2), (5, 0.55)]:
        assert pc.cond_measurement(q, status=st) == jc.cond_measurement(q, status=st)
    np.random.seed(6)
    a = pc.cond_measure_many(1, 2, 4)
    np.random.seed(6)
    b = jc.cond_measure_many(1, 2, 4)
    assert a.dtype == np.int32 and np.array_equal(a, b)
    for x, y in zip(planes(pc.get_tableau()), planes(jc.get_tableau())):
        assert np.array_equal(x, y)
    c = tct.StabilizerCircuit(2)
    c.x(0)
    with pytest.raises(ValueError, match="zero probability"):
        c.mid_measurement(0, keep=0)
    c.h(1)
    c.post_select(1, keep=1)
    assert c.expectation_ps(z=[1]).item() == -1.0


@pytest.mark.parametrize("cut", [[0], [0, 1, 2], [1, 4, 6]])
def test_entanglement_entropy(cut):
    jc, pc = clifford_circuit(tc, 8, 120, 4), clifford_circuit(tct, 8, 120, 4)
    assert pc.entanglement_entropy(cut) == jc.entanglement_entropy(cut)


def test_inverse_and_current_inverse_tableau():
    jc, pc = clifford_circuit(tc, 6, 80, 12), clifford_circuit(tct, 6, 80, 12)
    pi, ji = pc.inverse(), jc.inverse()
    assert pi.device.type == "cpu"
    assert [(i["name"], i["index"]) for i in pi.to_qir()] == [(i["name"], i["index"]) for i in ji.to_qir()]
    for a, b in zip(planes(pi.get_tableau()), planes(ji.get_tableau())):
        assert np.array_equal(a, b)
    echo = pc.copy()
    echo.append(pi)
    for q in range(6):
        assert echo.expectation_ps(z=[q]).item() == 1.0
    for a, b in zip(planes(pc.current_inverse_tableau()), planes(jc.current_inverse_tableau())):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [4, 6, 9])
def test_state_both_routes(n):
    jc, pc = clifford_circuit(tc, n, 6 * n, 20 + n), clifford_circuit(tct, n, 6 * n, 20 + n)
    want = np.asarray(jc.state())
    got = pc.state()
    assert got.device.type == "cpu" and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=STATE_ATOL)
    assert pc.state(form="tensor").shape == (2,) * n
    # the tableau's rebuild: equal to the JAX package's, and the replayed
    # state up to a global phase
    jr = tc.StabilizerCircuit(n, tableau_inputs=jc.get_tableau())
    pr = tct.StabilizerCircuit(n, tableau_inputs=pc.get_tableau())
    rebuilt = pr.state()
    np.testing.assert_allclose(rebuilt.numpy(), np.asarray(jr.state()), atol=STATE_ATOL)
    assert abs(abs(np.vdot(want, rebuilt.numpy())) - 1.0) < 1e-5
    assert pr.wavefunction(form="tensor").shape == (2,) * n


def test_state_after_collapse_and_noise():
    jc, pc = clifford_circuit(tc, 6, 60, 31), clifford_circuit(tct, 6, 60, 31)
    for c in (jc, pc):
        c.cond_measurement(2, status=0.8)
        c.depolarizing(0, 1, p=0.5, status=[0.1, 0.3])
    np.testing.assert_allclose(pc.state().numpy(), np.asarray(jc.state()), atol=STATE_ATOL)


@pytest.mark.parametrize("fmt", [None, "sample_int", "sample_bin", "count_vector", "count_dict_bin"])
def test_sample_seeded_and_with_status(fmt):
    jc, pc = clifford_circuit(tc, 6, 60, 40), clifford_circuit(tct, 6, 60, 40)
    got = pc.sample(32, format=fmt, random_generator=np.random.default_rng(8))
    want = jc.sample(32, format=fmt, random_generator=np.random.default_rng(8))
    st = np.random.default_rng(9).random((32, 6))
    got_s, want_s = pc.sample(32, format=fmt, status=st), jc.sample(32, format=fmt, status=st)
    for g, w in ((got, want), (got_s, want_s)):
        if fmt is None:
            assert all(np.array_equal(a.numpy(), np.asarray(b)) and pa == pb for (a, pa), (b, pb) in zip(g, w))
        elif fmt == "count_dict_bin":
            assert g == w
        else:
            assert np.array_equal(g.cpu().numpy(), np.asarray(w))
    bits, p = pc.sample()
    assert bits.shape == (6,) and bits.dtype == torch.int32 and p == -1.0


def test_sample_wide_register_int64():
    """At n=40 the port's integers are int64 (the JAX package's legacy bits,
    read as integers on the host)."""
    pc = clifford_circuit(tct, 40, 200, 41)
    jc = clifford_circuit(tc, 40, 200, 41)
    got = pc.sample(16, format="sample_int", random_generator=np.random.default_rng(2))
    bits = np.stack([np.asarray(b) for b, _ in jc.sample(16, random_generator=np.random.default_rng(2))])
    want = bits.astype(np.int64) @ (np.int64(2) ** np.arange(39, -1, -1, dtype=np.int64))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_f13_unseeded_samples_differ_and_reseed():
    """Queue 3 F13: the JAX package's unseeded ``sample`` repeats itself
    (recorded); the port's draws its engine seed from numpy's stream."""
    jc, pc = clifford_circuit(tc, 6, 0, 0), clifford_circuit(tct, 6, 0, 0)
    for c in (jc, pc):
        for q in range(6):
            c.h(q)
    a, b = (np.asarray(jc.sample(16, format="sample_bin")) for _ in range(2))
    np.random.seed(1)
    c3 = np.asarray(jc.sample(16, format="sample_bin"))
    assert np.array_equal(a, b) and np.array_equal(a, c3)  # the JAX package's fault, recorded
    np.random.seed(4)
    s1 = pc.sample(16, format="sample_bin")
    s2 = pc.sample(16, format="sample_bin")
    np.random.seed(4)
    s3 = pc.sample(16, format="sample_bin")
    assert not torch.equal(s1, s2) and torch.equal(s1, s3)


def qec_program(mod, rounds=2, **kw):
    """A 3-bit repetition code with lazy noise, measurement records,
    resets, detectors between rounds and an observable."""
    c = mod.StabilizerCircuit(5, **kw)
    for r in range(rounds):
        c.cnot(0, 3)
        c.cnot(1, 3)
        c.cnot(1, 4)
        c.cnot(2, 4)
        c.depolarize1(0, 1, 2, p=0.08)
        c.x_error(3, p=0.05)
        c.z_error(4, p=0.05)
        c.y_error(0, p=0.02)
        c.depolarize2(0, 1, p=0.04)
        c.measure_instruction(3, 4)
        c.reset_instruction(3, 4)
        if r:
            c.detector(-1, -3)
            c.detector(-2, -4)
        else:
            c.detector(-1)
            c.detector(-2)
    c.measure_instruction(0, 1, 2)
    c.detector(-1, -2, -4)
    c.observable_include(-1)
    c.observable_include(-2, idx=1)
    return c


@pytest.mark.parametrize("seed", [0, 11])
def test_sample_detectors_bit_for_bit(seed):
    np.random.seed(0)
    jc = qec_program(tc)
    np.random.seed(0)
    pc = qec_program(tct)
    d1, o1 = pc.sample_detectors(300, seed=seed)
    d2, o2 = jc.sample_detectors(300, seed=seed)
    assert d1.dtype == np.uint8 and d1.shape == (300, 5) and o1.shape == (300, 2)
    assert np.array_equal(d1, d2) and np.array_equal(o1, o2)
    assert 0 < d1.mean() < 0.5


def test_qec_state_skips_records():
    np.random.seed(2)
    jc = qec_program(tc, rounds=1)
    np.random.seed(2)
    pc = qec_program(tct, rounds=1)
    np.testing.assert_allclose(pc.state().numpy(), np.asarray(jc.state()), atol=STATE_ATOL)


def test_random_gate_and_tableau_gate():
    pc, jc = tct.StabilizerCircuit(4), tc.StabilizerCircuit(4)
    word = [("h", (0,)), ("cnot", (0, 1)), ("s", (1,)), ("x", (2,)), ("cx", (1, 2))]
    for c in (pc, jc):
        c.tableau_gate(0, 1, 3, tableau=word)
    for a, b in zip(planes(pc.get_tableau()), planes(jc.get_tableau())):
        assert np.array_equal(a, b)
    rec = tct.StabilizerCircuit(4)
    rec.tableau_gate(0, 1, 3, tableau=word, recorded=True)
    assert [i["index"] for i in rec.to_qir()] == [(0,), (0, 1), (1,), (3,), (1, 3)]
    assert abs(abs(np.vdot(rec.state().numpy(), pc.state().numpy())) - 1.0) < 1e-6
    pc.random_gate(0, 1, 2)
    assert not pc._replayable and abs(torch.linalg.vector_norm(pc.state()).item() - 1) < 1e-6


def test_unsupported_gate_raises():
    c = tct.StabilizerCircuit(2)
    with pytest.raises(ValueError, match="not Clifford"):
        c.t(0)
    with pytest.raises(ValueError, match="parameterized"):
        c.rx(0, theta=0.1)
    with pytest.raises(NotImplementedError):
        c.expectation((np.eye(2), [0]))
    with pytest.raises(ValueError, match="dense inputs"):
        tct.StabilizerCircuit(2, inputs=np.ones(4))


def test_tc2stim_round_trip():
    pc, jc = clifford_circuit(tct, 6, 50, 3), clifford_circuit(tc, 6, 50, 3)
    text = tct.translation.tc2stim(pc)
    assert text == jtc2stim(jc) == pc.current_circuit()
    back = tct.translation.stim2tc(text)
    assert back.device.type == "cpu" and back.nqubits == 6
    assert [(i["name"], i["index"]) for i in back.to_qir()] == [(i["name"], i["index"]) for i in pc.to_qir()]
    for a, b in zip(planes(back.get_tableau()), planes(pc.get_tableau())):
        assert np.array_equal(a, b)


def test_stim2tc_program_with_records_and_repeat():
    program = """# a repetition code
R 0 1 2 3 4
REPEAT 2 {
    CX 0 3 1 3
    CNOT 1 4 2 4
    X_ERROR(0.1) 0 1 2
    DEPOLARIZE1(0.05) 3
    DEPOLARIZE2(0.02) 0 1
    M 3 4
    DETECTOR rec[-1]
    DETECTOR rec[-2]
    R 3 4
    TICK
}
MZ 0 1 2
DETECTOR rec[-1] rec[-2]
OBSERVABLE_INCLUDE(0) rec[-1]
"""
    np.random.seed(3)
    pc = tct.translation.stim2tc(program)
    np.random.seed(3)
    jc = jstim2tc(program)
    strip = [{k: v for k, v in i.items() if k != "gate"} for i in pc.to_qir()]
    assert strip == [{k: v for k, v in i.items() if k != "gate"} for i in jc.to_qir()]
    a, b = pc.sample_detectors(100, seed=4), jc.sample_detectors(100, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="unsupported stim instruction"):
        tct.translation.stim2tc("MPP X0*X1\n")
    with pytest.raises(ValueError, match="no stim equivalent"):
        tct.translation.tc2stim(pc)


@pytest.mark.parametrize("d", [3, 5])
def test_surface_code_program_noiseless_is_deterministic(d):
    """``chip_smoke.surface_code_program`` (phase 19 (a)): without noise
    no detector fires and the observable (a logical Z) reads 0, on the
    tableau and, at d=3, on the dense circuit's trajectories."""
    tab = chip_smoke.surface_code_program(tct, d, 3, 0.0, tableau=True)
    dets, obs = tab.sample_detectors(40, seed=2)
    assert dets.shape == (40, 3 * (d * d - 1)) and obs.shape == (40, 1)
    assert not dets.any() and not obs.any()
    if d == 3:
        c = chip_smoke.surface_code_program(tct, d, 2, 0.0)
        st, sc = chip_smoke.detector_statuses(c, 6)
        det, ob = c.sample_detector(6, status=st, statusc=sc, with_observable=True)
        assert det.shape == (6, 16) and not det.any() and not ob.any()


def test_stab_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 19 at a small size on the CPU (the CPU
    path is its own reference there)."""
    times = chip_smoke._stab_checks(tct, "cpu", **chip_smoke.STAB_SMALL)
    assert all(ms >= 0 for ms, _, _ in times.values())
