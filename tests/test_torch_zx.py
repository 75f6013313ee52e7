"""The port's ``zx/`` against the JAX package's: fast siblings of
``tests/test_zx.py``'s 20 tests (its 4 ``slow`` ones included, at small
sizes), and the sampler against the JAX one on the same inputs.

Both packages build the same diagrams from the same circuits: spider counts
after ``simplify`` and their kinds are equal, matrices within 1e-5
(complex64) of each other and of ``Circuit.matrix()`` up to the diagram's
scalar.  The host algebra (``graph_s``, ``utils``, the channel algebra) is
equal to the JAX package's exactly; ``ExactScalarArray`` coefficients and
powers are equal ints.  The compiled sampler is held to the JAX one on the
same f-bits and uniforms: a record may differ only where its uniform lies
within 1e-6 of the threshold 1 - p1 (float32 marginals summed in another
order), and the prefix probabilities within 1e-5.  Draws (torch's
generator against JAX's keys) are held by statistics only: rates within 5
standard deviations of the exact value.  Inputs come from numpy seeds; the
port runs on the CPU at complex64, on one BLAS thread.
"""

import math

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import zx as jzx
from tensorcircuit_ng_tpu.zx import converter as jconv
from tensorcircuit_ng_tpu.zx import noise_model as jnm
from tensorcircuit_ng_tpu.zx import scalar_graph as jsg
from tensorcircuit_ng_tpu_torch import zx
from tensorcircuit_ng_tpu_torch.zx import converter as conv
from tensorcircuit_ng_tpu_torch.zx import noise_model as nm
from tensorcircuit_ng_tpu_torch.zx import scalar_graph as sg

TOL = 1e-5
SIGMAS = 5.0
#: a record may differ from the JAX sampler's only this near its threshold
BRACKET = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_on_cpu():
    """One torch and one BLAS thread (xdist runs six modules at once); the
    port on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1), tct.set_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _phase_aligned(a, b):
    """max |a/|a| - e^{iφ} b/|b|| over the entries, φ the best phase."""
    a = _np(a).reshape(-1)
    b = _np(b).reshape(-1)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    ph = np.vdot(b, a)
    return float(np.abs(a - ph / abs(ph) * b).max())


def _rate_sigmas(bits, p):
    """|mean - p| in standard deviations of a mean of len(bits) draws."""
    bits = _np(bits).astype(np.float64)
    sigma = math.sqrt(max(p * (1 - p), 1e-12) / bits.shape[0])
    return float(np.max(np.abs(bits.mean(axis=0) - p) / sigma))


BUILDERS = {
    "h_cnot": lambda c: (c.h(0), c.cnot(0, 1)),
    "s_cz": lambda c: (c.h(0), c.s(0), c.cz(0, 1), c.h(1)),
    "t_rz": lambda c: (c.t(0), c.rz(1, theta=0.7), c.cnot(1, 0)),
    "rzz": lambda c: (c.h(0), c.h(1), c.rzz(0, 1, theta=0.9)),
    "x_rx_swap": lambda c: (c.x(0), c.rx(1, theta=0.4), c.swap(0, 1)),
    "cphase": lambda c: (c.h(0), c.cphase(0, 1, theta=0.5)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_zx_matrix_matches_jax_and_circuit(name):
    c, jc = tct.Circuit(2), tc.Circuit(2)
    BUILDERS[name](c)
    BUILDERS[name](jc)
    g, jg = zx.circuit_to_zx(c), jzx.circuit_to_zx(jc)
    m = g.to_matrix()
    assert m.device.type == "cpu" and m.dtype == torch.complex64
    np.testing.assert_allclose(_np(m), np.asarray(jg.to_matrix()), atol=TOL)
    assert _phase_aligned(m, c.matrix()) < TOL
    assert g.num_spiders() == jg.num_spiders() and g.scalar_power2 == jg.scalar_power2


def _random_clifford_t(mods, n, steps, seed):
    rng = np.random.default_rng(seed)
    cs = [m.Circuit(n) for m in mods]
    names1 = ["h", "s", "t", "x", "z"]
    for _ in range(steps):
        if rng.random() < 0.6:
            name, q = names1[rng.integers(len(names1))], int(rng.integers(n))
            for c in cs:
                getattr(c, name)(q)
        else:
            q = int(rng.integers(n - 1))
            for c in cs:
                c.cnot(q, q + 1)
        if rng.random() < 0.3:
            q, th = int(rng.integers(n)), float(rng.normal())
            for c in cs:
                c.rz(q, theta=th)
    return cs


@pytest.mark.parametrize("seed", [4, 5])
def test_simplify_shrinks_as_jax_and_keeps_the_matrix(seed):
    c, jc = _random_clifford_t((tct, tc), 4, 16, seed)
    g, jg = zx.circuit_to_zx(c), jzx.circuit_to_zx(jc)
    m0 = _np(g.to_matrix())
    removed, jremoved = zx.simplify(g), jzx.simplify(jg)
    assert removed == jremoved > 0
    assert g.num_spiders() == jg.num_spiders()
    assert sorted(s.kind for s in g.spiders.values()) == sorted(s.kind for s in jg.spiders.values())
    assert {s.kind for s in g.spiders.values()} <= {"Z", "B"}
    assert zx.simplifier.t_count(g) == jzx.simplifier.t_count(jg)
    m1 = _np(g.to_matrix())
    np.testing.assert_allclose(m1, m0, atol=TOL)
    np.testing.assert_allclose(m1, np.asarray(jg.to_matrix()), atol=TOL)
    assert _phase_aligned(m1, c.matrix()) < TOL


def test_fusion_identity_removal_and_closed_scalar():
    c = tct.Circuit(2)
    c.rz(0, theta=0.3)
    c.rz(0, theta=0.4)
    c.cnot(0, 1)
    c.rz(1, theta=0.5)
    g = zx.circuit_to_zx(c)
    before = _np(g.to_matrix())
    assert g.fuse_spiders() > 0
    assert _phase_aligned(g.to_matrix(), before) < TOL
    # B - (H) - Z(0) - (H) - B is a plain wire
    w = zx.ZXGraph()
    bi, z, bo = w.add_spider("B"), w.add_spider("Z", 0.0), w.add_spider("B")
    w.inputs, w.outputs = [bi], [bo]
    w.add_edge(bi, z, hadamard=True)
    w.add_edge(z, bo, hadamard=True)
    assert zx.remove_identities(w) == 1
    np.testing.assert_allclose(_np(w.to_matrix()), np.eye(2), atol=1e-6)
    # <0|rz|0> as a matrix entry, and <11|C|00> as a closed diagram
    c1 = tct.Circuit(1)
    c1.rz(0, theta=0.8)
    assert _phase_aligned(zx.circuit_to_zx(c1).to_matrix()[0, 0].reshape(1), c1.amplitude("0").reshape(1)) < TOL
    for mod, pkg in ((tct, zx), (tc, jzx)):
        cc = mod.Circuit(2)
        cc.h(0)
        cc.cx(0, 1)
        cc.t(0)
        val = complex(_np(pkg.build_amplitude_graph(cc, "11").scalar()))
        assert abs(val - complex(_np(cc.amplitude("11")))) < TOL


def test_exact_scalar_coefficients_equal_jax():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 16, size=(2, 3))
    ours = zx.ExactScalarArray.from_phase_eighth(torch.as_tensor(k))
    theirs = jzx.ExactScalarArray.from_phase_eighth(k)
    np.testing.assert_array_equal(_np(ours.coeffs), np.asarray(theirs.coeffs))
    prod, jprod = ours * ours.scale_sqrt2(1), theirs * theirs.scale_sqrt2(1)
    for a, b in ((prod, jprod), (prod.prod(axis=1), jprod.prod(axis=1)), (ours.sum(axis=0), theirs.sum(axis=0))):
        np.testing.assert_array_equal(_np(a.coeffs), np.asarray(b.coeffs))
        np.testing.assert_array_equal(_np(a.power), np.asarray(b.power))
    np.testing.assert_allclose(_np(prod.to_complex()), np.asarray(jprod.to_complex()), rtol=TOL, atol=TOL)
    mixed = zx.ExactScalarArray.one() + zx.ExactScalarArray.one().scale_sqrt2(1)
    jmixed = jzx.ExactScalarArray.one() + jzx.ExactScalarArray.one().scale_sqrt2(1)
    np.testing.assert_array_equal(_np(mixed.coeffs), np.asarray(jmixed.coeffs))
    assert abs(complex(_np(mixed.to_complex())) - (1 + math.sqrt(2))) < TOL
    w = zx.ExactScalarArray.from_phase_eighth(1)
    acc = zx.ExactScalarArray.one()
    for _ in range(8):
        acc = acc * w
    assert abs(complex(_np(acc.to_complex())) - 1.0) < 1e-6
    assert abs(complex(_np((w + w).to_complex())) - 2 * np.exp(1j * np.pi / 4)) < 1e-6


def test_gf2_matmul_rank_and_find_basis_equal_jax():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 2, size=(6, 9)), rng.integers(0, 2, size=(9, 4))
    np.testing.assert_array_equal(_np(zx.gf2_matmul(a, b)), np.asarray(jzx.gf2_matmul(a, b)))
    np.testing.assert_array_equal(_np(zx.gf2_matmul([[1, 1], [0, 1]], [[1, 0], [1, 1]])), [[0, 1], [1, 1]])
    for shape in ((5, 3), (8, 8), (12, 6)):
        m = rng.integers(0, 2, size=shape)
        m[-1] = m[0] ^ m[1]
        assert zx.gf2_rank(torch.as_tensor(m)) == jzx.gf2_rank(m)
        basis, transform = zx.find_basis(m)
        jbasis, jtransform = jzx.find_basis(m)
        np.testing.assert_array_equal(basis, jbasis)
        np.testing.assert_array_equal(transform, jtransform)
        np.testing.assert_array_equal((transform @ basis) % 2, m % 2)


def test_connected_components_and_stab_decompositions_equal_jax():
    c, jc = tct.Circuit(4), tc.Circuit(4)
    for x in (c, jc):
        x.h(0)
        x.cx(0, 1)
        x.h(2)
        x.cx(2, 3)
    comps = zx.connected_components(zx.circuit_to_zx(c))
    jcomps = jzx.connected_components(jzx.circuit_to_zx(jc))
    assert [len(k.graph.spiders) for k in comps] == [len(k.graph.spiders) for k in jcomps]
    assert [k.output_indices for k in comps] == [k.output_indices for k in jcomps]
    for (cf, ops), (jcf, jops) in zip(sg.find_stab(3), jsg.find_stab(3)):
        assert cf == jcf and all(np.array_equal(x, y) for x, y in zip(ops, jops))
    acc = sum(cf * ops[0] for cf, ops in sg.find_stab(1))
    np.testing.assert_allclose(acc, np.diag([1.0, np.exp(0.25j * np.pi)]), atol=1e-12)
    for (cf, v), (jcf, jv) in zip(sg.find_stab_magic(2), jsg.find_stab_magic(2)):
        assert cf == jcf and np.array_equal(v, jv)
    u3 = sg.find_stab_u3(0.7, 0.3, -0.4)
    assert len(u3) == len(jsg.find_stab_u3(0.7, 0.3, -0.4))
    rz = lambda a: np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)])  # noqa: E731
    ry = lambda a: np.array([[np.cos(a / 2), -np.sin(a / 2)], [np.sin(a / 2), np.cos(a / 2)]])  # noqa: E731
    np.testing.assert_allclose(sum(cf * m for cf, m in u3), rz(0.3) @ ry(0.7) @ rz(-0.4), atol=1e-10)


def test_channel_algebra_equals_jax():
    rng = np.random.default_rng(0)
    for k in (1, 2, 3):
        a, b = rng.random(2**k), rng.random(2**k)
        a, b = a / a.sum(), b / b.sum()
        np.testing.assert_array_equal(nm.xor_convolve(a, b), jnm.xor_convolve(a, b))
    chans = [nm.Channel(nm.pauli_channel_1_probs(0.05, 0.02, 0.03), (2, 0)),
             nm.Channel(nm.error_probs(0.1), (0,)), nm.Channel(nm.error_probs(0.2), (0,)),
             nm.Channel(nm.error_probs(0.3), (3,)), nm.Channel(nm.correlated_error_probs([0.1, 0.2]), (1, 2)),
             nm.Channel(nm.pauli_channel_2_probs(*rng.random(15) / 30), (0, 1, 2, 3))]
    jchans = [jnm.Channel(c.probs, c.unique_col_ids) for c in chans]
    for null in (None, 3):
        ours, theirs = nm.simplify_channels(chans, null_col_id=null), jnm.simplify_channels(jchans, null_col_id=null)
        assert [c.unique_col_ids for c in ours] == [c.unique_col_ids for c in theirs]
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(x.probs, y.probs)


def test_channel_sampler_merges_and_draws_at_the_rate():
    s = nm.ChannelSampler([nm.error_probs(0.1), nm.error_probs(0.2)], np.array([[1, 1]]), seed=42, device="cpu")
    js = jnm.ChannelSampler([jnm.error_probs(0.1), jnm.error_probs(0.2)], np.array([[1, 1]]), seed=42)
    assert len(s.channels) == len(js.channels) == 1 and s.num_f_params == 1
    np.testing.assert_array_equal(s.channels[0].probs, js.channels[0].probs)
    p_eff = 0.1 * 0.8 + 0.9 * 0.2
    out, gen = s.sample_jax(100000)
    assert out.dtype == torch.uint8 and out.shape == (100000, 1) and isinstance(gen, torch.Generator)
    assert _rate_sigmas(out, p_eff) < SIGMAS
    assert _rate_sigmas(s.sample(100000), p_eff) < SIGMAS
    # the same seed draws the same bits; a generator given is used
    again = nm.ChannelSampler([nm.error_probs(0.1), nm.error_probs(0.2)], np.array([[1, 1]]), seed=42,
                              device="cpu").sample_jax(100000)[0]
    assert torch.equal(out, again)
    assert not torch.equal(s.sample_jax(100000, torch.Generator().manual_seed(1))[0], out)
    # several channels XOR onto shared columns: each column at its exact rate
    t = np.array([[1, 0, 1], [0, 1, 1]])
    s3 = nm.ChannelSampler([nm.error_probs(0.1), nm.error_probs(0.2), nm.error_probs(0.3)], t, seed=1,
                           device="cpu")
    bits = s3.sample_jax(50000)[0]
    f0 = 0.1 * 0.7 + 0.9 * 0.3
    f1 = 0.2 * 0.7 + 0.8 * 0.3
    assert _rate_sigmas(bits[:, :1], f0) < SIGMAS and _rate_sigmas(bits[:, 1:], f1) < SIGMAS


def _program(mod_zx, **kw):
    """A 4-qubit noisy Clifford+T program with X/Y/Z-basis measurements,
    resets, a flipped measurement, detectors and an observable."""
    c = mod_zx.StabilizerTCircuit(4, seed=5, **kw)
    c.h(0)
    c.t(0)
    c.cnot(0, 1)
    c.depolarize1(1, p=0.2)
    c.rx(2, theta=0.7)
    c.cz(1, 2)
    c.x_error(3, p=0.3)
    c.y_error(2, p=0.1)
    c.correlated_error([(0, "z"), (3, "x")], [0.2, 0.1])
    c.depolarizing2(2, 3, p=0.15)
    c.measure_instruction(0, p=0.1)
    c.mx(1)
    c.my(2)
    c.mr_instruction(3)
    c.h(3)
    c.t(3)
    c.reset_z(1)
    c.cnot(3, 1)
    c.measure_instruction(1, 3)
    c.detector_instruction(-1, -2)
    c.detector_instruction(-3)
    c.observable_instruction(-4, idx=0)
    return c


def _compiled(mod_zx, mod_sg, c):
    prepared = mod_zx.prepare_graph(c)
    return prepared, mod_sg.compile_program(prepared)


def test_sample_fn_bits_equal_jax_on_given_inputs():
    c, jc = _program(zx, device="cpu"), _program(jzx)
    (prep, prog), (jprep, jprog) = _compiled(zx, sg, c), _compiled(jzx, jsg, jc)
    assert prep.num_f == jprep.num_f and prep.steps.__len__() == jprep.steps.__len__()
    import jax

    rng = np.random.default_rng(11)
    shots = 256
    f = rng.integers(0, 2, size=(shots, prep.num_f)).astype(np.float32)
    u = rng.random((shots, len(prep.visible_pos))).astype(np.float32)
    bits, margin = prog.components[0].sample_fn(torch.as_tensor(f), torch.as_tensor(u), with_margin=True)
    jbits = np.asarray(jax.jit(jax.vmap(jprog.components[0].sample_fn))(f, u))
    assert bits.shape == jbits.shape == (shots, prep.num_records)
    differ = np.any(_np(bits) != jbits, axis=1)
    assert np.all(_np(margin)[differ] < BRACKET), (np.flatnonzero(differ), _np(margin)[differ])
    assert differ.sum() <= 2
    # the prefix graphs: P(records so far | f) within 1e-5 of the JAX ones
    for i in (1, prep.num_records // 2, prep.num_records):
        m = rng.integers(0, 2, size=(64, i)).astype(np.float32)
        params = np.hstack([f[:64], m, np.ones((64, 1), np.float32)])
        got = _np(prog.components[0].compiled_scalar_graphs[i].eval(torch.as_tensor(params)))
        want = np.asarray(jax.jit(jprog.components[0].compiled_scalar_graphs[i].eval)(params))
        np.testing.assert_allclose(got, want, atol=TOL)
    assert np.all(_np(prog.components[0].compiled_scalar_graphs[0].eval(torch.as_tensor(f))) == 1.0)
    # the batched route equals the rows one at a time
    one = torch.cat([prog.components[0].sample_fn(torch.as_tensor(f[i:i + 1]), torch.as_tensor(u[i:i + 1]))
                     for i in range(8)])
    assert torch.equal(one, bits[:8])


def test_scalar_graph_route_samples_the_same_distribution():
    """``sample_component`` without the fused sampler (the prefix graphs
    one output at a time): a Bell pair's outcomes equal, at rate 1/2."""
    c = zx.StabilizerTCircuit(2, seed=7, device="cpu")
    c.h(0)
    c.cx(0, 1)
    c.measure_instruction(0, 1)
    prog, sampler, _ = c._compile()
    comp = prog.components[0]
    comp.sample_fn = None
    bits, gen, _ = zx.sample_component(comp, torch.zeros((4000, 1)), torch.Generator().manual_seed(3))
    assert torch.equal(bits[:, 0], bits[:, 1]) and _rate_sigmas(bits[:, :1], 0.5) < SIGMAS


def test_bell_and_t_gate_statistics():
    c = zx.StabilizerTCircuit(2, seed=7, device="cpu")
    c.h(0)
    c.cx(0, 1)
    c.measure_instruction(0)
    c.measure_instruction(1)
    s = c.sample_measurements(3000)
    assert s.dtype == torch.bool and torch.equal(s[:, 0], s[:, 1])
    assert _rate_sigmas(s[:, :1], 0.5) < SIGMAS
    c2, jc2 = zx.StabilizerTCircuit(1, seed=3, device="cpu"), jzx.StabilizerTCircuit(1, seed=3)
    for x in (c2, jc2):
        x.h(0)
        x.t(0)
        x.h(0)
        x.measure_instruction(0)
    exact = abs((1 - np.exp(1j * np.pi / 4)) / 2) ** 2
    assert _rate_sigmas(c2.sample_measurements(20000), exact) < SIGMAS
    p = _np(c2.outcome_probability(np.array([1.0]), shots=3))
    np.testing.assert_allclose(p, np.asarray(jc2.outcome_probability(np.array([1.0]), shots=3)), atol=TOL)
    np.testing.assert_allclose(p, exact, atol=TOL)
    # the same seed gives the same shots
    c3 = zx.StabilizerTCircuit(1, seed=3, device="cpu")
    c3.h(0)
    c3.t(0)
    c3.h(0)
    c3.measure_instruction(0)
    assert torch.equal(c3.sample_measurements(500, seed=9), c2.sample_measurements(500, seed=9))


def test_noise_detectors_and_expectation_statistics():
    c = zx.StabilizerTCircuit(3, seed=11, device="cpu")
    c.x_error(1, p=0.2)
    c.cx(0, 2)
    c.measure_instruction(0)
    c.measure_instruction(1)
    c.measure_instruction(2)
    c.detector_instruction(-2)
    c.detector_instruction(-1, -3)
    det = c.sample_detectors(20000)
    assert det.dtype == torch.bool and det.shape == (20000, 2)
    assert _rate_sigmas(det[:, :1], 0.2) < SIGMAS and not det[:, 1].any()
    d, o = c.sample_detectors(100, separate_observables=True, use_reference=True)
    assert d.shape == (100, 2) and o.shape == (100, 0)
    c6, jc6 = zx.StabilizerTCircuit(1, seed=9, device="cpu"), jzx.StabilizerTCircuit(1, seed=9)
    for x in (c6, jc6):
        x.h(0)
        x.depolarizing(0, 0.1, 0.1, 0.1)
    e = float(c6.expectation_ps(x=[0], shots=8000))
    assert abs(e - 0.6) < SIGMAS * math.sqrt(0.64 / 8000)


def test_amplitude_outcome_probability_and_expectation_equal_jax():
    base, jbase = tct.Circuit(3), tc.Circuit(3)
    for x in (base, jbase):
        x.h(0)
        x.cx(0, 1)
        x.rz(2, theta=0.5)
        x.cx(1, 2)
        x.t(0)
        x.ry(2, theta=0.3)
    st, jst = zx.StabilizerTCircuit.from_circuit(base), jzx.StabilizerTCircuit.from_circuit(jbase)
    assert st.device.type == "cpu"
    for bits in ("000", "111", "011"):
        a = complex(_np(st.amplitude(bits)))
        assert abs(a - complex(np.asarray(jst.amplitude(bits)))) < TOL
        assert abs(a - complex(_np(base.amplitude(bits)))) < TOL
    for kw in ({"z": [0, 2]}, {"y": [2], "x": [1]}):
        e = float(st.expectation_ps(**kw))
        assert abs(e - float(np.real(np.asarray(jst.expectation_ps(**kw))))) < TOL
        assert abs(e - float(torch.real(base.expectation_ps(**kw)))) < TOL
    st.measure_instruction(0, 1, 2)
    jst.measure_instruction(0, 1, 2)
    for bits in ([1, 1, 0],):
        got = _np(st.outcome_probability(np.array(bits, dtype=float), shots=2))
        np.testing.assert_allclose(got, np.asarray(jst.outcome_probability(np.array(bits, dtype=float), shots=2)),
                                   atol=TOL)
        want = abs(complex(_np(base.amplitude("".join(map(str, bits)))))) ** 2
        np.testing.assert_allclose(got, want, atol=TOL)


def test_from_stim_str_and_from_circuit():
    text = "R 0 1 2\nX_ERROR(0.1) 0\nCX 0 1\nM 1\nDETECTOR rec[-1]\nM 0 2\n"
    c = zx.StabilizerTCircuit.from_stim_str(text, device="cpu")
    jc = jzx.StabilizerTCircuit.from_stim_str(text)
    assert c.nqubits == jc.nqubits == 3
    assert [t["kind"] for t in c._tape] == [t["kind"] for t in jc._tape]
    assert _rate_sigmas(c.sample_detectors(4000, seed=1), 0.1) < SIGMAS
    src = tct.Circuit(2)
    src.h(0)
    src.cnot(0, 1)
    src.rx(1, theta=0.3)
    st = zx.StabilizerTCircuit.from_circuit(src)
    assert [t["name"] for t in st._tape] == [it["name"] for it in src.to_qir()]
    np.testing.assert_allclose(_np(st._unitary_state()), _np(src.state()), atol=TOL)


def test_graphs_and_graph_representation_equal_jax():
    from tensorcircuit_ng_tpu.zx import graph_s as jgs
    from tensorcircuit_ng_tpu_torch.zx import graph_s as gs

    for mod in (gs, jgs):
        g = mod.GraphS()
        i, a, b, o = (g.add_vertex(t) for t in (0, 1, 1, 0))
        g.add_edge((i, a))
        g.add_edge((a, b), mod.EdgeType.HADAMARD)
        g.add_edge((a, b), mod.EdgeType.HADAMARD)
        g.add_edge((b, o))
        g.set_inputs([i])
        g.set_outputs([o])
        assert g.edge_type((a, b)) == 0
        np.testing.assert_allclose(g.to_tensor(), 0.5 * np.ones((2, 2)), atol=1e-12)
    br, jbr = zx.GraphRepresentation(), jzx.GraphRepresentation()
    for x, mod in ((br, zx), (jbr, jzx)):
        v1 = x.add_vertex(mod.VertexType.Z, qubit=0, row=1, phase=0.5)
        v2 = x.add_vertex(mod.VertexType.Z, qubit=0, row=2)
        x.add_edge((v1, v2))
        x.add_to_phase(v1, 0.25, params={"e0"})
        x.observables_dict[0] = v2
    assert br.phase(0) == jbr.phase(0) == 0.75 and br.get_params(0) == jbr.get_params(0) == {"e0"}
    assert br.observables == jbr.observables and br.copy().num_vertices() == 2
    with pytest.raises(AttributeError):
        br.not_a_method


def test_f24_sampling_graph_of_a_noisy_tape():
    """Queue 3 F24: the JAX ``build_sampling_graph`` reads ``num_bits`` /
    ``slots`` keys that its tape's channel items lack (KeyError on any
    noisy program) and a rotation's angle its tape does not keep.  The
    port names error bit k as f-bit k of ``prepare_graph``; a noiseless
    Clifford+T tape gives the JAX package's graph."""
    c, jc = _program(zx, device="cpu"), _program(jzx)
    with pytest.raises(KeyError):
        jconv.build_sampling_graph(jc)
    g = conv.build_sampling_graph(c)
    prep, jprep = conv.prepare_graph(c), jconv.prepare_graph(jc)
    flips = {s[4] for s in prep.steps if s[0] == "measure" and s[4] is not None}
    names = sorted({v for vs in g.phase_vars.values() for v in vs})
    assert names == sorted(f"e{k}" for k in range(prep.num_f) if k not in flips)
    assert [s[0] for s in prep.steps] == [s[0] for s in jprep.steps]
    assert prep.num_f == jprep.num_f and prep.detectors == jprep.detectors
    assert prep.observables == jprep.observables
    for x, y in zip(prep.channel_probs, jprep.channel_probs):
        np.testing.assert_array_equal(x, y)
    clean, jclean = zx.StabilizerTCircuit(3, seed=1, device="cpu"), jzx.StabilizerTCircuit(3, seed=1)
    for x in (clean, jclean):
        x.h(0)
        x.t(0)
        x.cnot(0, 1)
        x.cz(1, 2)
        x.s(2)
        x.measure_instruction(0, 1)
        x.mx(2)
    g, jg = conv.build_sampling_graph(clean), jconv.build_sampling_graph(jclean)
    assert g.num_spiders() == jg.num_spiders() and g.edges == jg.edges
    assert g.scalar_power2 == jg.scalar_power2


def test_mlzx_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 23 at a small size on the CPU: (a)-(c) the
    ML bridges on the TFIM path, (d) a d=2 surface code's shots against the
    tableau and, with a T gate, against the dense detectors, (e) a
    Clifford+T diagram's matrix."""
    import chip_smoke

    times = chip_smoke._mlzx_checks(tct, "cpu", (), **chip_smoke.MLZX_SMALL)
    assert {label[:3] for label in times} == {"(a)", "(b)", "(c)", "(d)", "(e)"}


def test_clifford_t_diagram_matrix_equals_jax():
    """Phase 23 (e)'s circuit in both packages at n=6: spider counts
    after ``simplify`` equal, the matrices within 1e-5 of each other and of
    ``Circuit.matrix()`` up to the diagram's scalar."""
    import chip_smoke

    n = 6
    c, jc = chip_smoke.clifford_t_circuit(tct, n, 4 * n), chip_smoke.clifford_t_circuit(tc, n, 4 * n)
    g, jg = zx.circuit_to_zx(c), jzx.circuit_to_zx(jc)
    assert zx.simplify(g) == jzx.simplify(jg) and g.num_spiders() == jg.num_spiders()
    m = g.to_matrix()
    np.testing.assert_allclose(_np(m), np.asarray(jg.to_matrix()), atol=TOL)
    assert chip_smoke._phase_aligned_err(m, c.matrix()) < TOL
