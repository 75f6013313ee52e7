"""``MPSCircuit`` and ``FiniteMPS`` of the port against the JAX package's, on
the CPU, case by case as ``tests/test_mpscircuit.py`` holds the JAX ones:
the exact regime against the dense circuit, the amplitude and norm,
truncation, the entropy, the factorization of a dense state, gates on 3-6
sites (7 refused), ``perfect_sampling`` and ``sample`` with the same status (equal
shots, or a shot whose uniform lies within 1e-6 of its float64 cdf
boundary), ``measure`` under one ``np.random.seed``, the MPO machinery and
``compress``, the rest of the reference API, ``FiniteMPS``'s environments,
the device a derived object keeps, and ``chip_smoke.py``'s phase 16 at a
small size (the gradients are in ``test_torch_mps_gradients.py``).

Tolerances: complex64 1e-5, complex128 1e-10 (a float32 probability of a
shot 1e-6: the JAX package keeps it in float32 at both dtypes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import chip_smoke as cs
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.models.mpscircuit import MPSCircuit as JMPS
from tensorcircuit_ng_tpu.models.mpscircuit import split_tensor as jsplit
from tensorcircuit_ng_tpu_torch.models.mpscircuit import split_tensor as tsplit

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


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _pair(n, chi=None):
    """The port's and the JAX package's MPSCircuit with the same rules."""
    split = {"max_singular_values": chi}
    return tct.MPSCircuit(n, split=split), JMPS(n, split=split)


def _random_ops(c, seed=0, layers=3):
    """``tests/test_mpscircuit.py``'s circuit: h, rx layers, a CNOT ladder
    and a non-adjacent rzz (the SWAP network)."""
    rng = np.random.default_rng(seed)
    n = c.nqubits
    for i in range(n):
        c.h(i)
    for _ in range(layers):
        for i in range(n):
            c.rx(i, theta=float(rng.normal()))
        for i in range(n - 1):
            c.cnot(i, i + 1)
        c.rzz(0, n - 1, theta=0.3)
    return c


def _build5(c):
    for i in range(5):
        c.h(i)
    for i in range(4):
        c.cx(i, i + 1)
    for i in range(5):
        c.rz(i, theta=0.3 * i + 0.1)
    c.cx(0, 4)
    return c


@pytest.mark.parametrize("chi", [None, 4])
def test_exact_and_truncated_states_match_jax(dtype, chi):
    t, j = _pair(8 if chi else 5, chi)
    _random_ops(t, 3, layers=2 if chi else 1)
    _random_ops(j, 3, layers=2 if chi else 1)
    assert t.get_bond_dimensions() == j.get_bond_dimensions()
    _close(t.wavefunction(), j.wavefunction(), TOL[dtype])
    for ps in [dict(z=[0]), dict(x=[2]), dict(z=[0, 4]), dict(x=[1], z=[3]), dict(y=[2, 3])]:
        _close(t.expectation_ps(**ps), j.expectation_ps(**ps), TOL[dtype])
    assert t.get_center_position() == j.get_center_position()
    _close(t.norm(), j.norm(), TOL[dtype])
    # the multi-site route of expectation: the overlap with a gated copy
    zz = np.kron(Z, X)
    _close(t.expectation((zz, [1, 3])), j.expectation((jnp.asarray(zz), [1, 3])), TOL[dtype])
    _close(t.expectation((Z, [1]), normalized=False), j.expectation((jnp.asarray(Z), [1]), normalized=False),
           TOL[dtype])


def test_exact_regime_matches_dense_and_amplitudes(dtype):
    t, j = _pair(4)
    c = tct.Circuit(4)
    for cc in (t, j, c):
        cc.h(0)
        for i in range(3):
            cc.cnot(i, i + 1)
    for s in ("0000", "1111", "0101", [1, 1, 1, 1]):
        _close(t.amplitude(s), j.amplitude(s), TOL[dtype])
    _close(t.amplitude("1111"), 1 / np.sqrt(2), TOL[dtype])
    _close(t.wavefunction(), c.state(), TOL[dtype])
    _close(t.entanglement_entropy(2), j.entanglement_entropy(2), TOL[dtype])
    _close(t.entanglement_entropy(2), np.log(2), 1e-4)


def test_from_wavefunction_and_tensors(dtype):
    c = _random_ops(tct.Circuit(5), 7)
    psi = _np(c.state())
    for chi in (None, 2):
        t = tct.MPSCircuit(5, wavefunction=psi, split={"max_singular_values": chi})
        j = JMPS(5, wavefunction=jnp.asarray(psi), split={"max_singular_values": chi})
        assert t.get_bond_dimensions() == j.get_bond_dimensions()
        assert t.get_center_position() == j.get_center_position() == 4
        _close(t.wavefunction(), j.wavefunction(), TOL[dtype])
    tensors = [_np(x) for x in j.get_tensors()]
    _close(tct.MPSCircuit(5, tensors=tensors).wavefunction(), JMPS(5, tensors=tensors).wavefunction(), TOL[dtype])


def test_gates_on_three_to_six_sites(dtype):
    rng = np.random.default_rng(4)
    for k, index in ((3, (0, 1, 3)), (4, (4, 0, 2, 1)), (6, (5, 0, 3, 1, 4, 2))):
        q, _ = np.linalg.qr(rng.normal(size=(2**k, 2**k)) + 1j * rng.normal(size=(2**k, 2**k)))
        t, j = _pair(6)
        c = tct.Circuit(6)
        for cc in (t, j, c):
            for i in range(6):
                cc.h(i)
            cc.toffoli(0, 1, 3)
            cc.any(*index, unitary=q)
        _close(t.wavefunction(), j.wavefunction(), TOL[dtype])
        _close(t.wavefunction(), c.state(), 10 * TOL[dtype])
        assert t.get_center_position() == j.get_center_position()
    t = tct.MPSCircuit(7)
    with pytest.raises(ValueError, match="up to 6"):
        t.any(*range(7), unitary=np.eye(2**7))


def _margin_miss(tensors, bits, status):
    """:func:`chip_smoke.mps_bracket_miss` on the JAX package's chain."""
    return cs.mps_bracket_miss([torch.as_tensor(np.asarray(t)) for t in tensors], bits, status)


def test_perfect_sampling_and_sample_match_jax(dtype):
    """The same status gives the JAX package's shots: equal at complex128,
    at complex64 a shot may differ only where a uniform lies within 1e-6 of
    its float64 cdf boundary on the JAX package's chain."""
    t, j = _pair(6, 4)
    c = tct.Circuit(6)
    for cc in (t, j, c):
        _random_ops(cc, 11, layers=2)
    status = np.random.default_rng(0).uniform(size=(200, 6))
    want = j.sample(batch=200, status=jnp.asarray(status))
    bits_j = np.stack([np.asarray(b) for b, _ in want])
    probs_j = np.asarray([float(p) for _, p in want])
    got = t.sample(200, status=status)
    bits_t = np.stack([_np(b) for b, _ in got])
    differ = np.flatnonzero((bits_t != bits_j).any(axis=1))
    chain = j.copy()
    chain.position(0)
    assert _margin_miss(chain.get_tensors(), bits_t, status) <= 1e-6, differ
    if dtype == "complex128":
        assert differ.size == 0
    same = np.setdiff1d(np.arange(200), differ)
    _close(np.asarray([_np(p) for _, p in got])[same], probs_j[same], 1e-6)
    assert got[0][0].dtype == torch.int32 and got[0][1].dtype == torch.float32
    for row in (0, 1):
        bt, pt = t.perfect_sampling(status=status[row])
        np.testing.assert_array_equal(_np(bt), bits_t[row])
        _close(pt, _np(got[row][1]), 1e-6)
    # the formats, from the same shots
    ints = _np(t.sample(200, status=status, format="sample_int"))
    np.testing.assert_array_equal(ints, bits_t @ (2 ** np.arange(5, -1, -1)))
    cv = _np(t.sample(200, status=status, format="count_vector"))
    np.testing.assert_array_equal(cv, np.bincount(ints, minlength=64))
    assert t.sample(200, status=status, format="count_dict_bin") == tct.quantum.count_vector2dict(cv, 6)
    one = t.sample(status=status[:1])
    np.testing.assert_array_equal(_np(one[0]), bits_t[0])
    # the dense circuit at the same status, in the exact regime
    e, _ = _pair(6)
    _random_ops(e, 11, layers=2)
    np.testing.assert_array_equal(_np(e.perfect_sampling(status=status[2])[0]),
                                  _np(c.perfect_sampling(status=status[2])[0]))


def test_sample_uniforms_from_generators(cpu):
    t, _ = _pair(4)
    t.h(0)
    t.cnot(0, 1)
    a = t.sample(64, random_generator=tct.backend.get_random_state(3, device="cpu"), format="sample_bin")
    b = t.sample(64, random_generator=tct.backend.get_random_state(3, device="cpu"), format="sample_bin")
    assert torch.equal(a, b) and torch.equal(a[:, 0], a[:, 1]) and not a[:, 2:].any()
    tct.backend.set_random_state(5)
    c1 = t.sample(64, format="sample_int")
    tct.backend.set_random_state(5)
    assert torch.equal(c1, t.sample(64, format="sample_int"))
    cv = t.sample(400, format="count_vector", random_generator=tct.backend.get_random_state(1, device="cpu"))
    assert int(cv[0] + cv[12]) == 400 and abs(int(cv[0]) - 200) < 80


def test_measure_fills_unlisted_qubits_from_numpy(dtype):
    """``measure(status=)`` draws the unlisted qubits' uniforms from
    ``np.random.uniform`` in both packages (kept on purpose), so one
    ``np.random.seed`` gives both the same outcome."""
    t, j = _pair(5, 4)
    _random_ops(t, 2)
    _random_ops(j, 2)
    for seed in range(4):
        np.random.seed(seed)
        rt, pt = t.measure(1, 3, with_prob=True, status=np.array([0.3, 0.8]))
        np.random.seed(seed)
        rj, pj = j.measure(1, 3, with_prob=True, status=jnp.asarray([0.3, 0.8]))
        np.testing.assert_array_equal(_np(rt), np.asarray(rj))
        _close(pt, pj, 1e-6)
    r, p = t.measure(0, 2, status=np.array([0.1, 0.9]))
    assert r.shape == (2,) and p.item() == -1.0
    assert t.measure_jit(0)[0].shape == (1,)


def test_mpo_machinery_and_compress(dtype):
    import scipy.linalg as sl

    t, j = _pair(6, 16)
    for m in (t, j):
        for i in range(6):
            m.h(i)
    zz1 = np.kron(np.kron(Z, Z), np.eye(2))
    gate = sl.expm(-1j * 0.35 * (zz1 + 0.4 * np.kron(np.eye(4), Z)))
    mt, mj = t.gate_to_mpo(gate, 3), j.gate_to_mpo(jnp.asarray(gate), 3)
    assert [tuple(x.shape) for x in mt] == [tuple(x.shape) for x in mj]
    _close(tct.quantum.tn2qop(mt).eval_matrix(), gate, TOL[dtype] * 10)
    t.apply_mpo(mt, 1, 2, 3)
    j.apply_mpo(mj, 1, 2, 3)
    _close(t.wavefunction(), j.wavefunction(), TOL[dtype] * 10)
    assert t.get_bond_dimensions() == j.get_bond_dimensions()
    c, cj = _pair(6)
    _random_ops(c, 5)
    _random_ops(cj, 5)
    c.compress(max_singular_values=4)
    cj.compress(max_singular_values=4)
    assert c.get_bond_dimensions() == cj.get_bond_dimensions() and max(c.get_bond_dimensions()) <= 4
    assert c.get_center_position() == cj.get_center_position() == 5
    _close(c.wavefunction(), cj.wavefunction(), TOL[dtype] * 10)


def test_reference_api_matches_jax(dtype):
    """``tests/test_mpscircuit.py::test_mps_parity_methods`` and
    ``::test_mps_mpo_roundtrip_and_apply`` on both packages."""
    t, j = _build5(tct.MPSCircuit(5)), _build5(JMPS(5))
    psi = _np(j.wavefunction())
    tol = TOL[dtype]
    assert t.is_valid() and t.get_center_position() == j.get_center_position()
    _close(t.get_norm(), 1.0, 10 * tol)
    _close(t.conj().wavefunction(), psi.conj(), tol)
    shell = t.copy_without_tensor()
    assert shell._nqubits == 5 and len(shell._qir) == len(t._qir) and shell.device == t.device
    _close(shell.wavefunction(), np.eye(32)[0], 0)
    mm, mj = t.copy(), j.copy()
    mm.mid_measurement(2, keep=1)
    mj.mid_measurement(2, keep=1)
    _close(mm.wavefunction(), mj.wavefunction(), tol)
    sl, slj = t.slice(1, 3), j.slice(1, 3)
    assert sl._nqubits == 3 and sl.is_valid() and sl.get_center_position() == slj.get_center_position()
    _close(sl.wavefunction(), slj.wavefunction(), tol)
    for keep in ([1, 3], [3, 1], [0, 2, 4]):
        _close(t.reduced_density_matrix(keep), j.reduced_density_matrix(keep), tol)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 4))
    for kw, cl in (({}, True), ({}, False), ({"split": {"max_singular_values": 2}}, True),
                   ({"split": {"max_truncation_err": 1e-12}}, False)):
        lt, rt = tsplit(a, center_left=cl, **kw)
        lj, rj = jsplit(jnp.asarray(a), center_left=cl, **kw)
        _close(lt @ rt, np.asarray(lj @ rj), 1e-5 if dtype == "complex64" else 1e-12)
    qm, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
    mpo_t, il_t = t.gate_to_MPO(qm.reshape(2, 2, 2, 2), 1, 3)
    mpo_j, il_j = j.gate_to_MPO(jnp.asarray(qm.reshape(2, 2, 2, 2)), 1, 3)
    assert il_t == il_j == 1 and [tuple(x.shape) for x in mpo_t] == [tuple(x.shape) for x in mpo_j]
    _close(tct.MPSCircuit.MPO_to_gate(mpo_t).tensor, JMPS.MPO_to_gate(mpo_j).tensor, tol)
    with pytest.raises(ValueError):
        t.gate_to_MPO(qm, 3, 1)
    with pytest.raises(ValueError):
        t.gate_to_MPO(qm)
    m2, m2j = t.copy(), j.copy()
    m2.apply_MPO(mpo_t, 1)
    m2j.apply_MPO(mpo_j, 1)
    _close(m2.wavefunction(), m2j.wavefunction(), 10 * tol)
    d2 = _build5(tct.Circuit(5))
    d2.any(1, 3, unitary=qm)
    _close(m2.wavefunction(), d2.state(), 10 * tol)
    m3, m3j = t.copy(), j.copy()
    m3.position(2)
    m3j.position(2)
    m3.reduce_dimension(2, split={"max_singular_values": 2})
    m3j.reduce_dimension(2, split={"max_singular_values": 2})
    _close(m3.wavefunction(), m3j.wavefunction(), 10 * tol)
    assert m3.get_center_position() == m3j.get_center_position()
    # the site tensors' gauge is each SVD's own: compare each package's
    # split against its own pair
    a2, b2 = tct.MPSCircuit.reduce_tensor_dimension(_np(t.tensors[1]), _np(t.tensors[2]), center_left=False)
    aj, bj = JMPS.reduce_tensor_dimension(j.tensors[1], j.tensors[2], center_left=False)
    _close(torch.einsum("iaj,jbk->iabk", a2, b2), torch.einsum("iaj,jbk->iabk", t.tensors[1], t.tensors[2]), tol)
    np.testing.assert_allclose(np.einsum("iaj,jbk->iabk", aj, bj),
                               np.einsum("iaj,jbk->iabk", j.tensors[1], j.tensors[2]), rtol=0, atol=tol)
    assert tuple(a2.shape) == tuple(aj.shape) and tuple(b2.shape) == tuple(bj.shape)
    # the rest of the state API
    t.set_split_rules({"max_singular_values": 2, "max_truncation_err": None})
    j.set_split_rules({"max_singular_values": 2, "max_truncation_err": None})
    assert t.split == j.split
    t.rxx(0, 1, theta=0.3)
    j.rxx(0, 1, theta=0.3)
    t.apply_single_gate(X, 2)
    j.apply_single_gate(jnp.asarray(X), 2)
    _close(t.wavefunction(), j.wavefunction(), tol)
    assert len(t.to_qir()) == len(j._qir)
    t.normalize()
    j.normalize()
    _close(t.proj_with_mps(t.conj()), j.proj_with_mps(j.conj()), tol)
    _close(t.state(), j.state(), tol)
    _close(t.get_quvector().eval(), j.get_quvector().eval(), tol)


def test_finite_mps_matches_jax(dtype):
    """``tests/test_mpscircuit.py::test_finite_mps_measurements`` on both
    packages, plus the two-site update and the environments."""
    t, j = tct.MPSCircuit(5), JMPS(5)
    for cc in (t, j):
        for i in range(5):
            cc.ry(i, theta=0.3 * (i + 1))
        for i in range(4):
            cc.cnot(i, i + 1)
    ft = tct.FiniteMPS([_np(x) for x in t.tensors], center_position=t._center, canonicalize=False)
    fj = tc.FiniteMPS(j._tensors, center_position=j._center, canonicalize=False)
    tol = TOL[dtype]
    for a, b in zip(ft.measure_local_operator([Z, X], [1, 3]), fj.measure_local_operator([Z, X], [1, 3])):
        _close(a, b, tol)
    for a, b in zip(ft.measure_two_body_correlator(Z, X, 2, [0, 2, 4]),
                    fj.measure_two_body_correlator(Z, X, 2, [0, 2, 4])):
        _close(a, b, tol)
    for a, b in zip(ft.left_envs([0, 3]).values(), fj.left_envs([0, 3]).values()):
        _close(a, b, tol)
    for a, b in zip(ft.right_envs([1, 4]).values(), fj.right_envs([1, 4]).values()):
        _close(a, b, tol)
    _close(ft.conj().tensors[2], np.conj(_np(ft.tensors[2])), 0)
    f2 = ft.copy()
    assert len(f2) == 5 and f2.center_position == ft.center_position and f2.tensors[0] is not ft.tensors[0]
    assert ft.bond_dimensions() == fj.bond_dimensions()
    _close(ft.norm(), fj.norm(), tol)
    with pytest.raises(ValueError):
        ft.measure_local_operator([Z], [1, 2])
    with pytest.raises(ValueError):
        ft.measure_two_body_correlator(Z, Z, 7, [0])
    rzz = np.diag(np.exp(-0.5j * np.array([1, -1, -1, 1])))
    for f in (ft, fj):
        f.apply_one_site_gate(X, 1)
        out = f.apply_two_site_gate(rzz @ np.kron(X, np.eye(2)), 2, 1, max_singular_values=2, center_position=4)
        assert tuple(out.shape) == (0,)
    assert ft.center_position == fj.center_position == 4
    assert ft.bond_dimensions() == fj.bond_dimensions()
    _close(tct.MPSCircuit(5, tensors=ft.tensors).wavefunction(), JMPS(5, tensors=fj.tensors).wavefunction(), 10 * tol)
    ft.position(0)
    fj.position(0)
    assert ft.check_canonical() < 10 * tol and abs(ft.check_canonical() - fj.check_canonical()) < 10 * tol
    # canonicalize moves the centre from the one given, so here it stays
    # as the tensors are, in both packages
    full = tct.FiniteMPS([_np(x) for x in t.tensors], center_position=2)
    fullj = tc.FiniteMPS(j._tensors, center_position=2)
    assert full.center_position == fullj.center_position == 2
    assert abs(full.check_canonical() - fullj.check_canonical()) < 10 * tol
    full.tensors = [_np(x) for x in full.tensors]
    assert isinstance(full.tensors[0], torch.Tensor)


def test_derived_objects_keep_the_device(cpu):
    with tct.set_device("cpu"):
        m = _build5(tct.MPSCircuit(5, device="cpu"))
    for d in (m.copy(), m.conj(), m.slice(0, 2), m.copy_without_tensor()):
        assert d.device.type == "cpu" and all(t.device.type == "cpu" for t in d.tensors)
    f = tct.FiniteMPS(m.tensors, device="cpu")
    assert f.copy().device.type == f.conj().device.type == "cpu"
    assert tct.MPSCircuit(3, tensors=[np.ones((1, 2, 1))] * 3, device="cpu").tensors[0].dtype == torch.complex64


def test_mps_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tct.MPSCircuit(3)
        with pytest.raises(RuntimeError, match="CUDA"):
            tct.FiniteMPS([np.ones((1, 2, 1))] * 2)


def test_phase16_checks_run_on_cpu(cpu):
    """``chip_smoke.py``'s phase 16 at a small size on the CPU (the card
    path and its reference are then one): every check passes."""
    small = dict(n=8, chi=4, depth=3, n_b=6, depth_b=2, shots=256, n_d=6, chi_d=8, sweeps_d=3, n_e=4)
    ref = cs._mps_reference(tct, **small)
    assert {"drift gram128", "drift gram64", "drift exact64"} <= set(ref)
    got = cs._mps_checks(tct, "cpu", ref, **small)
    assert got["status"].shape == (256, 8)


def test_phase16_circuits_match_jax(dtype):
    """Phase 16's circuit builders on both packages: the MPS VQE energy, and
    the dense form of the exact regime (``h_layer`` + ``zzrx_layer``)
    against the MPS one."""
    n, depth = 6, 2
    g = cs.mps_vqe_angles(n, depth)
    et = cs.tfim_energy_ps(cs.mps_vqe_circuit(tct, torch.as_tensor(g), n, 4), n)
    ej = cs.tfim_energy_ps(cs.mps_vqe_circuit(tc, jnp.asarray(g), n, 4), n)
    _close(et, ej, 10 * TOL[dtype])
    ed = cs.dense_vqe_energy(tct, torch.as_tensor(g.astype(RDT[dtype])), n)
    _close(ed, cs.tfim_energy_ps(cs.mps_vqe_circuit(tct, torch.as_tensor(g), n, 64), n), 10 * TOL[dtype])
    _close(cs.heisenberg_ground(6), np.linalg.eigvalsh(_heisenberg_dense(6))[0], 1e-10)


def _heisenberg_dense(n):
    y = np.array([[0, -1j], [1j, 0]])
    h = 0
    for i in range(n - 1):
        for p in (X, y, Z):
            h = h + np.kron(np.kron(np.eye(2**i), np.kron(p, p)), np.eye(2 ** (n - i - 2)))
    return h
