"""The port's einsum routes against the JAX package's, on the CPU:
``Circuit.amplitude``, ``expectation`` (value and the angles' gradient)
and ``sample`` (with and without a readout error) above 30 qubits, where
neither package makes a dense state; ``DMCircuit2``'s methods above its
cliff of 14 qubits and below it; ``amplitude_before``,
``expectation_before``, ``split=`` and the node-graph helpers; and
``chip_smoke.py``'s phase 15 (its circuit builders and checks) at a small
size.

Tolerances: values relative 1e-5 at complex64 and 1e-10 at complex128
(each package sums in its own order), the gradients likewise over their
largest entry; samples equal (the statuses lie far from the cdf
boundaries: a float32 sum moves a boundary by ~1e-7).  The JAX side of a
contraction runs as one jitted program; its sampler as ``jax_samples``
says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch.core import contractor as tctr

RTOL = {"complex64": 1e-5, "complex128": 1e-10}
Z = np.diag([1.0, -1.0])
X = np.array([[0.0, 1.0], [1.0, 0.0]])


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
    return x.detach().resolve_conj().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (got, want)


def chain(mod, n, th, depth=2):
    """A shallow 1D circuit on ``n`` qubits: H, then per layer a CNOT brick
    and ry(th[layer, q]) on each qubit (``th`` floats, a jnp array or a
    tensor)."""
    c = mod.Circuit(n)
    for i in range(n):
        c.h(i)
    for layer in range(depth):
        for i in range(layer % 2, n - 1, 2):
            c.cnot(i, i + 1)
        for i in range(n):
            c.ry(i, theta=th[layer][i])
    return c


@pytest.mark.parametrize("n", [32, 36])
def test_amplitude_and_expectation_past_the_cliff(dtype, n):
    """``amplitude`` and ``expectation`` above 30 qubits: the einsum route
    of both packages, the value and the gradient in the angles."""
    rng = np.random.default_rng(n)
    th = rng.normal(size=(2, n))
    bits = "".join(str(b) for b in rng.integers(0, 2, n))
    ops = ((Z, [n // 2]), (X, [n // 2 + 1]))

    def jax_f(t):
        c = chain(tc, n, t)
        return jnp.real(c.expectation(*ops)), c.amplitude(bits)

    (ej, aj), gj = jax.jit(lambda t: (jax_f(t), jax.grad(lambda u: jax_f(u)[0])(t)))(jnp.asarray(th))
    tt = torch.tensor(th, dtype=getattr(torch, {"complex64": "float32", "complex128": "float64"}[dtype]),
                      requires_grad=True)
    ct = chain(tct, n, tt)
    et = ct.expectation(*ops).real
    (gt,) = torch.autograd.grad(et, tt)
    _close(et, ej, RTOL[dtype])
    _close(gt, gj, RTOL[dtype])
    _close(chain(tct, n, th).amplitude(bits), aj, RTOL[dtype])
    # neither route made a dense state
    assert ct._state_cache is None
    ir = ct.amplitude_before(bits)
    assert ir.signature() == chain(tc, n, th).amplitude_before(bits).signature()
    assert ct.expectation_before(*ops).signature() == chain(tc, n, th).expectation_before(*ops).signature()


SAMPLE_N, SAMPLE_SHOTS = 32, 1
SAMPLE_RO = [[0.9, 0.8]] * SAMPLE_N


def _sample_inputs():
    th = np.random.default_rng(5).normal(size=(1, SAMPLE_N))
    st = np.random.default_rng(6).uniform(size=(SAMPLE_SHOTS, SAMPLE_N))
    return th, st


@pytest.fixture(scope="module")
def jax_samples():
    """The JAX package's shots at n=32 (complex64), with and without the
    readout error.  Its sampler jits one program a prefix length (~20 s
    here at n=31), so it runs with jit disabled and its contraction steps through
    opt_einsum on numpy (eager, each jnp step would compile on its own):
    its own status handling, conditionals and flips."""
    import opt_einsum as oe
    from tensorcircuit_ng_tpu.core import contractor as jctr

    def numpy_steps(steps, operands):
        ops = [np.asarray(o) for o in operands]
        for positions, es in steps:
            arrs = [ops.pop(i) for i in positions]
            ops.append(oe.contract(es, *arrs, backend="numpy"))
        return ops[0]

    th, st = _sample_inputs()
    cj = chain(tc, SAMPLE_N, th, depth=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jctr, "_execute_steps", numpy_steps)
    try:
        with jax.disable_jit():
            plain = np.stack([np.asarray(b) for b, _ in cj.sample(batch=SAMPLE_SHOTS, status=st)])
            # the legacy output: its integer formats overflow int32 past 31 qubits with x64 off
            ro = np.stack([np.asarray(b) for b, _ in cj.sample(batch=SAMPLE_SHOTS, status=st,
                                                                   readout_error=SAMPLE_RO)])
    finally:
        mp.undo()
    return plain, ro


def test_sample_past_the_cliff(dtype, jax_samples):
    """``sample`` above 2^30 amplitudes with a status, with and without a
    readout error (the flips from the status's bytes, as the JAX package
    draws them): the JAX package's bits, in the legacy output and the
    formats."""
    want, want_ro = jax_samples
    th, st = _sample_inputs()
    ct = chain(tct, SAMPLE_N, th, depth=1)
    legacy = ct.sample(batch=SAMPLE_SHOTS, status=st)
    assert [p for _, p in legacy] == [-1.0] * SAMPLE_SHOTS
    assert np.array_equal(np.stack([_np(b) for b, _ in legacy]), want)
    got_ro = ct.sample(batch=SAMPLE_SHOTS, status=st, readout_error=SAMPLE_RO, format="sample_int")
    assert got_ro.dtype == torch.int64
    assert np.array_equal(_np(got_ro), _np(tct.quantum.sample_bin2int(torch.as_tensor(want_ro), SAMPLE_N)))
    assert not np.array_equal(want_ro, want)
    one, p = ct.sample(status=st[:1])
    assert np.array_equal(_np(one), want[0]) and p == -1.0
    bins = ct.sample(batch=SAMPLE_SHOTS, status=torch.as_tensor(st), format="sample_bin")
    assert bins.dtype == torch.int64 and np.array_equal(_np(bins), want)  # int64 past 2^31 states


def test_sample_past_the_cliff_without_status(cpu):
    """Without a status the uniforms come from the generator given (on the
    circuit's device) or the backend's implicit one: the same seed, the
    same shots; a GHZ state gives all-zero and all-one strings."""
    c = cs.ghz_circuit(tct, 32)
    g1, g2 = (tct.backend.get_random_state(3, device="cpu") for _ in range(2))
    a = c.sample(batch=6, random_generator=g1, format="sample_bin")
    assert torch.equal(a, c.sample(batch=6, random_generator=g2, format="sample_bin"))
    tct.backend.set_random_state(4)
    b = c.sample(batch=6, format="sample_bin")
    assert torch.all(b == b[:, :1])


def dm2(mod, n, **kw):
    return cs.noisy_brickwork_dm(mod, n, 2, **kw)


@pytest.mark.parametrize("n", [6, 16])
def test_dmcircuit2_methods(dtype, n):
    """``DMCircuit2``'s ``expectation_before``, ``expectation``,
    ``probability``, ``measure_jit`` and ``amplitude`` against the JAX
    package's: above the cliff by the doubled network, below it (n=6) by
    the dense ρ, where each also equals the einsum route's value."""
    cj, ct = dm2(tc, n), dm2(tct, n)
    ops = ((Z, [n // 2]), (Z, [n // 2 + 1]))
    wires = (1, n // 2, n - 2)
    st = np.array([0.31, 0.62, 0.18, 0.83])
    mw = (0, n // 2, 3, n - 1)
    bits = "".join(str(b) for b in np.random.default_rng(n).integers(0, 2, n))
    # the JAX side in one program
    ej, pj, (sj, qj), aj, pallj = jax.jit(lambda: (
        cj.expectation(*ops), cj.probability(*wires), cj.measure_jit(*mw, with_prob=True, status=jnp.asarray(st)),
        cj.amplitude(bits), cj.probability() if n <= 14 else jnp.zeros(())))()
    irj, irt = cj.expectation_before(*ops), ct.expectation_before(*ops)
    assert irt.signature() == irj.signature()
    e = ct.expectation(*ops)
    _close(e, ej, RTOL[dtype])
    _close(tctr.contract_ir(irt), e, RTOL[dtype])
    p = ct.probability(*wires)
    _close(p, pj, RTOL[dtype])
    assert p.shape == (8,) and abs(p.sum().item() - 1.0) < 1e-5
    if n <= 14:
        _close(ct.probability(), pallj, RTOL[dtype])
    s, pr = ct.measure_jit(*mw, with_prob=True, status=st)
    assert np.array_equal(_np(s), np.asarray(sj))
    _close(pr, qj, RTOL[dtype])
    _close(ct.amplitude(bits), aj, RTOL[dtype])
    if n > 14:
        # the doubled network made no density matrix
        assert ct._state_cache is None


def test_dmcircuit2_sample_past_its_cliff(cpu):
    """``DMCircuit2.sample`` above 2^14 amplitudes draws from the doubled
    network (no ρ): each shot equals ``measure_jit`` of every qubit with
    the same uniforms, and a readout error flips bits."""
    n = 15
    c = dm2(tct, n)
    st = np.random.default_rng(8).uniform(size=(2, n))
    got = c.sample(batch=2, status=st, format="sample_bin")
    for k in range(2):
        assert np.array_equal(_np(got[k]), _np(c.measure_jit(*range(n), status=st[k])[0]))
    assert c._state_cache is None
    flipped = c.sample(batch=2, status=st, readout_error=[[0.5, 0.5]] * n, format="sample_bin")
    assert not torch.equal(flipped, got)


def test_split_and_node_helpers(cpu):
    """``Circuit(split=)`` is stored; the node-graph helpers of the JAX
    package's API."""
    rules = tctr.split_rules(max_singular_values=2)
    assert tct.Circuit(2, split=rules)._split == rules == tc.Circuit(2, split=rules)._split
    th = np.random.default_rng(2).normal(size=(2, 4))
    ct, cj = chain(tct, 4, th), chain(tc, 4, th)
    assert ct.to_graphviz() == cj.to_graphviz()
    assert ct.front_from_nodes() == cj.front_from_nodes() == [0, 1, 2, 3]
    _close(ct.all_zero_nodes()[0], np.asarray(cj.all_zero_nodes()[0]), 1e-7)
    for conj in (False, True):
        got, want = ct.copy_nodes(conj=conj), cj.copy_nodes(conj=conj)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.reshape(-1), np.asarray(w).reshape(-1), 1e-6)
    assert ct.coloring_nodes() is None and ct.coloring_copied_nodes() is None


def test_phase15_builders_against_the_jax_package(cpu):
    """Phase 15's circuits at a small size: the grid circuit's amplitude IR
    is the JAX package's and its contraction the JAX package's amplitude;
    the brickwork and the noisy DMCircuit2 agree too."""
    ang = cs.grid_angles(12, 5)
    gt, gj = cs.grid_circuit(tct, 3, 4, 5, ang), cs.grid_circuit(tc, 3, 4, 5, ang)
    irt, irj = gt.amplitude_before("0" * 12), gj.amplitude_before("0" * 12)
    assert irt.signature() == irj.signature()
    _close(tctr.contract_ir(irt), np.asarray(jax.jit(lambda: gj.amplitude("0" * 12))()), 1e-5)
    _close(tctr.contract_ir(irt), gt.state()[0], 1e-5)
    assert len(cs.grid_patterns(5, 6)) == 4 and sum(len(p) for p in cs.grid_patterns(5, 6)) == 49
    bt, bj = cs.brickwork_circuit(tct, 8, 3), cs.brickwork_circuit(tc, 8, 3)
    _close(bt.state(), np.asarray(bj.state()), 1e-5)
    dt, dj = cs.noisy_brickwork_dm(tct, 4, 2), cs.noisy_brickwork_dm(tc, 4, 2)
    _close(dt.densitymatrix(), np.asarray(dj.densitymatrix()), 1e-5)
    _close(cs.ghz_circuit(tct, 3).state(), np.asarray(cs.ghz_circuit(tc, 3).state()), 1e-6)


def test_phase15_checks_run_on_cpu(cpu):
    """``chip_smoke.py``'s phase 15 at a small size on the CPU (the card
    path and its reference are then one), with (b)-(d) past their cliffs:
    every check passes."""
    got = cs._contraction_checks(tct, "cpu", grid_a=(3, 3, 4), grid_b=(4, 8, 2), slice_target=2**3, ghz=(31, 8),
                                 brick=(31, 2, 2), dm2=(16, 2), dm2_small=6)
    assert len(got["sliced"]) >= 1 and all(cost is None for cost in got["once"].values())
