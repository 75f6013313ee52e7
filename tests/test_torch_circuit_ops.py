"""The deterministic rest of the port's ``Circuit`` against the JAX package,
on the CPU: copies, composition, remapping and the inverse circuit (with
their gradients), ``_expanded_qir``, the circuit unitary, Pauli-string and
light-cone expectations, subsystem readouts, the free ``expectation``,
counts and recorded instructions, the probe's error cases, the device a
derived circuit keeps, the gate and config helpers, the new top-level
exports, and the circuit functions of ``chip_smoke.py``'s circuit-API phase.

Inputs are numpy-seeded and handed to both packages, at complex64 and at
complex128.  Tolerances: states, matrices and expectations of at most 9
qubits agree to float32 rounding, 1e-6 (complex64), and to 1e-12
(complex128); gradients within 1e-5 (complex64 sums in another order);
the unitary's defect ‖U U† − I‖_max within 1e-5 (complex64: rounding of
~30 gate layers on every column) and 1e-12; ``batched_unitary``'s
eigendecompositions (LAPACK against XLA, complex64) within 1e-5; the TFIM
energy at n=7 (|E| ~ 7) within 2e-6 |E| between the packages.  The JAX
side of each test runs under ``jax.jit``, once per dtype for all its cases.  Random gates
draw numbers, so their tests hold properties, not values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import (
    composed_hea_energy,
    hea_energy,
    loschmidt_echo,
    remapped_tfim_energy,
    reversal,
    tfim_circuit,
    tfim_pauli_strings,
)
from tensorcircuit_ng_tpu.ops import gates as jgates
from tensorcircuit_ng_tpu_torch.models.circuit import expectation as circuit_expectation
from tensorcircuit_ng_tpu_torch.ops import gates as tgates

TOL = {"complex64": 1e-6, "complex128": 1e-12}
UNITARY_TOL = {"complex64": 1e-5, "complex128": 1e-12}
RDT = {"complex64": np.float32, "complex128": np.float64}
GRAD_TOL = 1e-5
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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _unitary(rng, dim):
    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    return np.linalg.qr(a)[0]


def _params(n, seed, rdt=np.float32):
    rng = np.random.default_rng(seed)
    return {
        "zz": rng.normal(size=(2, n - 1)).astype(rdt),
        "rx": rng.normal(size=(2, n)).astype(rdt),
        "rxl": rng.normal(size=n).astype(rdt),
        "ryl": rng.normal(size=n).astype(rdt),
        "u4": _unitary(rng, 4),
    }


def _mixed(mod, n, p, wide=True, measure=True):
    """h_layer, two zzrx_layer, rx_layer, ry_layer, cnot, rzm on 3 (and,
    ``wide``, on 9) wires, multicz, any, fredkin (and mid_measurement)."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    c = mod.Circuit(n)
    c.h_layer()
    c.zzrx_layer(pairs, p["zz"][0], p["rx"][0])
    c.zzrx_layer(pairs, p["zz"][1], p["rx"][1])
    c.rx_layer(p["rxl"])
    c.ry_layer(p["ryl"])
    c.cnot(0, n - 1)
    c.rzm(0, 2, 3, theta=0.37)
    if wide:
        c.rzm(*range(9), theta=-0.61)
    c.multicz(1, 2, 4)
    c.any(1, 3, unitary=p["u4"])
    c.fredkin(2, 0, 4)
    if measure:
        c.mid_measurement(3, keep=0)
    return c


def _unitary_circuit(mod, n, p):
    """A unitary mix that fits 3 qubits: h_layer, zzrx_layer, ry_layer,
    cnot, rzm, multicz, any, rx_layer."""
    c = mod.Circuit(n)
    c.h_layer()
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], p["zz"][0], p["rx"][0])
    c.ry_layer(p["ryl"])
    c.cnot(0, n - 1)
    c.rzm(0, 1, 2, theta=0.37)
    c.multicz(0, n - 1)
    c.any(1, 2, unitary=p["u4"])
    c.rx_layer(p["rxl"])
    return c


def _plain(mod, n, p):
    """Plain gates only: every item touches at most 3 wires."""
    c = mod.Circuit(n)
    c.h(0)
    c.cnot(0, 1)
    c.rx(2, theta=0.3)
    c.any(1, 2, unitary=p["u4"])
    c.rzz(0, 2, theta=0.5)
    c.multicz(0, 1, 2)
    c.rzm(0, 2, theta=-0.2)
    return c


def _names(c):
    return [item["name"] for item in c.to_qir()]


_JAX = {}


def _jax_ref(name, dtype, fn):
    """``fn()`` under ``jax.jit`` at the active dtype, once per (name,
    dtype), as numpy: the JAX side of every case of a test in one compile."""
    if (name, dtype) not in _JAX:
        _JAX[name, dtype] = jax.tree_util.tree_map(np.asarray, jax.jit(fn)())
    return _JAX[name, dtype]


# ---------------------------------------------------------------------------
# copy, inverse, expanded QIR
# ---------------------------------------------------------------------------


def _echo_parts(mod, p):
    c = _mixed(mod, 9, p)
    return {"state": c.state(), "inverse": c.inverse().state(),
            "echo": loschmidt_echo(_mixed(mod, 9, p, measure=False)).state()}


@pytest.mark.parametrize("what", ["copy", "inverse", "echo"])
def test_copy_inverse_and_echo_match_jax(dtype, what):
    p = _params(9, 0, RDT[dtype])
    ref = _jax_ref("echo", dtype, lambda: _echo_parts(tc, p))
    ct = _mixed(tct, 9, p)
    tol = TOL[dtype]
    if what == "copy":
        cp = ct.copy()
        assert _names(cp) == _names(ct) and cp.to_qir()[0].get("h_fold")
        _close(cp.state(), ct.state(), 0)
        _close(ct.state(), ref["state"], tol)
    elif what == "inverse":
        it, ij = ct.inverse(), _mixed(tc, 9, p).inverse()
        assert _names(it) == _names(ij) and it.gate_count() == ij.gate_count()
        assert "rzm" in _names(it) and "fredkind" in _names(it)  # the 9-wire rzm stays matrix-free
        _close(it.state(), ref["inverse"], tol)
    else:
        echo = loschmidt_echo(_mixed(tct, 9, p, measure=False)).state()
        _close(echo, ref["echo"], tol)
        assert abs(abs(echo[0].item()) ** 2 - 1) <= 10 * tol


def test_expanded_qir_matches_jax(dtype):
    n = 9
    p = _params(n, 2, RDT[dtype])
    xj, xt = _mixed(tc, n, p)._expanded_qir(), _mixed(tct, n, p)._expanded_qir()
    assert [(i["name"], tuple(i["index"])) for i in xt] == [(i["name"], tuple(i["index"])) for i in xj]
    # n H, two zzrx layers of n-1 rzz and n rx, n rx, n ry, 7 plain items
    assert len(xt) == 3 * n + 2 * (2 * n - 1) + 7
    for it, ij in zip(xt, xj):
        assert (it["gate"] is None) == (ij["gate"] is None)
        if it["gate"] is not None:
            _close(it["gate"].matrix(), ij["gate"].matrix(), TOL[dtype])


# ---------------------------------------------------------------------------
# composition and remapping
# ---------------------------------------------------------------------------

_KINDS = ["compose", "compose_indices", "compose_permuted", "append", "append_indices", "prepend"]


def _compose(mod, kind, p, q):
    n = 6
    base = _mixed(mod, n, p, wide=False, measure=False)
    if kind == "compose":
        return base.compose(_mixed(mod, n, q, wide=False))
    if kind == "compose_indices":
        return base.compose(_plain(mod, 3, q), indices=[4, 1, 2])
    if kind == "compose_permuted":
        return base.compose(_mixed(mod, n, q, wide=False), indices=[3, 0, 5, 1, 4, 2])
    if kind == "append":
        return base.append(_mixed(mod, n, q, wide=False))
    if kind == "append_indices":
        return base.append(_plain(mod, 3, q), indices=[5, 0, 3])
    return base.prepend(_plain(mod, n, q))


@pytest.mark.parametrize("kind", _KINDS)
def test_composition_matches_jax(dtype, kind):
    p, q = _params(6, 3, RDT[dtype]), _params(6, 4, RDT[dtype])
    ref = _jax_ref("compose", dtype, lambda: {k: _compose(tc, k, p, q).state() for k in _KINDS})
    ct = _compose(tct, kind, p, q)
    assert _names(ct) == _names(_compose(tc, kind, p, q))
    _close(ct.state(), ref[kind], TOL[dtype])


_MAPPING = {0: 6, 1: 2, 2: 4, 3: 0, 4: 1}


def _mapped(mod, case, p):
    if case == "reversal":
        return _mixed(mod, 7, p, wide=False).initial_mapping(reversal(7))
    return _plain(mod, 5, p).initial_mapping(_MAPPING, n=7)


@pytest.mark.parametrize("case", ["reversal", "larger_n"])
def test_initial_mapping_matches_jax(dtype, case):
    p = _params(7, 5, RDT[dtype])
    ref = _jax_ref("mapping", dtype, lambda: {k: _mapped(tc, k, p).state() for k in ("reversal", "larger_n")})
    ct = _mapped(tct, case, p)
    if case == "reversal":
        assert ct.to_qir()[0].get("h_fold") and ct.to_qir()[1]["pairs"][0] == (6, 5)
    else:
        assert ct.nqubits == 7 and ct.to_qir()[1]["index"] == (6, 2)
    assert _names(ct) == _names(_mapped(tc, case, p))
    _close(ct.state(), ref[case], TOL[dtype])


def _grad_circuit(mod, route, n, w, zz, rx):
    pairs = [(i, i + 1) for i in range(n - 1)]
    c = mod.Circuit(n)
    c.h_layer()
    c.zzrx_layer(pairs, zz, rx)
    c.ry_layer(w[0])
    c.cnot(0, 3)
    c.rx_layer(w[1])
    c.rzz(2, 5, theta=w[0, 1])
    if route == "inverse":
        return c.inverse()
    if route == "initial_mapping":
        return c.initial_mapping(reversal(n))
    if route == "compose":
        return mod.Circuit(n).compose(c, indices=[5, 2, 0, 1, 6, 4, 3])
    other = mod.Circuit(n)
    other.ry_layer(0.7 * w[1])
    other.zzrx_layer(pairs, 0.5 * zz, rx)
    return c.copy().append(other.inverse())


_ROUTES = ["inverse", "initial_mapping", "compose", "copy_append_inverse"]


def _grad_inputs(n):
    rng = np.random.default_rng(7)
    return tuple((rng.normal(size=shape) * 0.6).astype(np.float32) for shape in ((2, n), (n - 1,), (n,)))


def _grad_observable(mod, route, n, *a):
    return _grad_circuit(mod, route, n, *a).expectation_ps(z=[0, 2], x=[5])


@pytest.mark.parametrize("route", _ROUTES)
def test_gradients_match_jax(route, cpu):
    """d/d(w, zz, rx) of ⟨Z_0 Z_2 X_5⟩ through the route: the inverse's
    conjugate transposes and the remap's permutations keep autograd."""
    n = 7
    inputs = _grad_inputs(n)

    def value_and_grads():
        out = {}
        for r in _ROUTES:
            def f(*a, r=r):
                return jnp.real(_grad_observable(tc, r, n, *a))

            out[r] = jax.value_and_grad(f, argnums=(0, 1, 2))(*inputs)
        return out

    vj, gj = _jax_ref("grad", "complex64", value_and_grads)[route]
    ts = [torch.as_tensor(a).requires_grad_() for a in inputs]
    v = torch.real(_grad_observable(tct, route, n, *ts))
    gt = torch.autograd.grad(v, ts)
    assert abs(v.item() - float(vj)) <= TOL["complex64"]
    assert min(float(np.abs(_np(g)).max()) for g in gt) > 1e-2  # the gradient reaches every input
    for a, b in zip(gt, gj):
        _close(a, b, GRAD_TOL)


# ---------------------------------------------------------------------------
# the circuit unitary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(3, 9))
def test_matrix_matches_jax(dtype, n):
    """Rows and columns in the reference's order (a transposed U would
    still be unitary); column 0 is the state from |0...0>."""

    def params(k):
        return _params(k, 10 + k, RDT[dtype])

    ref = _jax_ref("matrix", dtype, lambda: {k: _unitary_circuit(tc, k, params(k)).matrix() for k in range(3, 9)})
    ct = _unitary_circuit(tct, n, params(n))
    u = ct.matrix()
    assert u.shape == (2**n, 2**n) and u.device.type == "cpu"
    _close(u, ref[n], TOL[dtype])
    _close(ct.get_unitary(), u, 0)
    eye = torch.eye(2**n, dtype=u.dtype)
    assert (u @ u.conj().T - eye).abs().max().item() <= UNITARY_TOL[dtype]
    _close(u[:, 0], ct.state(), TOL[dtype])


# ---------------------------------------------------------------------------
# expectations
# ---------------------------------------------------------------------------

_PS = [[1, 0, 3], [2, 3, 0, 1, 0, 2], [0, 0, 0, 0], [3, 3, 3, 1, 2, 2, 0]]


@pytest.mark.parametrize("k", range(len(_PS)))
def test_expectation_ps_matches_jax(dtype, k):
    """``ps=`` equals the reference's dense route and the port's own x/y/z
    lists (``ps=[1, 0, 3]`` raised TypeError before)."""

    def params(n):
        return _params(n, 20 + n, RDT[dtype])

    ref = _jax_ref("ps", dtype, lambda: [_unitary_circuit(tc, len(ps), params(len(ps))).expectation_ps(ps=ps)
                                         for ps in _PS])
    ps = _PS[k]
    ct = _unitary_circuit(tct, len(ps), params(len(ps)))
    got = ct.expectation_ps(ps=ps)
    _close(got, ref[k], TOL[dtype])
    xyz = {key: [i for i, v in enumerate(ps) if v == code] for key, code in (("x", 1), ("y", 2), ("z", 3))}
    _close(ct.expectation_ps(**xyz), got, 0)
    _close(ct.expectation_ps(ps=ps, reuse=False), got, 0)
    ops = [(tgates.pauli_gates()[v], [i]) for i, v in enumerate(ps) if v]
    _close(ct.expectation(*ops), got, TOL[dtype])


def test_expectation_structures_matches_jax(dtype):
    n = 7
    p = _params(n, 30, RDT[dtype])
    structures, weights = tfim_pauli_strings(n)
    structures.append([2, 0, 3, 1, 0, 2, 0])
    weights.append(0.25)
    ref = _jax_ref("structures", dtype,
                   lambda: _mixed(tc, n, p, wide=False).expectation_structures(structures, weights))
    ct = _mixed(tct, n, p, wide=False)
    got = ct.expectation_structures(structures, weights)
    _close(got, ref, 10 * TOL[dtype])
    fused = ct.expectation_zzx_energy([(i, i + 1) for i in range(n - 1)], 1.0, -1.0)
    _close(torch.real(got) - 0.25 * torch.real(ct.expectation_ps(ps=structures[-1])), fused, 10 * TOL[dtype])


def _cone_circuit(mod, which, p):
    """The unitary mix (fused layers carry every wire), or plain gates
    whose cone from wire 0 or 4 leaves items out."""
    if which == "mixed":
        return _mixed(mod, 6, p, wide=False, measure=False)
    c = mod.Circuit(6)
    for q in range(6):
        c.h(q)
    c.cnot(0, 1)
    c.cnot(2, 3)
    c.rx(5, theta=0.4)
    c.rzz(4, 5, theta=0.3)
    c.any(3, 4, unitary=p["u4"])
    c.cnot(1, 2)
    c.ry(0, theta=-0.7)
    return c


_CONES = [("mixed", 0), ("mixed", 4), ("plain", 0), ("plain", 4)]


@pytest.mark.parametrize("k", range(len(_CONES)))
def test_lightcone_expectation_matches_jax(dtype, k):
    """Fused layers carry every wire, so the cone keeps everything before
    the last of them; a cone of plain gates drops the items outside it."""
    p = _params(6, 40, RDT[dtype])
    ref = _jax_ref("cone", dtype, lambda: [_cone_circuit(tc, which, p).expectation((Z, [wire]), enable_lightcone=True)
                                           for which, wire in _CONES])
    which, wire = _CONES[k]
    ct = _cone_circuit(tct, which, p)
    kept = ct._lightcone_qir([wire])
    assert [i["name"] for i in kept] == [i["name"] for i in _cone_circuit(tc, which, p)._lightcone_qir([wire])]
    assert len(kept) < len(ct.to_qir())
    if which == "mixed":  # every layer and all before the last of them stays
        last = max(i for i, item in enumerate(ct.to_qir()) if len(item["index"]) == 6)
        assert all(any(k is item for k in kept) for item in ct.to_qir()[: last + 1])
    got = ct.expectation((Z, [wire]), enable_lightcone=True)
    _close(got, ref[k], TOL[dtype])
    _close(got, ct.expectation((Z, [wire])), TOL[dtype])
    _close(ct.expectation_ps(z=[wire], enable_lightcone=True), got, TOL[dtype])


_BITS = ("010110", [1, 1, 0, 0, 1, 0], "000000")
_TRACEOUT = [1, 0, 1, 1, 0, 1]
_LEFT = ((2,), (0, 3, 5), (1, 4))


def _subsystems(c, traceout):
    return ([c.outcome_probability(bits) for bits in _BITS],
            [c.projected_subsystem(traceout, left) for left in _LEFT])


def test_outcome_probability_and_projected_subsystem_match_jax(dtype):
    p = _params(6, 50, RDT[dtype])
    ref = _jax_ref("subsystems", dtype, lambda: _subsystems(_unitary_circuit(tc, 6, p), jnp.asarray(_TRACEOUT)))
    ct = _unitary_circuit(tct, 6, p)
    got = _subsystems(ct, torch.tensor(_TRACEOUT))
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        _close(a, b, TOL[dtype])
    assert got[0][0].dtype == (torch.float64 if dtype == "complex128" else torch.float32)
    _close(ct.wavefunction(), ct.state(), 0)


_FREE = {
    "ket": {},
    "bra": {"bra": True},
    "bra_noconj": {"bra": True, "conj": False},
    "normalization": {"bra": True, "normalization": True},
}


def _free(mod, gates, case, ket, bra):
    kw = dict(_FREE[case])
    if kw.pop("bra", False):
        kw["bra"] = bra
    ops = [(Z, [1]), (gates.GATES["x"](), [3]), (gates.GATES["cnot"]().matrix(), [0, 2])]
    return mod.expectation(*ops, ket=ket, **kw)


@pytest.mark.parametrize("case", sorted(_FREE))
def test_free_expectation_matches_jax(dtype, case):
    rng = np.random.default_rng(60)
    ket, bra = (rng.normal(size=16) + 1j * rng.normal(size=16) for _ in range(2))
    ket = ket.astype(dtype)
    ref = _jax_ref("free", dtype, lambda: {k: _free(tc, jgates, k, jnp.asarray(ket), bra) for k in _FREE})
    _close(_free(tct, tgates, case, ket, bra), ref[case], 10 * TOL[dtype])
    if case == "ket":  # a circuit's state through both entry points
        c = _unitary_circuit(tct, 4, _params(4, 61, RDT[dtype]))
        ops = [(Z, [1]), (tgates.GATES["x"](), [3])]
        _close(tct.expectation(*ops, ket=c.state()), c.expectation(*ops), TOL[dtype])


# ---------------------------------------------------------------------------
# counts, instructions, errors, devices
# ---------------------------------------------------------------------------


def test_counts_repr_and_instructions_match_jax(cpu):
    p = _params(9, 70)
    cj, ct = _mixed(tc, 9, p), _mixed(tct, 9, p)
    assert ct.count_flop() == cj.count_flop()
    assert repr(ct) == repr(cj) == "Circuit(nqubits=9, ngates=12)"

    def cond(item):
        return len(item["index"]) >= 3

    assert ct.gate_count_by_condition(cond) == cj.gate_count_by_condition(cond) == 9
    for c in (cj, ct):
        assert c.get_positional_logical_mapping() == {i: i for i in range(9)}
        c.barrier_instruction(0, 1)
        c.measure_instruction(4)
        c.reset_instruction(2)
        c.measure_instruction(1)
    assert ct._extra_qir == cj._extra_qir
    assert ct.get_positional_logical_mapping() == cj.get_positional_logical_mapping() == {0: 4, 1: 1}
    assert tct.Circuit.standardize_gate("CX") == tc.Circuit.standardize_gate("CX") == "cnot"
    apply = tct.Circuit.apply_general_variable_gate_delayed(tgates.GATES["rx"], name="rx")
    c = tct.Circuit(2)
    apply(c, 1, theta=0.3)
    jc = tc.Circuit(2)
    tc.Circuit.apply_general_variable_gate_delayed(jgates.GATES["rx"], name="rx")(jc, 1, theta=0.3)
    assert _names(c) == _names(jc) == ["rx"]
    _close(c.state(), jc.state(), TOL["complex64"])


@pytest.mark.parametrize("case", ["append_fused", "compose_part", "mapping_larger_n"])
def test_probe_errors_match_jax(case, cpu):
    """The reference's failures on fused items stay failures: ``append``
    with indices renames only ``index``, and per-qubit arrays need a
    full-register bijection."""

    def run(mod):
        if case == "append_fused":
            a = mod.Circuit(3)
            a.zzrx_layer([(0, 1), (1, 2)], np.array([0.1, 0.2]), np.array([0.1, 0.2, 0.3]))
            b = mod.Circuit(4)
            b.append(a, indices=[1, 2, 3])
            return b.state()
        if case == "compose_part":
            h = mod.Circuit(6)
            h.h_layer()
            return mod.Circuit(8).compose(h, indices=[7, 6, 5, 4, 3, 2])
        return _mixed(mod, 9, _params(9, 80)).initial_mapping({q: q for q in range(9)}, n=11)

    jax_error = AssertionError if case == "append_fused" else ValueError
    msg = "one rx angle per qubit required" if case == "append_fused" else "full-register bijection"
    with pytest.raises(jax_error, match=msg):
        run(tc)
    with pytest.raises(ValueError, match=msg):
        run(tct)


@pytest.mark.parametrize("method", ["copy", "inverse", "initial_mapping", "prepend", "compose"])
def test_cpu_circuit_stays_on_cpu(method):
    """Outside any device scope the port's default is the card; a circuit
    built on the CPU keeps the CPU through every derived circuit."""
    assert tct.get_device() == "cuda"
    p = _params(4, 90)
    c = tct.Circuit(4, device="cpu")
    c.h_layer()
    c.zzrx_layer([(0, 1), (2, 3)], torch.tensor(p["zz"][0][:2]), torch.tensor(p["rx"][0]))
    c.cnot(0, 2)
    other = tct.Circuit(4, device="cpu")
    other.rx_layer(p["rxl"])
    derived = {
        "copy": lambda: c.copy(),
        "inverse": lambda: c.inverse(),
        "initial_mapping": lambda: c.initial_mapping(reversal(4)),
        "prepend": lambda: c.prepend(other),
        "compose": lambda: other.compose(c, indices=[3, 2, 1, 0]),
    }[method]()
    assert derived.device.type == "cpu"
    assert derived.state().device.type == "cpu" and derived.matrix().device.type == "cpu"


# ---------------------------------------------------------------------------
# gate and config helpers, exports
# ---------------------------------------------------------------------------

_U2 = np.array([[0.6, 0.8j], [0.8j, 0.6]])
_GATE_HELPERS = {
    "adjoint": lambda g: g.GATES["rx"].adjoint()(theta=0.3),
    "adjoint_fixed": lambda g: g.GATES["s"].adjoint()(),
    "ided_before": lambda g: g.GATES["h"].ided()(),
    "ided_after": lambda g: g.GATES["ry"].ided(before=False)(theta=0.4),
    "controlled": lambda g: g.GATES["ry"].controlled()(theta=0.4),
    "ocontrolled": lambda g: g.GATES["x"].ocontrolled().controlled()(),
    "getattr": lambda g: g.rx_gate(theta=0.2),
    "get_gate": lambda g: g.get_gate("CNOT")(),
    "rgate_theoretical": lambda g: g.rgate_theoretical(0.3, 0.7, 1.1),
    "any_gate": lambda g: g.any_gate(_U2, name="u2"),
    "exponential_gate": lambda g: g.exponential_gate(np.kron(X, Z), 0.4),
    "exponential_gate_unity": lambda g: g.exponential_gate_unity(np.kron(X, Z), 0.4, half=True),
    "diagonal_gate": lambda g: g.diagonal_gate([1.0, 1j, -1.0, -1j]),
    "rzm_gate": lambda g: g.rzm_gate(0.3),
    "cmz_gate": lambda g: g.cmz_gate(0.2),
}


@pytest.mark.parametrize("name", sorted(_GATE_HELPERS))
def test_gate_helpers_match_jax(name):
    got, want = _GATE_HELPERS[name](tgates), _GATE_HELPERS[name](jgates)
    assert isinstance(got, tgates.Gate) and got.name == want.name
    assert got.tensor.shape == want.tensor.shape
    _close(got.tensor, want.tensor, TOL["complex64"])
    assert got.copy().tensor is got.tensor and got.copy().name == got.name


_VALUE_HELPERS = {
    "num_to_tensor": lambda g: g.num_to_tensor(0.5, [1.0, 2.0], device="cpu") if g is tgates else g.num_to_tensor(0.5, [1.0, 2.0]),
    "basis_states": lambda g: [g.zero_state, g.one_state, g.plus_state, g.minus_state],
    "pauli_gates": lambda g: g.pauli_gates(),
    "matrix_for_gate": lambda g: [g.matrix_for_gate(g.GATES["iswap"](theta=0.2))],
    "batched_unitary_row": lambda g: [g.batched_unitary(np.array([0.3, -0.2, 0.5, 0.1, 0.7]))],
    "batched_unitary_batch": lambda g: [g.batched_unitary(np.random.default_rng(3).normal(size=(3, 11)), 2)],
    "get_u_parameter": lambda g: [np.array(g.get_u_parameter(g.GATES["u"](theta=0.4, phi=0.3, lbd=-0.2).matrix()))],
}


@pytest.mark.parametrize("name", sorted(_VALUE_HELPERS))
def test_value_helpers_match_jax(name):
    got, want = _VALUE_HELPERS[name](tgates), _VALUE_HELPERS[name](jgates)
    tol = 1e-5 if name.startswith("batched") else TOL["complex64"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        _close(a, b, tol)


def test_other_gate_helpers_match_jax():
    assert tgates.array_to_tensor is tgates.num_to_tensor
    assert tgates.PAULI_CHAR_TO_INDEX == jgates.PAULI_CHAR_TO_INDEX
    assert tgates.bmatrix(_U2) == jgates.bmatrix(_U2)
    assert tgates.h is tgates.GATES["h"] and tgates.cnot_gate is tgates.GATES["cnot"]
    for g in (tgates, jgates):
        with pytest.raises(AttributeError):
            g.no_such_gate
        with pytest.raises(KeyError):
            g.get_gate("no_such_gate")
        mpo = object()
        assert g.mpo_gate(mpo) is mpo and g.meta_gate() is None and g.meta_vgate() is None
    ctl = tgates.GATES["x"].ocontrolled().controlled()
    assert ctl.ctrl == jgates.GATES["x"].ocontrolled().controlled().ctrl == [1, 0]
    assert ctl.nqubits == 3 and ctl.name == "cox"
    theta = torch.tensor(0.4, requires_grad=True)
    m = tgates.GATES["ry"].controlled().adjoint()(theta=theta).tensor
    (g,) = torch.autograd.grad(torch.real(m.sum()), theta)
    jg = jax.grad(lambda t: jnp.real(jgates.GATES["ry"].controlled().adjoint()(theta=t).tensor.sum()))(0.4)
    assert abs(g.item() - float(jg)) <= 1e-6
    rows = torch.tensor(np.random.default_rng(4).normal(size=(2, 4)), dtype=torch.float32)
    _close(tgates.batched_unitary(rows), tgates.batched_unitary(_np(rows)), 1e-5)


@pytest.mark.parametrize("which", ["single", "two"])
def test_random_gates_are_unitary(which):
    make = tgates.random_single_qubit_gate if which == "single" else tgates.random_two_qubit_gate
    a = make(generator=torch.Generator().manual_seed(5))
    b = make(generator=torch.Generator().manual_seed(5))
    other = make(generator=torch.Generator().manual_seed(6))
    k = 1 if which == "single" else 2
    assert a.tensor.shape == (2,) * (2 * k) and a.name == ("R1Q" if which == "single" else "R2Q")
    m = a.matrix()
    assert np.abs(m @ m.conj().T - np.eye(2**k)).max() <= 1e-6
    _close(a.tensor, b.tensor, 0)
    assert np.abs(a.tensor - other.tensor).max() > 1e-3


def _dtype_inside(mod):
    @mod.set_function_dtype("complex128")
    def f():
        return mod.config.dtypestr()

    return f()


@pytest.mark.parametrize("name", ["get_dtype", "rdtypestr", "npdtype", "runtime_dtype", "set_function_dtype"])
def test_config_helpers_match_jax(name):
    try:
        if name == "runtime_dtype":
            with tct.runtime_dtype("float64") as value, tc.runtime_dtype("float64") as cfg:
                assert value == ("complex128", "float64") and cfg.dtype == value[0]
                assert tct.get_dtype() == tc.get_dtype() == "complex128"
        elif name == "set_function_dtype":
            assert _dtype_inside(tct) == _dtype_inside(tc) == "complex128"
        else:
            for dt in ("complex128", "complex64"):
                tc.set_dtype(dt)
                with tct.set_dtype(dt):
                    assert getattr(tct.config, name)() == getattr(tc.config, name)()
        assert tct.get_dtype() == tc.get_dtype() == "complex64"
    finally:
        tc.set_dtype("complex64")  # the JAX scopes leave x64 on


def test_exports_match_jax():
    for name in ("gates", "Gate", "expectation", "num_to_tensor", "array_to_tensor", "get_dtype",
                 "runtime_dtype", "set_function_dtype"):
        assert hasattr(tc, name) and name in tct.__all__
    assert tct.gates is tgates and tct.Gate is tgates.Gate
    assert tct.expectation is circuit_expectation and tct.num_to_tensor is tgates.num_to_tensor


# ---------------------------------------------------------------------------
# the circuit functions of chip_smoke.py's circuit-API phase, at n <= 10
# ---------------------------------------------------------------------------


def _tfim_params(n, nl, seed):
    return (np.random.default_rng(seed).normal(size=(nl, 2, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("case", ["echo", "remapped_tfim", "composed_hea", "pauli_strings"])
def test_smoke_circuits_match_jax(case, cpu):
    n, nl = 7, 3
    g = _tfim_params(n, nl, 42)
    if case == "echo":
        ej = jax.jit(lambda: loschmidt_echo(tfim_circuit(tc, jnp.asarray(g), n, nl)).state())()
        et = loschmidt_echo(tfim_circuit(tct, torch.as_tensor(g), n, nl, device="cpu"))
        assert et.gate_count() == 1 + nl + nl * (2 * n - 1) + n
        _close(et.state(), ej, TOL["complex64"])
        assert abs(abs(et.state()[0].item()) ** 2 - 1) <= 1e-5
        return
    if case == "pauli_strings":
        structures, weights = tfim_pauli_strings(n)
        assert len(structures) == 2 * n - 1 and sum(weights) == -1.0
        pairs = [(i, i + 1) for i in range(n - 1)]

        def both(mod, p):
            c = tfim_circuit(mod, p, n, nl)
            return c.expectation_structures(structures, weights), c.expectation_zzx_energy(pairs, 1.0, -1.0)

        for s, e in (jax.jit(lambda: both(tc, jnp.asarray(g)))(), both(tct, torch.as_tensor(g))):
            assert abs(complex(s) - float(e)) <= 1e-5
        return
    if case == "remapped_tfim":
        def fj(p):
            return remapped_tfim_energy(tc, p, n, nl, reversal(n))

        def ft(p):
            return remapped_tfim_energy(tct, p, n, nl, reversal(n), device="cpu")

        def fu(p):
            return tfim_circuit(tct, p, n, nl).expectation_zzx_energy([(i, i + 1) for i in range(n - 1)], 1.0, -1.0)

        x = g
    else:
        perm = np.random.default_rng(5).permutation(n)
        x = (np.random.default_rng(9).normal(size=(2, 2, n)) * 0.4).astype(np.float32)

        def fj(w):
            return composed_hea_energy(tc, n, w, perm)

        def ft(w):
            return composed_hea_energy(tct, n, w, perm, device="cpu")

        def fu(w):
            return hea_energy(tct, n, w, device="cpu")

    ej, gj = jax.jit(jax.value_and_grad(lambda a: jnp.real(fj(a))))(jnp.asarray(x))
    results = []
    for f in (ft, fu):
        p = torch.as_tensor(x).requires_grad_()
        e = f(p)
        results.append((e.item(), torch.autograd.grad(e, p)[0]))
    (e, gt), (eu, gu) = results
    assert abs(e - float(ej)) <= 2e-6 * abs(float(ej)) and abs(e - eu) <= 2e-6 * abs(eu)
    _close(gt, gj, GRAD_TOL)
    _close(gt, gu, GRAD_TOL)
