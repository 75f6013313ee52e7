"""The port's contraction engine against the JAX package's, on the CPU:
``core/einsum_ir.py`` (the IR builders' signatures on the same QIR, with
matrix-free multicz and rzm items and channel items), ``core/contractor.py``
(``contract_ir`` under "plain", "greedy", "auto", "custom" and "treesa",
``choose_slices``, ``sliced_contract_ir`` with ``slice_ids`` and
``slice_weights``, ``strip_exponent``, ``dry_run`` and ``debug_level``,
``contraction_info``, ``get_tn_info``, the capture API and the parity API),
``core/native.py`` (the TreeSA path for one network and seed),
``simplify.py`` and the contractor part of ``config.py``.

Inputs are numpy-seeded and handed to both packages.  Values: relative 1e-5
at complex64 and 1e-10 at complex128 (each package sums in its own order);
signatures, paths and slice indices equal.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import opt_einsum as oe
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import simplify as jsimp
from tensorcircuit_ng_tpu.core import contractor as jctr
from tensorcircuit_ng_tpu.core import einsum_ir as jeir
from tensorcircuit_ng_tpu.core import native as jnative
from tensorcircuit_ng_tpu_torch import simplify as tsimp
from tensorcircuit_ng_tpu_torch.core import contractor as tctr
from tensorcircuit_ng_tpu_torch.core import einsum_ir as teir
from tensorcircuit_ng_tpu_torch.core import native as tnative

REPO = Path(__file__).resolve().parents[1]
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


def jval(ir, **kw):
    """The JAX package's ``contract_ir`` of ``ir``, as one jitted program
    (eager, each of its einsum steps would compile on its own)."""
    return np.asarray(jax.jit(lambda: jctr.contract_ir(ir, **kw))())


def _close(got, want, rtol):
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (got, want)


def brick(mod, n=8, depth=3, seed=3, wide=False, **kw):
    """H, then CNOT bricks with rz and rx on each qubit; with ``wide`` a
    multicz and an rzm on 9 wires (matrix-free items) and a 3-wire multicz."""
    rng = np.random.default_rng(seed)
    c = mod.Circuit(n, **kw)
    for i in range(n):
        c.h(i)
    for layer in range(depth):
        for i in range(layer % 2, n - 1, 2):
            c.cnot(i, i + 1)
        for i in range(n):
            c.rz(i, theta=float(rng.normal()))
            c.rx(i, theta=float(rng.normal()))
    c.multicz(0, 1, 2)
    c.rzm(1, 2, 3, theta=0.3)
    if wide:
        c.multicz(*range(9))
        c.rzm(*range(9), theta=0.7)
    return c


def dm_noisy(mod, n=5, **kw):
    """A DMCircuit with channel items (depolarizing, amplitude damping)."""
    rng = np.random.default_rng(4)
    c = mod.DMCircuit(n, **kw)
    for i in range(n):
        c.h(i)
    for i in range(n - 1):
        c.cnot(i, i + 1)
        c.depolarizing(i, px=0.02, py=0.03, pz=0.01)
        c.ry(i + 1, theta=float(rng.normal()))
    c.amplitudedamping(n - 1, gamma=0.1, p=1.0)
    c.rzm(0, 2, theta=0.4)
    return c


def _irs(c, mod, n, eir, **kw):
    q = c._expanded_qir()
    bits = [0, 1] * (n // 2) + [1] * (n % 2)
    return {
        "state": eir.circuit_state_ir(q, n, **kw),
        "amplitude": eir.amplitude_ir(q, n, bits, **kw),
        "expectation": eir.expectation_ir(q, n, [(Z, [2]), (X, [n - 1])], **kw),
        "expectation_no_cone": eir.expectation_ir(q, n, [(Z, [0])], lightcone=False, **kw),
    }


@pytest.mark.parametrize("wide", [False, True])
def test_ir_signatures_and_values(dtype, wide):
    """Each pure-state builder gives the JAX package's signature on the same
    QIR, and its contraction the same value (plan "auto")."""
    n = 10 if wide else 8
    cj, ct = brick(tc, n, wide=wide), brick(tct, n, wide=wide)
    irj, irt = _irs(cj, tc, n, jeir), _irs(ct, tct, n, teir, device="cpu")
    for key in irj:
        assert irt[key].signature() == irj[key].signature(), key
        assert all(t.dtype == getattr(torch, dtype) and t.device.type == "cpu" for t in irt[key].tensors)
        _close(tctr.contract_ir(irt[key]), jval(irj[key]), RTOL[dtype])


def test_superop_ir_signatures_and_values(dtype):
    """The doubled network with channel items: expectation, fixed and
    diagonal boundaries; the signature and the value of each."""
    n = 5
    cj, ct = dm_noisy(tc, n), dm_noisy(tct, n)
    qj, qt = cj._expanded_qir(), ct._expanded_qir()
    onehot = np.array([0.0, 1.0])
    cases = [
        ("superop_expectation_ir", ([(Z, [1]), (Z, [3])],), {}),
        ("superop_boundary_ir", (), {"diag_wires": [0, 3]}),
        ("superop_boundary_ir", (), {"fixed": {1: onehot}, "diag_wires": [4]}),
        ("superop_boundary_ir", (), {"fixed": {q: onehot for q in range(n)}}),
        ("superop_boundary_ir", ([(X, [2])],), {"lightcone": False}),
    ]
    for name, args, kws in cases:
        irj = getattr(jeir, name)(qj, n, *args, **kws)
        irt = getattr(teir, name)(qt, n, *args, device="cpu", **kws)
        assert irt.signature() == irj.signature(), (name, kws)
        _close(tctr.contract_ir(irt), jval(irj), RTOL[dtype])
    # the diagonal marginal sums to 1, and equals the dense density matrix's
    p = tctr.contract_ir(teir.superop_boundary_ir(qt, n, diag_wires=list(range(n)), device="cpu")).real
    _close(p.reshape(-1), np.real(np.diag(np.asarray(cj.densitymatrix()))), RTOL[dtype])


@pytest.mark.parametrize("method", ["plain", "greedy", "auto", "custom", "treesa"])
def test_contract_ir_under_each_contractor(dtype, method):
    """``contract_ir`` under each ``set_contractor`` method (the same plan
    in both packages: the paths are equal) and the value."""
    cj, ct = brick(tc, 8), brick(tct, 8)
    irj = jeir.amplitude_ir(cj._expanded_qir(), 8, [1, 0] * 4)
    irt = teir.amplitude_ir(ct._expanded_qir(), 8, [1, 0] * 4, device="cpu")
    if method == "custom":
        jopt = {"optimizer": jnative.TreeSAOptimizer(n_iters=300, skip_below_log10_flops=-1)}
        topt = {"optimizer": tnative.TreeSAOptimizer(n_iters=300, skip_below_log10_flops=-1)}
    elif method == "treesa":
        jopt = topt = {"n_iters": 300, "skip_below_log10_flops": -1}
    else:
        jopt = topt = {}
    with tc.cons.runtime_contractor(method, **jopt), tct.runtime_contractor(method, **topt):
        assert tct.get_contractor() == method
        vj = jval(irj)
        vt = tctr.contract_ir(irt)
        if method != "plain":
            assert list(tctr.find_path(irt)[0]) == list(jctr.find_path(irj)[0])
    assert tct.get_contractor() == "auto"
    _close(vt, vj, RTOL[dtype])


def test_set_contractor_and_cons(cpu):
    """``set_contractor`` (an optimizer makes it "custom"),
    ``set_function_contractor``, and the helpers on ``cons``."""
    try:
        assert tct.set_contractor("greedy", contraction_info=False) == "greedy"
        assert tct.get_contractor() == "greedy" and tct.config.contractor_options() == {"contraction_info": False}
        opt = tnative.TreeSAOptimizer()
        assert tct.set_contractor("auto", optimizer=opt) == "custom"
        assert tct.config.contractor_options()["optimizer"] is opt
    finally:
        tct.set_contractor("auto")
    assert tct.config.set_function_contractor("plain")(tct.get_contractor)() == "plain"
    assert tct.get_contractor() == "auto" and tct.config.contractor_options() == {}
    for name in ("choose_slices", "sliced_contract_ir", "get_symbol", "plain_contractor", "custom", "split_rules"):
        assert getattr(tct.cons, name) is getattr(tctr, name)
        assert callable(getattr(tc.cons, name))
    with pytest.raises(AttributeError):
        tct.cons.no_such_helper  # noqa: B018
    for name in ("set_contractor", "get_contractor", "runtime_contractor", "set_function_contractor",
                 "get_tn_info", "contraction_info", "simplify", "cons"):
        assert hasattr(tc, name) and hasattr(tct, name), name


def test_choose_slices_and_sliced_contraction(dtype):
    """``choose_slices`` picks the JAX package's indices; the sliced sum
    equals the whole contraction and the JAX package's; ``slice_ids``
    halves add up; ``slice_weights`` scale; an output index is refused."""
    n = 10
    cj, ct = brick(tc, n, depth=4), brick(tct, n, depth=4)
    irj = jeir.amplitude_ir(cj._expanded_qir(), n, [0] * n)
    irt = teir.amplitude_ir(ct._expanded_qir(), n, [0] * n, device="cpu")
    for target in (2**4, 2**3):
        sl = tctr.choose_slices(irt, target)
        assert sl == jctr.choose_slices(irj, target) and sl
    assert len(sl) >= 3
    whole = tctr.contract_ir(irt)
    sliced = tctr.sliced_contract_ir(irt, sl)
    _close(sliced, np.asarray(jctr.sliced_contract_ir(irj, sl)), RTOL[dtype])
    _close(sliced, whole.detach().numpy(), RTOL[dtype])
    ns = 2 ** len(sl)
    lo = tctr.sliced_contract_ir(irt, sl, slice_ids=np.arange(ns // 2))
    hi = tctr.sliced_contract_ir(irt, sl, slice_ids=torch.arange(ns // 2, ns))
    _close(lo + hi, whole.numpy(), RTOL[dtype])
    w = np.linspace(0.5, 1.5, ns)
    _close(tctr.sliced_contract_ir(irt, sl, slice_ids=np.arange(ns), slice_weights=w),
           np.asarray(jctr.sliced_contract_ir(irj, sl, slice_ids=jnp.arange(ns), slice_weights=jnp.asarray(w))),
           RTOL[dtype])
    state = teir.circuit_state_ir(ct._expanded_qir(), n, device="cpu")
    with pytest.raises(ValueError, match="output indices"):
        tctr.sliced_contract_ir(state, [state.output[0]])
    # a state network's slices keep its open legs
    ssl = tctr.choose_slices(state, 2**6)
    assert not set(ssl) & set(state.output)
    _close(tctr.sliced_contract_ir(state, ssl), tctr.contract_ir(state).numpy(), RTOL[dtype])


def test_strip_exponent_dry_run_and_info(dtype, capsys):
    """``strip_exponent``'s value and log factor, ``dry_run`` and
    ``debug_level=2``, ``contraction_info`` and its print, ``get_tn_info``."""
    cj, ct = brick(tc, 8), brick(tct, 8)
    irj = jeir.expectation_ir(cj._expanded_qir(), 8, [(Z, [3])])
    irt = teir.expectation_ir(ct._expanded_qir(), 8, [(Z, [3])], device="cpu")
    vt, lt = tctr.contract_ir(irt, strip_exponent=True)
    vj, lj = jax.jit(lambda: jctr.contract_ir(irj, strip_exponent=True))()
    assert lt.dtype == torch.float32
    _close(lt, np.asarray(lj), 1e-6)
    _close(vt, np.asarray(vj), RTOL[dtype])
    # the log factor is float32 in both packages, so the product is good to
    # float32 precision at complex128 too
    _close(vt * torch.exp(lt), tctr.contract_ir(irt).numpy(), 1e-5)
    state = teir.circuit_state_ir(ct._expanded_qir(), 8, device="cpu")
    z = tctr.contract_ir(state, dry_run=True)
    assert z.shape == (2,) * 8 and not z.any() and z.dtype == getattr(torch, dtype)
    with tct.runtime_contractor("auto", debug_level=2):
        assert tctr.contract_ir(irt).shape == () and tctr.contract_ir(irt).item() == 0
    ti, ji = tctr.contraction_info(irt), jctr.contraction_info(irj)
    assert set(ti) == set(ji)
    assert ti["flops"] == ji["flops"] and ti["log2[SIZE]"] == ji["log2[SIZE]"] and ti["path"] == ji["path"]
    assert tctr.contraction_info(irt, optimizer=None) == ti
    with tct.runtime_contractor("plain"):
        assert tctr.contraction_info(irt) == {}
    tctr._INFO_PRINTED.discard(irt.signature())
    capsys.readouterr()
    with tct.runtime_contractor("auto", contraction_info=True):
        tctr.contract_ir(irt)
        tctr.contract_ir(irt)
    out = capsys.readouterr().out
    assert out.count("contraction cost summary") == 1 and f"ops: {len(irt.inputs)}" in out
    for obj_t, obj_j in ((ct, cj), (irt, irj)):
        gt, gj = tct.get_tn_info(obj_t), tc.get_tn_info(obj_j)
        assert gt[0] == [tuple(x) for x in gj[0]] and gt[1] == tuple(gj[1]) and gt[2] == dict(gj[2])
    with pytest.raises(TypeError):
        tct.get_tn_info(3)


def test_treesa_path_matches_reference(cpu):
    """The native annealer on the port's copy of the source gives the JAX
    package's path for one network and seed, seeded or not; the library is
    built under ``build/native/`` by a hash of the source and flags."""
    with open(os.path.join(jnative._native_dir(), "treesa.cpp"), "rb") as f:
        assert tnative.SOURCE.read_bytes() == f.read()
    ct = brick(tct, 10, depth=4)
    ir = teir.amplitude_ir(ct._expanded_qir(), 10, [0] * 10, device="cpu")
    inputs = [tuple(i) for i in ir.inputs]
    for init in (None, list(oe.paths.greedy([frozenset(i) for i in inputs], frozenset(), ir.size_dict))):
        for seed in (1, 42):
            pt = tnative.treesa_path(inputs, (), ir.size_dict, n_iters=500, seed=seed, init_path=init)
            pj = jnative.treesa_path(inputs, (), ir.size_dict, n_iters=500, seed=seed, init_path=init)
            assert pt == pj
    assert tnative.treesa_available()
    lib = tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR and lib.exists() and lib.name.startswith("libtreesa_")
    assert lib.parent.relative_to(REPO).parts == ("build", "native")
    sym = [oe.get_symbol(k) for k in range(len(ir.size_dict))]
    opt_t, opt_j = tnative.TreeSAOptimizer(n_iters=500), jnative.TreeSAOptimizer(n_iters=500)
    ins = [frozenset(sym[i] for i in inp) for inp in inputs]
    sizes = {sym[i]: s for i, s in ir.size_dict.items()}
    assert opt_t(ins, frozenset(), sizes) == opt_j(ins, frozenset(), sizes)
    opt_t.skip_below_log10_flops = opt_j.skip_below_log10_flops = -1
    assert opt_t(ins, frozenset(), sizes) == opt_j(ins, frozenset(), sizes)
    assert tctr.OMEOptimizer(niters=200, seed=3)(ins, frozenset(), sizes) == jctr.OMEOptimizer(
        niters=200, seed=3)(ins, frozenset(), sizes)


def test_treesa_build_failure_raises(cpu, monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to greedy."""
    bad = tmp_path / "treesa.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.treesa_available()


def _grid_network(eir, L=4, D=32):
    """An L x L grid of tensors with bonds of size D (shapes only)."""
    ids = {}
    inputs = []
    for r in range(L):
        for q in range(L):
            nbs = [(r + dr, q + dq) for dr, dq in ((0, 1), (1, 0), (0, -1), (-1, 0)) if 0 <= r + dr < L and 0 <= q + dq < L]
            inputs.append(tuple(ids.setdefault(tuple(sorted(((r, q), nb))), len(ids)) for nb in nbs))
    return eir.EinsumIR(inputs, (), {i: D for i in ids.values()}, [])


def test_escalation_to_treesa(cpu):
    """A plan above 10^10 FLOPs under "auto" is planned again by TreeSA and
    the cheaper one kept: the JAX package's plan for the same network."""
    irt, irj = _grid_network(teir), _grid_network(jeir)
    greedy = oe.contract_path(irt.to_subscripts(), *irt.shapes(), shapes=True, optimize="auto")[1]
    assert float(greedy.opt_cost) > tctr.ESCALATE_FLOPS
    ti, ji = tctr.contraction_info(irt), jctr.contraction_info(irj)
    assert ti["path"] == ji["path"] and ti["flops"] == ji["flops"] < float(greedy.opt_cost) / 10


def test_relabelled_steps(cpu):
    """A network with more than 52 indices contracts (each step on its own
    letters); a step of more than 52 distinct indices is a ValueError."""
    ct, cj = brick(tct, 12, depth=6), brick(tc, 12, depth=6)
    irt = teir.amplitude_ir(ct._expanded_qir(), 12, [1] * 12, device="cpu")
    irj = jeir.amplitude_ir(cj._expanded_qir(), 12, [1] * 12)
    assert len(irt.size_dict) > 52
    _close(tctr.contract_ir(irt), jval(irj), 1e-5)
    wide = teir.EinsumIR([tuple(range(27)), tuple(range(27, 54))], tuple(range(54)), {i: 1 for i in range(54)},
                         [torch.ones((1,) * 27, dtype=torch.complex64)] * 2)
    with pytest.raises(ValueError, match="more than 52"):
        tctr.contract_ir(wide)
    assert tctr._relabel("ÀÁ,Áb->Àb") == "ab,bc->ac"


def test_fuse_identity_rule(cpu):
    """``fuse_single_qubit_qir`` drops an identity product of numpy gates
    (both packages) and of tensors that need no grad (the port only: the
    JAX package keeps a jnp one), and keeps one that needs a grad."""
    def circ(mod, theta):
        # wire 2 holds single-qubit gates only: an identity product there
        # is either dropped or kept as a "merged1q" item
        c = mod.Circuit(3)
        c.h(0)
        c.cnot(0, 1)
        c.rx(2, theta=theta)
        c.rx(2, theta=-theta)
        return c

    nj = len(jsimp.fuse_single_qubit_qir(circ(tc, 0.0)._expanded_qir()))
    nt = len(tsimp.fuse_single_qubit_qir(circ(tct, 0.0)._expanded_qir()))
    assert nj == nt == 1  # rx(0) twice: numpy identities, dropped by both
    assert len(tsimp.fuse_single_qubit_qir(circ(tct, 0.1)._expanded_qir())) == 2
    # a traced angle gives the JAX package a jnp gate, which it keeps
    counts = []

    def traced(t):
        counts.append(len(jsimp.fuse_single_qubit_qir(circ(tc, t)._expanded_qir())))
        return t

    jax.jit(traced)(0.0)
    assert counts == [2]
    assert len(tsimp.fuse_single_qubit_qir(circ(tct, torch.tensor(0.0))._expanded_qir())) == 1
    th = torch.tensor(0.0, requires_grad=True)
    fused = tsimp.fuse_single_qubit_qir(circ(tct, th)._expanded_qir())
    assert len(fused) == 2 and fused[1]["gate"].tensor.requires_grad and fused[1]["name"] == "merged1q"
    # a numpy chain stays numpy; a chain with a tensor is a tensor
    c = tct.Circuit(1)
    c.h(0)
    c.s(0)
    assert isinstance(tsimp.fuse_single_qubit_qir(c._expanded_qir())[0]["gate"].tensor, np.ndarray)
    c.rz(0, theta=torch.tensor(0.2))
    g = tsimp.fuse_single_qubit_qir(c._expanded_qir())[0]["gate"].tensor
    cj = tc.Circuit(1)
    cj.h(0)
    cj.s(0)
    cj.rz(0, theta=0.2)
    _close(g, np.asarray(jsimp.fuse_single_qubit_qir(cj._expanded_qir())[0]["gate"].tensor), 1e-6)


def test_simplify_helpers(dtype):
    """The SVD split and Schmidt rank, the light cone and the shape helpers."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    a, s, b = tsimp.split_two_qubit_gate(g)
    aj, sj, bj = jsimp.split_two_qubit_gate(g)
    _close(s, np.asarray(sj), 1e-6)
    back = torch.einsum("aik,k,kbj->abij", a, s.to(a.dtype), b).reshape(4, 4)
    _close(back, g, 1e-6)
    cnot = np.eye(4)[[0, 1, 3, 2]]
    for gate in (cnot, np.kron(X, Z), g):
        assert tsimp.gate_schmidt_rank(gate) == jsimp.gate_schmidt_rank(gate)
    a2, s2, b2 = tsimp.split_two_qubit_gate(g, max_singular_values=2)
    assert a2.shape == (2, 2, 2) and s2.shape == (2,) and b2.shape == (2, 2, 2)
    ct, cj = brick(tct, 8), brick(tc, 8)
    assert [i["index"] for i in tsimp.light_cone_qir(ct._expanded_qir(), [0])] == [
        tuple(i["index"]) for i in jsimp.light_cone_qir(cj._expanded_qir(), [0])]
    assert tsimp.light_cone_cancel is tsimp.light_cone_qir
    assert tsimp.infer_new_shape((2, 3, 4), (4, 5), [(2, 0)]) == jsimp.infer_new_shape((2, 3, 4), (4, 5), [(2, 0)])
    sd = {0: 2, 1: 3, 2: 4}
    assert tsimp.pseudo_contract_between((0, 1), (1, 2), sd) == jsimp.pseudo_contract_between((0, 1), (1, 2), sd)


def test_parity_api(cpu):
    """get_symbol, sorted_edges, set_tensornetwork_backend, the contractor
    entry points, the cost decorator and split_rules."""
    for i in (0, 25, 51, 52, 300):
        assert tctr.get_symbol(i) == jctr.get_symbol(i)
    ct, cj = brick(tct, 6), brick(tc, 6)
    irt = teir.amplitude_ir(ct._expanded_qir(), 6, [0] * 6, device="cpu")
    irj = jeir.amplitude_ir(cj._expanded_qir(), 6, [0] * 6)
    assert tctr.sorted_edges(irt) == jctr.sorted_edges(irj)
    for name in (None, "pytorch", "torch"):
        assert tctr.set_tensornetwork_backend(name) == "pytorch"
    with pytest.raises(ValueError):
        tctr.set_tensornetwork_backend("jax")
    want = jval(irj)
    for fn in (tctr.plain_contractor, tctr.experimental_contractor, lambda ir: tctr.custom(ir, optimizer="greedy"),
               lambda ir: tctr.custom_stateful(ir, tnative.TreeSAOptimizer, n_iters=100)):
        _close(fn(irt), want, 1e-5)
    assert tctr.split_rules(4, 1e-3) == jctr.split_rules(4, 1e-3)

    @tctr.contraction_info_decorator
    def make():
        return irt

    assert make() is irt


def test_capture_api(cpu):
    """``runtime_nodes_capture`` keeps the last IR built inside and
    ``function_nodes_capture`` raises ``NodesReturn`` with it.  (The JAX
    package's versions never capture: nothing there calls its
    ``_maybe_capture``; ROADMAP.md Queue 3, F6.)"""
    ct = brick(tct, 6)
    with tctr.runtime_nodes_capture() as store:
        ir = ct.amplitude_before("000000")
    assert store["ir"] is ir
    with tctr.runtime_nodes_capture() as store:
        pass
    assert store["ir"] is None

    @tctr.function_nodes_capture
    def amp():
        return ct.amplitude_before("000000")

    with pytest.raises(tctr.NodesReturn) as info:
        amp()
    assert isinstance(info.value.nodes, teir.EinsumIR) and len(info.value.nodes.inputs) == len(ir.inputs)
    assert tctr.function_nodes_capture(lambda: 3)() == 3
    cj = brick(tc, 6)
    with jctr.runtime_nodes_capture() as jstore:
        cj.amplitude_before("000000")
    assert jstore["ir"] is None
