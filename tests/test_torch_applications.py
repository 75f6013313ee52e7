"""The port's ``applications/`` against the JAX package's: the public names
of the ten modules (the generated layer families included), ``graphdata``,
``finance``, ``physics``, ``ensemble``, every ``layers`` function, the
losses of ``optimization``.

Both packages run from the same numpy-seeded inputs.  Tolerances: host
results (graphs, QUBOs, energies, collapses, votes) exact or within 1e-12
in float64; circuit states within 1e-6; losses and CVaR values within
1e-6.  ``QUBO_QAOA_cvar`` is in ``test_torch_applications_cvar.py``,
``vqes`` in ``test_torch_applications_vqes.py``, the QUBO-QAOA
trajectories and the slice end to end in
``test_torch_applications_train.py``; ``van``, ``dqas`` and ``vags`` in
``test_torch_applications_search.py``, ``test_torch_applications_vags.py``
and ``test_torch_applications_noise.py``.
"""

import os
import subprocess
import sys
import types

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import applications as japps
from tensorcircuit_ng_tpu.applications import (ensemble as jens, finance as jfin, graphdata as jgd, layers as jL,
                                               optimization as jopt, physics as jphys)
from tensorcircuit_ng_tpu_torch import applications
from tensorcircuit_ng_tpu_torch.applications import (ensemble, finance, graphdata, layers as L, optimization, physics,
                                                     vqes)
from chip_smoke import tfim_rows
from torch_apps_common import _jax_at_complex64, _np, _one_thread_on_cpu  # noqa: F401

MODULES = ("optimization", "dqas", "layers", "graphdata", "finance", "physics", "ensemble", "vqes", "van", "vags")


def _names(mod):
    """A module's public names: not modules, not typing's, no underscore."""
    return {n for n in dir(mod) if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)
            and getattr(getattr(mod, n), "__module__", None) != "typing"} - {"annotations", "Tensor", "Graph"}


# --------------------------------------------------------------- surface ---


def test_public_names_against_jax():
    """Every public name of the ten modules (``__all__`` and the rest of
    ``dir``: the layer families that ``layers`` generates) exists in the
    port; none is left out."""
    import importlib

    left_out = {}  # name -> why; nothing is left out
    for name in MODULES:
        jmod = importlib.import_module(f"tensorcircuit_ng_tpu.applications.{name}")
        mod = importlib.import_module(f"tensorcircuit_ng_tpu_torch.applications.{name}")
        assert set(getattr(jmod, "__all__", [])) == set(getattr(mod, "__all__", [])), name
        missing = _names(jmod) - _names(mod) - set(left_out)
        assert not missing, f"{name}: {sorted(missing)}"
    assert set(japps.__all__) == set(applications.__all__) == {"optimization", "dqas", "layers", "graphdata"}
    families = {n for n in _names(jL) if n.endswith(("layer", "gate", "_block", "_bitflip", "_bitflip_mc"))}
    assert len(families) >= 100 and families <= _names(L)


def test_applications_load_lazily():
    code = ("import sys, tensorcircuit_ng_tpu_torch as t\n"
            "assert 'tensorcircuit_ng_tpu_torch.applications' not in sys.modules\n"
            "a = t.applications\n"
            "assert a.__name__ == 'tensorcircuit_ng_tpu_torch.applications'\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'tensorcircuit_ng_tpu') for m in sys.modules)\n"
            "assert 'tensorcircuit_ng_tpu_torch.applications.van' not in sys.modules\n"
            "from tensorcircuit_ng_tpu_torch.applications import van, vags\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


# ------------------------------------------------------- host modules ---


def _edges(g):
    return sorted(tuple(sorted(e)) + (g.edges[e].get("weight"),) for e in g.edges)


def test_graphdata_as_jax():
    for d, n, w in ((3, 8, False), (3, 6, True), (4, 10, True)):
        a, b = graphdata.regular_graph_generator(d, n, w, seed=5), jgd.regular_graph_generator(d, n, w, seed=5)
        for _ in range(2):
            assert _edges(next(a)) == _edges(next(b))
    a, b = graphdata.erdos_graph_generator(8, 0.4, True, seed=2), jgd.erdos_graph_generator(8, 0.4, True, seed=2)
    assert _edges(next(a)) == _edges(next(b))
    assert _edges(graphdata.graph1()) == _edges(jgd.graph1())
    for key in ("3C", "4C", "8A"):
        g = graphdata.get_graph(key)
        assert _edges(g) == _edges(jgd.get_graph(key))
        assert graphdata.maxcut_solution_bruteforce(g) == jgd.maxcut_solution_bruteforce(g)
    assert graphdata.ensemble_maxcut_solution(graphdata.regular_graph_generator(3, 6, seed=1), 3) == \
        jgd.ensemble_maxcut_solution(jgd.regular_graph_generator(3, 6, seed=1), 3)
    g = graphdata.get_graph("8A")
    assert [_edges(x) for x in graphdata.reduce_edges(g, 2)] == [_edges(x) for x in jgd.reduce_edges(g, 2)]
    np.random.seed(3)
    r = _edges(graphdata.reduced_ansatz(g, 5))
    np.random.seed(3)
    assert r == _edges(jgd.reduced_ansatz(g, 5))
    assert [_edges(x) for x in graphdata.split_ansatz(g, 3)] == [_edges(x) for x in jgd.split_ansatz(g, 3)]
    for f, args in (("graph1D", (6,)), ("graph1D", (5, False)), ("even1D", (6,)), ("odd1D", (6,)),
                    ("Grid2D", (2, 3, False)), ("Grid2D", (3, 3)), ("Triangle2D", (3, 3))):
        assert _edges(getattr(graphdata, f)(*args)) == _edges(getattr(jgd, f)(*args))
    gq = graphdata.dress_graph_with_cirq_qubit(graphdata.graph1D(4))
    assert L.generate_qubits(gq) == jL.generate_qubits(jgd.dress_graph_with_cirq_qubit(jgd.graph1D(4)))
    lonely = nx.Graph([(0, 1)])
    lonely.add_node(2)
    assert graphdata.all_nodes_covered(g) and not graphdata.all_nodes_covered(lonely)


def _prices(n, days, seed=0):
    rng = np.random.default_rng(seed)
    return 100.0 * np.cumprod(1.0 + rng.normal(0.0005, 0.01, size=(n, days)), axis=1)


def test_finance_as_jax():
    prices = _prices(6, 40)
    sd, jsd = finance.StockData(prices), jfin.StockData(prices)
    np.testing.assert_array_equal(sd.get_return(), jsd.get_return())
    np.testing.assert_array_equal(sd.get_covariance(), jsd.get_covariance())
    q = finance.QUBO_from_portfolio(sd.get_covariance(), sd.get_return(), q=0.5, B=2, t=10.0)
    np.testing.assert_array_equal(q, jfin.QUBO_from_portfolio(jsd.get_covariance(), jsd.get_return(), 0.5, 2, 10.0))
    with pytest.raises(ValueError):
        finance.StockData([[1.0, 2.0], [1.0]])


def test_physics_as_jax():
    for L_ in (5, 6, 8, 9):
        for jzz, jx, pauli in ((1.0, 1.0, True), (0.7, 1.3, False), (1.2, 0.4, True)):
            assert abs(physics.TFIM1Denergy(L_, jzz, jx, pauli) - jphys.TFIM1Denergy(L_, jzz, jx, pauli)) <= 1e-12
        assert abs(physics.Heisenberg1Denergy(L_ - L_ % 2) - jphys.Heisenberg1Denergy(L_ - L_ % 2)) <= 1e-12
    n = 8
    ham = tfim_rows(n)
    with tct.set_dtype("complex128"):
        e0 = torch.linalg.eigvalsh(vqes.construct_matrix(ham, device="cpu"))[0].item()
    assert abs(physics.TFIM1Denergy(n) - e0) <= 1e-5
    pc, nu = 0.5, 1.3
    ns = [8, 16, 32]
    ps = [list(np.linspace(0.3, 0.7, 11)) for _ in ns]
    obs = [[float(np.tanh((p - pc) * L_ ** (1 / nu))) for p in ps[i]] for i, L_ in enumerate(ns)]
    dobs = [[0.01] * len(p) for p in ps]
    for kw in (dict(), dict(obs_type=0, beta=0.1), dict(fit_type=1, dobs=dobs)):
        got, want = physics.data_collapse(ns, ps, obs, pc + 0.02, nu, **kw), jphys.data_collapse(ns, ps, obs, pc + 0.02,
                                                                                                 nu, **kw)
        assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
        assert abs(got[3] - want[3]) <= 1e-12
    assert physics.pc_linear_interpolation([0.1, 0.2, 0.3], [1.0, 2.0, 4.0], 0.25) == \
        jphys.pc_linear_interpolation([0.1, 0.2, 0.3], [1.0, 2.0, 4.0], 0.25)


class _Stub:
    def __init__(self, bias):
        self.bias = bias

    def predict(self, x):
        return np.clip(x[:, 0] * 0.1 + self.bias, 0, 1)


def test_ensemble_as_jax_with_a_torch_module():
    x = np.random.default_rng(4).uniform(size=(7, 3)).astype(np.float32)
    lin = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Softmax(dim=-1))
    with torch.no_grad():
        lin[0].weight.copy_(torch.as_tensor(np.random.default_rng(5).normal(size=(2, 3))))
        lin[0].bias.zero_()
    wl = lin[0].weight.detach().numpy().astype(np.float64)

    def as_numpy(v):
        z = v @ wl.T
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    for models in (((_Stub(0.9), True), (_Stub(0.8), True), (_Stub(0.2), True)),):
        bag, jbag = ensemble.bagging(), jens.bagging()
        for m, trained in models:
            bag.append(m, trained)
            jbag.append(m, trained)
        for policy in ("average", "weight", "most"):
            np.testing.assert_allclose(bag.predict(x, policy), jbag.predict(x, policy), atol=1e-12)
            assert bag.eval(x, np.ones(7), policy) == jbag.eval(x, np.ones(7), policy)
    bag, jbag = ensemble.bagging(), jens.bagging()
    bag.append(lin, True)
    bag.append(as_numpy, True)
    jbag.append(as_numpy, True)
    jbag.append(as_numpy, True)
    for policy in ("average", "weight", "most"):
        got = bag.predict(x, policy)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, jbag.predict(x, policy), atol=1e-6)
    trained = []
    bag2 = ensemble.Bagging()
    bag2.append(_Stub(0.5))
    bag2.train(lambda m, **kw: trained.append(kw) or m, epochs=2)
    assert trained == [{"epochs": 2}] and bag2.model_trained == [True]
    with pytest.raises(ValueError):
        bag.predict(x, "nope")


# ------------------------------------------------------------- layers ---


def _layer_call(name, f, c, g, mod):
    """Apply one ``layers`` function to a 4-qubit circuit with fixed angles."""
    if name.endswith("gate"):
        return f(c, 0, 2, 0.3)
    if name in ("cnot_ring", "cz_ring"):
        return f(c)
    if name in ("rx_layer", "ry_layer", "rz_layer"):
        return f(c, np.array([0.1, 0.2, 0.3, 0.4], dtype=np.float32))
    if name == "entangler_layer":
        return f(c, np.arange(8, dtype=np.float32).reshape(2, 4) * 0.1)
    if name in ("zz_layer", "xx_layer", "yy_layer"):
        return f(c, np.array([0.1, 0.2, 0.3], dtype=np.float32))
    if name.endswith("_block"):
        return f(c, np.array([0.2, 0.4], dtype=np.float32), g)
    if name.endswith("bitflip_mc"):
        arg = np.array([0.1, 0.2, 0.3, 0.4], dtype=np.float32) if name.startswith("any") else 0.3
        return f(c, arg, g, 0.0, 0.0, 0.0)
    if name.startswith("any"):
        return f(c, np.array([0.1, 0.2, 0.3, 0.4], dtype=np.float32), g)
    return f(c, 0.3, g)


def test_every_layer_function_as_jax():
    """Each function of ``layers`` (the generated families among them) on a
    4-qubit ring: the same state (the Monte-Carlo ``_bitflip_mc`` ones at
    zero noise) within 1e-6; the exact channels on ``DMCircuit``."""
    g = nx.cycle_graph(4)
    skip = {n for n in _names(jL) if n.startswith("generate")} | {"bitfliplayer", "bitfliplayer_mc"}
    names = sorted(n for n in _names(jL) if callable(getattr(jL, n)) and n not in skip
                   and not n.endswith("_bitflip"))
    assert len(names) >= 90
    for name in names:
        c, jc = tct.Circuit(4), tc.Circuit(4)
        for cc in (c, jc):
            cc.h(1)
            cc.ry(3, theta=0.7)
        _layer_call(name, getattr(L, name), c, g, L)
        _layer_call(name, getattr(jL, name), jc, g, jL)
        np.testing.assert_allclose(_np(c.state()), np.asarray(jc.state()), atol=1e-6, err_msg=name)
    for name in sorted(n for n in _names(jL) if n.endswith("_bitflip") and not n.startswith("generate")):
        dm, jdm = tct.DMCircuit(3), tc.DMCircuit(3)
        for d in (dm, jdm):
            d.h(0)
        getattr(L, name)(dm, 0.3, nx.path_graph(3), 0.02, 0.03, 0.01)
        getattr(jL, name)(jdm, 0.3, nx.path_graph(3), 0.02, 0.03, 0.01)
        L.bitfliplayer(dm, nx.path_graph(3), 0.05, 0.0, 0.02)
        jL.bitfliplayer(jdm, nx.path_graph(3), 0.05, 0.0, 0.02)
        np.testing.assert_allclose(_np(dm.densitymatrix()), np.asarray(jdm.densitymatrix()), atol=1e-6, err_msg=name)
    c = tct.Circuit(4)
    L.bitfliplayer_mc(c, g, 0.0, 0.0, 0.0)
    L.anyswaplayer_bitflip_mc(c, np.ones(4) * 0.05, g, 0.0, 0.0, 0.0)
    assert abs(torch.linalg.vector_norm(c.state()).item() - 1) < 1e-6
    assert L.rxlayer.__trainable__ and not L.Hlayer.__trainable__ and L.zzgate.__doc__ == "zzgate"


# --------------------------------------------------------- optimization ---


def _qubo(n=6, seed=0):
    prices = _prices(n, 60, seed)
    sd = finance.StockData(prices)
    return finance.QUBO_from_portfolio(sd.get_covariance(), sd.get_return(), q=0.5, B=2, t=1.0)


def test_optimization_losses_as_jax():
    from tensorcircuit_ng_tpu.templates.ansatz import QAOA_ansatz_for_Ising as jansatz
    from tensorcircuit_ng_tpu.templates.conversions import QUBO_to_Ising as jq2i
    from tensorcircuit_ng_tpu_torch.templates.ansatz import QAOA_ansatz_for_Ising
    from tensorcircuit_ng_tpu_torch.templates.conversions import QUBO_to_Ising

    Q = _qubo(4)
    terms, w, off = QUBO_to_Ising(Q)
    assert (terms, w, off) == jq2i(Q)
    ev = optimization.ising_energy_vector(terms, w, off, device="cpu")
    np.testing.assert_allclose(_np(ev), np.asarray(jopt.ising_energy_vector(terms, w, off)), atol=1e-6)
    assert ev.dtype == torch.float32
    probs = np.random.default_rng(6).dirichlet(np.ones(16)).astype(np.float32)
    for alpha in (0.05, 0.25, 1.0):
        got = optimization.cvar_loss(torch.as_tensor(probs), ev, alpha)
        assert abs(got.item() - float(jopt.cvar_loss(jnp.asarray(probs), jnp.asarray(_np(ev)), alpha))) < 1e-6
        r = np.random.default_rng(7).normal(size=16)
        assert abs(optimization.cvar_value(r, probs, alpha).item() - float(jopt.cvar_value(r, probs, alpha))) < 1e-6
    np.testing.assert_allclose(_np(optimization._qubo_values(Q)), np.asarray(jopt._qubo_values(Q)), atol=1e-6)
    counts = {"0011": 30, "1100": 50, "1111": 20}
    efn = lambda b: float(_np(ev)[int(b, 2)])  # noqa: E731
    assert optimization.cvar_from_counts(counts, efn, 0.3) == jopt.cvar_from_counts(counts, efn, 0.3)

    params = np.random.default_rng(8).normal(size=4).astype(np.float32)
    c = QAOA_ansatz_for_Ising(torch.as_tensor(params), 2, terms, w, device="cpu")
    jc = jansatz(jnp.asarray(params), 2, terms, w)
    assert abs(optimization.cvar_from_expectation(c, Q, 0.3).item()
               - float(jopt.cvar_from_expectation(jc, Q, 0.3))) < 1e-6
    cc = optimization.cvar_from_circuit(c, 4000, Q, 0.3).item()
    assert abs(cc - optimization.cvar_from_expectation(c, Q, 0.3).item()) < 0.3
    # F26: the JAX Ising loss reads only code 1 as Z, so for QUBO_to_Ising's
    # code-3 terms it is the constant sum of the weights
    p = torch.as_tensor(params).requires_grad_()
    loss = optimization.QAOA_loss(2, terms, w, p)
    probs_c = _np(c.probability()).astype(np.float64)
    assert abs(loss.item() - float(probs_c @ (_np(ev).astype(np.float64) - off))) < 1e-5
    (g,) = torch.autograd.grad(loss, p)
    assert g.abs().max().item() > 1e-3
    assert abs(float(jopt.QAOA_loss(2, terms, w, jnp.asarray(params))) - sum(w)) < 1e-5
    assert abs(optimization.Ising_loss(c, [[1 if v == 3 else 0 for v in t] for t in terms], w).item()
               - float(jopt.Ising_loss(jc, [[1 if v == 3 else 0 for v in t] for t in terms], w))) < 1e-6
