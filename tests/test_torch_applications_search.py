"""The port's ``applications/`` samplers and search against the JAX
package's: ``van`` (MADE, PixelCNN, NMF with the flax parameters carried
across by ``convert.van_params``) and ``dqas`` (the compact and the
reference searches, the probabilistic-model search, the helpers).

Both packages run from the same numpy-seeded inputs.  Tolerances: model
log-probs and logits within 1e-5 (NMF 1e-6), kernels' losses and gradient
matrices within 1e-5 (relative to their largest entry where that passes
1), Adam trajectories within 1e-5 a step.  Where the JAX
package draws from ``jax.random`` (the samplers) only statistics are held;
where it draws from numpy (DQAS's architectures) the draws are equal.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.applications import dqas as jdqas, layers as jL, van as jvan
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.applications import dqas, layers as L, van
from torch_apps_common import TOL, _jax_at_complex64, _np, _one_thread_on_cpu  # noqa: F401

def _tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


# ---------------------------------------------------------------- van ---


@functools.lru_cache(maxsize=None)
def _made(n=6, hidden=16):
    jm = jvan.MADE(n=n, hidden=hidden)
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, n)))
    return jm, jp, convert.van_params(van.MADE(n, hidden, device="cpu"), _tree(jp))


def test_made_log_probs_and_autoregression():
    jm, jp, pm = _made()
    allx = np.array(list(itertools.product([0, 1], repeat=6)), dtype=np.float32)
    lp = _np(pm.log_prob(torch.as_tensor(allx)))
    np.testing.assert_allclose(lp, np.asarray(jax.jit(lambda x: jm.apply(jp, x))(allx)), atol=TOL)
    assert abs(np.exp(lp.astype(np.float64)).sum() - 1.0) < TOL
    x = torch.as_tensor(allx[::5])
    base = _np(pm.logits(x))
    for i in range(6):
        flipped = x.clone()
        flipped[:, i] = 1 - flipped[:, i]
        np.testing.assert_array_equal(_np(pm.logits(flipped))[:, : i + 1], base[:, : i + 1])
    s = pm.sample(torch.Generator().manual_seed(0), 64)
    assert s.shape == (64, 6) and set(np.unique(_np(s))) <= {0.0, 1.0}
    assert pm.model is pm and pm.call(x).shape == (x.shape[0],)
    assert abs(float(pm.regularization(lbd_w=0.02)) - float(jm.regularization(jp, lbd_w=0.02))) < 1e-6


def test_pixelcnn_logits_and_autoregression():
    jpc = jvan.PixelCNN(spin_channel=2, depth=2, filters=8)
    x = np.random.default_rng(1).integers(0, 2, size=(5, 4, 4)).astype(np.int32)
    jp = jpc.init(jax.random.PRNGKey(0), jax.nn.one_hot(x, 2))
    pc = convert.van_params(van.PixelCNN(2, 2, 8, device="cpu"), _tree(jp))
    onehot = torch.nn.functional.one_hot(torch.as_tensor(x).long(), 2).float()
    logits = _np(pc(onehot))
    np.testing.assert_allclose(logits, np.asarray(jax.jit(lambda v: jpc.apply(jp, v))(jax.nn.one_hot(x, 2))),
                               atol=TOL)
    np.testing.assert_allclose(_np(pc.log_prob(torch.as_tensor(x))),
                               np.asarray(jpc.apply(jp, x, method=jpc.log_prob)), atol=TOL)
    for i, j in [(0, 0), (1, 2), (2, 3), (3, 1)]:
        y = x.copy()
        y[:, i, j] = 1 - y[:, i, j]
        other = _np(pc(torch.nn.functional.one_hot(torch.as_tensor(y).long(), 2).float()))
        before = np.arange(16).reshape(4, 4) <= i * 4 + j
        np.testing.assert_array_equal(other[:, before], logits[:, before])
    s = pc.sample(torch.Generator().manual_seed(2), 3, 4, 4)
    assert s.shape == (3, 4, 4) and s.dtype == torch.int32


def test_pixelcnn_gradients_as_jax():
    """The gradients of the summed log-probs through the masked
    convolutions' float32 backward, against ``jax.grad``'s (carried into a
    torch layout by ``convert.van_params``), within 1e-5 of the largest."""
    jpc = jvan.PixelCNN(spin_channel=2, depth=2, filters=8)
    x = np.random.default_rng(4).integers(0, 2, size=(6, 4, 4)).astype(np.int32)
    jp = jpc.init(jax.random.PRNGKey(6), jax.nn.one_hot(x, 2))
    pc = convert.van_params(van.PixelCNN(2, 2, 8, device="cpu"), _tree(jp))
    got = torch.autograd.grad(pc.log_prob(torch.as_tensor(x)).sum(), list(pc.parameters()))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jpc.apply(p, x, method=jpc.log_prob))))(jp)
    want = list(convert.van_params(van.PixelCNN(2, 2, 8, device="cpu"), _tree(jg)).parameters())
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=TOL * max(1.0, float(w.abs().max())))


def test_nmf_log_probs_and_marginals():
    jn = jvan.NMF(spin_channel=2, dimensions=(4,))
    jp = jn.init(jax.random.PRNGKey(5), jnp.zeros((1, 4), dtype=jnp.int32))
    pn = convert.van_params(van.NMF(2, (4,), device="cpu"), _tree(jp))
    cfgs = np.array(list(itertools.product([0, 1], repeat=4)), dtype=np.int32)
    lp = _np(pn.log_prob(torch.as_tensor(cfgs)))
    np.testing.assert_allclose(lp, np.asarray(jn.apply(jp, cfgs, method=jn.log_prob)), atol=1e-6)
    draws = 8192
    s = _np(pn.sample(torch.Generator().manual_seed(7), draws))
    p1 = _np(torch.softmax(pn.meanfield, dim=-1))[:, 1]
    sigma = np.sqrt(p1 * (1 - p1) / draws)
    assert np.all(np.abs(s.mean(axis=0) - p1) <= 4 * sigma)


def test_convert_van_params_refuses_a_mismatch():
    _, jp, _ = _made()
    with pytest.raises(ValueError):
        convert.van_params(van.MADE(6, 8, device="cpu"), _tree(jp))


# ---------------------------------------------------------------- dqas ---


def _dqas_loss(mod, xnp, calls):
    def loss_fn(ops, params):
        calls.append(list(ops))
        c = mod.Circuit(1)
        for s, op in enumerate(ops):
            if op == 0:
                c.rx(0, theta=params[s, 0])
        return 1.0 - xnp.real(c.probability()[1])
    return loss_fn


def test_dqas_search_samples_the_same_architectures():
    calls, jcalls = [], []
    best, params, hist = dqas.DQAS_search(op_pool=[0, 1], nslots=1, loss_fn=_dqas_loss(tct, torch, calls), batch=4,
                                          steps=5, seed=3)
    jbest, jparams, jhist = jdqas.DQAS_search(op_pool=[0, 1], nslots=1, loss_fn=_dqas_loss(tc, jnp, jcalls), batch=4,
                                              steps=5, seed=3)
    assert calls == jcalls and len(calls) == 20
    np.testing.assert_allclose(hist, jhist, atol=TOL)
    np.testing.assert_allclose(_np(params), np.asarray(jparams), atol=TOL)
    assert best == jbest


def _kernel(mod, vg, xnp):
    def kernel(gdata, nnp, preset):
        def lossf(theta):
            c = mod.Circuit(1)
            for i, j in enumerate(preset):
                if j == 0:
                    c.rx(0, theta=theta[i, 0])
            return 1.0 - xnp.real(c.probability()[1])
        return vg(lossf, nnp)
    return kernel


def _jvg(f, x):
    return jax.value_and_grad(f)(jnp.asarray(x))


def test_dqas_reference_search_and_helpers():
    np.random.seed(1)
    stp, nnp, hist = dqas.DQAS_search(_kernel(tct, dqas.value_and_grad, torch), op_pool=[0, 1], p=2, batch=6, epochs=3)
    np.random.seed(1)
    jstp, jnnp, jhist = jdqas.DQAS_search(_kernel(tc, _jvg, jnp), op_pool=[0, 1], p=2, batch=6, epochs=3)
    np.testing.assert_allclose(_np(stp), np.asarray(jstp), atol=TOL)
    np.testing.assert_allclose(_np(nnp), np.asarray(jnnp), atol=TOL)
    np.testing.assert_allclose(hist, jhist, atol=TOL)
    prob = np.array([[0.2, 0.5, 0.3], [0.9, 0.05, 0.05]])
    np.random.seed(4)
    picks = dqas.preset_byprob(prob)
    np.random.seed(4)
    assert picks == jdqas.preset_byprob(prob)
    w = np.random.default_rng(2).normal(size=(2, 3))
    np.testing.assert_array_equal(_np(dqas.get_preset(prob)), np.asarray(jdqas.get_preset(prob)))
    np.testing.assert_allclose(_np(dqas.get_weights(w, prob)), np.asarray(jdqas.get_weights(w, prob)), atol=1e-6)
    np.testing.assert_allclose(_np(dqas.get_weights(w, preset=[2, 1])), np.asarray(jdqas.get_weights(w, preset=[2, 1])),
                               atol=1e-6)
    w3 = np.random.default_rng(3).normal(size=(2, 3, 2))
    np.testing.assert_allclose(_np(dqas.get_weights_v2(w3, [1, 0])), np.asarray(jdqas.get_weights_v2(w3, [1, 0])),
                               atol=1e-6)
    assert dqas.repr_op(L.zzlayer) == jdqas.repr_op(jL.zzlayer) == "zzlayer"
    assert dqas.repr_op(["rx", L.Hlayer]) == jdqas.repr_op(["rx", jL.Hlayer])


@functools.lru_cache(maxsize=None)
def _jax_lnp_grad(model):
    return jax.jit(jax.grad(lambda p, x: model.apply(p, x[None, :], method=model.log_prob)[0]))


def _lnp_grads_jax(model, params, samples):
    return [_jax_lnp_grad(model)(params, jnp.asarray(s)) for s in samples]


def test_van_sample_gradients_and_pmb_search():
    jm, jp, pm = _made(4, 8)
    samples, grads = dqas.van_sample({"model": pm}, 6, key=torch.Generator().manual_seed(1))
    jgrads = _lnp_grads_jax(jm, jp, _np(samples))
    for gp, gj in zip(grads, jgrads):
        np.testing.assert_allclose(_np(gp["l1.weight"]), np.asarray(gj["params"]["l1"]["kernel"]).T, atol=TOL)
        np.testing.assert_allclose(_np(gp["l2.bias"]), np.asarray(gj["params"]["l2"]["bias"]), atol=TOL)
    s2, _ = dqas.micro_sample(pm, 3, repetitions=[0, 0, 1, 2, 3], key=torch.Generator().manual_seed(1))
    assert s2.shape == (3, 5)
    assert abs(float(dqas.van_regularization(pm)) - float(jdqas.van_regularization(jp))) < 1e-6

    draws = np.random.default_rng(29).integers(0, 2, size=(3, 4, 4)).astype(np.float32)

    def port_sample(prob_model, batch, it=iter(draws)):
        x = torch.as_tensor(next(it))
        return x, dqas.log_prob_grads(prob_model["model"], x)

    def jax_sample(prob_model, batch, it=iter(draws)):
        x = next(it)
        return jnp.asarray(x), _lnp_grads_jax(prob_model["model"], prob_model["params"], x)

    nnp0 = np.random.default_rng(31).uniform(size=(4, 2))
    pmodel = {"model": convert.van_params(van.MADE(4, 8, device="cpu"), _tree(jp))}
    _, nnp, hist = dqas.DQAS_search_pmb(_kernel(tct, dqas.value_and_grad, torch), pmodel, sample_func=port_sample,
                                        op_pool=[0, 1], batch=4, epochs=3, nnp_initial_value=nnp0)
    jmodel = {"model": jm, "params": jp}
    _, jnnp, jhist = jdqas.DQAS_search_pmb(_kernel(tc, _jvg, jnp), jmodel, sample_func=jax_sample, op_pool=[0, 1],
                                           batch=4, epochs=3, nnp_initial_value=nnp0)
    np.testing.assert_allclose(_np(nnp), np.asarray(jnnp), atol=TOL)
    np.testing.assert_allclose(hist, jhist, atol=TOL)
    np.testing.assert_allclose(_np(pmodel["model"].l1.weight), np.asarray(jmodel["params"]["params"]["l1"]["kernel"]).T,
                               atol=TOL)
