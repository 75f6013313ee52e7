"""The port's ``applications/vags.py`` against the JAX package's, second
part: ``evaluate_vag`` and ``qaoa_train``, the noisy forwards
(``DMCircuit`` exactly, ``Circuit`` as Monte Carlo on given uniforms), the
measurement sets and the gate-wise VQE kernel, on a 3-regular 6-node graph
from ``graphdata``.

Both packages run from the same numpy-seeded inputs; the JAX forwards run
under ``jax.jit`` where the kernel takes a ``forward_func``.  Tolerances:
losses and gradient matrices within 1e-5 (relative to their largest entry
where that passes 1), Adam trajectories within 1e-5 a step.
"""

import functools

import networkx as nx
import numpy as np
import torch

import jax
import jax.numpy as jnp

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.applications import dqas as jdqas, layers as jL, vags as jvags
from tensorcircuit_ng_tpu_torch.applications import dqas, layers as L, vags
from torch_apps_common import (TOL, _both, _close, _graph, _jax_at_complex64, _jit_forward, _np,  # noqa: F401
                               _one_thread_on_cpu)

def _pools(mod):
    return [mod.Hlayer, mod.rxlayer, mod.zzlayer, mod.rylayer, mod.rx_zz_block]


# ---------------------------------------------------------------- vags ---


def _jax_evaluate(preset, g, lbd, overlap_threhold):
    """The JAX ``evaluate_vag``'s (objective, energy, gradient, overlap) of
    its ``exp_forward``, composed as it composes them, under ``jax.jit``:
    the JAX function itself runs op by op and compiles every gate and its
    adjoint (about 35 s here)."""
    fs = ((functools.partial(jvags._exp_fun, lbd=lbd), jnp.log), (jvags._identity, jvags._neg),
          (functools.partial(jvags._overlap_fun, overlap_threhold=overlap_threhold), jvags._identity))

    def forward(p):
        return [jnp.real(x) for x in jvags.exp_forward(p, preset, g, *fs)]

    def one(p):
        expe, ene, probasum = forward(p)
        gr = jax.grad(lambda q: forward(q)[1] if lbd == 0 else forward(q)[0])(p)
        return expe, ene, gr, probasum

    return jax.jit(one)


def test_evaluate_vag_and_qaoa_train():
    """``evaluate_vag`` at lbd 0.5 and 0, and 5 Adam steps of ``qaoa_train``
    against the JAX package's optax Adam(1e-2) on the same gradients."""
    import optax

    g = _graph()
    params = np.array([0.3, 0.7, 0.4], dtype=np.float32)
    preset = [0, 2, 1]
    dqas.set_op_pool(_pools(L))
    jdqas.set_op_pool(_pools(jL))
    got = vags.evaluate_vag(params, preset, g, lbd=0.5, overlap_threhold=4.0)
    _close(got, _jax_evaluate(preset, g, 0.5, 4.0)(jnp.asarray(params)))
    theta, energies, gibbs, overlaps = vags.qaoa_train(preset, g, epochs=5, initial_param=params, verbose=False)
    step = _jax_evaluate(preset, g, 0.0, 0.0)
    opt = optax.adam(1e-2)
    jtheta = jnp.asarray(params)
    state = opt.init(jtheta)
    want = []
    for _ in range(5):
        expe, ene, gr, probasum = step(jtheta)
        want.append((expe, ene, probasum))
        updates, state = opt.update(gr, state, jtheta)
        jtheta = optax.apply_updates(jtheta, updates)
    _close([theta], [jtheta])
    _close(energies, [w[1] for w in want])
    _close(gibbs, [w[0] for w in want])
    _close(overlaps, [w[2] for w in want])
    assert float(energies[-1]) < float(energies[0])


def _mc_noise(mod, status):
    """A Monte-Carlo depolarizing noise model on every node from given
    uniforms (a pool entry's noise model)."""
    def f(ci, g, px, py, pz):
        for i in range(len(g.nodes)):
            ci.depolarizing(i, px=px, py=py, pz=pz, status=status[i])
    return f


def test_qaoa_noise_vag_exact_and_monte_carlo():
    g = _graph()
    nnp = np.random.default_rng(17).uniform(size=(3, 3)).astype(np.float32)
    preset = [0, 1, 2]
    pool = [jL.Hlayer, (jL.zzlayer_bitflip, g, (0.02, 0.01, 0.03)), (jL.rxlayer, g, jL.bitfliplayer, (0.05, 0.0, 0.0))]
    ppool = [L.Hlayer, (L.zzlayer_bitflip, g, (0.02, 0.01, 0.03)), (L.rxlayer, g, L.bitfliplayer, (0.05, 0.0, 0.0))]
    mf = jvags.maxcut_measurements_tc
    got, want = _both(lambda: vags.qaoa_noise_vag(g, nnp, preset),
                      lambda: jvags.qaoa_noise_vag(g, nnp, preset,
                                                   forward_func=_jit_forward(jvags.noise_forward, preset, g, mf)),
                      ppool, pool)
    _close(got, want)
    status = np.random.default_rng(19).uniform(size=6) * 0.6
    pool = [jL.Hlayer, (jL.zzlayer, g, _mc_noise(tc, status), (0.1, 0.1, 0.1)), jL.rxlayer]
    ppool = [L.Hlayer, (L.zzlayer, g, _mc_noise(tct, status), (0.1, 0.1, 0.1)), L.rxlayer]
    got, want = _both(lambda: vags.qaoa_noise_vag(g, nnp, preset, is_mc=True),
                      lambda: jvags.qaoa_noise_vag(g, nnp, preset, forward_func=_jit_forward(
                          jvags.noise_forward, preset, g, mf, is_mc=True)), ppool, pool)
    _close(got, want)


def _rotated(mod):
    cc = mod.Circuit(6)
    for i in range(6):
        cc.ry(i, theta=0.1 * i + 0.2)
        cc.rx(i, theta=0.3 - 0.05 * i)
    return cc


def test_measurement_sets_and_gatewise_vqe():
    g = _graph()
    c = _rotated(tct)

    def jax_sets():
        jc = _rotated(tc)
        return [jnp.real(jvags.tfim_measurements_tc(jc, g, hx=0.7, hz=0.2)),
                jnp.real(jvags.heisenberg_measurements_tc(jc, g, hx=0.1, hy=0.3)),
                jnp.real(jvags.maxcut_measurements_tc(jc, g))]

    got = [vags.tfim_measurements_tc(c, g, hx=0.7, hz=0.2), vags.heisenberg_measurements_tc(c, g, hx=0.1, hy=0.3),
           vags.maxcut_measurements_tc(c, g)]
    _close([torch.real(x) for x in got], jax.jit(jax_sets)())
    pool = [("rx", [0]), ("cnot", [0, 1]), ("ry", [1]), ("h", [2]), ("rzz", [2, 3])]
    nnp = np.random.default_rng(23).uniform(size=(5, 5)).astype(np.float32)
    preset = [0, 1, 2, 3, 4]
    ring = nx.cycle_graph(4)  # the JAX side runs op by op: a small register
    got, want = _both(lambda: vags.gatewise_vqe_vag(ring, nnp, preset),
                      lambda: jvags.gatewise_vqe_vag(ring, nnp, preset), pool, pool)
    _close(got, want)
    m = np.diag([1.0, -1.0, 0.5, 2.0]).astype(np.complex64)
    rho = np.full((4, 4), 0.25, dtype=np.complex64)
    assert abs(float(vags.correlation(m, rho)) - float(jvags.correlation(m, rho))) < 1e-6
    cc = tct.Circuit(4)
    vags.compose_tc_circuit_with_multiple_pools(cc, [[0, 1]], [[L.Hlayer, L.rxlayer]], [torch.tensor([0.0, 0.4])], g)
    assert cc.gate_count() == 8

