"""The port's ``applications/vags.py`` against the JAX package's, first
part: the value-and-gradient kernels of DQAS (GHZ, QAOA, block QAOA), the
CVaR reweighting, and ``dqas``'s fixed-preset training and
``evaluate_everyone`` over them, on a 3-regular 6-node graph from
``graphdata`` (the rest in ``test_torch_applications_noise.py``).

Both packages run from the same numpy-seeded inputs; the JAX forwards run
under ``jax.jit`` where the kernel takes a ``forward_func``.  Tolerances:
losses and gradient matrices within 1e-5 (relative to their largest entry
where that passes 1), Adam trajectories within 1e-5 a step.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from tensorcircuit_ng_tpu.applications import dqas as jdqas, layers as jL, vags as jvags
from tensorcircuit_ng_tpu_torch.applications import dqas, layers as L, vags
from torch_apps_common import (TOL, _both, _close, _graph, _jax_at_complex64, _jit_forward, _np,  # noqa: F401
                               _one_thread_on_cpu)

def _pools(mod):
    return [mod.Hlayer, mod.rxlayer, mod.zzlayer, mod.rylayer, mod.rx_ry_block]


# ---------------------------------------------------------------- vags ---


def test_ghz_vag():
    pool = ["H0", "CNOT01", "CNOT12", "I", "X1"]
    nnp = np.zeros((4, 5), dtype=np.float32)
    for preset in ([0, 1, 2, 3], [4, 0, 1, 2]):
        got, want = _both(lambda: vags.GHZ_vag(None, nnp, preset), lambda: jvags.GHZ_vag(None, nnp, preset), pool,
                          pool)
        _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_forward(preset, g, f):
    return _jit_forward(jvags.exp_forward, list(preset), g, f)


def _jax_vag(g, nnp, preset, f=jvags._ENERGY_OBJECTIVE):
    """The JAX ``qaoa_vag`` with its forward under ``jax.jit`` (one compile
    a preset)."""
    return jvags.qaoa_vag(g, nnp, preset, f=f, forward_func=_jax_forward(tuple(preset), g, f))


def test_qaoa_vag_and_block_vag():
    g = _graph()
    rng = np.random.default_rng(13)
    nnp = rng.uniform(size=(5, 5)).astype(np.float32)
    preset = [0, 2, 1, 3, 2]
    got, want = _both(lambda: vags.qaoa_vag(g, torch.as_tensor(nnp), preset),
                      lambda: _jax_vag(g, jnp.asarray(nnp), preset, f=(jvags._identity, jvags._neg)),
                      _pools(L), _pools(jL))
    _close(got, want)
    assert np.count_nonzero(_np(got[1])) >= 3
    p = np.random.default_rng(14).dirichlet(np.ones(16)).astype(np.float32)
    r = list(np.random.default_rng(15).normal(size=16))
    for percent in (0.05, 0.3, 1.0):
        np.testing.assert_allclose(vags.cvar(r, torch.as_tensor(p), percent), jvags.cvar(r, jnp.asarray(p), percent),
                                   atol=1e-6)
    nnp2 = rng.uniform(size=(4, 5)).astype(np.float32)
    got, want = _both(lambda: vags.qaoa_block_vag(g, nnp2, [4, 1]),
                      lambda: jvags.qaoa_block_vag(g, nnp2, [4, 1]), _pools(L), _pools(jL))
    _close(got, want)
    assert np.count_nonzero(_np(got[1])) == 3


def test_simple_train_and_evaluate_everyone():
    g = _graph()
    nnp0 = np.random.default_rng(37).uniform(size=(3, 5))
    got, want = _both(lambda: dqas.qaoa_simple_train([0, 2, 1], g, epochs=3, nnp_initial_value=nnp0),
                      lambda: jdqas.qaoa_simple_train([0, 2, 1], g, vag_func=_jax_vag, epochs=3,
                                                      nnp_initial_value=nnp0),
                      _pools(L), _pools(jL))
    _close(got, want)
    got, want = _both(lambda: dqas.evaluate_everyone(vags.qaoa_vag, dqas.single_generator(g), nnp0, [[0, 2, 1], [0, 1, 2]]),
                      lambda: jdqas.evaluate_everyone(functools.partial(_jax_vag, f=(jvags._identity, jvags._neg)),
                                                      jdqas.single_generator(g), nnp0, [[0, 2, 1], [0, 1, 2]]),
                      _pools(L), _pools(jL))
    for (p1, l1), (p2, l2) in zip(got, want):
        assert p1 == p2
        _close([l1], [l2])
