"""What the ``tests/test_torch_applications*.py`` files share: two
module fixtures (the JAX package at complex64; the port on the CPU at one
torch and one BLAS thread), numpy views of either package's arrays, and
the vag files' seeded 3-regular 6-node graph and comparisons.

A test module applies the fixtures by importing them by name.
"""

import functools

import numpy as np
import pytest
import threadpoolctl
import torch

import jax

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.applications import dqas as jdqas
from tensorcircuit_ng_tpu_torch.applications import dqas

TOL = 1e-5


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


@functools.lru_cache(maxsize=None)
def _graph():
    """The 3-regular 6-node graph of seed 11, the same in both packages."""
    from tensorcircuit_ng_tpu.applications import graphdata as jg
    from tensorcircuit_ng_tpu_torch.applications import graphdata

    g = next(graphdata.regular_graph_generator(3, 6, seed=11))
    assert sorted(g.edges) == sorted(next(jg.regular_graph_generator(3, 6, seed=11)).edges)
    return g


def _both(fn_port, fn_jax, pool_port, pool_jax):
    """``fn_port()`` and ``fn_jax()``, each package with its op pool set."""
    dqas.set_op_pool(pool_port)
    jdqas.set_op_pool(pool_jax)
    return fn_port(), fn_jax()


def _close(a, b, tol=TOL):
    """Each pair within ``tol`` times the larger of 1 and the JAX side's
    largest magnitude (float32 sums of many terms)."""
    for x, y in zip(a, b):
        y = np.real(np.asarray(y))
        np.testing.assert_allclose(np.real(_np(x)), y, atol=tol * max(1.0, float(np.abs(y).max(initial=0.0))))


def _jit_forward(forward, preset, g, *args, **kws):
    """The JAX forward of one preset and graph under ``jax.jit``, for a JAX
    vag's ``forward_func`` (op by op it compiles every gate)."""
    jf = jax.jit(lambda th: forward(th, preset, g, *args, **kws))
    return lambda th, *_, **__: jf(th)
