"""K15's plain version (``kernels_micro.micro_grand_plain``) against the
Pallas kernel of ``examples/micro_grand_fusion.py`` (``_micro_kernel``,
the staged micro-benchmark of the grand forward kernel) in interpret mode,
at each level m1, m2 and m3.

The example is imported by path and cut to two blocks (its module
constants ``G = D = 2``, ``R_TOT = 2048``; ``RB = 1024`` stays, since the
10 butterflies need it, and so does L = 4); the test builds the same
``pl.pallas_call`` as ``run_micro`` with ``interpret=True``.  Inputs are
the example's kind, random and not unitary, from a numpy seed.  Tolerance:
1e-5 of the output's largest entry (both sides float32; the lane product
sums 128 terms, the outer stage 2, in another order).  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tensorcircuit_ng_tpu as tc
from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

_EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "micro_grand_fusion.py"


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("micro_grand_fusion_example", _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_micro(mod, level, args):
    """``run_micro``'s ``pallas_call`` on the module's (patched) shapes."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    L, G, D, R_TOT, LANES = mod.L, mod.G, mod.D, mod.R_TOT, mod.LANES
    full = lambda *shape: pl.BlockSpec(shape, lambda l, j: (0,) * len(shape), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        mod._micro_kernel(level),
        grid=(L, G),
        out_shape=(jax.ShapeDtypeStruct((R_TOT, LANES), jnp.float32),
                   jax.ShapeDtypeStruct((R_TOT, LANES), jnp.float32)),
        in_specs=[
            pl.BlockSpec((L, 10, 2), lambda l, j: (0, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((1, LANES, LANES), lambda l, j: (l, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, LANES, LANES), lambda l, j: (l, 0, 0), memory_space=pltpu.VMEM),
            full(L, D, D), full(L, D, D), full(R_TOT, LANES), full(R_TOT, LANES),
        ],
        out_specs=(full(R_TOT, LANES), full(R_TOT, LANES)),
        scratch_shapes=[pltpu.VMEM((R_TOT, LANES), jnp.float32),
                        pltpu.VMEM((R_TOT, LANES), jnp.float32)],
        interpret=True,
    )(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_micro_grand_plain_matches_example(example, monkeypatch, level):
    monkeypatch.setattr(example, "G", 2)
    monkeypatch.setattr(example, "D", 2)
    monkeypatch.setattr(example, "R_TOT", 2048)
    args = [a.numpy() for a in km.micro_inputs("cpu", seed=level, n=18)]
    want = _pallas_micro(example, level, args)
    got = km.micro_grand(level, *(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.all(np.isfinite(w))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("level", [1, 2, 3])
def test_micro_grand_stages_match_example(example, monkeypatch, level):
    """K15's card design composed from its stages' plain versions, in the
    kernel's buffer order, against the Pallas kernel at each level: the
    gates built once a call (``micro_gate_planes``), then per layer at m2
    the row stage x -> a (``row_fwd_plain`` with the gate planes) and the
    lane product a -> y (``_lane_apply``), at m3 the row stage x -> y, the
    product y -> a and the outer pass a -> y (``_outer_apply``); at m1 the
    copies to y and a in turn.  Tolerance as above."""
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl

    monkeypatch.setattr(example, "G", 2)
    monkeypatch.setattr(example, "D", 2)
    monkeypatch.setattr(example, "R_TOT", 2048)
    args = [a.numpy() for a in km.micro_inputs("cpu", seed=10 + level, n=18)]
    want = _pallas_micro(example, level, args)
    cs, mlr, mli, mor, moi, sr, si = (torch.as_tensor(a) for a in args)
    gr, gi = km.micro_gate_planes(cs)
    x = (sr, si)
    for l in range(cs.shape[0]):
        if level == 1:
            y = a = tuple(p.clone() for p in x)
        elif level == 2:
            a = krl.row_fwd_plain(gr[l], gi[l], *x)
            y = krl._lane_apply(mlr[l], mli[l], *a)
        else:
            y = krl.row_fwd_plain(gr[l], gi[l], *x)
            a = krl._lane_apply(mlr[l], mli[l], *y)
            y = krl._outer_apply(mor[l], moi[l], *a)
        x = y
    for g, w in zip(x, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.all(np.isfinite(w))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
