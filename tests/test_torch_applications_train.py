"""The port's QUBO-QAOA training and the application slice end to end,
against the JAX package's: ``optimization.QUBO_QAOA`` on a 6-asset
portfolio QUBO (``finance.StockData`` of a seeded random walk,
``QUBO_from_portfolio``) at ``nlayers=2`` for 10 Adam steps, with the plain
loss (CVaR at alpha 0.25 in ``test_torch_applications_cvar.py``); then
VQNHE and QUBO-QAOA run through the port's CPU path beside the JAX
package's.

Tolerances: the parameters after 10 steps within 1e-5, each step's loss
within 1e-5 of its size; the best bitstring and its energy equal; VQNHE's
best energy within 1e-4.  The JAX runs are cached a module (its ``QUBO_QAOA`` compiles
its value and gradient anew each call, about 12 s).
"""

import functools

import numpy as np
import torch

import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.applications import optimization as jopt, vqes as jvq
from tensorcircuit_ng_tpu_torch.applications import finance, optimization, physics, vqes
from chip_smoke import APPS_SMALL, _apps_checks, portfolio_qubo, tfim_rows
from torch_apps_common import _jax_at_complex64, _one_thread_on_cpu  # noqa: F401

STEPS = 10


def _qubo():
    """The 6-asset portfolio QUBO of 60 seeded days, budget 2."""
    return portfolio_qubo(finance, 6, 60, 2)


@functools.lru_cache(maxsize=None)
def _jax_run(alpha):
    losses = []
    params, e, bits = jopt.QUBO_QAOA(_qubo(), nlayers=2, steps=STEPS, alpha=alpha, seed=42,
                                     callback=lambda i, v: losses.append(v))
    return np.asarray(params), e, bits, losses


def check_qubo_qaoa_trajectory(alpha):
    losses = []
    params, e, bits = optimization.QUBO_QAOA(_qubo(), nlayers=2, steps=STEPS, alpha=alpha, seed=42,
                                             callback=lambda i, v: losses.append(v), device="cpu")
    jparams, je, jbits, jlosses = _jax_run(alpha)
    assert params.dtype == torch.float32 and params.device.type == "cpu"
    np.testing.assert_allclose(params.numpy(), jparams, atol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    assert bits == jbits and e == je
    assert losses[-1] < losses[0]


def test_qubo_qaoa_trajectory_as_jax():
    check_qubo_qaoa_trajectory(None)


def test_slice_end_to_end_as_jax():
    """A VQNHE on the periodic n=6 TFIM chain and the plain QUBO-QAOA run,
    each on the port's CPU path beside the JAX package's: the same final
    energy and the same best bitstring; the VQNHE above the exact ground
    energy (``physics.TFIM1Denergy``)."""
    n = 6
    rows = tfim_rows(n)
    kw = dict(model_type="complex", ansatz="hea", nlayers=2, units=8)
    best, _, _ = vqes.VQNHE(n, rows, device="cpu", **kw).training(maxiter=STEPS)
    jbest, _, _ = jvq.VQNHE(n, rows, **kw).training(maxiter=STEPS)
    assert abs(best - jbest) < 1e-4
    assert best >= physics.TFIM1Denergy(n) - 1e-4
    params, e, bits = optimization.QUBO_QAOA(_qubo(), nlayers=2, steps=STEPS, seed=42, device="cpu")
    _, je, jbits, _ = _jax_run(None)
    Q = _qubo()
    x = np.array([int(b) for b in bits], dtype=float)
    assert bits == jbits and e == je
    assert abs(e - float(x @ Q @ x)) < 1e-4 * max(1.0, abs(e))


def test_apps_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 24 at a small size on the CPU: (a) VQNHE
    eager and jitted, (b) QUBO-QAOA plain and CVaR, (c) the vag kernels,
    (d) DQAS's architectures, (e) the samplers."""
    times = _apps_checks(tct, "cpu", (), **APPS_SMALL)
    assert {label[:3] for label in times} == {"(a)", "(b)", "(c)", "(d)", "(e)"}
