"""The port's CVaR optimizers against the JAX package's: ``QUBO_QAOA``
with the CVaR loss at alpha 0.25 on the 6-asset portfolio QUBO of
``test_torch_applications_train.py`` (10 Adam steps, ``nlayers=2``), and
``QUBO_QAOA_cvar``'s COBYLA on the expectation (5 iterations).

Tolerances: the parameters after 10 steps within 1e-5, each step's loss
within 1e-5 of its size, the best bitstring and its energy equal; COBYLA's
parameters within 1e-5.
"""

import numpy as np

from tensorcircuit_ng_tpu.applications import optimization as jopt
from tensorcircuit_ng_tpu_torch.applications import optimization
from test_torch_applications_train import check_qubo_qaoa_trajectory
from torch_apps_common import _jax_at_complex64, _one_thread_on_cpu  # noqa: F401


def test_qubo_qaoa_cvar_trajectory_as_jax():
    check_qubo_qaoa_trajectory(0.25)


def test_qubo_qaoa_cvar_as_jax():
    Q = np.array([[-1.0, 0.5], [0.5, -1.0]])
    init = np.random.default_rng(9).normal(scale=0.5, size=2)
    got = optimization.QUBO_QAOA_cvar(Q, 1, 0.5, expectation_based=True, maxiter=5, init_params=init)
    want = jopt.QUBO_QAOA_cvar(Q, 1, 0.5, expectation_based=True, maxiter=5, init_params=init)
    np.testing.assert_allclose(got, want, atol=1e-5)

