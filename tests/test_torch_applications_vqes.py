"""The port's ``applications/vqes.py`` against the JAX package's: the dense
Hamiltonians, VQNHE for each of the four model types under both ansätze
(the JAX package's parameters carried across by ``convert``), its 10-step
joint Adam training, its files read by either package, ``Linear`` and
``JointSchedule``.

Tolerances: dense matrices within 1e-6; VQNHE's energy and both gradients
within 1e-5; the training's energies and parameters within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.applications import vqes as jvq
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.applications import vqes
from chip_smoke import tfim_rows
from torch_apps_common import _jax_at_complex64, _np, _one_thread_on_cpu  # noqa: F401


def test_construct_matrix_and_paulistring():
    rows = tfim_rows(4) + [[0.3, 2, 2, 0, 0]]
    np.testing.assert_allclose(_np(vqes.construct_matrix(rows)), jvq.construct_matrix(rows), atol=1e-6)
    np.testing.assert_allclose(_np(vqes.paulistring([1, 2, 3, 0])), jvq.paulistring([1, 2, 3, 0]), atol=1e-6)
    c, jc = tct.Circuit(4), tc.Circuit(4)
    for cc in (c, jc):
        cc.h(0)
        cc.rx(2, theta=0.4)
    assert abs(vqes.vqe_energy(c, rows).item() - float(jvq.vqe_energy(jc, rows))) < 1e-5
    assert abs(vqes.vqe_energy_shortcut(c, jvq.construct_matrix(rows)).item()
               - float(jvq.vqe_energy_shortcut(jc, jvq.construct_matrix(rows)))) < 1e-5


KINDS = [("real", "hea"), ("complex", "hea"), ("rbm", "hea"), ("complex-rbm", "hea"), ("real", "hn"),
         ("complex", "hn"), ("rbm", "hn"), ("complex-rbm", "hn")]


def _pair(model_type, ansatz, n=4):
    kw = dict(model_type=model_type, ansatz=ansatz, nlayers=2, units=8)
    return vqes.VQNHE(n, tfim_rows(n), device="cpu", **kw), jvq.VQNHE(n, tfim_rows(n), **kw)


@pytest.mark.parametrize("model_type,ansatz", KINDS)
def test_vqnhe_energy_and_gradients_as_jax(model_type, ansatz):
    v, jv = _pair(model_type, ansatz)
    np.testing.assert_array_equal(_np(v.circuit_params), np.asarray(jv.circuit_params))
    for k in jv.model_params:
        np.testing.assert_array_equal(_np(v.model_params[k]), np.asarray(jv.model_params[k]))
    # the JAX parameters carried across by name
    cp = convert.params(np.asarray(jv.circuit_params), "cpu")
    mp = convert.param_dict({k: np.array(x) for k, x in jv.model_params.items()}, "cpu")
    e, (gc, gm) = tct.backend.value_and_grad(v.energy, argnums=(0, 1))(cp, mp)
    je, (jgc, jgm) = jax.jit(jax.value_and_grad(jv.energy, argnums=(0, 1)))(jv.circuit_params, jv.model_params)
    assert abs(e.item() - float(je)) < 1e-5
    np.testing.assert_allclose(_np(gc), np.asarray(jgc), atol=1e-5)
    for k in jgm:
        np.testing.assert_allclose(_np(gm[k]), np.asarray(jgm[k]), atol=1e-5, err_msg=k)
    assert abs(v.plain_energy() - jv.plain_energy()) < 1e-5


@pytest.mark.parametrize("model_type,ansatz", KINDS[:4])
def test_vqnhe_training_as_jax(model_type, ansatz):
    """10 joint Adam steps: the best energy and its parameters.  The output
    biases ``b2`` and ``pb2`` shift log f by a constant (a norm and a global
    phase the energy divides out): their gradient is rounding noise, which
    Adam's normalization turns into steps of either sign, so they are held
    only through the energy."""
    v, jv = _pair(model_type, ansatz)
    hist = []
    best, cp, mp = v.training(maxiter=10, history=hist)
    jbest, jcp, jmp = jv.training(maxiter=10)
    assert len(hist) == 10 and best == min(hist) and hist[-1] < hist[0]
    assert abs(best - jbest) < 1e-4
    np.testing.assert_allclose(_np(cp), np.asarray(jcp), atol=1e-4)
    for k in set(jmp) - {"b2", "pb2"}:
        np.testing.assert_allclose(_np(mp[k]), np.asarray(jmp[k]), atol=1e-4, err_msg=k)
    e_h, e_p = v.evaluation()
    je_h, je_p = jv.evaluation()
    assert abs(e_h - je_h) < 1e-4 and abs(e_p - je_p) < 1e-4


def test_vqnhe_files_cross_the_packages(tmp_path):
    v, jv = _pair("complex", "hea")
    jv.training(maxiter=2)
    jv.save(str(tmp_path / "jax.pkl"))
    v.load(str(tmp_path / "jax.pkl"))
    np.testing.assert_array_equal(_np(v.circuit_params), np.asarray(jv.circuit_params))
    assert set(v.model_params) == set(jv.model_params) and v.model_type == "complex"
    assert all(x.dtype == torch.float32 and x.device.type == "cpu" for x in v.model_params.values())
    v.training(maxiter=2)
    v.save(str(tmp_path / "port.pkl"))
    jv2 = jvq.VQNHE(4, tfim_rows(4), model_type="rbm", ansatz="hn", nlayers=2, units=8)
    jv2.recover(str(tmp_path / "port.pkl"))
    assert jv2.model_type == "complex" and jv2.ansatz == "hea"
    np.testing.assert_array_equal(np.asarray(jv2.circuit_params), _np(v.circuit_params))
    for k in v.model_params:
        np.testing.assert_array_equal(np.asarray(jv2.model_params[k]), _np(v.model_params[k]))
    assert abs(jv2.evaluation()[0] - v.evaluation()[0]) < 1e-5
    v.create_real_rbm_model(seed=3)
    jv.create_real_rbm_model(seed=3)
    for k in jv.model_params:
        np.testing.assert_array_equal(_np(v.model_params[k]), np.asarray(jv.model_params[k]))
    assert v.create_hn_circuit() == v.circuit_state and v.ansatz == "hn"


def test_linear_and_joint_schedule():
    lin, jlin = vqes.Linear(4, 3), jvq.Linear(4, 3)
    p, jp = lin.init(np.random.default_rng(0)), jlin.init(np.random.default_rng(0))
    for k in jp:
        np.testing.assert_array_equal(_np(p[k]), np.asarray(jp[k]))
    x = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    carried = convert.param_dict({k: np.asarray(a) for k, a in jp.items()}, "cpu")
    y = lin(carried, x)
    assert y.shape == (2, 4) and y.is_complex()
    np.testing.assert_allclose(_np(y), np.asarray(jlin(jp, x)), atol=1e-6)
    np.testing.assert_allclose(_np(lin.call(p, torch.as_tensor(x))), np.asarray(jlin.call(jp, x)), atol=1e-6)
    sch, jsch = vqes.JointSchedule(10, 1e-3, 1e-2), jvq.JointSchedule(10, 1e-3, 1e-2)
    for step in (0, 5, 9, 10, 20):
        assert sch(step) == pytest.approx(float(jsch(step)), abs=1e-9)
    assert sch(5) == 1e-3 and sch(20) == 1e-2 and sch(torch.tensor(12)) == 1e-2
