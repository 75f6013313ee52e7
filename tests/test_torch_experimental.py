"""The port's ``experimental.py`` against the JAX package's.

On the same seeded inputs: ``adaptive_vmap`` (chunks with a remainder),
``dynamics_matrix``, ``qng``/``qng2`` (forward and reverse mode, both
kernels, with and without the factor 4), ``dynamics_rhs``,
``parameter_shift_grad`` (also under ``jit``, and against autograd),
``finite_difference_differentiator``, ``scan_circuit_layers`` and the
``hamiltonian_evol``/``evol_*`` names, on the generic gates and, where a
transform goes through a kernel, on the main path (``h_layer``,
``zzrx_layer``, ``expectation_zzx_energy``) at n=8: there ``qng`` takes
reverse mode, and forward mode raises in both packages.  Tolerance
(complex64 and float32): 1e-5 of the largest entry; parameter shift
against autograd 1e-4 (float32 differences of energies).
``save_params``/``load_params`` round-trip a pytree of tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import experimental as jex
from tensorcircuit_ng_tpu_torch import experimental as ex

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_on_the_cpu():
    """One torch and one BLAS thread (xdist runs six modules at once); the
    port's circuits on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1), tct.set_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _state_fn(mod):
    """params (4,) -> the 3-qubit state of an rx/ry/cnot ansatz."""
    def f(p):
        c = mod.Circuit(3)
        for i in range(3):
            c.rx(i, theta=p[i])
        c.cnot(0, 1)
        c.cnot(1, 2)
        c.ry(2, theta=p[3])
        return c.state()
    return f


def _loss_fn(mod, xp):
    def loss(p):
        c = mod.Circuit(2)
        c.rx(0, theta=p[0])
        c.ry(1, theta=p[1])
        c.cnot(0, 1)
        c.rx(1, theta=p[2])
        return xp.real(c.expectation_ps(z=[1]))
    return loss


def _main(mod, n=8, nl=2):
    pairs = [(i, i + 1) for i in range(n - 1)]

    def energy(zz, rx):
        c = mod.Circuit(n)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(pairs, zz[l], rx[l])
        return c.expectation_zzx_energy(pairs, 1.0, -1.0)

    def state(flat):
        p = flat.reshape(nl, 2 * n - 1)
        c = mod.Circuit(n)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(pairs, p[l, : n - 1], p[l, n - 1:])
        return c.state()

    return energy, state


P4 = np.array([0.3, -0.7, 1.1, 0.4], dtype=np.float32)


def test_adaptive_vmap_matches_jax():
    xs = np.random.default_rng(0).normal(size=(13, 4)).astype(np.float32)
    for chunk in (None, 5, 13):
        got = ex.adaptive_vmap(lambda x: torch.sum(x**2), chunk_size=chunk)(torch.as_tensor(xs))
        want = jex.adaptive_vmap(lambda x: jnp.sum(x**2), chunk_size=chunk)(jnp.asarray(xs))
        _close(got, want)
    two = ex.adaptive_vmap(lambda x, w: (x @ w, torch.sum(x)), vectorized_argnums=0, chunk_size=4)(
        torch.as_tensor(xs), torch.ones(4))
    _close(two[0], xs.sum(1))
    _close(two[1], xs.sum(1))


@pytest.mark.parametrize("kernel,post,mode", [("qng", "qng", "fwd"), ("qng", "qng", "rev"),
                                              ("dynamics", None, "rev"), ("qng", None, "fwd")])
def test_qng_matches_jax(kernel, post, mode):
    got = ex.qng(_state_fn(tct), kernel=kernel, postprocess=post, mode=mode)(torch.as_tensor(P4))
    want = jex.qng(_state_fn(tc), kernel=kernel, postprocess=post, mode=mode)(jnp.asarray(P4))
    _close(got, want)


def test_qng2_dynamics_matrix_and_rhs_match_jax():
    _close(ex.qng2(_state_fn(tct))(torch.as_tensor(P4)), jex.qng2(_state_fn(tc))(jnp.asarray(P4)))
    _close(ex.dynamics_matrix(_state_fn(tct))(torch.as_tensor(P4)),
           jex.dynamics_matrix(_state_fn(tc))(jnp.asarray(P4)))
    _close(ex.dynamics_rhs(_state_fn(tct), torch.as_tensor(P4)), jex.dynamics_rhs(_state_fn(tc), jnp.asarray(P4)))
    # a single rx: the QFIM is 1 (the factor 4 convention)
    one = ex.qng(lambda p: _state_fn(tct)(torch.cat([p, torch.zeros(3)])))(torch.tensor([0.7]))
    _close(one, [[1.0]])


def test_qng_on_the_main_path_takes_reverse_mode():
    """Through a kernel (K2's plain version here) the QFIM is reverse mode;
    forward mode raises, as in the JAX package (``custom_vjp``)."""
    _, ts = _main(tct)
    _, js = _main(tc)
    p = (np.random.default_rng(1).normal(size=30) * 0.3).astype(np.float32)
    _close(ex.qng(ts, mode="rev")(torch.as_tensor(p)), jex.qng(js, mode="rev")(jnp.asarray(p)), 1e-4)
    with pytest.raises((RuntimeError, NotImplementedError)):
        ex.qng(ts, mode="fwd")(torch.as_tensor(p))
    with pytest.raises(TypeError):
        jex.qng(js, mode="fwd")(jnp.asarray(p))


def test_parameter_shift_and_finite_differences_match_jax():
    p = np.array([0.3, 0.8, -0.4], dtype=np.float32)
    tl, jl = _loss_fn(tct, torch), _loss_fn(tc, jnp)
    got = ex.parameter_shift_grad(tl)(torch.as_tensor(p))
    _close(got, jex.parameter_shift_grad(jl)(jnp.asarray(p)))
    _close(got, torch.func.grad(tl)(torch.as_tensor(p)), 1e-4)
    _close(ex.parameter_shift_grad(tl, jit=True)(torch.as_tensor(p)), got)
    _close(ex.parameter_shift_grad_v2(tl)(torch.as_tensor(p)), got)
    fd = ex.finite_difference_differentiator(tl, shifts=(1e-2, 2e-2))(torch.as_tensor(p))
    _close(fd, jex.finite_difference_differentiator(jl, shifts=(1e-2, 2e-2))(jnp.asarray(p)), 1e-4)


def test_parameter_shift_on_the_main_path_matches_jax():
    """Two arguments (argnums=(0, 1)), 2 x 30 shifted energies through the
    stack's vmap rule, against the JAX package and autograd."""
    te_, _ = _main(tct)
    je_, _ = _main(tc)
    rng = np.random.default_rng(2)
    zz, rx = (rng.normal(size=(2, 7)) * 0.3).astype(np.float32), (rng.normal(size=(2, 8)) * 0.3).astype(np.float32)
    got = ex.parameter_shift_grad(te_, argnums=(0, 1))(torch.as_tensor(zz), torch.as_tensor(rx))
    want = jex.parameter_shift_grad(je_, argnums=(0, 1))(jnp.asarray(zz), jnp.asarray(rx))
    ad = torch.func.grad(te_, argnums=(0, 1))(torch.as_tensor(zz), torch.as_tensor(rx))
    for g, w, a in zip(got, want, ad):
        _close(g, w)
        _close(g, a, 1e-4)


def test_scan_circuit_layers_and_evolution_names_match_jax():
    n, nl = 4, 3
    params = (np.random.default_rng(3).normal(size=(nl, 2, n)) * 0.3).astype(np.float32)

    def layer(c, p):
        for i in range(n - 1):
            c.rzz(i, i + 1, theta=p[0, i])
        for i in range(n):
            c.rx(i, theta=p[1, i])

    def start(mod):
        c = mod.Circuit(n)
        for i in range(n):
            c.h(i)
        return c

    got = ex.scan_circuit_layers(start(tct), layer, torch.as_tensor(params)).state()
    _close(got, jex.scan_circuit_layers(start(tc), layer, jnp.asarray(params)).state())
    h = np.diag(np.arange(4.0)).astype(np.complex64)
    psi = np.ones(4, dtype=np.complex64) / 2
    _close(ex.hamiltonian_evol(torch.as_tensor(h), torch.as_tensor(psi), torch.tensor([0.5])),
           jex.hamiltonian_evol(jnp.asarray(h), jnp.asarray(psi), jnp.asarray([0.5])))
    _close(ex.evol_global(lambda t: torch.as_tensor(h), torch.as_tensor(psi), [0.3]),
           jex.evol_global(lambda t: jnp.asarray(h), jnp.asarray(psi), jnp.asarray([0.3])), 1e-5)
    x = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex64)
    _close(ex.evol_local(lambda t: torch.as_tensor(x), torch.as_tensor(psi), [0.3], [0]),
           jex.evol_local(lambda t: jnp.asarray(x), jnp.asarray(psi), jnp.asarray([0.3]), [0]), 1e-5)


def test_save_and_load_params(tmp_path):
    params = {"w": torch.randn(3, 2), "layers": [torch.arange(4), torch.tensor(1.5)]}
    path = str(tmp_path / "params.pt")
    ex.save_params(path, params)
    back = ex.load_params(path)
    assert torch.equal(back["w"], params["w"]) and torch.equal(back["layers"][0], params["layers"][0])
    ex.save_params(params, str(tmp_path / "other.pt"))
    again = ex.load_params(str(tmp_path / "other.pt"), template=params)
    assert float(again["layers"][1]) == 1.5 and again["w"].device == params["w"].device
