"""The port's ``shadows.py`` against the JAX package's.

With the same Pauli strings and the same uniforms (``status``) both
packages draw the same snapshot bits (equal here at complex128; at
complex64 the cumulative sums of float32 probabilities may move a uniform
within rounding of a cdf boundary, so the bits are held equal where every
uniform lies 1e-6 from its boundaries, as the sampling tests do); on the
same snapshots the estimators are deterministic and are held to the JAX
package's: the local snapshot states, the global shadow state in its three
forms and on a subsystem, the Pauli-string estimates of median of means,
the Rényi-2 and the shadow entropies, the bound.  Tolerances: complex64
1e-5, complex128 1e-10, relative to max(1, the largest entry).  Snapshots
drawn from the backend's generator (not JAX's threefry) are held to the
exact values within 5 standard errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import shadows as jsh
from tensorcircuit_ng_tpu_torch import shadows as sh

TOL = {"complex64": 1e-5, "complex128": 1e-10}
SIGMAS = 5.0


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: xdist runs six modules at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["complex64", "complex128"])
def dtype(request):
    tc.set_dtype(request.param)
    try:
        with tct.set_dtype(request.param), tct.set_device("cpu"):
            yield request.param
    finally:
        tc.set_dtype("complex64")


def _np(x):
    return x.detach().cpu().resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _psi(mod, n=3):
    c = mod.Circuit(n)
    c.h(0)
    c.cnot(0, 1)
    c.rx(2, theta=0.6)
    c.ry(1, theta=0.3)
    return c.state()


def _far_from_boundaries(psi, strings, status, tol=1e-6):
    """Every uniform at least ``tol`` from the float64 cdf boundaries of its
    setting's rotated state."""
    n = strings.shape[1]
    for s, us in zip(strings, status):
        phi = np.asarray(psi, dtype=np.complex128)
        for q in range(n):
            phi = np.moveaxis(np.tensordot(sh._ROT[s[q]], np.moveaxis(phi.reshape((2,) * n), q, 0), 1), 0, q)
        cdf = np.cumsum(np.abs(phi.reshape(-1)) ** 2)
        if np.min(np.abs(cdf[None, :] - us[:, None])) < tol:
            return False
    return True


def _snapshots(dtype, ns=200, repeat=4, seed=7):
    rng = np.random.default_rng(seed)
    strings = rng.integers(0, 3, size=(ns, 3)).astype(np.int32)
    status = rng.random((ns, repeat)).astype(np.float64 if dtype == "complex128" else np.float32)
    got = sh.shadow_snapshots(_psi(tct), strings, status)
    want = jsh.shadow_snapshots(_psi(tc), jnp.asarray(strings), jnp.asarray(status))
    return strings, status, got, want


def test_snapshots_match_jax(dtype):
    strings, status, got, want = _snapshots(dtype)
    assert got.shape == (200, 4, 3) and got.dtype == torch.int32
    if dtype == "complex128" or _far_from_boundaries(_np(_psi(tct)), strings, status):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_local_and_global_shadow_states_match_jax(dtype):
    strings, _, snaps, _ = _snapshots(dtype)
    js = jnp.asarray(_np(snaps))
    _close(sh.local_snapshot_states(snaps, strings), jsh.local_snapshot_states(js, jnp.asarray(strings)), TOL[dtype])
    for name in ("global_shadow_state", "global_shadow_state1", "global_shadow_state2"):
        for sub in (None, [0, 2]):
            _close(getattr(sh, name)(snaps, strings, sub=sub), getattr(jsh, name)(js, jnp.asarray(strings), sub=sub),
                   TOL[dtype])
    lss = sh.local_snapshot_states(snaps, strings)
    _close(sh.global_shadow_state(lss), jsh.global_shadow_state(jnp.asarray(_np(lss))), TOL[dtype])
    _close(sh.slice_sub(lss, [1]), jsh.slice_sub(jnp.asarray(_np(lss)), [1]), TOL[dtype])


def test_estimators_match_jax(dtype):
    strings, _, snaps, _ = _snapshots(dtype)
    js, jstr = jnp.asarray(_np(snaps)), jnp.asarray(strings)
    for kw in ({"z": [0, 1]}, {"x": [2], "z": [0]}, {"ps": [1, 2, 3]}):
        got = sh.expectation_ps_shadow(snaps, strings, k=4, **kw)
        want = jsh.expectation_ps_shadow(js, jstr, k=4, **kw)
        _close(torch.stack(got), np.asarray(want), 1e-6)
    for kw in ({"sub": [0]}, {"subsystem_to_keep": [0, 1]}, {"subsystems_to_trace_out": [2]}):
        assert abs(sh.renyi_entropy_2(snaps, **kw) - jsh.renyi_entropy_2(js, **kw)) <= TOL[dtype]
    for alpha in (1, 2):
        for kw in ({"sub": [0, 1]}, {"subsystems_to_trace_out": [1]}):
            _close(sh.entropy_shadow(snaps, strings, alpha=alpha, **kw),
                   jsh.entropy_shadow(js, jstr, alpha=alpha, **kw), 10 * TOL[dtype])
    assert sh.shadow_bound([[1, 0, 3], [0, 2, 0]], 0.5) == jsh.shadow_bound([[1, 0, 3], [0, 2, 0]], 0.5)
    with pytest.raises(ValueError):
        sh.renyi_entropy_2(snaps[:, :1])
    with pytest.raises(ValueError):
        sh.entropy_shadow(snaps, strings, sub=[5])


def test_shadows_from_the_generator_within_five_sigma():
    """Snapshots drawn from the backend's generator (no status): <Z_0 Z_1>,
    <X_2 Z_1> and the Rényi-2 entropy of qubit 0 within 5 standard errors
    of the exact values."""
    with tct.set_device("cpu"):
        tct.backend.set_random_state(3)
        psi = _psi(tct)
        ns, n = 3000, 3
        strings = np.random.default_rng(1).integers(0, 3, size=(ns, n))
        snaps = sh.shadow_snapshots(psi, strings)
        assert snaps.shape == (ns, 1, n)
        for kw, ps in (({"z": [0, 1]}, [3, 3, 0]), ({"x": [2], "z": [1]}, [0, 3, 1])):
            ests = torch.stack(sh.expectation_ps_shadow(snaps, strings, k=ns, **kw)).numpy()
            c = tct.Circuit(n, inputs=psi)
            exact = float(torch.real(c.expectation_ps(ps=ps)))
            assert abs(ests.mean() - exact) <= SIGMAS * ests.std() / np.sqrt(ns)
        snaps4 = sh.shadow_snapshots(psi, strings, np.random.default_rng(2).random((ns, 4)))
        rho = tct.quantum.reduced_density_matrix(psi, [0])
        s_exact = -np.log(float(torch.real(torch.trace(rho @ rho))))
        groups = [np.exp(-sh.renyi_entropy_2(g, [0])) for g in _np(snaps4).reshape(10, -1, 4, n)]
        s_all = sh.renyi_entropy_2(snaps4, [0])
        sigma = np.std(groups) / np.sqrt(10) / np.exp(-s_all)
        assert abs(s_all - s_exact) <= SIGMAS * sigma
