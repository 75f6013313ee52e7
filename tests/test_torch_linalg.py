"""The port's ``core/linalg.py`` against the JAX package's, on the same
numpy-seeded inputs, in complex64 and complex128.

Values are compared where they are gauge-free (singular values,
eigenvalues, reconstructions, eigenvector moduli); decompositions whose
gauge both packages fix the same way (LAPACK's QR) are compared directly.
Gradients are of gauge-invariant losses and compared as ``conj(torch) ==
jax``: torch's gradient of a complex tensor is the conjugate of JAX's.
Tolerances, relative to the largest entry compared: ``RTOL[dtype]``,
1e-4 in complex64 (float32 LAPACK and sums in another order; the Gram SVD
squares the condition number) and 1e-9 in complex128.  The JAX side runs
under ``jax.jit``, which compiles a case once instead of op by op.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tensorcircuit_ng_tpu as tc
from tensorcircuit_ng_tpu.core import linalg as JL

from tensorcircuit_ng_tpu_torch.core import linalg as TL

RTOL = {"complex64": 1e-4, "complex128": 1e-9}


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(params=["complex64", "complex128"])
def dtype(request):
    """The complex dtype of a case; complex128 turns JAX's x64 on for it."""
    if request.param == "complex128":
        tc.set_dtype("complex128")
        yield request.param
        tc.set_dtype("complex64")
    else:
        yield request.param


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _cplx(rng, shape, dtype):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _grads(fn_jax, fn_torch, a):
    """(jax grad, conj of torch grad) of a real loss at complex ``a``."""
    gj = np.asarray(jax.jit(jax.grad(fn_jax))(jnp.asarray(a)))
    t = torch.as_tensor(a).requires_grad_()
    fn_torch(t).backward()
    return gj, np.conj(t.grad.numpy())


def _svd_loss(svd, xp, k):
    """Gauge-invariant: the top-k singular values and a weighted |rank-k
    reconstruction|^2."""

    def loss(x):
        u, s, vh = svd(x)
        rec = (u[..., :, :k] * s[..., None, :k]) @ vh[..., :k, :]
        w = xp.arange(rec.shape[-1] * rec.shape[-2], dtype=s.dtype).reshape(rec.shape[-2:]) / 10
        return xp.real(xp.sum(s[..., :k]) + xp.sum(w * xp.abs(rec) ** 2))

    return loss


@pytest.mark.parametrize(
    "name,shape",
    [("adaware_svd", (2, 6, 4)), ("adaware_svd", (4, 6)), ("gram_svd", (2, 6, 4)),
     ("gram_svd", (4, 6)), ("jacobi_svd", (2, 6, 4))],
)
def test_svd_values_and_gradients_match_jax(dtype, name, shape):
    a = _cplx(np.random.default_rng(len(shape) + shape[-1]), shape, dtype)
    jfn, tfn = getattr(JL, name), getattr(TL, name)
    uj, sj, vj = (np.asarray(x) for x in jax.jit(jfn)(jnp.asarray(a)))
    ut, st, vt = (x.numpy() for x in tfn(torch.as_tensor(a)))
    rtol = RTOL[dtype]
    _close(st, sj, rtol)
    _close((ut * st[..., None, :]) @ vt, a, rtol)
    k = 2
    gj, gt = _grads(_svd_loss(jfn, jnp, k), _svd_loss(tfn, torch, k), a)
    _close(gt, gj, rtol)


def test_jacobi_svd_rejects_odd_width():
    with pytest.raises(ValueError, match="even"):
        TL.jacobi_svd(torch.ones((4, 5), dtype=torch.complex64))


@pytest.mark.parametrize("shape", [(5, 3), (3, 5)])
def test_qr_rq_match_jax(dtype, shape):
    a = _cplx(np.random.default_rng(shape[0]), shape, dtype)
    rtol = RTOL[dtype]
    for jfn, tfn in ((JL.adaware_qr, TL.adaware_qr), (JL.adaware_rq, TL.adaware_rq)):
        outj = [np.asarray(x) for x in jax.jit(jfn)(jnp.asarray(a))]
        outt = [x.numpy() for x in tfn(torch.as_tensor(a))]
        for xj, xt in zip(outj, outt):
            _close(xt, xj, rtol)
        w = [np.random.default_rng(7).standard_normal(x.shape) for x in outj]

        def loss(xp, fn):
            return lambda x: xp.real(sum(xp.sum(xp.asarray(wi) * y) for wi, y in zip(w, fn(x))))

        gj, gt = _grads(loss(jnp, jfn), loss(torch, tfn), a)
        _close(gt, gj, rtol)


def test_eigh_matches_jax(dtype):
    rng = np.random.default_rng(11)
    x = _cplx(rng, (5, 5), dtype)
    a = (x + x.conj().T) / 2
    ej, vj = (np.asarray(y) for y in jax.jit(JL.adaware_eigh)(jnp.asarray(a)))
    et, vt = (y.numpy() for y in TL.adaware_eigh(torch.as_tensor(a)))
    rtol = RTOL[dtype]
    _close(et, ej, rtol)
    _close(np.abs(vt), np.abs(vj), rtol)  # columns up to a phase
    c = np.arange(5.0)
    w = rng.standard_normal((5, 5))

    def loss(xp, fn):
        def f(m):
            e, v = fn(m)
            return xp.sum(xp.asarray(c) * e) + xp.sum(xp.asarray(w) * xp.abs(v) ** 2)

        return f

    gj, gt = _grads(loss(jnp, JL.adaware_eigh), loss(torch, TL.adaware_eigh), a)
    _close(gt, gj, rtol)


@pytest.mark.parametrize("err,relative", [(0.0, False), (0.5, False), (0.05, True)])
def test_truncated_svd_matches_jax(err, relative):
    a = _cplx(np.random.default_rng(3), (2, 8, 6), "complex64")
    a[1] = a[1] @ np.diag(np.exp(-np.arange(6.0))).astype(np.complex64)
    jfn = jax.jit(lambda x: JL.truncated_svd(x, 4, err, relative))
    uj, sj, vj, mj = (np.asarray(x) for x in jfn(jnp.asarray(a)))
    ut, st, vt, mt = (x.numpy() for x in TL.truncated_svd(torch.as_tensor(a), 4, err, relative))
    np.testing.assert_array_equal(mt, mj)
    _close(st, sj, RTOL["complex64"])
    _close((ut * st[..., None, :]) @ vt, (uj * sj[..., None, :]) @ vj, RTOL["complex64"])


def test_truncated_svd_auto_takes_gram_on_cuda_only(monkeypatch):
    """``USE_GRAM_SVD=None`` decides on the tensor's device: exact SVD here."""
    calls = []
    monkeypatch.setattr(TL, "gram_svd", lambda a: calls.append(a) or TL.adaware_svd(a))
    TL.truncated_svd(torch.ones((4, 4), dtype=torch.complex64), 2)
    assert calls == []
    monkeypatch.setattr(TL, "USE_GRAM_SVD", True)
    TL.truncated_svd(torch.ones((4, 4), dtype=torch.complex64), 2)
    assert len(calls) == 1


def test_lobpcg_matches_jax():
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    a = (q * np.linspace(1.0, 10.0, 30)) @ q.T
    ej, _ = JL.lobpcg(jnp.asarray(a, dtype=jnp.float32), k=2, maxiter=200)
    et, vt = TL.lobpcg(torch.as_tensor(a), k=2, maxiter=200)
    np.testing.assert_allclose(np.sort(et.numpy()), np.sort(np.asarray(ej)), atol=1e-4)
    np.testing.assert_allclose(np.sort(et.numpy()), [1.0, 1.0 + 9.0 / 29], atol=1e-6)
    np.testing.assert_allclose(a @ vt.numpy(), vt.numpy() * et.numpy(), atol=1e-5)
