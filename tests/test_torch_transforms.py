"""The port's 13 ``torch.autograd.Function``s under ``torch.func``.

Each Function (``core/kernels_stack.py``: ``_StackCore``, ``_StackEnergy``,
``_StackEnergyTheta``; ``core/kernels_rowlayer.py``: ``_ZzrxRowLayer``,
``_RowLayer``, ``_RowLayerLane``, ``_RowLayerConst``, ``_RotxRowLayer``;
``core/kernels_multilayer.py``: ``_Multilayer``; ``core/kernels_jacobi.py``:
``_JacobiSVD``; ``core/linalg.py``: ``_SVDAdjoint``, ``_QR``, ``_Eigh``)
is held, through its public wrapper, against its ``jax.custom_vjp``
counterpart in the JAX package on the same seeded inputs: the value and
``torch.func.grad`` of a real loss against ``jax.value_and_grad``,
``torch.func.vmap`` over a batch of two inputs against ``jax.vmap``, and
``vmap(grad)`` against ``jax.vmap(jax.grad)``.  The JAX side of the kernel
boundaries runs on its CPU branch, and where that is a Pallas kernel
(K2/K4 under ``zzrx_stack_energy_theta``, the Jacobi SVD) in interpret
mode; the port's on the CPU through the plain versions.  A complex leaf's gradient
is compared as JAX's, the conjugate of torch's.  Tolerance, all in
complex64/float32: 1e-5 of the largest entry; the decompositions 1e-4.  Forward mode (``torch.func.jvp``) raises through every
Function, as ``jax.jvp`` does through each counterpart.

A last test checks that the kernel calls of a Function's forward and
backward get plain tensors, never a transform's wrapped ones (a kernel
takes a pointer a plane), and that under ``vmap(grad)`` the kernel runs
once a batch element, forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from torch._C._functorch import is_functorch_wrapped_tensor

import tensorcircuit_ng_tpu as tc
from tensorcircuit_ng_tpu.core import kernels as jkernels
from tensorcircuit_ng_tpu.core import kernels_jacobi as jkj
from tensorcircuit_ng_tpu.core import kernels_multilayer as jkml
from tensorcircuit_ng_tpu.core import kernels_rowlayer as jkrl
from tensorcircuit_ng_tpu.core import kernels_stack as jkst
from tensorcircuit_ng_tpu.core import linalg as jla
from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as kj
from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst
from tensorcircuit_ng_tpu_torch.core import linalg as tla

RTOL = 1e-5
#: the decompositions (complex64): LAPACK and the Jacobi sweeps in another
#: order of sums
RTOL_LA = 1e-4


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


#: the Functions whose JAX counterpart reaches a Pallas kernel on the CPU
#: only in interpret mode (the others take the JAX package's CPU branch)
PALLAS = {"_StackEnergyTheta", "_JacobiSVD"}


@pytest.fixture(autouse=True)
def _small_kernel_rows(monkeypatch, request):
    """Two kernel rows (one for the angle-level boundary at n=9), so that
    an outer stage (nouter 1) exists in both packages; interpret mode for
    the Pallas counterparts."""
    name = request.node.callspec.params.get("name") if hasattr(request.node, "callspec") else None
    kq = 1 if name == "_StackEnergyTheta" else 2
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    pallas = name in PALLAS
    monkeypatch.setattr(jkj, "_INTERPRET", pallas)
    jkernels.set_interpret_mode(pallas)
    yield
    jkernels.set_interpret_mode(False)


def _c(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _unitaries(rng, k, dim):
    return np.linalg.qr(rng.standard_normal((k, dim, dim)) + 1j * rng.standard_normal((k, dim, dim)))[0]


def _unit(rng, *shape):
    z = _c(rng, *shape)
    return (z / np.linalg.norm(z)).astype(np.complex64)


N, L = 10, 2
PAIRS = ((0, 9), (1, 5), (2, 3), (8, 0))


def _spec():
    return jkernels.ising_readout_spec(N, zz_terms=[(a, b, 0.7) for a, b in PAIRS],
                                       x_terms=[(q, -1.3) for q in range(N)])


def _weighted(xp, w):
    """Re Σ conj(w) · y of a complex output y."""
    return lambda y: xp.real(xp.sum(xp.conj(w) * y))


def _invariant(xp, ws):
    """A loss of a decomposition's factors that no phase gauge moves:
    Σ w · |factor|² (singular values and eigenvalues as they are)."""
    def loss(*outs):
        total = 0.0
        for w, o in zip(ws, outs):
            o = xp.abs(o) ** 2 if o.dtype in (np.complex64, np.complex128, jnp.complex64, jnp.complex128,
                                               torch.complex64, torch.complex128) else o
            total = total + xp.sum(w * o)
        return total
    return loss


def _case(name):
    """(torch f, jax f, numpy inputs, the argument that is batched and
    differentiated, the tolerance) of one Function through its wrapper;
    ``f`` returns a real scalar loss."""
    rng = np.random.default_rng(sum(map(ord, name)))
    r = 2**N // 128
    if name in ("_StackCore", "_StackEnergy"):
        # unitary outer and lane matrices: in interpret mode the JAX stack
        # takes the fused topology, whose adjoint un-applies them
        mout = _unitaries(rng, L, 2).astype(np.complex64)
        mlane = _unitaries(rng, L, 128).astype(np.complex64)
        args = [_unit(rng, r, 128), (rng.normal(size=(L, len(PAIRS))) * 0.5).astype(np.float32),
                (rng.normal(size=(L, 2)) * 0.5).astype(np.float32), mout, mlane]
        if name == "_StackCore":
            w = _c(rng, r, 128)
            return (lambda *a: _weighted(torch, torch.as_tensor(w))(kst.zzrx_stack_core(PAIRS, N, *a)),
                    lambda *a: _weighted(jnp, jnp.asarray(w))(jkst.zzrx_stack_core(PAIRS, N, *a)), args, 0, RTOL)
        spec = _spec()
        return (lambda *a: kst.zzrx_stack_energy(PAIRS, N, *a, spec),
                lambda *a: jkst.zzrx_stack_energy(PAIRS, N, *a, spec), args, 1, RTOL)
    if name == "_StackEnergyTheta":
        n, pairs = 9, ((0, 8), (1, 5), (2, 3))
        spec = jkernels.ising_readout_spec(n, zz_terms=[(a, b, 0.7) for a, b in pairs],
                                           x_terms=[(q, -1.3) for q in range(n)])
        args = [_unit(rng, 4, 128), (rng.normal(size=(L, len(pairs))) * 0.4).astype(np.float32),
                (rng.normal(size=(L, n)) * 0.4).astype(np.float32)]
        return (lambda *a: kst.zzrx_stack_energy_theta(pairs, n, *a, spec),
                lambda *a: jkst.zzrx_stack_energy_theta(pairs, n, *a, spec), args, 2, RTOL)
    if name == "_ZzrxRowLayer":
        w = _c(rng, r, 128)
        args = [_unit(rng, r, 128), (rng.normal(size=len(PAIRS)) * 0.5).astype(np.float32),
                (rng.normal(size=2) * 0.5).astype(np.float32)]
        return (lambda *a: _weighted(torch, torch.as_tensor(w))(krl.zzrx_row_layer(PAIRS, N, *a)),
                lambda *a: _weighted(jnp, jnp.asarray(w))(jkrl.zzrx_row_layer(PAIRS, N, *a)), args, 0, RTOL)
    if name in ("_RowLayer", "_RowLayerLane", "_RowLayerConst"):
        w = _c(rng, 16, 128)
        args = [_unit(rng, 16, 128), _unitaries(rng, 4, 2).astype(np.complex64)]
        if name == "_RowLayerLane":
            args.append(_unitaries(rng, 1, 128)[0].astype(np.complex64))
        fn = {"_RowLayer": "row_layer", "_RowLayerLane": "row_layer_lane", "_RowLayerConst": "row_layer_const"}[name]
        return (lambda *a: _weighted(torch, torch.as_tensor(w))(getattr(krl, fn)(*a)),
                lambda *a: _weighted(jnp, jnp.asarray(w))(getattr(jkrl, fn)(*a)), args, 0, RTOL)
    if name == "_RotxRowLayer":
        w = _c(rng, 32, 128)
        args = [_unit(rng, 32, 128), (rng.normal(size=5) * 0.7).astype(np.float32)]
        return (lambda *a: _weighted(torch, torch.as_tensor(w))(krl.rotx_row_layer(*a)),
                lambda *a: _weighted(jnp, jnp.asarray(w))(jkrl.rotx_row_layer(*a)), args, 1, RTOL)
    if name == "_Multilayer":
        pairs = ((0, 5), (2, 8), (1, 9))
        w = _c(rng, 8, 128)
        args = [_unit(rng, 8, 128), (rng.normal(size=(L, 3)) * 0.5).astype(np.float32),
                (rng.normal(size=(L, 3)) * 0.5).astype(np.float32),
                _unitaries(rng, L, 128).astype(np.complex64)]
        return (lambda *a: _weighted(torch, torch.as_tensor(w))(kml.zzrx_multilayer(pairs, N, *a)),
                lambda *a: _weighted(jnp, jnp.asarray(w))(jkml.zzrx_multilayer(pairs, N, *a)), args, 0, RTOL)
    # the linear algebra (well-separated spectra: gauge-free losses)
    a = (rng.normal(size=(6, 4)) + 1j * rng.normal(size=(6, 4))).astype(np.complex64)
    ws = [rng.normal(size=s).astype(np.float32) for s in ((6, 4), (4,), (4, 4))]
    if name == "_SVDAdjoint":
        return (lambda x: _invariant(torch, [torch.as_tensor(v) for v in ws])(*tla.adaware_svd(x)),
                lambda x: _invariant(jnp, [jnp.asarray(v) for v in ws])(*jla.adaware_svd(x)), [a], 0, RTOL_LA)
    if name == "_JacobiSVD":
        return (lambda x: _invariant(torch, [torch.as_tensor(v) for v in ws])(*kj.jacobi_svd(x, 10, True)),
                lambda x: _invariant(jnp, [jnp.asarray(v) for v in ws])(*jkj.jacobi_svd(x, 10, True)), [a], 0,
                RTOL_LA)
    if name == "_QR":
        wq = [rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(4, 4)).astype(np.float32)]
        return (lambda x: _invariant(torch, [torch.as_tensor(v) for v in wq])(*tla.adaware_qr(x)),
                lambda x: _invariant(jnp, [jnp.asarray(v) for v in wq])(*jla.adaware_qr(x)), [a], 0, RTOL_LA)
    h = a.conj().T @ a
    we = [rng.normal(size=(4,)).astype(np.float32), rng.normal(size=(4, 4)).astype(np.float32)]
    return (lambda x: _invariant(torch, [torch.as_tensor(v) for v in we])(*tla.adaware_eigh(x)),
            lambda x: _invariant(jnp, [jnp.asarray(v) for v in we])(*jla.adaware_eigh(x)), [h], 0, RTOL_LA)


FUNCTIONS = ["_StackCore", "_StackEnergy", "_StackEnergyTheta", "_ZzrxRowLayer", "_RowLayer", "_RowLayerLane",
             "_RowLayerConst", "_RotxRowLayer", "_Multilayer", "_JacobiSVD", "_SVDAdjoint", "_QR", "_Eigh"]


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    got = np.conj(got) if np.iscomplexobj(got) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _batch(x, rng):
    """The input and a perturbed copy (Hermitian if the input is), stacked."""
    noise = rng.normal(size=x.shape) * 0.05
    other = (x + noise.astype(x.dtype)) if not np.iscomplexobj(x) else (x + (noise + 1j * noise).astype(x.dtype))
    if x.ndim == 2 and x.shape[0] == x.shape[1] and np.allclose(x, x.conj().T):
        other = (other + other.conj().T) / 2
    return np.stack([x, other.astype(x.dtype)])


def _with(args, i, x):
    out = list(args)
    out[i] = x
    return out


@pytest.mark.parametrize("name", FUNCTIONS)
def test_grad_matches_jax(name):
    tf, jf, args, i, rtol = _case(name)
    targs = [torch.as_tensor(a) for a in args]
    g = torch.func.grad(lambda x: tf(*_with(targs, i, x)))(targs[i])
    jargs = [jnp.asarray(a) for a in args]
    v, jg = jax.value_and_grad(lambda x: jf(*_with(jargs, i, x)))(jargs[i])
    assert abs(tf(*targs).item() - float(v)) <= rtol * max(1.0, abs(float(v)))
    _close(g, jg, rtol)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_vmap_matches_jax(name):
    tf, jf, args, i, rtol = _case(name)
    xb = _batch(args[i], np.random.default_rng(1))
    targs, jargs = [torch.as_tensor(a) for a in args], [jnp.asarray(a) for a in args]
    got = torch.func.vmap(lambda x: tf(*_with(targs, i, x)))(torch.as_tensor(xb))
    want = jax.vmap(lambda x: jf(*_with(jargs, i, x)))(jnp.asarray(xb))
    _close(got, want, rtol)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_vmap_of_grad_matches_jax(name):
    tf, jf, args, i, rtol = _case(name)
    xb = _batch(args[i], np.random.default_rng(2))
    targs, jargs = [torch.as_tensor(a) for a in args], [jnp.asarray(a) for a in args]
    got = torch.func.vmap(torch.func.grad(lambda x: tf(*_with(targs, i, x))))(torch.as_tensor(xb))
    want = jax.vmap(jax.grad(lambda x: jf(*_with(jargs, i, x))))(jnp.asarray(xb))
    _close(got, want, rtol)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_forward_mode_raises_in_both(name):
    """No forward mode through a kernel or its adjoint: torch raises for a
    Function without a ``jvp``, JAX for a ``custom_vjp``."""
    tf, jf, args, i, _ = _case(name)
    targs, jargs = [torch.as_tensor(a) for a in args], [jnp.asarray(a) for a in args]
    with pytest.raises((RuntimeError, NotImplementedError)):
        torch.func.jvp(lambda x: tf(*_with(targs, i, x)), (targs[i],), (torch.ones_like(targs[i]),))
    with pytest.raises(TypeError):
        jax.jvp(lambda x: jf(*_with(jargs, i, x)), (jargs[i],), (jnp.ones_like(jargs[i]),))


def test_kernels_take_plain_tensors_once_an_element(monkeypatch):
    """Under ``vmap(grad)`` the Functions hand their kernel wrappers plain
    tensors and call them once a batch element, forward and backward: the
    K2 and K4 plain versions are wrapped here to count and to reject a
    wrapped tensor, as a kernel's pointer would."""
    calls = {"fwd": 0, "bwd": 0}

    def plain_only(key, fn):
        def wrapped(*args):
            assert not any(isinstance(a, torch.Tensor) and is_functorch_wrapped_tensor(a) for a in args)
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", 1)
    monkeypatch.setattr(kg, "grand_zzrx_fwd_plain", plain_only("fwd", kg.grand_zzrx_fwd_plain))
    monkeypatch.setattr(kg, "grand_zzrx_bwd_plain", plain_only("bwd", kg.grand_zzrx_bwd_plain))
    tf, _, args, i, _ = _case("_StackEnergyTheta")
    xb = torch.as_tensor(_batch(args[i], np.random.default_rng(3)))
    targs = [torch.as_tensor(a) for a in args]
    torch.func.vmap(torch.func.grad(lambda x: tf(*_with(targs, i, x))))(xb)
    assert calls == {"fwd": 2, "bwd": 2}
