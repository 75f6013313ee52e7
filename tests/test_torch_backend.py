"""The port's ``TorchBackend`` against the JAX package's ``JaxBackend``.

- The array surface: each method on the same seeded numpy inputs in both
  backends, at complex64 (1e-5) and complex128 (1e-10), each relative to
  max(1, the largest entry); integer and boolean results equal.  The
  decompositions are compared where no gauge moves them (singular values,
  eigenvalues, q·r, the Schur form's reconstruction and sorted diagonal);
  the iterative LOBPCG eigenvalues within 1e-4 (1e-8 at complex128).
- The transforms (``grad``, ``value_and_grad``, ``vjp``, ``jacrev``,
  ``hessian``, ``vmap``, ``vvag`` and the compositions [1]-[3] of
  ``examples/vmap_grad_composition.py``) against the JAX package, on the
  generic gate path (``rx``, ``ry``, ``cnot``, ``expectation_ps``) and on the
  main path (``h_layer``, ``zzrx_layer``, ``expectation_zzx_energy``) at
  n=8, L=4 on the CPU, within 1e-5 (complex64); ``jit`` on the CPU equal
  to eager, and ``jit_compile=False``; a complex leaf's gradient in the
  JAX convention.
- ``scan``, ``cond``, ``switch``, ``fori_loop``, ``while_loop`` and the tree
  utilities; ``optimizer`` with ``torch.optim.Adam`` against
  ``optax.adam`` over 5 steps (1e-5: float32 sums in another order); ``expm``, ``sqrtmh`` and
  ``eigsh_lobpcg``; the ``config`` names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

import chip_smoke as cs
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.backend import backend as JK
from tensorcircuit_ng_tpu_torch.backend import backend as K

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}


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


@pytest.fixture
def cpu():
    with tct.set_device("cpu"):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _inputs(dt, seed=0):
    """Seeded numpy operands of the case table at the dtype."""
    rng = np.random.default_rng(seed)
    cdt, rdt = np.dtype(dt), RDT[dt]
    c = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(cdt)  # noqa: E731
    r = lambda *s: rng.normal(size=s).astype(rdt)  # noqa: E731
    h = c(4, 4)
    return {
        "c": c(4, 3), "c44": c(4, 4), "c8": c(8), "c3": c(2, 3, 4), "v": c(4), "r": r(4, 3), "r44": r(4, 4),
        "rv": r(6), "pos": np.abs(r(4, 3)) + rdt(0.5), "unit": np.tanh(r(4, 3)), "big": np.abs(r(4, 3)) + rdt(1.5),
        "herm": (h + h.conj().T) / 2, "psd": (h @ h.conj().T).astype(cdt),
        "ints": rng.integers(-20, 20, size=(3, 4)).astype(np.int32), "nat": rng.integers(0, 4, size=(5,)),
        "bools": rng.random((3, 4)) > 0.5, "sorted": np.sort(r(8)), "q": r(5),
    }


def _cases(x, dt):
    """name -> (args, kwargs) for both backends."""
    rdt = str(np.dtype(RDT[dt]))
    return {
        "convert_to_tensor": ((x["c"],), {}), "cast": ((x["r"], "int32"), {}), "eye": ((4,), {"dtype": dt, "M": 5}),
        "ones": (((2, 3),), {"dtype": dt}), "zeros": (((2, 3),), {"dtype": rdt}), "copy": ((x["c"],), {}),
        "arange": ((2, 9, 3), {}), "shape_prod": (([2, 3, 4],), {}), "sizen": ((x["c3"],), {}),
        "reshape": ((x["c"], (3, 4)), {}), "reshape2": ((x["c8"],), {}), "reshapem": ((x["c44"].reshape(-1),), {}),
        "reshaped": ((x["c8"], 2), {}), "transpose": ((x["c3"], (1, 0, 2)), {}), "tile": ((x["c"], (2, 1)), {}),
        "stack": (([x["c"], x["c"]],), {"axis": 1}), "concat": (([x["c"], x["c"]],), {"axis": 0}),
        "slice": ((x["c44"], (3, 1), (2, 2)), {}), "gather1d": ((x["c"], np.array([0, 5, 11])), {}),
        "scatter": ((x["c44"], np.array([[0, 1], [2, 3]]), x["v"][:2]), {}),
        "real": ((x["c"],), {}), "imag": ((x["c"],), {}), "conj": ((x["c"],), {}), "adjoint": ((x["c"],), {}),
        "abs": ((x["c"],), {}), "sign": ((x["c"],), {}), "exp": ((x["c"],), {}), "log": ((x["pos"],), {}),
        "sqrt": ((x["pos"],), {}), "square": ((x["c"],), {}), "sin": ((x["c"],), {}), "cos": ((x["c"],), {}),
        "tan": ((x["r"],), {}), "tanh": ((x["r"],), {}), "acos": ((x["unit"],), {}), "asin": ((x["unit"],), {}),
        "atan": ((x["r"],), {}), "atan2": ((x["r"], x["pos"]), {}), "acosh": ((x["big"],), {}),
        "asinh": ((x["r"],), {}), "atanh": ((x["unit"],), {}), "cosh": ((x["r"],), {}), "sinh": ((x["r"],), {}),
        "sigmoid": ((x["r"],), {}), "relu": ((x["r"],), {}), "softmax": ((x["r"],), {"axis": 0}),
        "power": ((x["c"], 3), {}), "mod": ((x["ints"], 7), {}), "floor": ((x["r"] * 3,), {}),
        "ceil": ((x["r"] * 3,), {}), "round": ((x["r"] * 3,), {}), "clip": ((x["r"], -0.5, 0.5), {}),
        "maximum": ((x["r"], x["pos"]), {}), "minimum": ((x["r"], x["pos"]), {}),
        "sum": ((x["c"],), {"axis": 0}), "mean": ((x["c3"],), {"axis": (0, 2)}), "std": ((x["r"],), {"axis": 1}),
        "max": ((x["r"],), {"axis": 1}), "min": ((x["r"],), {}), "argmax": ((x["r"],), {"axis": 1}),
        "argmin": ((x["r"],), {}), "cumsum": ((x["c"],), {"axis": 1}), "prod": ((x["c"],), {"axis": 0}),
        "norm": ((x["c"],), {}), "unique_with_counts": ((x["nat"],), {}),
        "relative_entropy": ((x["pos"], x["pos"][::-1].copy()), {}), "equal": ((x["ints"], 3), {}),
        "not_equal": ((x["ints"], 3), {}), "greater": ((x["r"], x["pos"]), {}), "less": ((x["r"], 0.1), {}),
        "greater_equal": ((x["ints"], 0), {}), "less_equal": ((x["ints"], 0), {}),
        "where": ((x["bools"], x["ints"], -x["ints"]), {}), "onehot": ((x["nat"], 4), {}),
        "matmul": ((x["c44"], x["c"]), {}), "tensordot": ((x["c44"], x["c"], 1), {}),
        "einsum": (("ij,jk->ik", x["c44"], x["c"]), {}), "outer_product": ((x["v"], x["v"]), {}),
        "kron": ((x["c44"], x["c"]), {}), "trace": ((x["c3"].reshape(4, 3, 2)[:3],), {}),
        "det": ((x["c44"],), {}), "inv": ((x["c44"],), {}), "solve": ((x["c44"], x["c"]), {}),
        "eigvalsh": ((x["herm"],), {}), "expm": ((x["c44"] * 0.3,), {}), "sqrtmh": ((x["psd"],), {"psd": True}),
        "diagflat": ((x["v"],), {}), "diag": ((x["c44"],), {"k": 1}), "moveaxis": ((x["c3"], 0, 2), {}),
        "searchsorted": ((x["sorted"], x["q"]), {"side": "right"}), "all": ((x["bools"],), {"axis": 0}),
        "any": ((x["bools"],), {}), "argsort": ((x["rv"],), {}), "sort": ((x["r"],), {"axis": 0}),
        "lexsort": (((x["nat"], x["nat"][::-1].copy()),), {}), "top_k": ((x["rv"], 3), {}), "reverse": ((x["c"],), {}),
        "expand_dims": ((x["c"], 1), {}), "ones_like": ((x["c"],), {}), "zeros_like": ((x["r"],), {}),
        "repeat": ((x["c"], 2), {"axis": 0}), "meshgrid": ((x["rv"], x["q"]), {}),
        "floor_divide": ((x["ints"], 6), {}), "bitwise_and": ((x["ints"], 5), {}),
        "bitwise_or": ((x["ints"], 5), {}), "bitwise_xor": ((x["ints"], 5), {}),
        "left_shift": ((np.abs(x["ints"]), 2), {}), "right_shift": ((np.abs(x["ints"]), 2), {}),
        "popc": ((x["ints"],), {}), "i": ((), {"dtype": dt}), "matvec": ((x["c44"], x["v"]), {}),
        "dtype": ((x["c"],), {}), "svd": ((x["c"],), {}), "qr": ((x["c"],), {}), "eigh": ((x["herm"],), {}),
        "eig": ((x["r44"],), {}), "schur": ((x["r44"],), {}), "stop_gradient": ((x["c"],), {}),
        "special_jv": ((6, x["pos"][0, 0] * 3, 30), {}),
    }


def _gauge_free(name, out, a):
    """A decomposition's outputs where no gauge moves them."""
    if name == "svd":
        return [out[1]]
    if name == "qr":
        return [out[0] @ out[1]]
    if name == "eigh":
        return [out[0]]
    if name == "eig":
        e = _np(out[0])
        return [e[np.lexsort((e.imag, e.real))]]
    if name == "schur":
        t, z = _np(out[0]), _np(out[1])
        return [z @ t @ z.conj().T, np.sort(np.diag(t))]
    return out


NAMES = sorted(_cases(_inputs("complex64"), "complex64"))


def _call(backend, name, args, kws, torch_side):
    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v) if torch_side else jnp.asarray(v)
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
            return type(v)(conv(a) for a in v)
        return v

    return getattr(backend, name)(*(conv(a) for a in args), **kws)


@pytest.mark.parametrize("name", NAMES)
def test_array_surface_matches_jax(dtype, name):
    x = _inputs(dtype)
    args, kws = _cases(x, dtype)[name]
    got = _call(K, name, args, kws, True)
    want = _call(JK, name, args, kws, False)
    if name == "dtype":
        assert got == want
        return
    got, want = _gauge_free(name, got, None), _gauge_free(name, want, None)
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype] * (10 if name in ("expm", "schur", "eig", "inv", "solve", "special_jv") else 1))


def test_lobpcg_eigenvalues_match_jax(dtype):
    """``eigsh_lobpcg`` (the smallest) and ``lobpcg_standard`` (the largest)
    on a real symmetric matrix with a gap, against the JAX package's and
    the exact eigenvalues."""
    rng = np.random.default_rng(3)
    q = np.linalg.qr(rng.normal(size=(40, 40)))[0]
    lam = np.concatenate([[-5.0, -4.0], np.linspace(-1, 1, 36), [4.0, 5.0]])
    a = ((q * lam) @ q.T).astype(RDT[dtype])
    x0 = rng.normal(size=(40, 2)).astype(RDT[dtype])
    tol = 1e-4 if dtype == "complex64" else 1e-8
    e, v = K.eigsh_lobpcg(torch.as_tensor(a), k=2, x0=torch.as_tensor(x0), maxiter=200)
    ej, _ = JK.eigsh_lobpcg(jnp.asarray(a), k=2, x0=jnp.asarray(x0), maxiter=200)
    _close(np.sort(_np(e)), np.sort(np.asarray(ej)), tol)
    _close(np.sort(_np(e)), [-5.0, -4.0], tol)
    np.testing.assert_allclose(_np(torch.as_tensor(a) @ v), _np(v) * _np(e), atol=10 * tol)
    th, _, _ = K.lobpcg_standard(torch.as_tensor(a), torch.as_tensor(x0), m=200)
    thj, _, _ = JK.lobpcg_standard(jnp.asarray(a), jnp.asarray(x0), m=200)
    _close(np.sort(_np(th)), np.sort(np.asarray(thj)), tol)


def test_expm_and_sqrtmh(dtype):
    """``expm`` of an anti-Hermitian matrix is unitary; ``sqrtmh`` squares
    back; both against the JAX package and scipy."""
    import scipy.linalg as sl

    rng = np.random.default_rng(4)
    h = rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6))
    h = ((h + h.conj().T) / 2).astype(dtype)
    u = K.expm(torch.as_tensor(-1j * h))
    _close(u, JK.expm(jnp.asarray(-1j * h)), 10 * TOL[dtype])
    _close(u, sl.expm(-1j * h.astype(np.complex128)), 10 * TOL[dtype])
    _close(u @ u.mH, np.eye(6), 10 * TOL[dtype])
    p = (h @ h.conj().T).astype(dtype)
    s = K.sqrtmh(torch.as_tensor(p), psd=True)
    _close(s @ s, p, 10 * TOL[dtype])
    _close(s, JK.sqrtmh(jnp.asarray(p), psd=True), 10 * TOL[dtype])


def test_control_flow_and_trees(cpu):
    """``scan`` (with and without xs, a pytree carry), ``cond``, ``switch``
    (the index clamped), ``fori_loop``, ``while_loop``, ``stop_gradient``
    and the tree utilities against the JAX package."""
    xs = np.arange(6, dtype=np.float32).reshape(3, 2)

    def f(xp):
        return lambda carry, x: ((carry[0] + x, carry[1] * 2), x * carry[1])

    carry, ys = K.scan(f(torch), (torch.zeros(2), torch.tensor(1.0)), torch.as_tensor(xs))
    jcarry, jys = JK.scan(f(jnp), (jnp.zeros(2), jnp.asarray(1.0)), jnp.asarray(xs))
    for g, w in zip((*carry, ys), (*jcarry, jys)):
        _close(g, w, 1e-6)
    c2, none = K.scan(lambda c, _: (c + 1, None), torch.tensor(0), None, length=4)
    assert int(c2) == 4 and none is None
    assert float(K.cond(torch.tensor(True), lambda a: a + 1, lambda a: a - 1, torch.tensor(2.0))) == 3.0
    assert float(K.cond(False, lambda a: a + 1, lambda a: a - 1, torch.tensor(2.0))) == 1.0
    branches = [lambda a: a * 0, lambda a: a * 1, lambda a: a * 2]
    for i in (-1, 1, 7):
        assert float(K.switch(torch.tensor(i), branches, torch.tensor(3.0))) == float(
            JK.switch(jnp.asarray(i), branches, jnp.asarray(3.0)))
    assert int(K.fori_loop(1, 5, lambda i, v: v * i, 1)) == int(JK.fori_loop(1, 5, lambda i, v: v * i, 1)) == 24
    assert int(K.while_loop(lambda v: v < 100, lambda v: v * 3, torch.tensor(1))) == 243
    t = torch.tensor(2.0, requires_grad=True)
    assert not K.stop_gradient(t * 3).requires_grad
    tree = {"a": [torch.tensor(1.0), torch.tensor(2.0)], "b": (torch.tensor(3.0),)}
    leaves, spec = K.tree_flatten(tree)
    jleaves, _ = JK.tree_flatten({"a": [1.0, 2.0], "b": (3.0,)})
    assert [float(v) for v in leaves] == list(jleaves)
    back = K.tree_unflatten(spec, [v * 10 for v in leaves])
    assert float(back["b"][0]) == 30.0 and float(K.tree_map(lambda v: v + 1, tree)["a"][1]) == 3.0


def test_config_names():
    """``get_backend_name``, ``current()`` and its ``rdtype``/``idtype``,
    as the JAX package names them."""
    assert tct.config.get_backend_name() == "pytorch"
    with tct.set_dtype("complex128"):
        cur = tct.config.current()
        assert (cur.dtype, cur.rdtype, cur.idtype, cur.npdtype) == ("complex128", "float64", "int64",
                                                                    np.dtype("complex128"))
    cur = tct.config.current()
    jcur = tc.config.current()
    assert (cur.dtype, cur.rdtype, cur.idtype) == (jcur.dtype, jcur.rdtype, jcur.idtype)
    assert cur.backend == "pytorch" and cur.contractor == jcur.contractor


def test_optimizer_adam_matches_optax(cpu):
    """5 steps of ``optimizer(torch.optim.Adam, lr=0.05)`` (and of the
    factory form) against ``optax.adam(0.05)`` on the same gradients."""
    rng = np.random.default_rng(5)
    p0 = {"w": rng.normal(size=(3, 2)).astype(np.float32), "b": rng.normal(size=(2,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    for opt in (K.optimizer(torch.optim.Adam, lr=0.05),
                K.optimizer(lambda ps: torch.optim.Adam(ps, lr=0.05, betas=(0.9, 0.999), eps=1e-8))):
        jopt = JK.optimizer(optax.adam(0.05))
        p = {k: torch.as_tensor(v) for k, v in p0.items()}
        pj = {k: jnp.asarray(v) for k, v in p0.items()}
        for g in grads:
            p = opt.update({k: torch.as_tensor(v) for k, v in g.items()}, p)
            pj = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, pj)
            for k in p0:
                _close(p[k], pj[k], 1e-5)


# ---------------------------------------------------------------- transforms


N_GEN = 4


def _f(mod, xp):
    """``examples/vmap_grad_composition.py``'s f: <Z_0> of a 2-layer
    rx/ry/cnot ansatz, data angles theta and weights alpha."""
    def f(theta, alpha):
        c = mod.Circuit(N_GEN)
        for j in range(2):
            for i in range(N_GEN):
                c.rx(i, theta=theta[j])
                c.ry(i, theta=alpha[j])
            for i in range(N_GEN - 1):
                c.cnot(i, i + 1)
        return xp.real(c.expectation_ps(z=[0]))
    return f


def _main(mod, n=8, nl=4):
    """The main path (``chip_smoke.transform_energy``'s circuit) of a
    (nl, 2, n) grid."""
    pairs = [(i, i + 1) for i in range(n - 1)]

    def energy(p):
        c = mod.Circuit(n)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        return c.expectation_zzx_energy(pairs, 1.0, -1.0)
    return energy


def _gen_inputs():
    rng = np.random.default_rng(0)
    return rng.normal(size=(3, 2)).astype(np.float32), rng.normal(size=(2,)).astype(np.float32)


@pytest.mark.parametrize("path", ["generic", "main"])
def test_grad_value_and_grad_vjp_jacrev_match_jax(cpu, path):
    if path == "generic":
        thetas, alpha = _gen_inputs()
        tf, jf = _f(tct, torch), _f(tc, jnp)
        args, jargs = (torch.as_tensor(thetas[0]), torch.as_tensor(alpha)), (jnp.asarray(thetas[0]),
                                                                             jnp.asarray(alpha))
        argnums = 1
    else:
        p = (np.random.default_rng(42).normal(size=(4, 2, 8)) * 0.1).astype(np.float32)
        tf, jf = _main(tct), _main(tc)
        args, jargs = (torch.as_tensor(p),), (jnp.asarray(p),)
        argnums = 0
    _close(K.grad(tf, argnums=argnums)(*args), jax.grad(jf, argnums=argnums)(*jargs), 1e-5)
    v, g = K.value_and_grad(tf, argnums=argnums)(*args)
    vj, gj = jax.value_and_grad(jf, argnums=argnums)(*jargs)
    _close(v, vj, 1e-5)
    _close(g, gj, 1e-5)
    (v2, aux), g2 = K.value_and_grad(lambda *a: (tf(*a), tf(*a) * 2), argnums=argnums, has_aux=True)(*args)
    _close(aux, 2 * vj, 1e-5)
    _close(g2, gj, 1e-5)
    out, vjp = K.vjp(lambda x: tf(*(args[:argnums] + (x,))), args[argnums], torch.tensor(1.5))
    _, jvjp = JK.vjp(lambda x: jf(*(jargs[:argnums] + (x,))), jargs[argnums], jnp.asarray(1.5))
    _close(vjp, jvjp, 1e-5)
    vec = lambda xp: (lambda x: xp.stack([tf(*(args[:argnums] + (x,))), tf(*(args[:argnums] + (x * 2,)))])  # noqa
                      if xp is torch else jnp.stack([jf(*(jargs[:argnums] + (x,))),
                                                     jf(*(jargs[:argnums] + (x * 2,)))]))
    _close(K.jacrev(vec(torch))(args[argnums]), jax.jacrev(vec(jnp))(jargs[argnums]), 1e-5)


def test_hessian_matches_jax_on_the_generic_path(cpu):
    """Forward over reverse on the generic gates (no kernel); through a
    kernel forward mode raises, in both packages (test_torch_transforms)."""
    thetas, alpha = _gen_inputs()
    h = K.hessian(lambda a: _f(tct, torch)(torch.as_tensor(thetas[0]), a))(torch.as_tensor(alpha))
    hj = jax.hessian(lambda a: _f(tc, jnp)(jnp.asarray(thetas[0]), a))(jnp.asarray(alpha))
    _close(h, hj, 1e-5)
    jv = K.jvp(lambda a: _f(tct, torch)(torch.as_tensor(thetas[0]), a), torch.as_tensor(alpha),
               torch.ones(2))[1]
    jvj = JK.jvp(lambda a: _f(tc, jnp)(jnp.asarray(thetas[0]), a), jnp.asarray(alpha), jnp.ones(2))[1]
    _close(jv, jvj, 1e-5)


def test_compositions_match_jax(cpu):
    """[1] vmap(grad) and grad(vmap), [2] nested vmap, [3] vvag of
    ``examples/vmap_grad_composition.py`` against the JAX package, each
    under ``jit`` (eager on the CPU) and against the loop."""
    thetas, alpha = _gen_inputs()
    tth, tal = torch.as_tensor(thetas), torch.as_tensor(alpha)
    jth, jal = jnp.asarray(thetas), jnp.asarray(alpha)
    tf, jf = _f(tct, torch), _f(tc, jnp)
    gs = K.jit(K.vmap(K.grad(tf, argnums=1), vectorized_argnums=0))(tth, tal)
    _close(gs, JK.vmap(JK.grad(jf, argnums=1), vectorized_argnums=0)(jth, jal), 1e-5)
    _close(gs, torch.stack([K.grad(tf, argnums=1)(t, tal) for t in tth]), 1e-6)
    g_outer = K.jit(K.grad(lambda a: torch.mean(K.vmap(tf, vectorized_argnums=0)(tth, a))))(tal)
    _close(g_outer, gs.mean(0), 1e-6)
    grid = np.random.default_rng(1).normal(size=(4, 2)).astype(np.float32)
    ff = K.jit(K.vmap(K.vmap(tf, vectorized_argnums=1), vectorized_argnums=0))(tth, torch.as_tensor(grid))
    _close(ff, JK.vmap(JK.vmap(jf, vectorized_argnums=1), vectorized_argnums=0)(jth, jnp.asarray(grid)), 1e-5)
    vals, grad = K.jit(K.vvag(tf, argnums=1, vectorized_argnums=0))(tth, tal)
    jvals, jgrad = JK.vvag(jf, argnums=1, vectorized_argnums=0)(jth, jal)
    _close(vals, jvals, 1e-5)
    _close(grad, jgrad, 1e-5)
    _close(grad, gs.sum(0), 1e-6)


def test_main_path_vmap_vvag_jit_match_jax(cpu):
    """The main path at n=8, L=4: ``vmap`` over 3 parameter grids, ``vvag``
    (per-grid values and gradients), ``vmap(grad)``, and ``jit`` (eager on
    the CPU, and ``jit_compile=False``) against the JAX package."""
    ps = (np.random.default_rng(6).normal(size=(3, 4, 2, 8)) * 0.1).astype(np.float32)
    tp, jp = torch.as_tensor(ps), jnp.asarray(ps)
    tf, jf = _main(tct), _main(tc)
    _close(K.vmap(tf)(tp), jax.vmap(jf)(jp), 1e-5)
    vals, grads = K.vvag(tf, argnums=0, vectorized_argnums=0)(tp)
    jvals, jgrads = JK.vvag(jf, argnums=0, vectorized_argnums=0)(jp)
    _close(vals, jvals, 1e-5)
    _close(grads, jgrads, 1e-5)
    _close(K.vmap(K.grad(tf))(tp), jax.vmap(jax.grad(jf))(jp), 1e-5)
    for jitted in (K.jit(K.value_and_grad(tf)), K.jit(K.value_and_grad(tf), jit_compile=False)):
        v, g = jitted(tp[0])
        ve, ge = K.value_and_grad(tf)(tp[0])
        assert torch.equal(v, ve) and torch.equal(g, ge)
        _close(v, jax.value_and_grad(jf)(jp[0])[0], 1e-5)
    assert K.jit(tf).captures == 0


def test_jit_static_argnums_and_complex_gradients(cpu):
    """``static_argnums`` reaches the function as a value; a complex leaf's
    gradient is the JAX package's (the conjugate of torch's ``.grad``)."""
    f = K.jit(lambda x, k: torch.sum(x**k), static_argnums=(1,))
    assert float(f(torch.tensor([2.0, 3.0]), 2)) == 13.0 and float(f(torch.tensor([2.0, 3.0]), 3)) == 35.0
    z = np.array([1.0 + 2.0j, -0.5 + 0.3j], dtype=np.complex64)
    w = np.array([0.3 - 1.0j, 2.0 + 0.1j], dtype=np.complex64)
    loss_t = lambda v: torch.real(torch.sum(torch.as_tensor(w) * v * v))  # noqa: E731
    loss_j = lambda v: jnp.real(jnp.sum(jnp.asarray(w) * v * v))  # noqa: E731
    _close(K.grad(loss_t)(torch.as_tensor(z)), jax.grad(loss_j)(jnp.asarray(z)), 1e-6)
    v, g = K.value_and_grad(loss_t)(torch.as_tensor(z))
    _close(g, jax.grad(loss_j)(jnp.asarray(z)), 1e-6)


def test_transform_phase_checks_on_the_cpu(cpu):
    """``chip_smoke.py``'s phase 18 at a small size on the CPU: (a)-(f)
    against the CPU path (there ``jit`` runs eagerly), the shadow estimates
    within 5 standard errors of the exact values."""
    assert cs._transform_checks(tct, "cpu", (), **cs.TRANSFORM_SMALL) == {}
