"""The QuOperator family of the port's ``quantum.py`` against the JAX
package's, on the CPU: the QuOperator cases of ``tests/test_quantum.py`` and
``tests/test_refparity_quantum.py`` (the algebra, scalar-only products, the
two routes to an expectation, the projector, non-square operators, the
local embedding, the partial trace, ``tn2qop``, ``generate_local_hamiltonian``
and the node-graph names), and the circuit methods that end in one:
``get_quvector``/``quvector``, ``get_quoperator`` and its aliases, ``mpo``
(a QuOperator, MPO tensors, a matrix), ``DMCircuit.get_dm_as_quoperator``,
and ``mps_inputs=`` of ``Circuit`` (an ``MPSCircuit``, a ``FiniteMPS``, a
list of tensors, a QuVector) and of ``DMCircuit``, where the JAX package
ignores it (Queue 3 F7): the port is held against the JAX ``DMCircuit`` of
the dense input.

Tolerances: complex64 1e-5, complex128 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import quantum as jqu
from tensorcircuit_ng_tpu.models.mpscircuit import MPSCircuit as JMPS

qu = tct.quantum
TOL = {"complex64": 1e-5, "complex128": 1e-10}
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: xdist runs six modules at once, and
    these small decompositions, on eight threads each, oversubscribe the
    cores (10-40x their time alone under the tier-1 run)."""
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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _cplx(rng, shape, dtype):
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return a.astype(np.complex64 if dtype == "complex64" else np.complex128)


def _same(got, want, tol):
    """The same class name, legs and values."""
    assert type(got).__name__ == type(want).__name__
    assert got.out_dims == tuple(want.out_dims) and got.in_dims == tuple(want.in_dims)
    _close(got.eval(), want.eval(), tol)


def test_algebra_matches_jax(dtype):
    rng = np.random.default_rng(0)
    tol = TOL[dtype]
    a, b, v = _cplx(rng, (2, 2, 2, 2), dtype), _cplx(rng, (2, 2, 2, 2), dtype), _cplx(rng, (2, 2), dtype)
    ta, tb, tv = qu.QuOperator.from_tensor(a), qu.QuOperator.from_tensor(b), qu.QuVector.from_tensor(v)
    ja, jb, jv = (jqu.QuOperator.from_tensor(jnp.asarray(a)), jqu.QuOperator.from_tensor(jnp.asarray(b)),
                  jqu.QuVector.from_tensor(jnp.asarray(v)))
    for got, want in [
        (ta @ tb, ja @ jb), (ta @ tv, ja @ jv), (tv.adjoint() @ ta @ tv, jv.adjoint() @ ja @ jv),
        (ta | tb, ja | jb), (ta.tensor_product(tv), ja.tensor_product(jv)), (ta.adjoint(), ja.adjoint()),
        (ta + tb, ja + jb), (ta - tb, ja - jb), (-ta, -ja), (ta * 2.5, ja * 2.5), (0.5j * ta, 0.5j * ja),
        (ta / 4.0, ja / 4.0), (ta.partial_trace([1]), ja.partial_trace([1])), (ta.trace(), ja.trace()),
        (ta.norm(), ja.norm()), (tv.projector(), jv.projector()), (tv.reduced_density([0]), jv.reduced_density([0])),
        (tv.reduced_density_matrix([1]), jv.reduced_density_matrix([1])),
        (qu.QuAdjointVector.from_tensor(v).reduced_density([1]),
         jqu.QuAdjointVector.from_tensor(jnp.asarray(v)).reduced_density([1])),
        (ta.copy(), ja.copy()), (qu.eliminate_identities(qu.QuOperator.from_tensor(a.reshape(2, 1, 2, 2, 2, 1),
                                                                                   [0, 1, 2], [3, 4, 5])),
                                 jqu.eliminate_identities(jqu.QuOperator.from_tensor(
                                     jnp.asarray(a.reshape(2, 1, 2, 2, 2, 1)), [0, 1, 2], [3, 4, 5]))),
    ]:
        _same(got, want, tol * 10)
    _close((ta @ v.reshape(4)).eval(), (ja @ jnp.asarray(v.reshape(4))).eval(), tol * 10)
    assert ta.shape == ja.shape == (4, 4) and tv.shape == jv.shape == (4, 1)
    assert tv.space == jv.space and tv.subsystem_edges == jv.subsystem_edges
    assert ta.in_space == ja.in_space and ta.out_space == ja.out_space
    assert (ta.is_scalar, tv.is_vector, tv.adjoint().is_adjoint_vector) == (False, True, True)
    assert qu.get_all_nodes([ta, tv])[1] is tv.nodes[0] and qu.reachable(ta)[0] is ta._t
    assert ta.contract() is ta
    ta.check_network()
    qu.check_spaces([ta, tb, tv])
    with pytest.raises(ValueError, match="incompatible"):
        qu.check_spaces([tv, ta])
    _close(qu.extract_tensors_from_qop(ta), a.reshape(4, 4), 0)


def test_scalar_products_and_their_errors(dtype):
    """``tests/test_refparity_quantum.py::test_mul_semantics``."""
    mat = np.eye(2)
    op = qu.QuOperator.from_tensor(mat, [0], [1])
    sc = qu.QuScalar.from_tensor(np.float64(0.5))
    for got in ((op * sc).eval(), (sc * op).eval(), (op * np.float64(0.5)).eval(), (np.float64(0.5) * op).eval(),
                (op / qu.QuScalar(2.0)).eval()):
        _close(got, mat * 0.5, 1e-12)
    assert isinstance(sc * op, qu.QuOperator) and isinstance(sc * sc, qu.QuScalar)
    _close((sc * sc).eval(), 0.25, 1e-12)
    _close((op * torch.tensor(0.5)).eval(), mat * 0.5, 1e-12)
    with pytest.raises(ValueError):
        _ = op * op
    with pytest.raises(ValueError):
        _ = op * mat


def test_refparity_cases(dtype):
    """``tests/test_refparity_quantum.py``'s QuOperator cases."""
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    psi = qu.QuVector.from_tensor(rng.random((2, 2)))
    pp = psi.tensor_product(psi)
    assert len(pp.subsystem_edges) == 4
    np.testing.assert_allclose(complex(pp.norm().eval()), complex(psi.norm().eval()) ** 2, rtol=1e-12)
    rng = np.random.default_rng(1)
    pt = rng.random((2, 2, 2)) + 1j * rng.random((2, 2, 2))
    ot = rng.random((2, 2)) + 1j * rng.random((2, 2))
    psi = qu.QuVector.from_tensor(pt)
    op = qu.QuOperator.from_tensor(ot, [0], [1])
    op3 = op.tensor_product(qu.identity((2, 2), dtype=dtype, device="cpu"))
    r1 = complex((psi.adjoint() @ op3 @ psi).eval())
    r2 = complex((op @ psi.reduced_density([1, 2])).trace().eval())
    np.testing.assert_allclose(r1, r2, rtol=1e-5 if dtype == "complex64" else 1e-12)
    pt2 = np.random.default_rng(2).random((2, 2))
    pt2 /= np.linalg.norm(pt2)
    p = qu.QuVector.from_tensor(pt2).projector()
    _close((p @ qu.QuVector.from_tensor(pt2)).eval(), pt2, tol)
    _close((p @ p).eval(), p.eval(), tol)
    a = qu.QuOperator.from_tensor(np.ones([2] * 5), [0, 1, 2], [3, 4])
    b = qu.QuOperator.from_tensor(np.ones([2] * 5), [0, 1], [2, 3, 4])
    _close((a @ b).eval(), 4 * np.ones([2] * 6), 0)
    ja = jqu.QuOperator.from_tensor(jnp.ones([2] * 5), [0, 1, 2], [3, 4])
    assert a.out_dims == ja.out_dims and a.in_dims == ja.in_dims


def test_constructors_match_jax(dtype):
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    t = _cplx(rng, (2, 3, 2, 3), dtype)
    for axes in (dict(out_axes=[1, 0]), dict(in_axes=[0, 2]), dict(out_axes=[3], in_axes=[0, 1, 2])):
        _same(qu.QuOperator.from_tensor(t, **axes), jqu.QuOperator.from_tensor(jnp.asarray(t), **axes), tol)
    _same(qu.QuVector.from_tensor(t, [2, 0, 3, 1]), jqu.QuVector.from_tensor(jnp.asarray(t), [2, 0, 3, 1]), tol)
    loc = _cplx(rng, (3, 2, 3, 2), dtype)
    _same(qu.QuOperator.from_local_tensor(loc, (2, 3, 2), [1, 2]),
          jqu.QuOperator.from_local_tensor(jnp.asarray(loc), (2, 3, 2), [1, 2]), tol)
    _same(qu.identity((2, 3), device="cpu"), jqu.identity((2, 3)), 0)
    assert qu.identity((2,), device="cpu")._t.dtype == tct.config.torch_dtype()
    for out_dims, in_dims in (((2, 2), (2,)), ((2,), ()), ((), (2,)), ((), ())):
        size = int(np.prod(out_dims + in_dims))
        flat = np.arange(size, dtype=np.float64) + 1.0
        _same(qu.quantum_constructor(out_dims, in_dims, flat),
              jqu.quantum_constructor(out_dims, in_dims, jnp.asarray(flat)), 1e-6)
    z = np.diag([1.0, -1.0])
    h = qu.generate_local_hamiltonian(np.kron(z, z).reshape(2, 2, 2, 2), X)
    _close(h, np.kron(np.kron(z, z), X), 1e-12)
    hq = qu.generate_local_hamiltonian(X, z, matrix_form=False)
    _same(hq, jqu.generate_local_hamiltonian(X, z, matrix_form=False), 1e-6)


def test_tn2qop_matches_jax(dtype):
    """``tests/test_quantum.py::test_mpo_interop_vendored_fixtures``' chain:
    the bond-3 transverse-field Ising MPO against the dense Hamiltonian."""
    L, g = 4, 0.7
    W = np.zeros((3, 3, 2, 2))
    W[0, 0] = W[2, 2] = np.eye(2)
    W[0, 1] = Z
    W[1, 2] = -Z
    W[0, 2] = -g * X
    Ws = [W[:1]] + [W] * (L - 2) + [W[:, 2:]]
    chain = [np.transpose(w, (0, 2, 3, 1)) for w in Ws]
    h_dense = sum(-np.kron(np.kron(np.eye(2**i), np.kron(Z, Z)), np.eye(2 ** (L - i - 2))) for i in range(L - 1))
    h_dense = h_dense + sum(-g * np.kron(np.kron(np.eye(2**i), X), np.eye(2 ** (L - i - 1))) for i in range(L))
    q = qu.tn2qop(chain)
    _close(q.eval_matrix(), h_dense, 1e-12)
    _same(q, jqu.tn2qop([jnp.asarray(w) for w in chain]), 1e-5)
    # MPSCircuit.gate_to_mpo's factors contract back through tn2qop
    gate = np.linalg.qr(_cplx(np.random.default_rng(4), (8, 8), dtype))[0]
    with tct.set_device("cpu"):
        _close(qu.tn2qop(tct.MPSCircuit(3).gate_to_mpo(gate, 3)).eval_matrix(), gate, 10 * TOL[dtype])


def _circuit(mod, n=4, **kw):
    c = mod.Circuit(n, **kw)
    for i in range(n):
        c.ry(i, theta=0.3 * i + 0.2)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    c.rzz(0, n - 1, theta=0.4)
    return c


def test_circuit_quvector_quoperator_and_mpo_match_jax(dtype):
    tol = TOL[dtype]
    t, j = _circuit(tct), _circuit(tc)
    for got, want in ((t.get_quvector(), j.get_quvector()), (t.quvector(), j.quvector()),
                      (t.get_quoperator(), j.get_quoperator()), (t.quoperator(), j.quoperator()),
                      (t.get_circuit_as_quoperator(), j.get_circuit_as_quoperator())):
        _same(got, want, 10 * tol)
    _close(t.get_quoperator().eval_matrix(), t.matrix(), 0)
    _close(t.get_quvector().eval().reshape(-1), t.state(), 0)
    gate = np.linalg.qr(_cplx(np.random.default_rng(5), (8, 8), dtype))[0]
    mpo = [x.numpy() for x in tct.MPSCircuit(3, device="cpu").gate_to_mpo(gate, 3)]
    for arg in (mpo, qu.tn2qop(mpo), gate):
        tm, jm = _circuit(tct), _circuit(tc)
        tm.mpo(0, 2, 3, mpo=arg)
        jarg = [jnp.asarray(w) for w in mpo] if isinstance(arg, list) else (
            jqu.tn2qop([jnp.asarray(w) for w in mpo]) if isinstance(arg, qu.QuOperator) else jnp.asarray(gate))
        jm.mpo(0, 2, 3, mpo=jarg)
        _close(tm.state(), jm.state(), 10 * tol)
        assert tm.to_qir()[-1]["name"] == "mpo"
    # the reference case: quvector chaining and replacement (test_circuit.py:692)
    c = tct.Circuit(2)
    c.x(0)
    c2 = tct.Circuit(2, mps_inputs=c.quvector())
    c2.x(0)
    _close(c2.state(), [1.0, 0, 0, 0], tol)
    c3 = tct.Circuit(2)
    c3.x(0)
    c3.replace_mps_inputs(c.quvector())
    _close(c3.state(), [1.0, 0, 0, 0], tol)


def _mps(mod, n=5):
    m = mod(n) if mod is JMPS else mod(n, device="cpu")
    for i in range(n):
        m.ry(i, theta=0.4 * i + 0.1)
    for i in range(n - 1):
        m.cnot(i, i + 1)
    m.rzz(1, 3, theta=0.9)
    return m


def test_mps_inputs_of_circuit_match_jax(dtype):
    """``mps_inputs=`` as an MPSCircuit, a FiniteMPS, a list of (l, d, r)
    tensors and a QuVector, on both packages, then more gates."""
    tol = TOL[dtype]
    t, j = _mps(tct.MPSCircuit), _mps(JMPS)
    kinds = [(t, j), (tct.FiniteMPS(t.tensors, canonicalize=False), tc.FiniteMPS(j.tensors, canonicalize=False)),
             ([_np(x) for x in t.tensors], list(j.tensors)), (t.get_quvector(), j.get_quvector())]
    for tin, jin in kinds:
        ct, cj = tct.Circuit(5, mps_inputs=tin), tc.Circuit(5, mps_inputs=jin)
        for c in (ct, cj):
            c.h(2)
            c.cz(0, 4)
        _close(ct.state(), cj.state(), 10 * tol)
        ct.replace_mps_inputs(tin)
        _close(ct.state(), cj.state(), 10 * tol)
    _close(tct.Circuit(5, mps_inputs=t).state(), t.wavefunction(), tol)


def test_dmcircuit_mps_inputs_and_quoperator(dtype):
    """The port's ``DMCircuit(mps_inputs=)`` is the pure ρ of the MPS state:
    against the JAX ``DMCircuit(inputs=dense)``.  The JAX ``DMCircuit``
    drops ``mps_inputs`` and starts from |0...0> (Queue 3 F7)."""
    tol = TOL[dtype]
    t, j = _mps(tct.MPSCircuit), _mps(JMPS)
    psi = np.asarray(j.wavefunction())
    for cls in ("DMCircuit", "DMCircuit2"):
        dt = getattr(tct, cls)(5, mps_inputs=t)
        dj = getattr(tc, cls)(5, inputs=jnp.asarray(psi))
        for d in (dt, dj):
            d.depolarizing(2, px=0.05, py=0.02, pz=0.1)
            d.cnot(0, 4)
        _close(dt.densitymatrix(), dj.densitymatrix(), 10 * tol)
        _same(dt.get_dm_as_quoperator(), dj.get_dm_as_quoperator(), 10 * tol)
    rho_f7 = np.asarray(tc.DMCircuit(5, mps_inputs=j.get_tensors()).densitymatrix())
    assert abs(rho_f7[0, 0] - 1.0) < 1e-6 and abs(np.trace(rho_f7) - 1.0) < 1e-6
    assert abs(rho_f7[0, 0] - abs(psi[0]) ** 2) > 0.1
    # Queue 3 F7's case: X_0 H_2 |000> as MPS tensors
    m = tct.MPSCircuit(3, device="cpu")
    m.x(0)
    m.h(2)
    rho = _np(tct.DMCircuit(3, mps_inputs=m.get_tensors()).densitymatrix())
    want = np.zeros(8)
    want[[4, 5]] = 1 / np.sqrt(2)
    _close(rho, np.outer(want, want), tol)
