"""The port's ``QuditCircuit`` (with ``ops/quditgates.py``) and ``U1Circuit``
against the JAX package's.

States, expectations and the gradient of one energy each (``torch.autograd``
against ``jax.grad``) at complex64 (1e-5) and complex128 (1e-10): qudits at
d = 3 and 4, every gate factory with float and tensor angles; the U(1)
sector at n = 8, k = 4 (number-conserving XY rotations, ``rz``, ``rzz``,
``cz``, ``cphase``, ``z``), the sector basis (vectorized) equal to the JAX
package's, the number-violation ``ValueError``, ``return_blocks``,
sampling with a given status (equal indices), ``U1Operator`` and the
readouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.models.u1circuit import U1Operator as JU1Operator
from tensorcircuit_ng_tpu.models.u1circuit import _sector_basis as jbasis
from tensorcircuit_ng_tpu.ops import quditgates as jqg
from tensorcircuit_ng_tpu_torch.models.u1circuit import _sector_basis as pbasis
from tensorcircuit_ng_tpu_torch.ops import quditgates as pqg

TOL = {"complex64": 1e-5, "complex128": 1e-10}


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


def _rdt(dtype):
    return torch.float64 if dtype == "complex128" else torch.float32


# ---------------------------------------------------------------- qudits

GATE_CASES = [
    ("rx_matrix_func", (0.37, 0, 2)),
    ("ry_matrix_func", (-0.81, 1, 2)),
    ("rz_matrix_func", (1.3, 0, 1)),
    ("phase_matrix_func", (0.4, 2)),
    ("rzz_matrix_func", (0.9, 0, 1, 2, 0)),
    ("rxx_matrix_func", (-0.6, 1, 2, 0, 1)),
]


@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("name,args", GATE_CASES, ids=[g for g, _ in GATE_CASES])
def test_quditgates_float_and_tensor_angles(dtype, d, name, args):
    want = np.asarray(getattr(jqg, name)(d, *args))
    got = getattr(pqg, name)(d, *args)
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, atol=TOL[dtype])
    t = torch.tensor(args[0], dtype=_rdt(dtype), requires_grad=True)
    gt = getattr(pqg, name)(d, t, *args[1:])
    assert gt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(gt), want, atol=TOL[dtype])
    (g,) = torch.autograd.grad(torch.real(gt.sum()), t)
    jg = jax.grad(lambda a: jnp.real(jnp.sum(getattr(jqg, name)(d, a, *args[1:]))))(jnp.asarray(args[0]))
    assert abs(g.item() - float(jg)) < 10 * TOL[dtype]


@pytest.mark.parametrize("d", [3, 4, 5])
def test_quditgates_fixed(dtype, d):
    for name in ("i_matrix_func", "x_matrix_func", "z_matrix_func", "h_matrix_func", "s_matrix_func",
                 "swap_matrix_func"):
        np.testing.assert_allclose(getattr(pqg, name)(d), np.asarray(getattr(jqg, name)(d)), atol=TOL[dtype])
    for cv in (None, 0, d - 1):
        np.testing.assert_allclose(pqg.csum_matrix_func(d, cv), np.asarray(jqg.csum_matrix_func(d, cv)))
        np.testing.assert_allclose(pqg.cphase_matrix_func(d, cv), np.asarray(jqg.cphase_matrix_func(d, cv)),
                                   atol=TOL[dtype])
        np.testing.assert_allclose(pqg.cphase_matrix_func(d, cv, 0.3), np.asarray(jqg.cphase_matrix_func(d, cv, 0.3)),
                                   atol=TOL[dtype])
    w = np.exp(2j * np.pi / 7)
    np.testing.assert_allclose(pqg.z_matrix_func(d, w), np.asarray(jqg.z_matrix_func(d, w)), atol=TOL[dtype])
    for key, (_, builder) in pqg.SINGLE_BUILDERS.items():
        if key == "U8" and d != 3:
            continue
        np.testing.assert_allclose(builder(d, theta=0.2, gamma=0.1, z=0.3, eps=0.5),
                                   np.asarray(jqg.SINGLE_BUILDERS[key][1](d, theta=0.2, gamma=0.1, z=0.3, eps=0.5)),
                                   atol=TOL[dtype])
    for key, (_, builder) in pqg.TWO_BUILDERS.items():
        np.testing.assert_allclose(builder(d, theta=0.2), np.asarray(jqg.TWO_BUILDERS[key][1](d, theta=0.2)),
                                   atol=TOL[dtype])


def test_quditgates_errors():
    with pytest.raises(ValueError, match="out of range"):
        pqg.rzz_matrix_func(3, 0.1, 0, 3)
    with pytest.raises(ValueError, match="distinct"):
        pqg.rxx_matrix_func(3, 0.1, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="qutrits"):
        pqg.u8_matrix_func(4)
    with pytest.raises(ValueError, match="cv must be"):
        pqg.csum_matrix_func(3, 5)


def qudit_program(mod, d, th, **kw):
    """Every named qudit gate on n=4, angles from ``th``."""
    c = mod.QuditCircuit(4, dim=d, **kw)
    for q in range(4):
        c.h(q)
    c.rx(0, theta=th[0], j=0, k=2)
    c.ry(1, theta=th[1], j=1, k=2)
    c.rz(2, theta=th[2])
    c.phase(3, theta=th[3], j=2)
    c.csum(0, 1)
    c.cnot(1, 2)
    c.rzz(2, 3, theta=th[4])
    c.rxx(0, 3, theta=th[5], j1=0, k1=1, j2=1, k2=2)
    c.cphase(1, 2, theta=th[6])
    c.cphase(0, 2)
    c.x(1)
    c.z(2)
    c.swap(0, 3)
    c.i(1)
    if d == 3:
        c.u8(1, gamma=th[7], z=th[8], eps=th[9])
    return c


@pytest.mark.parametrize("d", [3, 4])
def test_qudit_state_energy_and_grad(dtype, d):
    th = np.random.default_rng(d).normal(size=10)
    want = np.asarray(jax.jit(lambda a: qudit_program(tc, d, a).state())(jnp.asarray(th)))
    c = qudit_program(tct, d, th)
    assert c.dim == d and c.nqudits == 4 and c.device.type == "cpu"
    np.testing.assert_allclose(_np(c.state()), want, atol=TOL[dtype])
    op = np.diag(np.arange(d) - (d - 1) / 2.0) + 0.3 * (np.eye(d, k=1) + np.eye(d, k=-1))

    def je(t):
        cc = qudit_program(tc, d, t)
        return jnp.real(sum(cc.expectation((op, [q])) for q in range(4)))

    t = torch.tensor(th, dtype=_rdt(dtype), requires_grad=True)
    cc = qudit_program(tct, d, t)
    e = torch.real(sum(cc.expectation((op, [q])) for q in range(4)))
    (g,) = torch.autograd.grad(e, t)
    je_val, je_grad = jax.jit(jax.value_and_grad(je))(jnp.asarray(th))
    assert abs(e.item() - float(je_val)) < TOL[dtype]
    np.testing.assert_allclose(g.numpy(), np.asarray(je_grad), atol=10 * TOL[dtype])


def test_qudit_sampling_and_errors():
    th = np.random.default_rng(0).normal(size=10)
    jc = qudit_program(tc, 3, th)
    with tct.set_device("cpu"):
        pc = qudit_program(tct, 3, th)
        st = np.random.default_rng(1).random(32)
        got = pc.sample(32, allow_state=True, status=st, format="count_dict_bin")
        assert got == jc.sample(32, allow_state=True, status=jnp.asarray(st), format="count_dict_bin")
        assert all(len(k) == 4 and set(k) <= set("012") for k in got)
        with pytest.raises(NotImplementedError, match="qubit-specific"):
            pc.expectation_ps(z=[0])
        with pytest.raises(ValueError, match="dim must be"):
            tct.QuditCircuit(2, dim=37)
        c2 = tct.QuditCircuit(2, dim=2)
        c2.h(0)
        assert abs(c2.expectation_ps(x=[0]).real.item() - 1.0) < 1e-6
        cp = pc.copy()
        np.testing.assert_allclose(_np(cp.state()), _np(pc.state()), atol=1e-7)


# ------------------------------------------------------------------ U(1)


@pytest.mark.parametrize("n,k", [(1, 0), (1, 1), (6, 3), (9, 2), (12, 7), (12, 12)])
def test_sector_basis_equals_jax(n, k):
    got = pbasis(n, k)
    assert got.dtype == np.int64 and np.array_equal(got, jbasis(n, k))
    assert np.array_equal(got, tct.quantum.u1_inds(n, k))


def xy(t, lib):
    """exp(-i t (XX + YY)/2): the number-conserving hopping rotation."""
    if lib is torch:
        cdt = tct.config.torch_dtype()
        c, s = torch.cos(t).to(cdt), torch.sin(t).to(cdt)
        z, o = torch.zeros((), dtype=cdt), torch.ones((), dtype=cdt)
        return torch.stack([torch.stack([o, z, z, z]), torch.stack([z, c, -1j * s, z]),
                            torch.stack([z, -1j * s, c, z]), torch.stack([z, z, z, o])])
    c, s = jnp.cos(t), jnp.sin(t)
    return jnp.array([[1, 0, 0, 0], [0, c, -1j * s, 0], [0, -1j * s, c, 0], [0, 0, 0, 1]])


U1_N, U1_K = 8, 4


def u1_program(mod, th, lib, **kw):
    """Two brick layers of XY rotations with rz, rzz, cz, cphase, z."""
    c = mod.U1Circuit(U1_N, k=U1_K, **kw)
    i = 0
    for layer in range(2):
        for a in range(layer % 2, U1_N - 1, 2):
            c.unitary(a, a + 1, unitary=xy(th[i], lib))
            i += 1
        for q in range(U1_N):
            c.rz(q, theta=th[i % len(th)])
            i += 1
        c.rzz(0, 5, theta=th[3])
        c.cz(1, 2)
        c.cphase(2, 6, theta=th[5])
        c.z(3)
    c.swap(0, 7)
    c.iswap(3, 4)
    return c


def u1_energy(c):
    return sum(c.expectation_ps(z=[q, q + 1]) for q in range(U1_N - 1))


def test_u1_state_energy_and_grad(dtype):
    th = np.random.default_rng(1).normal(size=30)
    jc = u1_program(tc, jnp.asarray(th), jnp)
    pc = u1_program(tct, torch.tensor(th), torch)
    assert pc.sector_dim == 70 and pc.basis.dtype == torch.int64 and pc.state().device.type == "cpu"
    np.testing.assert_allclose(_np(pc.state()), np.asarray(jc.state()), atol=TOL[dtype])
    np.testing.assert_allclose(_np(pc.to_dense()), np.asarray(jc.to_dense()), atol=TOL[dtype])
    t = torch.tensor(th, dtype=_rdt(dtype), requires_grad=True)
    e = torch.real(u1_energy(u1_program(tct, t, torch)))
    (g,) = torch.autograd.grad(e, t)

    def je(a):
        return jnp.real(u1_energy(u1_program(tc, a, jnp)))

    je_val, je_grad = jax.jit(jax.value_and_grad(je))(jnp.asarray(th))
    assert abs(e.item() - float(je_val)) < TOL[dtype]
    np.testing.assert_allclose(g.numpy(), np.asarray(je_grad), atol=10 * TOL[dtype])


def test_u1_readouts(dtype):
    th = np.random.default_rng(2).normal(size=30)
    jc = u1_program(tc, jnp.asarray(th), jnp)
    pc = u1_program(tct, torch.tensor(th), torch)
    tol = TOL[dtype]
    for q in range(U1_N):
        assert abs(pc.expectation_z(q).item() - float(jc.expectation_z(q))) < tol
    for x, y, z in [([0, 1], None, None), (None, [2, 3], [5]), ([4], [5], None), (None, None, [0, 3])]:
        assert abs(pc.expectation_ps(x=x, y=y, z=z).item() - complex(jc.expectation_ps(x=x, y=y, z=z))) < tol
    assert abs(pc.expectation_two_body(0, 3).item() - complex(jc.expectation_two_body(0, 3))) < tol
    assert abs(pc.entanglement_entropy([0, 1, 2]).item() - float(jc.entanglement_entropy([0, 1, 2]))) < 10 * tol
    np.testing.assert_allclose(_np(pc.probability()), np.asarray(jc.probability()), atol=tol)
    np.testing.assert_allclose(_np(pc.probability_full()), np.asarray(jc.probability_full()), atol=tol)
    ps = [[3, 3, 0, 0, 0, 0, 0, 0], {"x": [1, 2]}, [2, 2, 0, 0, 0, 0, 0, 0]]
    w = [1.0, 0.5, -0.5]
    assert abs(pc.expectation_pss(ps, w).item() - float(jc.expectation_pss(ps, w))) < tol
    rho = pc.reduced_density_matrix([0, 1, 2])
    np.testing.assert_allclose(_np(rho), np.asarray(jc.reduced_density_matrix([0, 1, 2])), atol=tol)
    blocks = pc.reduced_density_matrix(subsystem_to_traceout=[3, 4, 5, 6, 7], return_blocks=True)
    want = jc.reduced_density_matrix(subsystem_to_traceout=[3, 4, 5, 6, 7], return_blocks=True)
    assert [b.shape for b in blocks] == [tuple(np.asarray(b).shape) for b in want] == [(1, 1), (3, 3), (3, 3), (1, 1)]
    for a, b in zip(blocks, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=tol)
    with pytest.raises(ValueError, match="specify one"):
        pc.reduced_density_matrix()


@pytest.mark.parametrize("fmt", [None, "sample_int", "sample_bin", "count_dict_bin"])
def test_u1_sampling_with_status(dtype, fmt):
    th = np.random.default_rng(3).normal(size=30)
    jc = u1_program(tc, jnp.asarray(th), jnp)
    pc = u1_program(tct, torch.tensor(th), torch)
    st = np.random.default_rng(4).random((64, U1_N))
    got, want = pc.sample(64, status=st, format=fmt), jc.sample(64, status=jnp.asarray(st), format=fmt)
    if fmt is None:
        assert all(np.array_equal(_np(a), np.asarray(b)) for (a, _), (b, _) in zip(got, want))
    elif fmt == "count_dict_bin":
        assert got == want
    else:
        assert np.array_equal(_np(got), np.asarray(want))
    bits, p = pc.measure(0, 3, 5, with_prob=True, status=st[:1, 0])
    jbits, jp = jc.measure(0, 3, 5, with_prob=True, status=jnp.asarray(st[:1, 0]))
    assert np.array_equal(_np(bits), np.asarray(jbits)) and abs(p.item() - float(jp)) < TOL[dtype]
    assert all(bin(int(v)).count("1") == U1_K for v in _np(pc.sample(16, format="sample_int")))


def test_u1_number_violation_raises():
    with tct.set_device("cpu"):
        c = tct.U1Circuit(4, filled=[0, 2])
        for apply in (lambda: c.x(0), lambda: c.rxx(0, 1, theta=0.3), lambda: c.h(1),
                      lambda: c.unitary(0, 1, unitary=np.kron(np.eye(2), [[0, 1], [1, 0]]))):
            with pytest.raises(ValueError, match="not particle-number conserving"):
                apply()
        t = torch.tensor(0.3, requires_grad=True)
        with pytest.raises(ValueError, match="not particle-number conserving"):
            c.unitary(0, 1, unitary=torch.linalg.matrix_exp(-1j * t * torch.as_tensor(
                np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]), dtype=torch.complex64)))
        with pytest.raises(ValueError, match="filled=|k="):
            tct.U1Circuit(4)


def test_u1_maps_cached_and_copy():
    with tct.set_device("cpu"):
        c = tct.U1Circuit(6, k=3)
        c.unitary(0, 1, unitary=xy(torch.tensor(0.4), torch))
        c.unitary(0, 1, unitary=xy(torch.tensor(0.2), torch))
        c.unitary(2, 1, unitary=xy(torch.tensor(0.1), torch))
        assert sorted(c._maps) == [(0, 1), (2, 1)]
        d = c.copy()
        assert d._maps is c._maps and torch.equal(d.state(), c.state())
        assert d._copy_params() == {"nqubits": 6, "filled": None, "k": 3, "device": torch.device("cpu")}
        before = c.state().clone()
        c.unitary(0, 1, unitary=xy(torch.tensor(0.4), torch))
        c2 = tct.U1Circuit(6, k=3, inputs=before)
        c2.unitary(0, 1, unitary=xy(torch.tensor(0.4), torch))
        assert torch.equal(c2.state(), c.state())


def test_u1_operator(dtype):
    ps = [[3, 3, 0, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0], [2, 2, 0, 0, 0, 0, 0, 0], {"z": [4, 7]}]
    w = [1.0, 0.5, 0.5, -0.3]
    jo = JU1Operator(U1_N, U1_K, ps, w)
    po = tct.U1Operator(U1_N, U1_K, ps, w, device="cpu")
    np.testing.assert_allclose(_np(po.matrix), np.asarray(jo.matrix), atol=1e-12)
    th = np.random.default_rng(5).normal(size=30)
    jc = u1_program(tc, jnp.asarray(th), jnp)
    pc = u1_program(tct, torch.tensor(th), torch)
    np.testing.assert_allclose(_np(po(pc.state())), np.asarray(jo(jc.state())), atol=TOL[dtype])
    np.testing.assert_allclose(_np(po.matvec(pc.state())), np.asarray(jo.matvec(jc.state())), atol=TOL[dtype])
    assert abs(po.expectation(pc.state()).item() - complex(jo.expectation(jc.state()))) < TOL[dtype]
