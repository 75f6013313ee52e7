"""The port's Pauli propagation (``models/pauliprop.py``) against the JAX
package's.

The dense engine's basis (order, ``basis``, ``index``, the rank of every
string) equals the JAX package's at n <= 6, k = 2 and 3, and its float32
coefficient vectors agree index for index (1e-5) through rx, ry, rz, h,
cnot, cz, rzz, swap and a random two-qubit unitary; at k = n the
expectation equals the dense state's (1e-5); the sparse host engine equals
the JAX package's; one input gives the same bits twice; and F15: the port
propagates ``h_layer`` and ``zzrx_layer`` (through ``_expanded_qir``) where
the JAX package raises ``KeyError: 'gate'`` (kept as a record).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.models import pauliprop as jpp
from tensorcircuit_ng_tpu_torch.models import pauliprop as ppp

TOL = 1e-5


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


@pytest.fixture(autouse=True)
def _cpu():
    with tct.set_device("cpu"):
        yield


def _random_unitary(rng, d):
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return np.linalg.qr(a)[0]


def brickwork(mod, n, layers, seed, **kw):
    """rx/ry/rz on every qubit, then cnot, cz, rzz, swap and a random
    two-qubit unitary on alternating pairs."""
    rng = np.random.default_rng(seed)
    c = mod.Circuit(n, **kw)
    for layer in range(layers):
        for q in range(n):
            a, b, g = rng.normal(size=3)
            c.rx(q, theta=a)
            c.ry(q, theta=b)
            c.rz(q, theta=g)
        c.h(layer % n)
        for k, q in enumerate(range(layer % 2, n - 1, 2)):
            kind = (layer + k) % 5
            if kind == 0:
                c.cnot(q, q + 1)
            elif kind == 1:
                c.cz(q, q + 1)
            elif kind == 2:
                c.rzz(q, q + 1, theta=rng.normal())
            elif kind == 3:
                c.swap(q, q + 1)
            else:
                c.any(q, q + 1, unitary=_random_unitary(rng, 4))
    return c


@pytest.mark.parametrize("n,k", [(4, 2), (5, 3), (6, 2), (6, 3)])
def test_basis_and_index_match_jax(n, k):
    je, pe = jpp.PauliPropagationEngine(n, k), ppp.PauliPropagationEngine(n, k, device="cpu")
    assert pe.dim == je.dim and pe.SINK == je.SINK
    assert pe.sites.shape == pe.codes.shape == (pe.dim, k)
    assert pe.basis == je.basis and pe.index == je.index
    assert torch.equal(pe._rank(pe.sites, pe.codes, pe.sites < n), torch.arange(pe.dim))
    rng = np.random.default_rng(n * 10 + k)
    for _ in range(20):
        ps = list(rng.integers(0, 4, size=n) * (rng.random(size=n) < 0.5))
        assert pe.string_to_code(ps) == je.string_to_code(ps)
        assert torch.equal(pe.observable_vector(ps), torch.as_tensor(np.asarray(je.observable_vector(ps))))


@pytest.mark.parametrize("n,k", [(5, 2), (5, 3), (6, 2), (6, 3)])
def test_coefficients_index_for_index(n, k):
    je, pe = jpp.PauliPropagationEngine(n, k), ppp.PauliPropagationEngine(n, k, device="cpu")
    cj, cp = brickwork(tc, n, 3, n + k), brickwork(tct, n, 3, n + k, device="cpu")
    for ps in ([3, 3] + [0] * (n - 2), [0, 1, 0, 2] + [0] * (n - 4), [3] + [0] * (n - 2) + [1]):
        vj = np.asarray(je.propagate(cj.to_qir(), ps))
        vp = pe.propagate(cp.to_qir(), ps)
        assert vp.dtype == torch.float32 and vp.shape == (pe.dim + 1,)
        assert np.abs(vp.numpy() - vj).max() <= TOL
        assert abs(float(pe.expectation_zero_state(vp)) - float(je.expectation_zero_state(vj))) <= TOL
    segs = [cp.to_qir()[: len(cp.to_qir()) // 2], cp.to_qir()[len(cp.to_qir()) // 2:]]
    jsegs = [cj.to_qir()[: len(cj.to_qir()) // 2], cj.to_qir()[len(cj.to_qir()) // 2:]]
    scan_p = pe.compute_expectation_scan(segs, [3, 3] + [0] * (n - 2))
    scan_j = np.asarray(je.compute_expectation_scan(jsegs, [3, 3] + [0] * (n - 2)))
    assert scan_p.shape == (3,) and np.abs(scan_p.numpy() - scan_j).max() <= TOL


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_k_equals_n_against_dense(dtype):
    n = 5
    with tct.set_dtype(dtype):
        c = brickwork(tct, n, 3, 5, device="cpu")
        eng = ppp.PauliPropagationEngine(n, n, device="cpu")
        for ps in ([3, 3, 0, 0, 0], [1, 0, 2, 0, 3], [0, 0, 3, 0, 0], [2, 2, 1, 1, 3]):
            x = [i for i, v in enumerate(ps) if v == 1]
            y = [i for i, v in enumerate(ps) if v == 2]
            z = [i for i, v in enumerate(ps) if v == 3]
            dense = float(torch.real(c.expectation_ps(x=x, y=y, z=z)))
            assert abs(float(eng.expectation(c, ps)) - dense) <= TOL


def test_sparse_engine_against_jax():
    n = 5
    cj, cp = brickwork(tc, n, 2, 3), brickwork(tct, n, 2, 3, device="cpu")
    for k in (2, 5):
        je, pe = jpp.SparsePauliPropagationEngine(n, k), ppp.SparsePauliPropagationEngine(n, k)
        dj = je.propagate(cj.to_qir(), [3, 0, 3, 0, 0])
        dp = pe.propagate(cp.to_qir(), [3, 0, 3, 0, 0])
        assert set(dj) == set(dp)
        assert max(abs(dj[key] - dp[key]) for key in dj) <= 1e-6
        assert abs(pe.expectation(cp, [3, 0, 3, 0, 0]) - je.expectation(cj, [3, 0, 3, 0, 0])) <= 1e-6
        sj = je.compute_expectation_scan([cj.to_qir()[:10], cj.to_qir()[10:]], [0, 3, 0, 0, 0])
        sp = pe.compute_expectation_scan([cp.to_qir()[:10], cp.to_qir()[10:]], [0, 3, 0, 0, 0])
        assert np.abs(np.asarray(sj) - np.asarray(sp)).max() <= 1e-6
    assert pe.string_to_code([0, 2, 0, 1, 0]) == je.string_to_code([0, 2, 0, 1, 0]) == ((1, 2), (3, 1))
    assert pe.get_initial_state([3, 0, 0, 0, 0]) == {((0, 3),): 1.0}


def test_dense_engine_same_bits_twice():
    n, k = 6, 3
    c = brickwork(tct, n, 3, 11, device="cpu")
    outs = [ppp.PauliPropagationEngine(n, k, device="cpu").propagate(c.to_qir(), [3, 3, 0, 0, 0, 0])]
    eng = ppp.PauliPropagationEngine(n, k, device="cpu")
    outs += [eng.propagate(c.to_qir(), [3, 3, 0, 0, 0, 0]) for _ in range(2)]  # maps built, then cached
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert len(eng._gate_map_cache) == len({tuple(it["index"]) for it in c.to_qir()})


def _fused_circuit(mod, **kw):
    c = mod.Circuit(4, **kw)
    c.h_layer()
    c.zzrx_layer([(0, 1), (1, 2), (2, 3)], np.array([0.3, -0.5, 0.7]), np.array([0.2, 0.4, -0.6, 0.9]))
    return c


def test_f15_fused_items_propagate():
    """Queue 3 F15: ``to_qir()``'s fused items carry no gate; the JAX package
    raises where the port propagates the expanded QIR."""
    cp, cj = _fused_circuit(tct, device="cpu"), _fused_circuit(tc)
    dense = float(torch.real(cp.expectation_ps(z=[0, 1])))
    assert abs(dense) > 0.1
    assert abs(float(tct.pauli_propagation(cp, [3, 3, 0, 0], k=4)) - dense) <= TOL
    eng = ppp.PauliPropagationEngine(4, 4, device="cpu")
    assert abs(float(eng.expectation(cp, [3, 3, 0, 0])) - dense) <= TOL
    assert abs(float(eng.compute_expectation_scan([cp.to_qir()], [3, 3, 0, 0])[-1]) - dense) <= TOL
    assert abs(ppp.SparsePauliPropagationEngine(4).expectation(cp, [3, 3, 0, 0]) - dense) <= TOL
    with pytest.raises(KeyError, match="gate"):
        jpp.pauli_propagation(cj, [3, 3, 0, 0], k=4)
    with pytest.raises(KeyError, match="gate"):
        jpp.PauliPropagationEngine(4, 2).expectation(cj, [3, 3, 0, 0])
    with pytest.raises(KeyError, match="gate"):
        jpp.SparsePauliPropagationEngine(4).expectation(cj, [3, 3, 0, 0])
    # the JAX engine over the expanded QIR, index for index (k = 2: the sink too)
    vj = np.asarray(jpp.PauliPropagationEngine(4, 2).propagate(cj._expanded_qir(), [3, 3, 0, 0]))
    vp = ppp.PauliPropagationEngine(4, 2, device="cpu").propagate(cp, [3, 3, 0, 0])
    assert np.abs(vp.numpy() - vj).max() <= TOL


def test_ptm_and_reference_names():
    je, pe = jpp.PauliPropagationEngine(3, 2), ppp.PauliPropagationEngine(3, 2, device="cpu")
    rng = np.random.default_rng(5)
    u1, u2 = _random_unitary(rng, 2), _random_unitary(rng, 4)
    assert np.abs(pe.get_ptm_1q(u1).numpy() - np.asarray(je.get_ptm_1q(u1))).max() <= 1e-6
    assert np.abs(pe.get_ptm_2q(u2).numpy() - np.asarray(je.get_ptm_2q(u2))).max() <= 1e-6
    ut = torch.as_tensor(u2, dtype=torch.complex64)
    assert np.abs(pe.get_ptm_2q(ut).numpy() - np.asarray(je.get_ptm_2q(u2))).max() <= 1e-6
    assert pe.string_to_code([1, 1, 1]) == pe.SINK == je.string_to_code([1, 1, 1])
    assert torch.equal(pe.get_initial_state([0, 3, 0]), pe.observable_vector([0, 3, 0]))


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.PauliPropagationEngine(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.pauli_propagation(_fused_circuit(tct, device="cpu"), [3, 3, 0, 0], k=2, device="cuda")
