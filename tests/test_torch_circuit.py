"""The port's circuit path against the JAX package, on the CPU.

``tensorcircuit_ng_tpu_torch.Circuit(..., device="cpu")`` and
``tensorcircuit_ng_tpu.Circuit`` get the same numpy-seeded parameters (the
benchmark's ``(L, 2, n)`` grid, scaled by 0.1) and must agree on the TFIM
energy and on ``state()``.  Both take their CPU branch: the stack path on
float32 planes for complex64 n > 7, the per-layer path otherwise.

Tolerances (complex64): both sides sum in float32 in another order.  The
energy is a sum of ~2n terms of size <= 1, so an absolute 2e-5 * n; the
state is a unit vector, so its difference in 2-norm within 2e-6.  complex128
keeps the dense formulation in float64 on both sides: 1e-10.
"""

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels_grand, kernels_rowlayer, statevec


def _pairs(n, periodic):
    return [(i, (i + 1) % n) for i in range(n if periodic else n - 1)]


def _grid(n, L, seed):
    return np.random.default_rng(seed).normal(size=(L, 2, n)) * 0.1


def _build(mod, n, L, pairs, grid, **kw):
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for l in range(L):
        c.zzrx_layer(pairs, grid[l, 0, : len(pairs)], grid[l, 1])
    return c


def _both(n, L, periodic, weights, seed):
    pairs = _pairs(n, periodic)
    grid = _grid(n, L, seed)
    cj = _build(tc, n, L, pairs, np.asarray(grid, np.float32))
    ct = _build(tct, n, L, pairs, convert.params(grid, "cpu"), device="cpu")
    ej = float(cj.expectation_zzx_energy(pairs, *weights))
    et = ct.expectation_zzx_energy(pairs, *weights)
    return cj, ct, ej, et


@pytest.mark.parametrize(
    "n,L,periodic,weights",
    [
        (8, 3, False, (1.0, -1.0)),  # stack path, nouter 0
        (8, 4, True, (0.7, -1.3)),
        (12, 3, False, (1.0, -1.0)),
        (12, 4, False, (0.7, -1.3)),
        (20, 4, False, (1.0, -1.0)),  # the benchmark shape: nouter 3
        (20, 3, True, (0.7, -1.3)),
    ],
)
def test_energy_and_state_match_jax(n, L, periodic, weights):
    cj, ct, ej, et = _both(n, L, periodic, weights, seed=100 + n + L)
    assert et.device.type == "cpu" and et.dtype == torch.float32
    assert abs(et.item() - ej) <= 2e-5 * n, (et.item(), ej)
    sj = np.asarray(cj.state())
    st = convert.to_numpy(ct.state())
    assert st.shape == sj.shape == (2**n,) and st.dtype == np.complex64
    assert np.linalg.norm(st - sj) <= 2e-6


def test_complex128_matches_jax():
    tc.set_dtype("complex128")
    try:
        with tct.set_dtype("complex128"):
            cj, ct, ej, et = _both(10, 3, False, (0.7, -1.3), seed=11)
            sj = np.asarray(cj.state())
            st = convert.to_numpy(ct.state())
    finally:
        tc.set_dtype("complex64")
    assert et.dtype == torch.float64
    assert abs(et.item() - ej) <= 1e-10
    assert st.dtype == np.complex128
    np.testing.assert_allclose(st, sj, atol=1e-10)


def test_cpu_circuit_launches_no_kernel():
    kernels_rowlayer.zzrx_fwd.launches = 0
    kernels_grand.grand_zzrx_fwd.launches = 0
    for L in (3, 4):
        _both(20, L, False, (1.0, -1.0), seed=L)
    assert kernels_rowlayer.zzrx_fwd.launches == 0
    assert kernels_grand.grand_zzrx_fwd.launches == 0


def test_mixed_qir_matches_jax():
    """Every QIR item kind of the port: unitary and diagonal gates, a
    rzz_product, a lone zzrx_layer and a run of two with other pairs."""
    n = 9
    rng = np.random.default_rng(21)
    u = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
    cz = np.diag([1, 1, 1, -1]).astype(np.complex64)
    p1, p2 = _pairs(n, False), _pairs(n, True)
    zz = rng.normal(size=(3, n)) * 0.3
    rx = rng.normal(size=(3, n)) * 0.3
    out = []
    for mod, kw in ((tc, {}), (tct, {"device": "cpu"})):
        c = mod.Circuit(n, **kw)
        c.h_layer()
        c.apply_general_gate(u.astype(np.complex64), 3, 1)
        c.apply_general_gate(cz, 0, 5, name="cz")
        c.rzz_product(p1, np.float32(zz[0, : n - 1]))
        c.zzrx_layer(p1, np.float32(zz[0, : n - 1]), np.float32(rx[0]))
        c.zzrx_layer(p2, np.float32(zz[1]), np.float32(rx[1]))
        c.zzrx_layer(p2, np.float32(zz[2]), np.float32(rx[2]))
        out.append((float(c.expectation_zzx_energy(p2, 0.7, -1.3)), convert.to_numpy(c.state())))
    (ej, sj), (et, st) = out
    assert abs(et - ej) <= 2e-5 * n
    assert np.linalg.norm(st - sj) <= 2e-6


def test_energy_equals_separate_readouts():
    """The fused readout equals zz_sum - x_sum on the port's own state."""
    n, L = 12, 4
    pairs = _pairs(n, False)
    ct = _build(tct, n, L, pairs, convert.params(_grid(n, L, 3), "cpu"), device="cpu")
    e = ct.expectation_zzx_energy(pairs, 1.0, -1.0)
    sep = ct.expectation_zz_sum(pairs) - ct.expectation_x_sum()
    assert abs(e.item() - sep.item()) <= 2e-5 * n


def _rand_state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    return (psi / np.linalg.norm(psi)).astype(np.complex64)


@pytest.mark.parametrize("n", [6, 10])
def test_readout_spec_carried_from_jax(n):
    """A readout spec built by the JAX package (weighted ZZ, single Z, a
    partial X field) gives the same energy in the port after ``convert``."""
    from tensorcircuit_ng_tpu.core import kernels as jkernels
    from tensorcircuit_ng_tpu_torch.core import kernels

    psi = _rand_state(n, seed=n)
    spec = jkernels.ising_readout_spec(
        n,
        zz_terms=[(0, 1, 0.5), (2, n - 1)],
        z_terms=[3, (n - 2, -0.25)],
        x_terms=[(q, 0.1 * (q + 1)) for q in range(0, n, 2)],
    )
    want = float(jkernels.ising_energy_dense(psi, n, spec))
    got = kernels.ising_energy_dense(convert.state(psi, "cpu"), n, convert.readout_spec(spec))
    # complex64 on both sides: a sum of ~n terms of size <= 1 in float32
    assert abs(got.item() - want) <= 2e-6 * n


@pytest.mark.parametrize("op", ["unitary", "diagonal", "zz_phase", "zz_sum", "x_sum", "ps"])
def test_statevec_ops_match_jax(op):
    from tensorcircuit_ng_tpu.core import statevec as jsv

    n = 6
    psi = _rand_state(n, seed=len(op))
    rng = np.random.default_rng(1)
    pt = convert.state(psi, "cpu")
    if op == "unitary":
        g = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
        want = jsv.apply_unitary(psi, g, [4, 1])
        got = statevec.apply_unitary(pt, g, [4, 1])
    elif op == "diagonal":
        dg = np.exp(1j * rng.normal(size=(2, 2)))
        want = jsv.apply_diagonal(psi, dg, [3, 0])
        got = statevec.apply_diagonal(pt, dg, [3, 0])
    elif op == "zz_phase":
        pairs, th = [(0, 5), (2, 3)], rng.normal(size=2)
        want = jsv.apply_zz_product_phase(psi, pairs, th)
        got = statevec.apply_zz_product_phase(pt, pairs, torch.as_tensor(th))
    elif op == "zz_sum":
        pairs, w = [(0, 1), (1, 4), (5, 2)], [0.5, -1.0, 2.0]
        want = jsv.expectation_zz_sum(psi, pairs, w)
        got = statevec.expectation_zz_sum(pt, pairs, w)
    elif op == "x_sum":
        want = jsv.expectation_x_sum(psi, [0, 2, 5])
        # blocks of 4 qubits where JAX takes 7: the sum must not depend on it
        got = statevec.expectation_x_sum(pt, [0, 2, 5], block=4)
    else:
        want = jsv.expectation_ps(psi, x=[1], y=[3], z=[0, 5])
        got = statevec.expectation_ps(pt, x=[1], y=[3], z=[0, 5])
    # complex64 on both sides (the JAX process runs without x64), sums in
    # another order over a unit vector
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want), atol=2e-6)

