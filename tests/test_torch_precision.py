"""complex128 keeps float64 angles end to end.

- Angles given as Python floats (or lists of them) are built in the real
  dtype of the state, float64 under complex128, as the JAX package's
  ``jnp.asarray`` gives after ``set_dtype``: ``rx_layer``, ``ry_layer``,
  ``rzz_product`` and ``zzrx_layer`` at n=9 with angles 0.3 + 0.02 i, and
  ``rzm(1, 2, 7, theta=0.37)`` at n=11, against the JAX package and a
  float64 numpy oracle.  A float32 round trip of the angles was 1e-10 to
  2e-9 off; here both sides are float64, so 1e-14 (about 100 ulps of an
  O(1) amplitude sum) holds.
- ``ML_MODE = "xla"`` builds its zz exponent and rx krons at the state's
  precision: complex128 at n=10, L=2 against the float64 per-layer path
  within 1e-13 (a complex64 kron cast up was 1.5e-8 off), and at n=11
  through a circuit, state and energy.
"""

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch.core import kernels

TOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture
def complex128():
    tc.set_dtype("complex128")
    try:
        with tct.set_dtype("complex128"):
            yield
    finally:
        tc.set_dtype("complex64")


def _state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    return psi / np.linalg.norm(psi)


def _on_qubit(psi, n, q, g):
    v = psi.reshape(2**q, 2, -1)
    return np.einsum("ab,xby->xay", g, v).reshape(-1)


def _zz_phase(psi, n, wires_thetas):
    idx = np.arange(2**n)
    expo = np.zeros(2**n)
    for wires, th in wires_thetas:
        sign = np.ones(2**n)
        for w in wires:
            sign *= 1 - 2 * ((idx >> (n - 1 - w)) & 1)
        expo += th * sign
    return psi * np.exp(-0.5j * expo)


def _rot(th, pauli):
    return np.cos(th / 2) * np.eye(2) - 1j * np.sin(th / 2) * pauli


_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])


def _oracle(layer, psi, n, ang, pairs):
    if layer in ("rzz_product", "zzrx_layer"):
        psi = _zz_phase(psi, n, [(p, ang[k]) for k, p in enumerate(pairs)])
    if layer != "rzz_product":
        for q in range(n):
            psi = _on_qubit(psi, n, q, _rot(ang[q], _Y if layer == "ry_layer" else _X))
    return psi


def _apply(c, layer, ang, pairs):
    if layer == "rzz_product":
        c.rzz_product(pairs, ang[: len(pairs)])
    elif layer == "zzrx_layer":
        c.zzrx_layer(pairs, ang[: len(pairs)], ang)
    else:
        getattr(c, layer)(ang)


@pytest.mark.parametrize("layer", ["rx_layer", "ry_layer", "rzz_product", "zzrx_layer"])
def test_python_float_angles_keep_float64(complex128, layer):
    n = 9
    psi = _state(n, 3)
    ang = [0.3 + 0.02 * i for i in range(n)]  # Python floats
    pairs = [(i, i + 1) for i in range(n - 1)]
    cj = tc.Circuit(n, inputs=psi)
    _apply(cj, layer, ang, pairs)
    ct = tct.Circuit(n, inputs=psi, device="cpu")
    _apply(ct, layer, ang, pairs)
    got = ct.state().numpy()
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, np.asarray(cj.state()), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _oracle(layer, psi, n, ang, pairs), rtol=0, atol=TOL)


def test_python_float_rzm_keeps_float64(complex128):
    n = 11
    psi = _state(n, 4)
    cj = tc.Circuit(n, inputs=psi)
    cj.rzm(1, 2, 7, theta=0.37)
    ct = tct.Circuit(n, inputs=psi, device="cpu")
    ct.rzm(1, 2, 7, theta=0.37)
    got = ct.state().numpy()
    np.testing.assert_allclose(got, np.asarray(cj.state()), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _zz_phase(psi, n, [((1, 2, 7), 0.37)]), rtol=0, atol=TOL)


def test_python_floats_follow_complex64():
    """Under complex64 Python floats stay float32, as before."""
    c = tct.Circuit(3, device="cpu")
    c.rx_layer([0.1, 0.2, 0.3])
    assert c._qir[-1]["thetas"].dtype == torch.float32 and c.state().dtype == torch.complex64


def test_xla_multilayer_keeps_complex128(monkeypatch):
    n, L = 10, 2
    pairs = [(i, i + 1) for i in range(n - 1)]
    rng = np.random.default_rng(5)
    zz = torch.as_tensor(rng.normal(size=(L, n - 1)))  # float64
    rx = torch.as_tensor(rng.normal(size=(L, n)))
    psi = torch.as_tensor(_state(n, 6))
    monkeypatch.setattr(kernels, "ML_MODE", "xla")
    got = kernels.fused_zzrx_multilayer(psi, pairs, zz, rx)
    monkeypatch.setattr(kernels, "ML_MODE", "perlayer")
    want = kernels.fused_zzrx_multilayer(psi, pairs, zz, rx)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)


def test_xla_multilayer_circuit_keeps_complex128(complex128, monkeypatch):
    n, L = 11, 2
    pairs = [(i, i + 1) for i in range(n - 1)]
    p = np.random.default_rng(7).normal(size=(L, 2, n)) * 0.4

    def run(mode):
        monkeypatch.setattr(kernels, "ML_MODE", mode)
        c = tct.Circuit(n, device="cpu")
        c.h_layer()
        for l in range(L):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        return c.state().numpy(), c.expectation_zzx_energy(pairs, 0.7, -1.3).item()

    (s_xla, e_xla), (s_ref, e_ref) = run("xla"), run("perlayer")
    np.testing.assert_allclose(s_xla, s_ref, rtol=0, atol=1e-13)
    assert abs(e_xla - e_ref) <= 1e-12
