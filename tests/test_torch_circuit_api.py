"""The port's ``Circuit`` API beyond the TFIM layers against the JAX
package, on the CPU: the gate registry, broadcast application, ``any``,
the QIR round trip and gate counts, ``multicz``/``rzm``, amplitudes,
probabilities, ``expectation``, ``mid_measurement``, measurement with an
external ``status``, and the hardware-efficient-ansatz (HEA) VQE path
(``chip_smoke.hea_energy``: ry_layer, a CNOT ladder, rz_layer, a final
constant h_layer and the TFIM energy), value and gradient.

Inputs are numpy-seeded and handed to both packages.  Tolerances:
matrices and states of a few qubits agree to float32 rounding, 1e-6;
complex128 to 1e-12.  The HEA gradient within 1e-4, each entry a float32
sum over 2^n amplitudes a layer taken in another order.  The HEA energy
(|E| ~ 7-18 here) within 2e-6 |E| of the JAX package's: in float32 the
state's norm alone drifts by ~1e-6 over the ~30 gate layers, which moves E
by ~1e-6 |E| on each side (at n=12 both float32 energies stand ~1e-5 off
the float64 value, in opposite directions), so an absolute 1e-5 sits at
float32's floor.  At n=20 the port is also held within 1e-6 |E| of its own
complex128 run (it stands 6e-7 |E| off it; the JAX package 2.1e-6 |E|).
The JAX side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import hea_energy
from tensorcircuit_ng_tpu.ops import gates as jgates
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
from tensorcircuit_ng_tpu_torch.ops import gates as tgates

ATOL = 1e-6

_G = np.kron(np.array([[0, 1], [1, 0]]), np.diag([1.0, -1.0]))  # G^2 = I


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


#: parameters of each parameterized gate (the fixed ones take none)
_PARAMS = {
    "r": {"theta": 0.3, "alpha": 0.7, "phi": 1.1},
    "u": {"theta": 0.3, "phi": 0.7, "lbd": -1.1},
    "cu": {"theta": 0.3, "phi": 0.7, "lbd": -1.1},
    "exp": {"unitary": _G, "theta": 0.4},
    "exp1": {"unitary": _G, "theta": 0.4},
    "exponential": {"unitary": _G, "theta": 0.4},
    "su4": {"theta": np.linspace(-1.0, 1.3, 15)},
    "multicontrol": {"unitary": np.array([[0, 1], [1, 0]]), "ctrl": [1, 0]},
}


def _cpu():
    return tct.set_device("cpu")


def test_gate_registry_names_match_jax():
    assert sorted(tgates.GATES) == sorted(jgates.GATES)
    assert tgates.FIXED_GATE_NAMES == jgates.FIXED_GATE_NAMES
    assert tgates.VARIABLE_GATE_NAMES == jgates.VARIABLE_GATE_NAMES
    assert tgates.GATE_ALIASES == jgates.GATE_ALIASES
    assert tgates.VARIABLE_ALIASES == jgates.VARIABLE_ALIASES


@pytest.mark.parametrize("name", sorted(jgates.GATES))
def test_gate_matches_jax(name):
    """Every gate of the JAX registry builds the same matrix in the port;
    concrete parameters give numpy matrices, as in the JAX package."""
    if name in jgates.FIXED_GATE_NAMES:
        kws = {}
    else:
        kws = _PARAMS.get(name, {"theta": 0.37})
    want = jgates.GATES[name](**kws)
    got = tgates.GATES[name](**kws)
    assert isinstance(got.tensor, np.ndarray)
    assert got.name == want.name and got.tensor.shape == want.tensor.shape
    assert got.tensor.dtype == np.complex64
    np.testing.assert_allclose(got.tensor, np.asarray(want.tensor), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["rx", "r", "u", "su4", "exponential"])
def test_tensor_parameters_keep_autograd(name):
    """A tensor parameter gives a torch matrix; d Re(sum m)/d theta matches
    the JAX package's gradient of the same function."""
    kws = dict(_PARAMS.get(name, {"theta": 0.37}))
    theta = np.asarray(kws["theta"], np.float32)

    def jf(t):
        return jnp.real(jnp.sum(jgates.GATES[name](**{**kws, "theta": t}).tensor))

    jg = jax.grad(jf)(jnp.asarray(theta))
    t = torch.as_tensor(theta).requires_grad_()
    m = tgates.GATES[name](**{**kws, "theta": t}).tensor
    assert isinstance(m, torch.Tensor) and m.dtype == torch.complex64
    (g,) = torch.autograd.grad(torch.real(torch.sum(m)), t)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


def _unitary(rng, dim):
    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    return np.linalg.qr(a)[0].astype(np.complex64)


def _broadcast_circuit(mod, u4, thetas, **kw):
    c = mod.Circuit(5, **kw)
    c.h(range(5))
    c.cnot(range(3), range(1, 4))  # zips elementwise: (0,1), (1,2), (2,3)
    c.rx(range(5), theta=thetas)  # a parameter a position
    c.any(0, 2, unitary=u4)
    c.RZ(4, theta=0.3)
    c.toffoli(0, 1, 2)
    c.cu(1, 3, theta=0.2, phi=0.5, lbd=-0.4)
    c.cx(4, 0)
    c.iswap(2, 4, theta=0.6)
    return c


def test_broadcast_any_and_counts_match_jax():
    rng = np.random.default_rng(1)
    u4 = _unitary(rng, 4)
    thetas = rng.standard_normal(5).astype(np.float32)
    cj = _broadcast_circuit(tc, u4, thetas)
    with _cpu():
        ct = _broadcast_circuit(tct, u4, thetas)
        np.testing.assert_allclose(ct.state().numpy(), np.asarray(cj.state()), rtol=0, atol=ATOL)
        assert ct.gate_count() == cj.gate_count() == 19
        for names in (["cnot"], ["cx"], ["h", "rz"], ["any"]):
            assert ct.gate_count(names) == cj.gate_count(names)
        assert ct.gate_summary() == cj.gate_summary()
        # the QIR round trip rebuilds the same circuit
        again = tct.Circuit.from_qir(ct.to_qir(), {"nqubits": 5})
        np.testing.assert_allclose(again.state().numpy(), ct.state().numpy(), rtol=0, atol=0)
        assert again.gate_summary() == ct.gate_summary()


def test_qir_round_trip_keeps_the_fused_layers():
    """The fused items replay as themselves: the leading h_layer still folds
    and stays constant, the rx, ry and zzrx layers keep their angles."""
    rng = np.random.default_rng(2)
    n = 8
    with _cpu():
        c = tct.Circuit(n)
        c.h_layer()
        c.ry_layer(rng.standard_normal(n))
        c.rx_layer(rng.standard_normal(n))
        c.zzrx_layer([(0, 1), (2, 3)], rng.standard_normal(2), rng.standard_normal(n))
        c.multicz(0, 3, 7)
        c.rzm(1, 2, theta=0.4)
        c.h_layer()
        again = tct.Circuit.from_qir(c.to_qir())
        assert [it["name"] for it in again.to_qir()] == [it["name"] for it in c.to_qir()]
        assert again.to_qir()[0].get("h_fold") and again.to_qir()[-1]["constant"]
        np.testing.assert_allclose(again.state().numpy(), c.state().numpy(), rtol=0, atol=0)


def _dense_circuit(mod, n, thetas, **kw):
    c = mod.Circuit(n, **kw)
    c.h(range(n))
    c.ry(range(n), theta=thetas)
    c.multicz(0, 2, n - 1)
    c.rzm(1, 3, 4, theta=0.7)
    c.mcz([1, 2])
    c.cz(0, n - 1)
    c.rx(range(n), theta=thetas[::-1].copy())
    return c


def test_multicz_rzm_amplitude_probability_expectation_match_jax():
    n = 6
    thetas = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    cj = _dense_circuit(tc, n, thetas)
    x = np.array([[0, 1], [1, 0]])
    z = np.diag([1.0, -1.0])
    zz = np.kron(z, z)
    with _cpu():
        ct = _dense_circuit(tct, n, thetas)
        np.testing.assert_allclose(ct.state().numpy(), np.asarray(cj.state()), rtol=0, atol=ATOL)
        for bits in ("010110", [1, 1, 0, 0, 1, 0]):
            np.testing.assert_allclose(ct.amplitude(bits).numpy(), np.asarray(cj.amplitude(bits)), atol=ATOL)
        p = ct.probability()
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(cj.probability()), rtol=0, atol=ATOL)
        for ops in (
            [(z, [0])],
            [(x, [3]), (z, [5])],
            [(tgates.GATES["y"](), [2])],
            [(zz, [1, 4])],
            [(tgates.GATES["cnot"]().matrix(), [5, 0]), (x, 2)],
        ):
            jops = [(jgates.GATES[o.name]() if isinstance(o, tgates.Gate) else o, w) for o, w in ops]
            np.testing.assert_allclose(
                ct.expectation(*ops).numpy(), np.asarray(cj.expectation(*jops)), rtol=0, atol=ATOL
            )


@pytest.mark.parametrize("keep", [0, 1, "tensor"])
def test_mid_measurement_matches_jax(keep):
    thetas = np.random.default_rng(4).standard_normal(5).astype(np.float32)
    jkeep = 1 if keep == "tensor" else keep
    cj = _dense_circuit(tc, 5, thetas)
    cj.mid_measurement(2, keep=jkeep)
    with _cpu():
        ct = _dense_circuit(tct, 5, thetas)
        ct.post_select(2, keep=torch.tensor(1) if keep == "tensor" else keep)
        assert ct.to_qir()[-1]["name"] == "mid_measurement"
        np.testing.assert_allclose(ct.state().numpy(), np.asarray(cj.state()), rtol=0, atol=ATOL)


def test_measure_jit_and_perfect_sampling_match_jax():
    """The same status gives the JAX package's outcomes and probability."""
    n = 6
    rng = np.random.default_rng(5)
    thetas = rng.standard_normal(n).astype(np.float32)
    cj = _dense_circuit(tc, n, thetas)
    with _cpu():
        ct = _dense_circuit(tct, n, thetas)
        for _ in range(4):
            status = rng.random(n).astype(np.float32)
            bj, pj = cj.perfect_sampling(status=jnp.asarray(status))
            bt, pt = ct.perfect_sampling(status=status)
            assert bt.dtype == torch.int32
            np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
            np.testing.assert_allclose(pt.item(), float(pj), rtol=1e-5)
            sj, _ = cj.measure_jit(4, 1, status=jnp.asarray(status[:2]))
            st, none = ct.measure_jit(4, 1, status=torch.as_tensor(status[:2]))
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
            assert none.item() == -1.0
        # without status: torch.rand on the circuit's device, with the generator
        a = ct.measure(0, 3, 5, with_prob=True, generator=torch.Generator().manual_seed(7))
        b = ct.measure(0, 3, 5, with_prob=True, generator=torch.Generator().manual_seed(7))
        assert torch.equal(a[0], b[0]) and a[1].item() == b[1].item() and 0 < a[1].item() <= 1


def test_replace_inputs_and_h_layer_on_inputs_match_jax():
    """h_layer anywhere but first on |0...0> is a constant row layer (K8
    backward on the card): here on ``inputs=`` and after replace_inputs."""
    n = 9
    rng = np.random.default_rng(6)
    psi0 = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    psi1 = np.roll(psi0, 5)

    def build(mod, inputs, **kw):
        c = mod.Circuit(n, inputs=inputs, **kw)
        c.h_layer()
        c.rz_layer(np.linspace(-1, 1, n))
        c.h_layer()
        return c

    cj = build(tc, jnp.asarray(psi0))
    with _cpu():
        ct = build(tct, convert.state(psi0))
        np.testing.assert_allclose(ct.state().numpy(), np.asarray(cj.state()), rtol=0, atol=ATOL)
        cj.replace_inputs(jnp.asarray(psi1))
        ct.replace_inputs(convert.state(psi1))
        np.testing.assert_allclose(ct.state().numpy(), np.asarray(cj.state()), rtol=0, atol=ATOL)


def _hea_both(n, L, seed, dtype=np.float32):
    w0 = (np.random.default_rng(seed).normal(size=(L, 2, n)) * 0.1).astype(dtype)
    ej, gj = jax.jit(jax.value_and_grad(lambda w: hea_energy(tc, n, w)))(jnp.asarray(w0))
    w = torch.as_tensor(w0).requires_grad_()
    e = hea_energy(tct, n, w, device="cpu")
    (g,) = torch.autograd.grad(e, w)
    return float(ej), np.asarray(gj), e, g, w0


@pytest.mark.parametrize("n,L", [(8, 2), (12, 2)])
def test_hea_value_and_grad_matches_jax(n, L):
    for k in (krl.row_fwd, krl.row_bwd, krl.row_bwd_const):
        k.launches = 0
    ej, gj, e, g, _ = _hea_both(n, L, seed=n + L)
    assert e.dtype == torch.float32 and g.shape == (L, 2, n)
    assert abs(e.item() - ej) <= 2e-6 * abs(ej)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-4)
    # the CPU path runs the plain versions: no kernel launched
    assert (krl.row_fwd.launches, krl.row_bwd.launches, krl.row_bwd_const.launches) == (0, 0, 0)


def test_hea_value_and_grad_matches_jax_n20():
    """The path's width, L=4: nkernel 11 and 2 outer qubits a layer."""
    ej, gj, e, g, w0 = _hea_both(20, 4, seed=42)
    with torch.no_grad(), tct.set_dtype("complex128"):
        e64 = hea_energy(tct, 20, torch.as_tensor(w0, dtype=torch.float64), device="cpu").item()
    assert abs(e.item() - e64) <= 1e-6 * abs(e64)
    assert abs(e.item() - ej) <= 2e-6 * abs(ej)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-4)


def test_hea_value_and_grad_matches_jax_complex128():
    """complex128 keeps the per-qubit formulation on both sides."""
    tc.set_dtype("complex128")
    try:
        with tct.set_dtype("complex128"):
            ej, gj, e, g, _ = _hea_both(12, 2, seed=9, dtype=np.float64)
    finally:
        tc.set_dtype("complex64")
    assert e.dtype == torch.float64
    assert abs(e.item() - ej) <= 1e-12
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-12)


def test_statevec_helpers_match_jax():
    """The flat-state helpers the circuit methods call, on one seeded
    state: Z-string phase (a tensor angle keeps autograd), multi-controlled
    Z, the block-sandwich sum of a one-qubit operator, local products,
    slot flips and signs, marginals over unsorted wires, projection."""
    from tensorcircuit_ng_tpu.core import statevec as jsv
    from tensorcircuit_ng_tpu_torch.core import statevec as tsv

    n = 9
    rng = np.random.default_rng(8)
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    j, t = jnp.asarray(psi), torch.as_tensor(psi)
    y = np.array([[0, -1j], [1j, 0]])
    z = np.diag([1.0, -1.0])
    pairs = [
        (tsv.apply_zstring_phase(t, [0, 4, 8], torch.tensor(0.7)), jsv.apply_zstring_phase(j, [0, 4, 8], 0.7)),
        (tsv.apply_multicz(t, [1, 3, 5]), jsv.apply_multicz(j, [1, 3, 5])),
        (tsv.expectation_1q_sum(t, y, [0, 2, 7, 8]), jsv.expectation_1q_sum(j, y, [0, 2, 7, 8])),
        (tsv.expectation_local(t, [(z, [3]), (np.kron(y, z), [6, 1])]),
         jsv.expectation_local(j, [(z, [3]), (np.kron(y, z), [6, 1])])),
        (tsv.flip_slot(t, 4), jsv.flip_slot(j, 4)),
        (tsv.sign_slot(t, 2), jsv.sign_slot(j, 2)),
        (tsv.marginal_probability(t, [5, 1, 7]), jsv.marginal_probability(j, [5, 1, 7])),
        (tsv.project_slot(t, 3, 1), jsv.project_slot(j, 3, 1)),
        (tsv.amplitude(t, [1, 0, 1, 1, 0, 0, 1, 0, 1]), jsv.amplitude(j, [1, 0, 1, 1, 0, 0, 1, 0, 1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    theta = torch.tensor(0.7, requires_grad=True)
    v = torch.real(torch.vdot(t, tsv.apply_zstring_phase(t, [0, 4, 8], theta)))
    (g,) = torch.autograd.grad(v, theta)
    jg = jax.grad(lambda a: jnp.real(jnp.vdot(j, jsv.apply_zstring_phase(j, [0, 4, 8], a))))(0.7)
    np.testing.assert_allclose(g.item(), float(jg), rtol=0, atol=1e-6)
