"""The port's ``AnalogCircuit`` and ``SymbolCircuit`` (with
``ops/symbolgates.py``) against the JAX package's.

``AnalogCircuit``: the output state with a local block and with a
time-dependent global block (dense, and as a COO tensor scaled in t)
against the JAX package's, within 1e-4 (the ODE's tolerance); two backward
passes through one circuit give one gradient, within 1e-3 of a central
difference; the kept state (only without autograd); ``inverse()`` returns
to the input.  ``SymbolCircuit``: substituted states, ``matrix``,
``expectation_ps``, ``bind`` and ``to_circuit`` against the JAX package's
(1e-10) and the bound circuit's state (1e-5 at complex64, 1e-10 at
complex128); F14 (``to_circuit`` keeps ``inputs``; the JAX package's is
0.989 off on the probe, kept as a record) and F16 (``tct.symbolgates`` is
the gate module; the JAX package's ``tc.symbolgates.sym_x`` is an
AttributeError, kept as a record).
"""

import numpy as np
import pytest
import sympy as sp
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.ops import symbolgates as jsg

ODE_TOL = 1e-4
TOL = {"complex64": 1e-5, "complex128": 1e-10}
X = np.array([[0, 1], [1, 0]], dtype=complex)
Z = np.diag([1.0, -1.0]).astype(complex)


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


def _op(n, site_ops):
    m = np.eye(1, dtype=complex)
    for q in range(n):
        m = np.kron(m, site_ops.get(q, np.eye(2)))
    return m


def _chain_parts(n):
    zz = sum(_op(n, {i: Z, i + 1: Z}) for i in range(n - 1))
    xs = sum(_op(n, {i: X}) for i in range(n))
    return zz, xs


T, OMEGA = 0.5, 1.2


LOCAL_H = np.cos(0.7) * np.kron(X, X) + 0.4 * np.kron(Z, np.eye(2)) + 0.3 * np.kron(np.eye(2), X)


def _build(mod, n, **kw):
    """h, cnot, a time-dependent global block, rx on every qubit, a local
    block on (1, 2), then a cnot."""
    zz, xs = _chain_parts(n)
    if mod is tc:
        import jax.numpy as jnp

        zz, xs, loc, sin = jnp.asarray(zz), jnp.asarray(xs), jnp.asarray(LOCAL_H), jnp.sin
    else:
        zz, xs, loc, sin = torch.as_tensor(zz), torch.as_tensor(xs), torch.as_tensor(LOCAL_H), torch.sin
    c = mod.AnalogCircuit(n, **kw)
    c.h(0)
    c.cnot(0, 1)
    c.rz(2, theta=0.4)
    c.add_analog_block(lambda t: zz + OMEGA * sin(np.pi * t / T) * xs, T)
    for q in range(n):
        c.rx(q, theta=0.2 + 0.1 * q)
    c.add_analog_block(lambda t: loc * (1.0 + 0.5 * t), 0.6, index=[1, 2])
    c.cnot(1, 2)
    return c


def test_analog_states_against_jax(dtype):
    n = 3
    sj = np.asarray(_build(tc, n).state())
    cp = _build(tct, n, device="cpu")
    sp_ = cp.state()
    assert sp_.dtype == getattr(torch, dtype)
    assert np.abs(_np(sp_) - sj).max() <= ODE_TOL
    assert abs(float(torch.linalg.vector_norm(sp_)) - 1.0) <= ODE_TOL
    zz = float(torch.real(cp.expectation_ps(z=[0, 1])))
    assert abs(zz - float(np.real(_build(tc, n).expectation_ps(z=[0, 1])))) <= ODE_TOL


def test_global_block_as_scaled_coo_equals_dense():
    n = 4
    zz, xs = _chain_parts(n)
    with tct.set_device("cpu"):
        hzz = tct.PauliStringSum2COO([[3 if q in (i, i + 1) else 0 for q in range(n)] for i in range(n - 1)])
        hx = tct.PauliStringSum2COO([[1 if q == i else 0 for q in range(n)] for i in range(n)])
    dense = tct.AnalogCircuit(n, device="cpu")
    coo = tct.AnalogCircuit(n, device="cpu")
    for c in (dense, coo):
        c.h_layer()
    zz, xs = torch.as_tensor(zz), torch.as_tensor(xs)
    dense.add_analog_block(lambda t: zz + OMEGA * torch.sin(np.pi * t / T) * xs, T)
    coo.add_analog_block(lambda t: (lambda v: hzz @ v + OMEGA * torch.sin(np.pi * t / T) * (hx @ v)), T)
    assert np.abs(_np(dense.state()) - _np(coo.state())).max() <= 1e-5


def _grad_circuit(omega):
    n = 3
    zz, xs = _chain_parts(n)
    zz_t, xs_t = (torch.as_tensor(m, dtype=torch.complex128) for m in (zz, xs))
    c = tct.AnalogCircuit(n, device="cpu")
    c.h_layer()
    c.add_analog_block(lambda t: zz_t + omega * torch.sin(np.pi * t / T) * xs_t, T)
    return c


def test_two_backward_passes_and_the_kept_state():
    with tct.set_dtype("complex128"):
        omega = torch.tensor(OMEGA, dtype=torch.float64, requires_grad=True)
        c = _grad_circuit(omega)
        grads = []
        for _ in range(2):
            e = torch.real(c.expectation_ps(z=[0, 1]))
            (g,) = torch.autograd.grad(e, omega)
            grads.append(float(g))
        assert grads[0] == grads[1] and c._state_cache is None
        h = 1e-3
        ep, em = (float(torch.real(_grad_circuit(OMEGA + s * h).expectation_ps(z=[0, 1]))) for s in (1, -1))
        assert abs(grads[0] - (ep - em) / (2 * h)) <= 1e-3
        const = _grad_circuit(OMEGA)
        first = const.state()
        assert const.state() is first  # kept without autograd
        const.rx(0, theta=0.3)  # a gate drops it
        assert const._state_cache is None and const.state() is not first


def test_inverse_returns_to_the_input(dtype):
    n = 3
    c = _build(tct, n, device="cpu")
    psi = c.state()
    inv = c.inverse()
    assert len(inv.analog_blocks) == 2 and inv.analog_blocks[0].index == [1, 2]
    back = tct.AnalogCircuit(n, inputs=psi, device="cpu")
    back.append(inv.digital_circuits[0])
    back.analog_blocks = inv.analog_blocks
    back.digital_circuits += inv.digital_circuits[1:]
    zero = np.zeros(2**n)
    zero[0] = 1
    assert np.abs(_np(back.state()) - zero).max() <= 10 * ODE_TOL


def test_analog_readouts_and_delegation():
    c = _build(tct, 3, device="cpu")
    psi = c.state()
    assert torch.allclose(c.probability(), torch.abs(psi) ** 2)
    assert torch.allclose(c.amplitude("010"), psi[2])
    assert torch.allclose(c.effective_circuit().state(), psi)
    assert c.current_digital_circuit() is c.digital_circuits[-1] and c.nqubits == 3
    assert c.device.type == "cpu" and len(c.digital_circuits) == 3


# ---------------------------------------------------------------- SymbolCircuit

th, ph = sp.symbols("theta phi", real=True)


def _sym_circuit(mod, n=3, **kw):
    c = mod.SymbolCircuit(n, **kw)
    c.h(0)
    c.rx(1, theta=th)
    c.cnot(0, 1)
    c.rzz(1, 2, theta=ph)
    c.ry(2, theta=th + ph)
    c.crz(0, 2, theta=ph)
    c.phase(1, theta=2 * th)
    c.cphase(2, 0, theta=ph)
    c.rxx(0, 1, theta=th)
    c.s(2)
    c.any(0, 2, unitary=np.kron(X, Z))
    return c


BIND = {th: 0.37, ph: -0.81}


def _sym_np(expr):
    return np.asarray(sp.N(expr.subs(BIND)), dtype=complex).reshape(-1)


def test_symbol_states_against_jax_and_bound_circuit(dtype):
    cj, cp = _sym_circuit(tc), _sym_circuit(tct, device="cpu")
    wj, wp = _sym_np(cj.wavefunction()), _sym_np(cp.wavefunction())
    assert np.abs(wp - wj).max() <= 1e-12
    bound = cp.to_circuit(BIND)
    assert isinstance(bound, tct.Circuit) and bound.device.type == "cpu"
    assert np.abs(_np(bound.state()) - wp).max() <= TOL[dtype]
    assert np.abs(_sym_np(cp.matrix()) - _sym_np(cj.matrix())).max() <= 1e-12
    assert abs(complex(sp.N(cp.amplitude("011").subs(BIND))) - wp[3]) <= 1e-12
    assert np.abs(_sym_np(cp.probability()) - np.abs(wp) ** 2).max() <= 1e-12
    assert cp.free_symbols() == {th, ph}


def _small_sym(mod, **kw):
    c = mod.SymbolCircuit(2, **kw)
    c.h(0)
    c.rx(1, theta=th)
    c.cnot(0, 1)
    c.rzz(0, 1, theta=ph)
    return c


def test_symbol_expectation_and_bind():
    cj, cp = _small_sym(tc), _small_sym(tct, device="cpu")
    for kw in ({"z": [0]}, {"x": [0], "z": [1]}):
        ej, ep = cj.expectation_ps(**kw), cp.expectation_ps(**kw)
        assert abs(complex(sp.N(ep.subs(BIND))) - complex(sp.N(ej.subs(BIND)))) <= 1e-12
        bound = cp.to_circuit(BIND).expectation_ps(**kw)
        assert abs(complex(sp.N(ep.subs(BIND))) - complex(bound)) <= 1e-5
    half = cp.bind({th: 0.37})
    assert isinstance(half, tct.SymbolCircuit) and half.free_symbols() == {ph}
    full = half.bind({ph: -0.81})
    assert not full.free_symbols()
    assert np.abs(_sym_np(full.wavefunction()) - _sym_np(cp.wavefunction())).max() <= 1e-12
    before = cp.expectation_before((tct.gates.z(), [0]))
    assert abs(complex(sp.N(before.subs(BIND))) - complex(sp.N(cp.expectation_ps(z=[0]).subs(BIND)))) <= 1e-12
    with pytest.raises(ValueError, match="requires numeric values"):
        cp.sample(batch=4, allow_state=True)
    with pytest.raises(ValueError, match="unbound symbols"):
        cp.to_circuit({th: 0.1})
    bits = cp.sample(bindings=BIND, batch=4, allow_state=True, format="sample_bin", status=np.full(4, 0.5))
    assert tuple(bits.shape) == (4, 2)


def _f14_probe(mod, **kw):
    inputs = np.zeros(4, dtype=complex)
    inputs[1] = 1.0  # |01>
    c = mod.SymbolCircuit(2, inputs=inputs, **kw)
    c.rx(0, theta=th)
    c.cnot(0, 1)
    return c


def test_f14_to_circuit_keeps_inputs(dtype):
    """Queue 3 F14: the JAX package's ``to_circuit`` starts from |00>, 0.989
    off the symbolic state on the probe (kept as a record)."""
    cp, cj = _f14_probe(tct, device="cpu"), _f14_probe(tc)
    sym = _sym_np(cp.wavefunction().subs({th: 0.3}))
    assert np.abs(sym - np.array([0, np.cos(0.15), -1j * np.sin(0.15), 0])).max() <= 1e-12
    assert np.abs(_np(cp.to_circuit({th: 0.3}).state()) - sym).max() <= TOL[dtype]
    jax_bound = np.asarray(cj.to_circuit({th: 0.3}).state())
    assert abs(np.abs(jax_bound - sym).max() - 0.989) <= 1e-3
    assert np.abs(_sym_np(cj.wavefunction().subs({th: 0.3})) - sym).max() <= 1e-12
    z = cp.to_circuit({th: 0.3}).expectation_ps(z=[1])
    assert abs(float(torch.real(z)) - float(np.real(np.vdot(sym, np.diag([1, -1, 1, -1]) @ sym)))) <= TOL[dtype]


def test_f16_symbolgates_module():
    """Queue 3 F16: ``tct.symbolgates`` is ``ops/symbolgates.py``; the JAX
    package maps ``tc.symbolgates`` to the circuit module (kept as a record)."""
    assert tct.symbolgates.sym_x() == jsg.sym_x()
    with pytest.raises(AttributeError):
        tc.symbolgates.sym_x
    a, b, g = sp.symbols("a b g")
    args = {"sym_u": (a, b, g), "sym_cu": (a, b, g), "sym_r": (a, b, g), "sym_cr": (a, b, g),
            "sym_any": (np.kron(X, Z),)}
    for name in jsg.__all__:
        fj, fp = getattr(jsg, name), getattr(tct.symbolgates, name)
        params = args.get(name, (a,) if fp.__code__.co_argcount else ())
        vals = {a: 0.3, b: -1.1, g: 0.7}
        mj = np.asarray(sp.N(fj(*params).subs(vals)), dtype=complex)
        mp = np.asarray(sp.N(fp(*params).subs(vals)), dtype=complex)
        assert np.abs(mj - mp).max() <= 1e-12, name
    assert set(tct.symbolgates.__all__) == set(jsg.__all__)


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        for make in (lambda: tct.SymbolCircuit(2), lambda: tct.AnalogCircuit(2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _f14_probe(tct, device="cpu").to_circuit({th: 0.3}, device="cuda")


def test_slice_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 20 at a small size on the CPU (the CPU path
    is its own reference there)."""
    import chip_smoke

    times = chip_smoke._slice_checks(tct, "cpu", **chip_smoke.SLICE_SMALL)
    assert all(ms >= 0 for ms, _, _ in times.values())
