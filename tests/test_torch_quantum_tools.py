"""The rest of the port's ``quantum.py`` against the JAX package, on the
CPU: the Pauli-sum builders (dense, COO, matrix-free), the Heisenberg
Hamiltonian, ``LinearOperator``, the Pauli-string helpers, the QI toolbox
(reduced density matrices, entropies, negativities, fidelity, trace
distance, thermal states, the stabilizer Rényi entropy, the helpers), the
U(1) helpers, the MPO converters that need no optional package, the
backend's sparse surface, and ``chip_smoke.py``'s phase 17 at n=8.

Inputs are numpy-seeded and handed to both packages, at complex64 (1e-5)
and complex128 (1e-10), each relative to max(1, the largest entry).  The
COO index planes and the sort order are equal (exact).  Gradients in
circuit angles are compared for the entropies, the negativities,
``fidelity`` and ``trace_distance`` of full-rank states (where ``eigh``'s
gradient is finite in both packages) and ``free_energy``; the pure-state
``fidelity`` gradient is NaN in the JAX package and a central difference's
in the port (Queue 3 F10 of ``ROADMAP.md``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import chip_smoke as cs
import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import quantum as jq
from tensorcircuit_ng_tpu.backend import backend as JK
from tensorcircuit_ng_tpu_torch import quantum as tq

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}
N = 6


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
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
    """Both packages at the dtype, the port on the CPU."""
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
        return (x.to_dense() if x.layout != torch.strided else x).detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _strings(n, count, seed):
    rng = np.random.default_rng(seed)
    ls = rng.integers(0, 4, size=(count, n)).tolist()
    ls += [ls[0], [0] * n]  # a repeated string and the identity
    return ls, rng.normal(size=len(ls)).tolist()


# ---------------------------------------------------------------------------
# Pauli-string Hamiltonians
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", [[1, 0], [3, 3], [2, 1], [0, 2], [1, 2, 3], [2, 2, 2]])
def test_pauli_string_builders_match_jax(dtype, l):
    """One string: the scipy route, the dense matrix and the COO tensor
    (with a weight) against the JAX package's."""
    _close(tq.PauliStringSum2COO([l], numpy=True).todense(), jq.PauliStringSum2COO([l], numpy=True).todense(), 0)
    _close(tq.PauliString2Dense(l), jq.PauliString2Dense(l), TOL[dtype])
    _close(tq.PauliString2Dense(l, weight=0.3), jq.PauliString2Dense(l, weight=0.3), TOL[dtype])
    got = tq.PauliString2COO(l, weight=-0.7)
    want = jq.PauliString2COO(l, weight=-0.7)
    assert got.is_coalesced() and got.dtype == tct.config.torch_dtype()
    np.testing.assert_array_equal(got.indices().T.numpy(), want.indices)
    _close(got.values(), want.values, TOL[dtype])


@pytest.mark.parametrize("n", [6, 10])
def test_pauli_sum_coo_matches_jax(dtype, n):
    """Σ w_i P_i of random strings (a repeated one and the identity among
    them): equal index planes in the same order, the values, ``to_dense``
    and ``@ v``; the device route against the scipy route."""
    ls, w = _strings(n, 12, n)
    got, want = tq.PauliStringSum2COO(ls, w), jq.PauliStringSum2COO(ls, w)
    assert got.is_coalesced() and got.dtype == tct.config.torch_dtype() and got.shape == (2**n, 2**n)
    np.testing.assert_array_equal(got.indices().T.numpy(), want.indices)
    _close(got.values(), want.values, TOL[dtype])
    host = tq.PauliStringSum2COO(ls, w, numpy=True)
    np.testing.assert_array_equal(got.indices().numpy(), np.stack([host.row, host.col]))
    np.testing.assert_array_equal(got.values().numpy(), host.data.astype(dtype))
    v = np.random.default_rng(1).normal(size=(2**n, 2)) @ np.array([1.0, 1j])
    v = v.astype(dtype)
    _close(tct.backend.to_dense(got), np.asarray(JK.to_dense(want)), TOL[dtype])
    _close(got @ torch.as_tensor(v), want @ jnp.asarray(v), TOL[dtype])
    b = np.stack([v, 2 * v], 1)
    _close(tct.backend.sparse_dense_matmul(got, torch.as_tensor(b)), want @ jnp.asarray(b), TOL[dtype])


def test_pauli_sum_dense_and_mvp_match_jax(dtype):
    """The dense sum and the matrix-free product (flat and (2,)*n input)
    against the JAX package's, and the gradient of <v|H|v> in v through
    the product (torch's complex gradient is the conjugate of JAX's)."""
    ls, w = _strings(N, 8, 3)
    want = np.asarray(jq.PauliStringSum2Dense(ls, w))
    _close(tq.PauliStringSum2Dense(ls, w), want, TOL[dtype])
    _close(tq.PauliStringSum2Dense(ls, w, numpy=True), jq.PauliStringSum2Dense(ls, w, numpy=True), 0)
    rng = np.random.default_rng(2)
    v = (rng.normal(size=2**N) + 1j * rng.normal(size=2**N)).astype(dtype)
    jm, tm = jq.PauliStringSum2MVP(ls, w), tq.PauliStringSum2MVP(ls, w)
    _close(tm(torch.as_tensor(v)), jax.jit(jm)(jnp.asarray(v)), TOL[dtype])
    _close(tm(torch.as_tensor(v).reshape((2,) * N)).reshape(-1), want @ v, TOL[dtype])
    x = torch.as_tensor(v).requires_grad_()
    (g,) = torch.autograd.grad(torch.real(torch.vdot(x, tm(x))), x)
    gj = jax.jit(jax.grad(lambda y: jnp.real(jnp.vdot(y, jm(y)))))(jnp.asarray(v))
    _close(np.conj(_np(g)), gj, 10 * TOL[dtype])


@pytest.mark.parametrize("kind", ["networkx", "edges"])
def test_heisenberg_hamiltonian_matches_jax(dtype, kind):
    """The Heisenberg/XYZ Hamiltonian of a graph or an edge list, with
    fields, as COO, dense and scipy, against the JAX package's; the open
    3-site chain's ground energy is -4 and Line1D(6)'s -11.2111."""
    g = tct.templates.graphs.Line1D(5, pbc=False) if kind == "networkx" else [(0, 1), (1, 2), (3, 4), (4, 0)]
    kw = {"hzz": 0.7, "hxx": 1.1, "hyy": -0.4, "hz": 0.3, "hx": -0.2, "hy": 0.5}
    got, want = tq.heisenberg_hamiltonian(g, **kw), jq.heisenberg_hamiltonian(g, **kw)
    np.testing.assert_array_equal(got.indices().T.numpy(), want.indices)
    _close(got.values(), want.values, TOL[dtype])
    _close(tq.xyz_hamiltonian(g, sparse=False, **kw), jq.heisenberg_hamiltonian(g, sparse=False, **kw), TOL[dtype])
    _close(tq.heisenberg_hamiltonian(g, numpy=True, **kw).todense(), jq.heisenberg_hamiltonian(g, numpy=True, **kw).todense(), 0)
    e = np.linalg.eigvalsh(_np(tq.heisenberg_hamiltonian([(0, 1), (1, 2)], sparse=False)))
    np.testing.assert_allclose(e[0], -4.0, atol=1e-5)
    e6 = np.linalg.eigvalsh(_np(tq.heisenberg_hamiltonian(tct.templates.graphs.Line1D(6), sparse=False)))
    np.testing.assert_allclose(e6[0], -11.2111, atol=1e-4)


def test_linear_operator_forms_match_jax(dtype):
    """``aslinearoperator`` of a dense matrix, a COO tensor, a matrix-free
    product and another LinearOperator: ``matvec``, call, ``@`` and shape."""
    ls, w = _strings(4, 5, 7)
    v = np.random.default_rng(0).normal(size=16).astype(dtype)
    want = np.asarray(jq.PauliStringSum2Dense(ls, w)) @ v
    forms = [tq.PauliStringSum2Dense(ls, w), tq.PauliStringSum2COO(ls, w), tq.PauliStringSum2MVP(ls, w)]
    for h in forms + [tq.aslinearoperator(forms[1])]:
        op = tct.aslinearoperator(h)
        assert isinstance(op, tct.LinearOperator)
        for out in (op.matvec(torch.as_tensor(v)), op(torch.as_tensor(v)), op @ torch.as_tensor(v)):
            _close(out, want, TOL[dtype])
    assert tq.LinearOperator(forms[0]).shape == tq.LinearOperator(forms[1]).shape == (16, 16)
    assert tq.LinearOperator(forms[2], shape=(16, 16)).shape == (16, 16)


def test_pauli_string_helpers_match_jax():
    """``ps2xyz`` / ``xyz2ps`` both ways, ``ps2coo_core`` against the JAX
    package's and the dense string, and the reference's aliases."""
    assert tq.ps2xyz([1, 2, 2, 0]) == {"x": [0], "y": [1, 2], "z": []} == jq.ps2xyz([1, 2, 2, 0])
    assert tq.xyz2ps({"x": [0], "y": [1, 2], "z": []}, 4) == [1, 2, 2, 0]
    assert tq.xyz2ps(tq.ps2xyz([0, 3, 1])) == [0, 3, 1] == jq.xyz2ps(jq.ps2xyz([0, 3, 1]))
    for l in ([1, 3], [2, 0, 1], [3, 3], [2, 2, 3, 1]):
        idx, vals = tq.ps2coo_core(l)
        jidx, jvals = jq.ps2coo_core(l)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(vals, jvals)
        dense = np.zeros([2 ** len(l)] * 2, dtype=np.complex128)
        dense[idx[:, 0], idx[:, 1]] = vals
        np.testing.assert_array_equal(dense, jq.PauliStringSum2Dense([l], numpy=True))
    ls, w = _strings(4, 4, 1)
    for alias in (tq.PauliStringSum2COO_numpy(ls, w), tq.PauliStringSum2COO(ls, w, numpy=True)):
        np.testing.assert_array_equal(alias.todense(), jq.PauliStringSum2COO_numpy(ls, w).todense())
    with tct.set_device("cpu"):
        np.testing.assert_array_equal(_np(tq.PauliStringSum2COO_tf(ls, w)), _np(tq.PauliStringSum2COO(ls, w)))
        np.testing.assert_array_equal(_np(tq.PauliString2COO_jit["pytorch"]([1, 2])), _np(tq.PauliString2COO([1, 2])))


def test_builders_take_the_configured_device(monkeypatch):
    """A builder that makes a tensor from no tensor runs on the configured
    device, or on ``device=``: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        for build in (lambda: tq.PauliStringSum2COO([[3, 3]]), lambda: tq.PauliStringSum2Dense([[1, 0]]),
                      lambda: tq.PauliString2Dense([2]), lambda: tq.PauliString2COO([1]),
                      lambda: tq.heisenberg_hamiltonian([(0, 1)]), lambda: tq.u1_mask(3, 1),
                      lambda: tq.onehot_d_tensor(1), lambda: tct.templates.hamiltonians.tfim_hamiltonian(3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        assert tq.PauliStringSum2COO([[3, 3]], device="cpu").device.type == "cpu"
        assert tq.u1_mask(3, 1, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the QI toolbox
# ---------------------------------------------------------------------------


def _angles(dtype, seed=5, n=N):
    return (np.random.default_rng(seed).normal(size=(3, n)) * 0.9).astype(RDT[dtype])


def _state(mod, p, n=N):
    """A generic entangled n-qubit state of the angles p [3, n]."""
    c = mod.Circuit(n)
    for q in range(n):
        c.ry(q, theta=p[0, q])
    for q in range(n - 1):
        c.cnot(q, q + 1)
    for q in range(n):
        c.rx(q, theta=p[1, q])
    for q in range(0, n - 1, 2):
        c.cnot(q + 1, q)
    for q in range(n):
        c.rz(q, theta=p[2, q])
    return c.state()


def _h3(mod):
    return mod.quantum.heisenberg_hamiltonian([(0, 1), (1, 2)], hz=0.3, hx=-0.2, sparse=False)


#: real functions of the state psi of N qubits and of a second state phi
#: in either package's module; qubits 0, 2 and 4 kept: full-rank 8x8
#: densities, their smallest eigenvalues 3.4e-3 (psi) and 1.0e-2 (phi)
_RHO = {"subsystem_to_keep": [0, 2, 4]}
_PHI_SEED = 7
QUANTITIES = {
    "entanglement_entropy": lambda m, psi, phi: m.quantum.entanglement_entropy(psi, 3),
    "entanglement_entropy_keep": lambda m, psi, phi: m.quantum.entanglement_entropy(psi, subsystem_to_keep=[1, 4]),
    "renyi_entanglement_entropy": lambda m, psi, phi: m.quantum.renyi_entanglement_entropy(psi, [3, 4], k=2),
    "renyi_entanglement_entropy_3": lambda m, psi, phi: m.quantum.renyi_entanglement_entropy(
        psi, subsystems_to_trace_out=[0, 5], k=3),
    "mutual_information_pure": lambda m, psi, phi: m.quantum.mutual_information(psi, cut=[0, 1]),
    "mutual_information_mixed": lambda m, psi, phi: m.quantum.mutual_information(
        m.quantum.reduced_density_matrix(psi, **_RHO), [0]),
    "entropy": lambda m, psi, phi: m.quantum.entropy(m.quantum.reduced_density_matrix(psi, **_RHO)),
    "renyi_entropy": lambda m, psi, phi: m.quantum.renyi_entropy(m.quantum.reduced_density_matrix(psi, **_RHO), 3),
    "entanglement_negativity": lambda m, psi, phi: m.quantum.entanglement_negativity(
        m.quantum.reduced_density_matrix(psi, **_RHO), [0]),
    "log_negativity": lambda m, psi, phi: m.quantum.log_negativity(
        m.quantum.reduced_density_matrix(psi, **_RHO), [0, 2], base="2"),
    "fidelity": lambda m, psi, phi: m.quantum.fidelity(
        m.quantum.reduced_density_matrix(psi, **_RHO), m.quantum.reduced_density_matrix(phi, **_RHO)),
    "trace_distance": lambda m, psi, phi: m.quantum.trace_distance(
        m.quantum.reduced_density_matrix(psi, **_RHO), m.quantum.reduced_density_matrix(phi, **_RHO)),
    "free_energy": lambda m, psi, phi: m.quantum.free_energy(m.quantum.reduced_density_matrix(psi, **_RHO), _h3(m), 0.7),
    "renyi_free_energy": lambda m, psi, phi: m.quantum.renyi_free_energy(
        m.quantum.reduced_density_matrix(psi, **_RHO), _h3(m), 0.7, k=2),
    "stabilizer_renyi_entropy": lambda m, psi, phi: m.quantum.stabilizer_renyi_entropy(psi),
    "stabilizer_renyi_entropy_1": lambda m, psi, phi: m.quantum.stabilizer_renyi_entropy(psi, alpha=1),
    "anti_flatness": lambda m, psi, phi: m.quantum.anti_flatness(m.quantum.reduced_density_matrix(psi, **_RHO)),
    "entanglement_anti_flatness": lambda m, psi, phi: m.quantum.entanglement_anti_flatness(psi, [0, 1, 2]),
}


@functools.lru_cache(maxsize=None)
def _jax_states(dtype):
    """The JAX package's two states and the pullback of the first through
    its circuit (each compiled once a dtype)."""
    tc.set_dtype(dtype)
    p = jnp.asarray(_angles(dtype))
    state = jax.jit(lambda q: _state(tc, q))
    pullback = jax.jit(lambda ct: jax.vjp(lambda q: _state(tc, q), p)[1](ct)[0])
    return state(p), pullback, state(jnp.asarray(_angles(dtype, seed=_PHI_SEED)))


def _jax_value_and_grad(name, dtype):
    psi, pullback, phi = _jax_states(dtype)
    fn = QUANTITIES[name]
    v, gpsi = jax.jit(jax.value_and_grad(lambda s: jnp.real(fn(tc, s, phi))))(psi)
    return float(v), np.asarray(pullback(gpsi))


@pytest.mark.parametrize("name", sorted(QUANTITIES))
def test_qi_values_and_angle_gradients_match_jax(dtype, name):
    """Each quantity of a 6-qubit circuit state (and of its 3-qubit
    reduced density matrix, full rank), and its gradient in the circuit's
    18 angles, against the JAX package's."""
    phi = _state(tct, torch.as_tensor(_angles(dtype, seed=_PHI_SEED)))
    p = torch.as_tensor(_angles(dtype)).requires_grad_()
    v = torch.real(QUANTITIES[name](tct, _state(tct, p), phi))
    (g,) = torch.autograd.grad(v, p)
    vj, gj = _jax_value_and_grad(name, dtype)
    assert torch.isfinite(g).all()
    _close(v, vj, TOL[dtype])
    _close(g, gj, 10 * TOL[dtype])


def test_reduced_density_matrix_forms_match_jax(dtype):
    """A ket (flat and (2,)*n), a density matrix and QuOperators, with an
    int cut, a list, both keyword forms, ``p`` weights and
    ``normalize=False``, against the JAX package's."""
    psi = _np(_state(tct, torch.as_tensor(_angles(dtype))))
    rho = np.outer(psi, psi.conj())
    w = np.random.default_rng(3).uniform(size=2**N).astype(RDT[dtype])
    cases = [
        ((psi, 2), {}), ((psi.reshape((2,) * N), [1, 4]), {}), ((rho, [0, 5]), {}), ((rho, 3), {}),
        ((psi,), {"subsystem_to_keep": [2, 3]}), ((rho,), {"subsystems_to_trace_out": [1, 2, 3]}),
        ((psi, [0]), {"p": w}), ((psi, [4, 1]), {"normalize": False}), ((rho, [2]), {"normalize": False}),
    ]
    for args, kw in cases:
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        _close(tq.reduced_density_matrix(*args, **kw), jq.reduced_density_matrix(*args, **jkw), TOL[dtype])
    for got, want in ((tq.QuVector(psi.reshape((2,) * N)), jq.QuVector(jnp.asarray(psi.reshape((2,) * N)))),
                      (tq.QuOperator.from_tensor(rho.reshape((2,) * 2 * N)),
                       jq.QuOperator.from_tensor(jnp.asarray(rho.reshape((2,) * 2 * N))))):
        _close(tq.reduced_density_matrix(got, [0, 3]), jq.reduced_density_matrix(want, [0, 3]), TOL[dtype])
    with pytest.raises(ValueError):
        tq.reduced_density_matrix(psi)


def test_qudit_entropy_and_dual_keywords(dtype):
    """A d=3 Schmidt state: the entropy of its ket and its density matrix,
    the keyword forms, an int cut and the mutual information 2 S(A), all
    the exact -Σ λ ln λ and the JAX package's values."""
    d = 3
    schmidt = np.array([0.6, 0.3, 0.1])
    schmidt = schmidt / np.linalg.norm(schmidt)
    exact = -np.sum(schmidt**2 * np.log(schmidt**2))
    psi = np.zeros(d * d, dtype=dtype)
    for k in range(d):
        psi[k * d + k] = schmidt[k]
    rho = np.outer(psi, psi.conj())
    for s in (psi, rho):
        for kw in ({"subsystems_to_trace_out": [0]}, {"subsystem_to_keep": [1]}, {"cut": 1}):
            got = tq.entanglement_entropy(s, dim=d, **kw)
            _close(got, exact, 1e-5)
            _close(got, jq.entanglement_entropy(s, dim=d, **kw), TOL[dtype])
    _close(tq.mutual_information(psi, subsystems_to_trace_out=[0], dim=d), 2 * exact, 1e-5)
    _close(tq.mutual_information(psi, subsystems_to_trace_out=[0], dim=d),
           jq.mutual_information(psi, subsystems_to_trace_out=[0], dim=d), TOL[dtype])


def test_known_values(dtype):
    """The toolbox's closed forms (``tests/test_quantum.py`` and
    ``test_refparity_quantum.py``): a Bell pair's entropies and negativity,
    |+><+| against I/2, a noisy Bell pair's log-negativity 0.485427, a
    two-level Gibbs state and its thermofield double."""
    bell = np.array([1, 0, 0, 1], dtype=dtype) / np.sqrt(2)
    rho = np.outer(bell, bell.conj())
    _close(tq.reduced_density_matrix(bell, [1]), np.eye(2) / 2, 1e-6)
    _close(tq.entanglement_entropy(bell, [1]), np.log(2), 1e-5)
    _close(tq.renyi_entropy(np.eye(2) / 2, 2), np.log(2), 1e-5)
    _close(tq.entanglement_entropy(np.array([1, 0, 1, 0], dtype=dtype) / np.sqrt(2), [1]), 0.0, 1e-4)
    _close(tq.entanglement_negativity(rho, [0]), 0.5, 1e-5)
    _close(tq.log_negativity(rho, [0], base="2"), 1.0, 1e-5)
    plus = np.array([[0.5, 0.5], [0.5, 0.5]], dtype=dtype)
    _close(tq.fidelity(plus, np.eye(2, dtype=dtype) / 2), 0.5, 1e-5)
    _close(tq.trace_distance(plus, np.eye(2, dtype=dtype) / 2), 0.5, 1e-4)
    dm = tct.DMCircuit(2)
    dm.h(0)
    dm.cnot(0, 1)
    dm.depolarizing(0, px=0.1, py=0.1, pz=0.1)
    noisy = dm.state()
    _close(tq.log_negativity(noisy, [0], base="2"), 0.485427, 1e-5)
    _close(tq.entanglement_negativity(noisy, [1]), 0.2, 1e-5)
    _close(tq.partial_transpose(tq.partial_transpose(noisy, [0]), [0]), noisy, 1e-6)
    h = np.diag([0.0, 1.0]).astype(dtype)
    z = 1 + np.exp(-1)
    g = tq.gibbs_state(h, beta=1.0)
    _close(torch.diagonal(g), [1 / z, np.exp(-1) / z], 1e-5)
    _close(tq.reduced_density_matrix(tq.double_state(h, beta=1.0), [1]), g, 1e-5)
    r, hh = np.array([[1.0, 0], [0, 0]], dtype=dtype), np.array([[-1.0, 0], [0, 1]], dtype=dtype)
    _close(tq.free_energy(r, hh, 0.5), -1.0, 1e-6)
    _close(tq.renyi_free_energy(r, hh, 0.5), -1.0, 1e-6)
    _close(tq.free_energy(r, tq.QuOperator.from_tensor(hh), 0.5), -1.0, 1e-6)


def test_thermal_and_purified_states_match_jax(dtype):
    """``gibbs_state``, ``double_state`` and ``purified_state`` of a
    3-qubit Hamiltonian H(a) = H0 + a H1 (non-degenerate), their values
    and the gradient in a of a readout of each (``eigh``'s gradient),
    against the JAX package's; a purified state's reduction is ρ."""
    h0 = np.asarray(jq.heisenberg_hamiltonian([(0, 1), (1, 2)], hz=0.3, hx=-0.2, sparse=False, numpy=True))
    h1 = np.asarray(jq.PauliStringSum2Dense([[1, 3, 0], [0, 2, 2]], [0.4, -0.3], numpy=True))
    o = np.asarray(jq.PauliStringSum2Dense([[3, 0, 1], [0, 1, 0]], [1.0, 0.5], numpy=True))

    def readouts(xp, mod, a, cast):
        h = cast(h0) + a * cast(h1)
        g = mod.gibbs_state(h, beta=0.8)
        d = mod.double_state(h, beta=0.8)
        p = mod.purified_state(g)
        oc = cast(o)
        return (xp.real(xp.trace(g @ oc)), xp.real(xp.sum(xp.abs(d[:8]) ** 2)),
                xp.real(xp.sum(xp.abs(p) ** 2 * xp.arange(64))), g, d, p)

    a = torch.tensor(0.37, dtype=getattr(torch, str(np.dtype(RDT[dtype]))), requires_grad=True)
    got = readouts(torch, tq, a, lambda x: torch.as_tensor(x.astype(dtype)))
    want = readouts(jnp, jq, jnp.asarray(0.37, dtype=RDT[dtype]), lambda x: jnp.asarray(x.astype(dtype)))
    jac = jax.jit(jax.jacfwd(lambda x: jnp.stack(readouts(jnp, jq, x, lambda y: jnp.asarray(y.astype(dtype)))[:3])))
    gj = jac(jnp.asarray(0.37, dtype=RDT[dtype]))
    for k in range(3):
        (g,) = torch.autograd.grad(got[k], a, retain_graph=True)
        _close(got[k], want[k], TOL[dtype])
        _close(g, gj[k], 10 * TOL[dtype])
    _close(got[3], want[3], TOL[dtype])
    _close(got[4], want[4], TOL[dtype])
    _close(tq.reduced_density_matrix(got[5].detach(), [3, 4, 5]), got[3].detach(), 10 * TOL[dtype])


def test_fidelity_gradient_at_a_pure_state(dtype):
    """Queue 3 F10: ``fidelity(|ψ><ψ|, diag(1/2, 0, 0, 1/2))`` of the Bell-type
    state ry(0, θ=0.3), cnot(0, 1) is 0.49999982 at complex64 in the JAX
    package, and its gradient in θ is NaN (``eigh``'s adjoint at the pure
    ρ's zero eigenvalues, √λ's infinite slope).  The port takes both roots
    by ``core.linalg.sqrtmh``, whose Daleckii-Krein adjoint is finite at
    rank deficiency: at complex128 its gradient equals a central difference
    (h = 1e-4) within 1e-5; at complex64, where a central difference of
    the rounding-level roots is noise, it equals the exact derivative 0 (F
    is ½ at every θ) within 1e-5.  The entropy and the negativity of the
    same state go through ``eigvalsh`` and keep finite gradients in both."""
    sigma = np.diag([0.5, 0.0, 0.0, 0.5]).astype(dtype)

    def psi(mod, t):
        c = mod.Circuit(2)
        c.ry(0, theta=t)
        c.cnot(0, 1)
        return c.state()

    def rho(xp, s):
        return xp.outer(s, xp.conj(s))

    rdt = getattr(torch, str(np.dtype(RDT[dtype])))
    t = torch.tensor(0.3, dtype=rdt, requires_grad=True)
    tj = jnp.asarray(0.3, dtype=RDT[dtype])
    f = tq.fidelity(rho(torch, psi(tct, t)), sigma)
    fj, gj = jax.jit(jax.value_and_grad(lambda x: jq.fidelity(rho(jnp, psi(tc, x)), sigma)))(tj)
    _close(f, fj, 10 * TOL[dtype])
    # the exact value is 1/2; √ of the pure ρ's rounding-level eigenvalues
    # (~√eps) moves it at complex64
    assert abs(float(fj) - 0.5) < 1e-4 and abs(f.item() - 0.5) < 1e-4
    assert np.isnan(float(gj))
    (g,) = torch.autograd.grad(f, t)
    assert torch.isfinite(g)
    if dtype == "complex128":
        h = 1e-4
        with torch.no_grad():
            cd = (tq.fidelity(rho(torch, psi(tct, torch.tensor(0.3 + h, dtype=rdt))), sigma)
                  - tq.fidelity(rho(torch, psi(tct, torch.tensor(0.3 - h, dtype=rdt))), sigma)) / (2 * h)
        assert abs(g.item() - cd.item()) <= 1e-5
    else:
        assert abs(g.item()) <= 1e-5
    for name in ("entanglement_entropy", "entanglement_negativity"):
        fn = {"entanglement_entropy": lambda m, xp, s: m.entanglement_entropy(s, [1]),
              "entanglement_negativity": lambda m, xp, s: m.entanglement_negativity(rho(xp, s), [0])}[name]
        (gt,) = torch.autograd.grad(fn(tq, torch, psi(tct, t)), t)
        gjj = jax.jit(jax.grad(lambda x: fn(jq, jnp, psi(tc, x))))(tj)
        assert np.isfinite(float(gjj)) and torch.isfinite(gt)
        _close(gt, gjj, 10 * TOL[dtype])


def test_helpers_match_jax(dtype):
    """``taylorlnm``, ``op2tensor``, ``onehot_d_tensor``, ``trace_product``
    of tensors and QuOperators, ``partial_transpose``, ``reduced_wavefunction``
    and the U(1) helpers, against the JAX package's."""
    rng = np.random.default_rng(4)
    x = (0.1 * (rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))).astype(dtype)
    _close(tq.taylorlnm(x, 6), jq.taylorlnm(jnp.asarray(x), 6), TOL[dtype])

    @tq.op2tensor
    def tr(m):
        return torch.trace(torch.as_tensor(m))

    _close(tr(tq.QuOperator.from_tensor(np.eye(2) * 2)), 4.0, 1e-6)
    _close(tr(np.eye(3)), 3.0, 1e-6)
    for i, d in ((1, 2), (2, 4), ([0, 2, 1], 3)):
        _close(tq.onehot_d_tensor(i, d), jq.onehot_d_tensor(i, d), 0)
        assert tq.onehot_d_tensor(i, d).dtype == tct.config.torch_dtype()
    o, h = np.ones([2, 2]), np.eye(2)
    for a, b in [(o, h), (tq.QuOperator.from_tensor(o), tq.QuOperator.from_tensor(h)),
                 (tq.QuOperator.from_tensor(o), h), (o, tq.QuOperator.from_tensor(h))]:
        _close(tq.trace_product(a, b), 2.0, 1e-6)
    m = rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16))
    r = (m @ m.conj().T / np.trace(m @ m.conj().T)).astype(dtype)
    _close(tq.partial_transpose(r, [0, 3]), jq.partial_transpose(jnp.asarray(r), [0, 3]), TOL[dtype])
    _close(tq.partial_transpose(tq.partial_transpose(r, [1]), [1]), r, TOL[dtype])
    psi = _np(_state(tct, torch.as_tensor(_angles(dtype))))
    for cut, meas in (([2], [1]), ([0, 4], [1, 0]), ([5, 1, 3], None)):
        _close(tq.reduced_wavefunction(psi, cut, meas), jq.reduced_wavefunction(psi, cut, meas), TOL[dtype])
    np.testing.assert_array_equal(tq.u1_inds(5, 2), jq.u1_inds(5, 2))
    assert tq.u1_inds(5, 1).tolist() == [1, 2, 4, 8, 16] and tq.u1_inds(4, 0).tolist() == [0]
    mask = tq.u1_mask(6, 3)
    assert mask.dtype == getattr(torch, tct.config.rdtypestr()) and float(mask.sum()) == 20
    _close(mask, jq.u1_mask(6, 3), 0)
    p = tq.u1_project(psi, N, 2)
    _close(p, jq.u1_project(psi, N, 2), 0)
    _close(tq.u1_enlarge(p, N, 2), jq.u1_enlarge(jnp.asarray(_np(p)), N, 2), 0)


def _tfi_mpo_fixtures():
    """``tests/test_quantum.py``'s vendored-layout TFI MPO (bond 3, L=4) as a
    TeNPy-style and a quimb-style object, and its dense Hamiltonian."""
    J, g, L = 1.0, 0.7, 4
    X = np.array([[0, 1], [1, 0.0]])
    Z = np.diag([1.0, -1.0])
    W = np.zeros((3, 3, 2, 2))
    W[0, 0] = np.eye(2)
    W[0, 1] = Z
    W[0, 2] = -g * X
    W[1, 2] = -J * Z
    W[2, 2] = np.eye(2)
    Ws = [W[0:1]] + [W] * (L - 2) + [W[:, 2:3]]
    ls = [[3 if k in (i, i + 1) else 0 for k in range(L)] for i in range(L - 1)]
    ls += [[1 if k == i else 0 for k in range(L)] for i in range(L)]
    h = tq.PauliStringSum2Dense(ls, [-J] * (L - 1) + [-g] * L, numpy=True)

    class W_:
        def __init__(self, w):
            self._w = w

        def to_ndarray(self):
            return self._w

    class TenpyMPO:
        def __init__(self):
            self.L = len(Ws)

        def get_W(self, i):
            return W_(Ws[i])

    class QuimbMPO:
        arrays = [Ws[0][0]] + [W] * (L - 2) + [Ws[-1][:, 0]]

    return TenpyMPO(), QuimbMPO(), h


def test_mpo_converters_without_their_packages(cpu):
    """``tenpy2qop`` and ``quimb2qop`` of duck-typed MPOs (no package
    needed) against the dense Hamiltonian and the JAX package's; ``qop2tn``,
    ``qop2quimb`` and ``qop2tenpy`` raise ImportError naming the package
    they need (none of the three is installed here)."""
    tenpy_mpo, quimb_mpo, h = _tfi_mpo_fixtures()
    for conv in ("tenpy2qop", "quimb2qop"):
        mpo = tenpy_mpo if conv == "tenpy2qop" else quimb_mpo
        got = getattr(tq, conv)(mpo)
        assert isinstance(got, tq.QuOperator)
        _close(got.eval_matrix(), h, 1e-12)
        _close(got.eval_matrix(), getattr(jq, conv)(mpo).eval_matrix(), 1e-6)
    op = tq.QuOperator.from_tensor(np.eye(4).reshape(2, 2, 2, 2))
    for fn, pkg in (("qop2tn", "tensornetwork"), ("qop2quimb", "quimb"), ("qop2tenpy", "tenpy")):
        with pytest.raises(ImportError, match=pkg):
            getattr(tq, fn)(op)


# ---------------------------------------------------------------------------
# the backend's sparse surface
# ---------------------------------------------------------------------------


def test_backend_sparse_surface_matches_jax(dtype):
    """``coo_sparse_matrix`` with a duplicate entry (summed, row-major),
    from scipy, ``is_sparse``, ``to_dense`` and ``sparse_dense_matmul`` of a
    vector and a matrix, against the JAX package's ``NumpyCOO``; the values'
    device is the matrix's."""
    import scipy.sparse as sp

    idx = np.array([[0, 1], [1, 0], [2, 2], [2, 0], [0, 1]])
    vals = np.array([1.0 + 1j, 2.0, -1.0, 0.5, 0.25], dtype=dtype)
    m = tct.backend.coo_sparse_matrix(idx, vals, (3, 3))
    jm = JK.coo_sparse_matrix(idx, vals, (3, 3))
    assert tct.backend.is_sparse(m) and m.is_coalesced() and m.device.type == "cpu"
    assert not tct.backend.is_sparse(torch.ones(2)) and not tct.backend.is_sparse(np.ones(2))
    assert m.indices().T.tolist() == [[0, 1], [1, 0], [2, 0], [2, 2]]
    _close(tct.backend.to_dense(m), np.asarray(jm.todense()), TOL[dtype])
    v = np.arange(3).astype(dtype)
    b = np.arange(6).reshape(3, 2).astype(dtype)
    _close(tct.backend.sparse_dense_matmul(m, torch.as_tensor(v)), JK.sparse_dense_matmul(jm, v), TOL[dtype])
    _close(tct.backend.sparse_dense_matmul(m, torch.as_tensor(b)), JK.sparse_dense_matmul(jm, b), TOL[dtype])
    a = sp.random(5, 5, density=0.4, random_state=1).astype(dtype)
    _close(tct.backend.coo_sparse_matrix_from_numpy(a), a.toarray(), TOL[dtype])
    _close(tct.backend.coo_sparse_matrix(torch.as_tensor(idx), torch.as_tensor(vals), (3, 3)), jm.todense(), TOL[dtype])


def test_exports_match_jax():
    """The JAX package's top-level names of the slice, and ``templates``."""
    for name in ("PauliStringSum2COO", "PauliStringSum2Dense", "PauliStringSum2MVP", "aslinearoperator",
                 "LinearOperator"):
        assert getattr(tct, name) is getattr(tq, name) and hasattr(tc, name)
    assert tct.templates.hamiltonians.tfim_hamiltonian and tct.templates.lattice.ChainLattice
    assert [name for name in jq.__all__ if not hasattr(tq, name)] == []


# ---------------------------------------------------------------------------
# phase 17 at a small size
# ---------------------------------------------------------------------------


def test_phase17_checks_on_the_cpu(cpu):
    """``chip_smoke._hamiltonian_checks`` (phase 17) at n=8 on the CPU, its
    card and CPU paths one: every route within its stated tolerance."""
    out = cs._hamiltonian_checks(tct, "cpu", (), **cs.HAM_SMALL)
    assert out["nnz"] == (8 + 1) * 2**8
