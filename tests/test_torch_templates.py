"""The port's ``templates/`` against the JAX package's, on the CPU, case by
case after ``tests/test_templates.py`` and ``tests/test_refparity_templates.py``:
lattices and graphs, the QUBO/Ising conversions, the Hamiltonians (COO and
dense), the chemistry helpers, the circuit blocks and ansätze (states and
angle gradients), the expectation templates (dense, sparse, matrix-free
and QuOperator Hamiltonians; the term-by-term spin models; the
parameterized measurements) and the data encodings.

Inputs are numpy-seeded and handed to both packages, at complex64 (1e-5)
and complex128 (1e-10), each relative to max(1, the largest entry); graph
and lattice structure (pairs, identifiers, weights) is compared exactly.
"""

import functools

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import templates as jt
from tensorcircuit_ng_tpu_torch import templates as tt

TOL = {"complex64": 1e-5, "complex128": 1e-10}
RDT = {"complex64": np.float32, "complex128": np.float64}


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
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _edges(g):
    return sorted((min(a, b), max(a, b), d.get("weight")) for a, b, d in g.edges(data=True))


# ---------------------------------------------------------------------------
# lattices, graphs, conversions
# ---------------------------------------------------------------------------


LATTICES = {
    "chain": lambda m: m.lattice.ChainLattice(6, pbc=True),
    "chain_open": lambda m: m.lattice.ChainLattice(6, pbc=False),
    "square": lambda m: m.lattice.SquareLattice((3, 3), pbc=False),
    "square_pbc": lambda m: m.lattice.SquareLattice((4, 3)),
    "rectangular": lambda m: m.lattice.RectangularLattice((3, 2), pbc=False),
    "honeycomb": lambda m: m.lattice.HoneycombLattice((2, 2)),
    "triangular": lambda m: m.lattice.TriangularLattice((3, 3)),
    "kagome": lambda m: m.lattice.KagomeLattice((2, 2)),
    "lieb": lambda m: m.lattice.LiebLattice((2, 2)),
    "checkerboard": lambda m: m.lattice.CheckerboardLattice((2, 2), pbc=False),
    "cubic": lambda m: m.lattice.CubicLattice((2, 2, 2)),
    "dimerized": lambda m: m.lattice.DimerizedChainLattice(4, pbc=False),
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_lattices_match_jax(name):
    """Sites, identifiers, coordinates, distances and the first- and
    second-neighbour bonds of each named lattice."""
    got, want = LATTICES[name](tt), LATTICES[name](jt)
    assert got.num_sites == want.num_sites == len(got) and got.dimensionality == want.dimensionality
    assert got.sites == want.sites
    np.testing.assert_array_equal(got.get_coordinates(), want.get_coordinates())
    np.testing.assert_array_equal(got.distance_matrix(), want.distance_matrix())
    for k in (1, 2):
        assert got.get_neighbor_pairs(k) == want.get_neighbor_pairs(k) == got.get_all_pairs(k)
    assert sorted(got.to_networkx().edges) == sorted(want.to_networkx().edges)


def test_lattice_counts_and_customize():
    """``tests/test_templates.py``'s counts (a ring of 6, the open 3x3 grid's
    12 bonds and 8 diagonals, the unit-cell site counts), ``CustomizeLattice``
    with added and removed sites, and ``get_compatible_layers``."""
    lat = tt.lattice
    assert len(lat.ChainLattice(6, pbc=True).get_neighbor_pairs(1)) == 6
    assert len(lat.ChainLattice(6, pbc=False).get_neighbor_pairs(1)) == 5
    sq = lat.SquareLattice((3, 3), pbc=False)
    assert (len(sq.get_neighbor_pairs(1)), len(sq.get_neighbor_pairs(2))) == (12, 8)
    assert [lat.HoneycombLattice((2, 2)).num_sites, lat.KagomeLattice((2, 2)).num_sites,
            lat.LiebLattice((2, 2)).num_sites, lat.TriangularLattice((3, 3)).num_sites,
            lat.CubicLattice((2, 2, 2)).num_sites] == [8, 12, 12, 9, 8]
    c, jc = (m.lattice.CustomizeLattice(2, ["a", "b", "c"], [[0, 0], [1, 0], [2, 0]]) for m in (tt, jt))
    assert c.get_index("b") == 1 and c.get_identifier(2) == "c"
    for x in (c, jc):
        x.add_sites(["d"], [[3, 0]]).remove_sites(["a"])
    assert c.sites == jc.sites == ["b", "c", "d"] and c.get_neighbor_pairs() == jc.get_neighbor_pairs()
    assert lat.CustomizeLattice.from_lattice(sq).get_neighbor_pairs() == sq.get_neighbor_pairs()
    bonds = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    layers = lat.get_compatible_layers(bonds)
    assert layers == jt.lattice.get_compatible_layers(bonds)
    for layer in layers:
        used = [q for b in layer for q in b]
        assert len(used) == len(set(used))
    assert sum(len(x) for x in layers) == len(bonds)


@pytest.mark.parametrize(
    "make",
    [lambda m: m.graphs.Line1D(7), lambda m: m.graphs.Line1D(5, pbc=False, weight=0.5),
     lambda m: m.graphs.Even1D(8), lambda m: m.graphs.Odd1D(8), lambda m: m.graphs.regular_graph(3, 10, seed=3),
     lambda m: m.graphs.regular_graph(3, 8, seed=1, weights=True), lambda m: m.graphs.erdos_graph(9, 0.4, seed=2),
     lambda m: m.graphs.erdos_graph(9, 0.5, seed=4, weights=True), lambda m: m.graphs.Grid2DCoord(3, 4).lattice_graph(),
     lambda m: m.graphs.Grid2DCoord(4, 2).lattice_graph(pbc=False)],
    ids=["line", "line_open", "even", "odd", "regular", "regular_w", "erdos", "erdos_w", "grid", "grid_open"],
)
def test_graphs_match_jax(make):
    """Nodes, node weights, edges and edge weights of each generator."""
    got, want = make(tt), make(jt)
    assert list(got.nodes(data=True)) == list(want.nodes(data=True))
    assert _edges(got) == _edges(want)


def test_grid2dcoord():
    """``Grid2DCoord``'s index maps and bonds (``tests/test_templates.py``)."""
    g, jg = tt.graphs.Grid2DCoord(3, 2), jt.graphs.Grid2DCoord(3, 2)
    assert g.two2one(*g.one2two(4)) == 4 and g.one2two(4) == jg.one2two(4)
    assert len(g.all_rows(pbc=False)) == 4 and len(g.all_cols(pbc=False)) == 3
    for pbc in (False, True):
        assert g.all_rows(pbc) == jg.all_rows(pbc) and g.all_cols(pbc) == jg.all_cols(pbc)


def test_qubo_ising_conversions_match_jax():
    """QUBO -> Ising (structures, weights, offset) equal to the JAX
    package's and exact on every bit string; back to a QUBO; ``get_ps`` of
    an openfermion-style operator."""
    q = np.array([[1.0, -2.0, 0.5], [-2.0, 3.0, 1.0], [0.5, 1.0, -1.0]])
    got, want = tt.conversions.QUBO_to_Ising(q), jt.conversions.QUBO_to_Ising(q)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    assert abs(got[2] - want[2]) < 1e-12
    structures, weights, offset = got
    for k in range(8):
        x = np.array([(k >> (2 - i)) & 1 for i in range(3)], dtype=float)
        z = 1 - 2 * x
        e = offset + sum(w * np.prod([z[i] for i, v in enumerate(l) if v == 3]) for l, w in zip(structures, weights))
        np.testing.assert_allclose(x @ q @ x, e, atol=1e-9)
    q2, const = tt.conversions.Ising_to_QUBO(structures, weights, offset)
    jq2, jconst = jt.conversions.Ising_to_QUBO(structures, weights, offset)
    np.testing.assert_allclose(q2, jq2, atol=1e-12)
    assert abs(const - jconst) < 1e-12

    class FakeQO:
        terms = {((0, "X"), (2, "Z")): 0.5, ((1, "Y"),): -1.0}

    ps, w = tt.conversions.get_ps(FakeQO(), 3)
    assert ps.tolist() == [[1, 0, 3], [0, 2, 0]] and w.tolist() == [0.5, -1.0]


# ---------------------------------------------------------------------------
# Hamiltonians
# ---------------------------------------------------------------------------


HAMILTONIANS = {
    "tfim": lambda m, sparse: m.hamiltonians.tfim_hamiltonian(5, j=0.8, h=-1.1, sparse=sparse),
    "tfim_pbc": lambda m, sparse: m.hamiltonians.tfim_hamiltonian(4, pbc=True, sparse=sparse),
    "ising": lambda m, sparse: m.hamiltonians.ising_hamiltonian(m.graphs.regular_graph(3, 6, seed=5, weights=True),
                                                                 sparse=sparse),
    "ising_edges": lambda m, sparse: m.hamiltonians.ising_hamiltonian([(0, 1), (1, 2), (2, 0)], sparse=sparse),
    "heisenberg": lambda m, sparse: m.hamiltonians.heisenberg_hamiltonian(m.graphs.Line1D(5), hz=0.2, sparse=sparse),
    "rydberg": lambda m, sparse: m.hamiltonians.rydberg_hamiltonian(
        m.lattice.ChainLattice(4, pbc=False), omega=1.0, delta=0.5, c6=1.0, sparse=sparse),
    "rydberg_cutoff": lambda m, sparse: m.hamiltonians.rydberg_hamiltonian(
        np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.5], [2.0, 1.0]]), omega=0.7, delta=-0.3, cutoff=1.6, sparse=sparse),
    "h2": lambda m, sparse: m.chems.h2_hamiltonian(sparse=sparse),
}


@pytest.mark.parametrize("name", sorted(HAMILTONIANS))
def test_hamiltonians_match_jax(dtype, name):
    """Each Hamiltonian as COO (indices equal, values) and dense against
    the JAX package's; each Hermitian."""
    got, want = HAMILTONIANS[name](tt, True), HAMILTONIANS[name](jt, True)
    assert tct.backend.is_sparse(got) and got.dtype == tct.config.torch_dtype()
    np.testing.assert_array_equal(got.indices().T.numpy(), want.indices)
    _close(got.values(), want.values, TOL[dtype])
    dense = HAMILTONIANS[name](tt, False)
    _close(dense, HAMILTONIANS[name](jt, False), TOL[dtype])
    _close(dense, _np(dense).conj().T, 0)
    _close(dense, got, 0)


def test_tfim_sign_convention():
    """``tfim_hamiltonian`` is j ΣZZ + h ΣX (h = -1 by default), the
    ``expectation_zzx_energy(pairs, 1.0, -1.0)`` of the TFIM path: equal on
    a random state."""
    n = 5
    rng = np.random.default_rng(0)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi = torch.as_tensor(psi / np.linalg.norm(psi))
    with tct.set_device("cpu"), tct.set_dtype("complex128"):
        c = tct.Circuit(n, inputs=psi)
        e = tt.measurements.operator_expectation(c, tt.hamiltonians.tfim_hamiltonian(n))
        want = c.expectation_zzx_energy([(i, i + 1) for i in range(n - 1)], 1.0, -1.0)
    _close(e, want, 1e-12)


def test_jordan_wigner_two_body_matches_jax():
    """The JW strings and weights of a real symmetric hopping matrix, and
    its spectrum: the one-body energies filled."""
    h = np.array([[0.5, -1.0, 0.0, 0.2], [-1.0, 0.1, -0.7, 0.0], [0.0, -0.7, -0.3, 0.4], [0.2, 0.0, 0.4, 0.0]])
    got, want = tt.chems.jordan_wigner_two_body(h), jt.chems.jordan_wigner_two_body(h)
    assert got[0] == want[0] and got[1] == want[1]
    with tct.set_device("cpu"), tct.set_dtype("complex128"):
        m = _np(tct.PauliStringSum2Dense(*got))
    e1 = np.linalg.eigvalsh(h)
    fock = sorted(sum(e1[i] for i in range(4) if (k >> i) & 1) for k in range(16))
    np.testing.assert_allclose(np.linalg.eigvalsh(m), fock, atol=1e-10)


# ---------------------------------------------------------------------------
# blocks and ansätze
# ---------------------------------------------------------------------------


def _qaoa_terms():
    structures, weights, _ = jt.conversions.QUBO_to_Ising(np.array([[1.0, -2.0, 0.5], [-2.0, 3.0, 1.0],
                                                                    [0.5, 1.0, -1.0]]))
    return structures + [[3, 3, 3]], weights + [0.4]


CIRCUITS = {
    "qaoa_x": lambda m, p: m.ansatz.QAOA_ansatz_for_Ising(p[:4], 2, *_qaoa_terms()),
    "qaoa_xy": lambda m, p: m.ansatz.QAOA_ansatz_for_Ising(p[:4], 2, *_qaoa_terms(), mixer="XY"),
    "qaoa_zz": lambda m, p: m.ansatz.QAOA_ansatz_for_Ising(p[:2], 1, *_qaoa_terms(), mixer="ZZ"),
    "hea": lambda m, p: m.ansatz.hea_ansatz(p[:12], 3, 1),
    "example_block": lambda m, p: m.blocks.example_block(_circ(m, 3), p[:12], nlayers=2),
    "qaoa_block": lambda m, p: m.blocks.QAOA_block(_circ(m, 4), m.graphs.regular_graph(3, 4, seed=2, weights=True),
                                                   p[0], p[1]),
    "grid2d_entangling": lambda m, p: m.blocks.Grid2D_entangling(
        _circ(m, 4), m.graphs.Grid2DCoord(2, 2), np.kron(np.array([[0, 1], [1, 0]]), np.array([[0, 1], [1, 0]])), p),
    "qft": lambda m, p: m.blocks.qft(_rotated(m, 4, p), *range(4)),
    "qft_inverse": lambda m, p: m.blocks.qft(_rotated(m, 4, p), 0, 2, 3, inverse=True, do_swaps=False),
    "bell_pair": lambda m, p: m.blocks.Bell_pair_block(_rotated(m, 4, p), links=[(0, 2), (1, 3)]),
}


def _circ(mod, n):
    return (tct if mod is tt else tc).Circuit(n)


def _rotated(mod, n, p):
    c = _circ(mod, n)
    for q in range(n):
        c.ry(q, theta=p[q])
    return c


def _angles(dtype, size=12, seed=3):
    return (np.random.default_rng(seed).normal(size=size) * 0.8).astype(RDT[dtype])


@functools.lru_cache(maxsize=None)
def _jax_circuit(name, dtype):
    tc.set_dtype(dtype)

    def energy(p):
        s = CIRCUITS[name](jt, p).state()
        w = jnp.arange(s.shape[0], dtype=jnp.real(s).dtype)
        return jnp.sum(jnp.abs(s) ** 2 * w), s

    (v, s), g = jax.jit(jax.value_and_grad(energy, has_aux=True))(jnp.asarray(_angles(dtype)))
    return np.asarray(s), float(v), np.asarray(g)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_blocks_and_ansatze_match_jax(dtype, name):
    """The state of each block or ansatz and the gradient in its angles of
    Σ_k k |psi_k|² (angles a tensor with autograd), against the JAX
    package's."""
    p = torch.as_tensor(_angles(dtype)).requires_grad_()
    s = CIRCUITS[name](tt, p).state()
    v = torch.sum(torch.abs(s) ** 2 * torch.arange(s.shape[0], dtype=p.dtype))
    (g,) = torch.autograd.grad(v, p)
    ws, wv, wg = _jax_circuit(name, dtype)
    _close(s, ws, TOL[dtype])
    _close(v, wv, TOL[dtype])
    _close(g, wg, 10 * TOL[dtype])


def test_block_known_states(cpu):
    """QFT|0> is uniform and the QFT's matrix the DFT (its inverse the
    adjoint); the Bell block gives singlets (opposite bits on every
    sample); ``state_centric`` lifts it; the HEA at zero angles is |0>;
    a diagonal ``Grid2D_entangling`` is a phase on |0000>."""
    n = 4
    c = tt.blocks.qft(tct.Circuit(3))
    _close(c.state(), np.ones(8) / np.sqrt(8), 1e-6)
    big = 2**n
    dft = np.exp(2j * np.pi * np.outer(np.arange(big), np.arange(big)) / big) / np.sqrt(big)
    _close(tt.blocks.qft(tct.Circuit(n), *range(n)).matrix(), dft, 1e-6)
    _close(tt.blocks.qft(tct.Circuit(n), *range(n), inverse=True).matrix(), dft.conj().T, 1e-6)
    bell = tt.blocks.Bell_pair_block(tct.Circuit(n))
    for k in range(6):
        bits, _ = bell.perfect_sampling(status=np.random.default_rng(k).uniform(size=n))
        bits = _np(bits)
        assert bits[0] != bits[1] and bits[2] != bits[3]
    s = tt.blocks.state_centric(tt.blocks.Bell_pair_block)(torch.tensor([1.0, 0, 0, 0], dtype=torch.complex64))
    _close(s, [0, 0.70710677, -0.70710677, 0], 1e-6)
    assert abs(_np(tt.ansatz.hea_ansatz(np.zeros((3, 2, n)), n, 2).state())[0]) > 0.99
    coord = tt.graphs.Grid2DCoord(2, 2)
    zz = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
    nb = len(coord.all_rows()) + len(coord.all_cols())
    s = _np(tt.blocks.Grid2D_entangling(tct.Circuit(n), coord, zz, torch.ones(nb) * 0.3).state())
    assert abs(s[0] - np.exp(-1j * 0.3 * nb)) < 1e-5
    assert tt.blocks.grid_coord(2, 3) == jt.blocks.grid_coord(2, 3)


# ---------------------------------------------------------------------------
# expectation templates
# ---------------------------------------------------------------------------


def _tfim_circuit(mod, p, n=5):
    c = _circ(mod, n)
    for q in range(n):
        c.ry(q, theta=p[q])
    for q in range(n - 1):
        c.cnot(q, q + 1)
    for q in range(n):
        c.rx(q, theta=p[n + q])
    return c


def _hamiltonian_forms(mod, n=5):
    qu = (tct if mod is tt else tc).quantum
    ls = [[3 if k in (i, i + 1) else 0 for k in range(n)] for i in range(n - 1)]
    ls += [[1 if k == i else 0 for k in range(n)] for i in range(n)] + [[2, 0, 2, 0, 0]]
    w = [1.0] * (n - 1) + [-1.0] * n + [0.3]
    dense = qu.PauliStringSum2Dense(ls, w)
    return {
        "sparse": qu.PauliStringSum2COO(ls, w),
        "dense": dense,
        "mvp": qu.PauliStringSum2MVP(ls, w),
        "quoperator": qu.QuOperator.from_tensor(jnp.reshape(jnp.asarray(dense), (2,) * 2 * n) if mod is jt
                                                else torch.reshape(dense, (2,) * 2 * n)),
    }


@functools.lru_cache(maxsize=None)
def _jax_expectation(form, dtype):
    tc.set_dtype(dtype)
    h = _hamiltonian_forms(jt)[form]
    v, g = jax.jit(jax.value_and_grad(lambda p: jt.measurements.operator_expectation(_tfim_circuit(jt, p), h)))(
        jnp.asarray(_angles(dtype, 10)))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("form", ["sparse", "dense", "mvp", "quoperator"])
def test_operator_expectation_forms_match_jax(dtype, form):
    """``operator_expectation`` (and its ``sparse_`` and ``mpo_`` names) of a
    TFIM-with-YY Hamiltonian as COO, dense, matrix-free and QuOperator: the
    value and its angle gradient against the JAX package's."""
    h = _hamiltonian_forms(tt)[form]
    p = torch.as_tensor(_angles(dtype, 10)).requires_grad_()
    c = _tfim_circuit(tt, p)
    e = tt.measurements.operator_expectation(c, h)
    (g,) = torch.autograd.grad(e, p)
    v, gj = _jax_expectation(form, dtype)
    _close(e, v, TOL[dtype])
    _close(g, gj, 10 * TOL[dtype])
    _close(tt.measurements.sparse_expectation(c, h), v, TOL[dtype])
    _close(tt.measurements.mpo_expectation(c, h), v, TOL[dtype])
    _close(tt.measurements.operator_expectation(c.state().detach(), h), v, TOL[dtype])


def test_operator_expectation_of_a_product_state(cpu):
    """|+>^n: <X_i> = 1 and <ZZ> = 0, so the TFIM's sparse and dense
    energies are -n (``tests/test_templates.py``); the three forms of
    ``test_refparity_templates.py`` at ry(θ=1)|0>, h|0>: 0.84147 and
    gradient 0.54032."""
    n = 4
    c = tct.Circuit(n)
    for i in range(n):
        c.h(i)
    for sparse in (True, False):
        _close(tt.measurements.operator_expectation(c, tt.hamiltonians.tfim_hamiltonian(n, sparse=sparse)), -n, 1e-5)
    x = np.array([[0, 1], [1, 0.0]])
    for h in (torch.as_tensor(np.kron(x, np.eye(2)), dtype=torch.complex64), tct.quantum.PauliString2COO([1, 0]),
              tct.QuOperator.from_local_tensor(x, [2, 2], [0])):
        t = torch.ones((), requires_grad=True)
        c = tct.Circuit(2)
        c.ry(0, theta=t)
        c.h(1)
        e = tt.measurements.operator_expectation(c, h)
        (g,) = torch.autograd.grad(e, t)
        _close(e, 0.84147, 1e-4)
        _close(g, 0.54032, 1e-4)


MEASUREMENTS = {
    "heisenberg": lambda m, c, p: m.measurements.heisenberg_measurements(c, m.graphs.Line1D(5, pbc=False)),
    "heisenberg_fields": lambda m, c, p: m.measurements.heisenberg_measurements(
        c, [(0, 2), (1, 3), (4, 0)], hzz=0.5, hxx=-0.3, hyy=0.8, hz=0.2, hx=-0.4, hy=0.1, reuse=False),
    "spin_glass": lambda m, c, p: m.measurements.spin_glass_measurements(c, _weighted_graph()),
    "any": lambda m, c, p: m.measurements.any_measurements(c, np.array([1, 0, 2, 3, 3])),
    "any_local": lambda m, c, p: m.measurements.any_local_measurements(c, np.array([2, 1, 3]), [4, 0, 2]),
    "parameterized": lambda m, c, p: m.measurements.parameterized_measurements(c, np.array([3, 1, 0, 2, 3])),
    "parameterized_local": lambda m, c, p: m.measurements.parameterized_local_measurements(
        c, _local_weights(p)).sum(),
    "parameterized_local_onehot": lambda m, c, p: m.measurements.parameterized_local_measurements(
        c, np.array([3, 3, 1, 0, 2]), onehot=True).sum(),
}


def _weighted_graph():
    g = nx.Graph()
    for i, w in enumerate([0.0, 0.3, 0.0, -0.2, 0.5]):
        g.add_node(i, weight=w)
    for a, b, w in [(0, 1, 1.0), (1, 2, -0.5), (2, 4, 0.7), (3, 0, 1.2)]:
        g.add_edge(a, b, weight=w)
    return g


def _local_weights(p):
    """[5, 4] Pauli weights that depend on the angles (a gradient path
    through the structure)."""
    base = np.random.default_rng(1).normal(size=(5, 4))
    if isinstance(p, torch.Tensor):
        return torch.as_tensor(base, dtype=p.dtype) * p[:5, None]
    return jnp.asarray(base, dtype=p.dtype) * p[:5, None]


@functools.lru_cache(maxsize=None)
def _jax_measurement(name, dtype):
    tc.set_dtype(dtype)
    v, g = jax.jit(jax.value_and_grad(lambda p: jnp.real(MEASUREMENTS[name](jt, _tfim_circuit(jt, p), p))))(
        jnp.asarray(_angles(dtype, 10)))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("name", sorted(MEASUREMENTS))
def test_measurement_templates_match_jax(dtype, name):
    """The term-by-term spin models, ``any_*`` and the parameterized
    measurements on a 5-qubit circuit: the value and its angle gradient."""
    p = torch.as_tensor(_angles(dtype, 10)).requires_grad_()
    v = torch.real(MEASUREMENTS[name](tt, _tfim_circuit(tt, p), p))
    (g,) = torch.autograd.grad(v, p)
    vj, gj = _jax_measurement(name, dtype)
    _close(v, vj, TOL[dtype])
    _close(g, gj, 10 * TOL[dtype])


def test_heisenberg_measurements_equal_the_hamiltonian(cpu):
    """``heisenberg_measurements`` term by term equals ``operator_expectation``
    of ``heisenberg_hamiltonian`` (``tests/test_templates.py``); a local
    parameterized measurement gives [-1, -1, 1] on X_0 CNOT(0, 1) H_2
    (``test_refparity_templates.py``)."""
    n = 4
    g = tt.graphs.Line1D(n, pbc=False)
    c = tct.Circuit(n)
    for i in range(n):
        c.rx(i, theta=0.3 * (i + 1))
    _close(tt.measurements.heisenberg_measurements(c, g),
           tt.measurements.operator_expectation(c, tt.hamiltonians.heisenberg_hamiltonian(g, sparse=False)), 1e-5)
    c = tct.Circuit(3)
    c.x(0)
    c.cnot(0, 1)
    c.h(2)
    _close(tt.measurements.parameterized_local_measurements(c, np.array([3, 3, 1]), onehot=True), [-1, -1, 1], 1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_amplitude_encoding_matches_jax(cpu):
    """One datum normalized and padded, one cut to 2^n first, a zero datum,
    an index gather, and a batch by ``torch.vmap``, against the JAX
    package's (``tests/test_templates.py``, ``test_refparity_templates.py``)."""
    enc, jenc = tt.dataset.amplitude_encoding, jt.dataset.amplitude_encoding
    for fig, n, index in ((np.arange(16.0), 4, None), (np.arange(20.0), 3, None), (np.zeros(5), 3, None),
                          (np.eye(2), 2, np.array([0, 3, 1, 2])), (np.ones([2, 2]), 3, None)):
        got = enc(fig.astype(np.float32), n, index)
        _close(got, jenc(jnp.asarray(fig, jnp.float32), n, None if index is None else jnp.asarray(index)), 1e-6)
    _close(enc(np.arange(16.0), 4).norm(), 1.0, 1e-6)
    xb = np.random.default_rng(0).normal(size=(5, 10)).astype(np.float32)
    vb = torch.vmap(lambda f: enc(f, 4))(torch.as_tensor(xb))
    assert tuple(vb.shape) == (5, 16)
    _close(vb, jax.vmap(lambda f: jenc(f, 4))(jnp.asarray(xb)), 1e-6)
    _close(torch.linalg.vector_norm(vb, dim=1), np.ones(5), 1e-5)
    _close(enc(np.stack([np.eye(2), np.ones([2, 2])])[1], 3), [0.5, 0.5, 0.5, 0.5, 0, 0, 0, 0], 1e-6)


def test_mnist_pair_data_takes_a_loader():
    """The two classes of a loader's data, relabelled and scaled (and
    thresholded), as the JAX package's; no loader is a ValueError."""
    rng = np.random.default_rng(0)
    data = ((rng.integers(0, 256, size=(40, 4, 4)).astype(float), rng.integers(0, 10, size=40)),
            (rng.integers(0, 256, size=(20, 4, 4)).astype(float), rng.integers(0, 10, size=20)))
    for binarize in (False, True):
        got = tt.dataset.mnist_pair_data(2, 7, binarize=binarize, loader=lambda: data)
        want = jt.dataset.mnist_pair_data(2, 7, binarize=binarize, loader=lambda: data)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="loader"):
        tt.dataset.mnist_pair_data()


def test_templates_take_the_configured_device(monkeypatch):
    """Template Hamiltonians and circuits run on the configured device, or
    on ``device=``: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        for build in (lambda: tt.hamiltonians.tfim_hamiltonian(3), lambda: tt.chems.h2_hamiltonian(),
                      lambda: tt.hamiltonians.ising_hamiltonian([(0, 1)], sparse=False),
                      lambda: tt.ansatz.hea_ansatz(np.zeros((2, 2, 3)), 3, 1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        assert tt.hamiltonians.tfim_hamiltonian(3, device="cpu").device.type == "cpu"
        assert tt.ansatz.hea_ansatz(np.zeros((2, 2, 3)), 3, 1, device="cpu").state().device.type == "cpu"
