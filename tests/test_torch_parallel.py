"""The port's ``parallel/`` against the JAX package: the sharded statevector
(``ShardedStatevec``, ``Circuit(mesh=...)``), term sharding,
``DistributedContractor``, the process-group helpers, the export of a
traced function (with F18 of ``ROADMAP.md`` Queue 3), and the non-unitary
channels of a mesh circuit (F19: the same branch as the JAX dense circuit
on the same status, states within 1e-6 at complex64).

The port's meshes here are in-process CPU meshes of 2, 4 and 8 shards
(``Mesh(["cpu"] * k)``), and one two-process gloo group.  The JAX side is
its dense ``Circuit`` (each readout of the port held against the same
readout of the JAX state, worked in float64 with numpy: the JAX CPU
``expectation`` of a complex64 state drifts by 1e-5 at n=12), and, where the
engine's own conventions decide the result (``sample_direct``,
``measure_jit``, ``unitary_kraus``), the JAX ``Circuit(mesh=...)`` itself, in
two jitted SPMD programs on 4 of the 8 CPU devices.

Tolerances: states and readouts within 1e-5 at complex64 and 1e-10 at
complex128; gradients within 2e-4 at complex64, the JAX package's own
tolerance for the sharded gradient (``tests/test_sharded_state.py``), and
1e-10 at complex128; samples and measurement outcomes equal, at statuses
1e-3 away from every cdf boundary; ``DistributedContractor`` values and
gradients within 1e-5, its slices equal; the export within 1e-6.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from jax.sharding import Mesh as JMesh

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.parallel import DistributedContractor as JDC
from tensorcircuit_ng_tpu.parallel import term_sharded_expectation as j_term
from tensorcircuit_ng_tpu_torch import config, experimental
from tensorcircuit_ng_tpu_torch.core import kernels_multilayer, kernels_rowlayer, kernels_stack
from tensorcircuit_ng_tpu_torch.ops.gates import rx_matrix, rzz_matrix
from tensorcircuit_ng_tpu_torch.parallel import (
    DistributedContractor,
    Mesh,
    ShardedStatevec,
    default_mesh,
    term_sharded_expectation,
)

import torch_parallel_worker as worker
from chip_smoke import par_probe_circuit

ROOT = Path(__file__).resolve().parents[1]
TOL = {"complex64": 1e-5, "complex128": 1e-10}
GRAD_TOL = {"complex64": 2e-4, "complex128": 1e-10}
EXPORT_TOL = 1e-6
#: statuses are kept this far from every cdf boundary
STATUS_MARGIN = 1e-3


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
    return x.detach().cpu().resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(k):
    return Mesh(["cpu"] * k, ("sv",))


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


# ----------------------------------------------------------------------
# numpy readouts of a dense state, in float64
# ----------------------------------------------------------------------

_PAULI = {
    "x": np.array([[0, 1], [1, 0]]),
    "y": np.array([[0, -1j], [1j, 0]]),
    "z": np.diag([1.0, -1.0]),
}
_PAULI_I = [np.eye(2), _PAULI["x"], _PAULI["y"], _PAULI["z"]]


def _apply(psi, m, wires, n):
    t = np.reshape(psi, (2,) * n)
    k = len(wires)
    m = np.reshape(m, (2,) * (2 * k))
    t = np.tensordot(m, t, axes=(list(range(k, 2 * k)), list(wires)))
    return np.reshape(np.moveaxis(t, list(range(k)), list(wires)), (-1,))


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def _ry(t):
    return np.array([[np.cos(t / 2), -np.sin(t / 2)], [np.sin(t / 2), np.cos(t / 2)]])


def _ev(psi, ops, n):
    """⟨psi| Π ops |psi⟩ in complex128; ``ops`` a list of (matrix, wires)."""
    psi = np.asarray(psi, np.complex128)
    phi = psi
    for m, wires in ops:
        phi = _apply(phi, m, wires, n)
    return np.vdot(psi, phi)


def _ev_ps(psi, n, x=(), y=(), z=()):
    return _ev(psi, [(_PAULI[p], [q]) for p, qs in (("x", x), ("y", y), ("z", z)) for q in qs], n)


def _marginal(psi, wires, n):
    p = np.reshape(np.abs(np.asarray(psi, np.complex128)) ** 2, (2,) * n)
    rest = [q for q in range(n) if q not in wires]
    return np.reshape(np.transpose(p, list(wires) + rest), (2 ** len(wires), -1)).sum(1)


def _ising(psi, n, pairs, xw):
    e = sum(_ev_ps(psi, n, z=[a, b]) for a, b in pairs)
    return np.real(e + xw * sum(_ev_ps(psi, n, x=[q]) for q in range(n)))


# ----------------------------------------------------------------------
# F18 and the export
# ----------------------------------------------------------------------


def _f18_energy(theta):
    c = tct.Circuit(6, device="cpu")
    for i in range(6):
        c.ry(i, theta=theta[i] / 2 + 0.2)
        c.rx(i, theta=theta[i])
    for i in range(5):
        c.cnot(i, i + 1)
    return torch.real(c.expectation_ps(z=[0, 1]))


def _clear_tensor_caches():
    for f in (config._cached_constant, kernels_stack._readout_tensors, kernels_rowlayer._pair_shifts,
              kernels_multilayer._sign_tensors):
        f.cache_clear()


def test_f18_export_leaves_eager_path_real(tmp_path):
    """An export that meets the device-constant caches empty leaves them
    holding no fake tensor: the eager value after it is real and equal."""
    theta = torch.linspace(0.1, 0.6, 6)
    _clear_tensor_caches()
    before = _f18_energy(theta)
    _clear_tensor_caches()
    path = str(tmp_path / "f18.pt2")
    experimental.jax_func_save(path, _f18_energy, theta)
    exported = experimental.jax_func_load(path)(theta)
    after = _f18_energy(theta)
    fresh = _f18_energy(theta + 0.0)
    for v in (before, exported, after, fresh):
        assert type(v) is torch.Tensor
        assert abs(float(v) - float(before)) < EXPORT_TOL
    assert abs(float(before) - 0.9363) < 1e-4


def _zzrx_energy(zz, rx):
    n = 8
    c = tct.Circuit(n, device="cpu")
    c.h_layer()
    c.zzrx_layer(_ring(n), zz, rx)
    c.zzrx_layer(_ring(n), zz * 0.8, rx * 1.2)
    return c.expectation_zzx_energy(_ring(n), 1.0, 0.7)


def test_export_round_trip_of_a_circuit_energy(tmp_path):
    """``jax_jitted_function_save``/``_load`` of a CPU circuit energy (the
    fused zzrx path through the kernels' plain versions): saved, loaded and
    called at the traced and at other inputs, equal to the eager value."""
    rng = np.random.default_rng(11)
    zz, rx = (torch.tensor(rng.normal(size=8) * s, dtype=torch.float32) for s in (0.3, 0.4))
    path = str(tmp_path / "energy.pt2")
    experimental.jax_jitted_function_save(path, _zzrx_energy, zz, rx)
    f = experimental.jax_jitted_function_load(path)
    for a, b in ((zz, rx), (zz * 0.5, rx + 0.1)):
        assert abs(float(f(a, b)) - float(_zzrx_energy(a, b))) < EXPORT_TOL
    def dense(a, b):
        j = tc.Circuit(8)
        j.h_layer()
        j.zzrx_layer(_ring(8), a, b)
        j.zzrx_layer(_ring(8), a * 0.8, b * 1.2)
        return j.expectation_zzx_energy(pairs=_ring(8), zz_weight=1.0, x_weight=0.7)

    want = jax.jit(dense)(jnp.asarray(zz.numpy()), jnp.asarray(rx.numpy()))
    assert abs(float(f(zz, rx)) - float(want)) < TOL["complex64"]


# ----------------------------------------------------------------------
# ShardedStatevec: the functional API
# ----------------------------------------------------------------------


@pytest.mark.parametrize("ndev,n", [(2, 8), (4, 10), (8, 12)])
def test_sharded_statevec_matches_dense(dtype, ndev, n):
    tol = TOL[dtype]
    sv = ShardedStatevec(n, _mesh(ndev))
    th = np.random.default_rng(n).normal(size=n) * 0.7
    cnot = np.asarray(tc.gates.cnot().tensor)
    psi = sv.init_zero()
    for q in range(n):
        psi = sv.h(psi, q)
    for q in range(n):
        psi = sv.apply(psi, rx_matrix(th[q]), [q])
    for q in range(0, n - 1, 2):  # CNOTs on top (shard) qubits and local ones
        psi = sv.apply(psi, cnot, [q, q + 1])
    for q in range(1, n - 1, 2):
        psi = sv.apply(psi, rzz_matrix(0.3), [q, q + 1])
    psi = sv.apply(psi, cnot, [n - 1, 0])  # local control, top target
    def dense():
        c = tc.Circuit(n)
        for q in range(n):
            c.h(q)
        for q in range(n):
            c.rx(q, theta=th[q])
        for q in range(0, n - 1, 2):
            c.cnot(q, q + 1)
        for q in range(1, n - 1, 2):
            c.rzz(q, q + 1, theta=0.3)
        c.cnot(n - 1, 0)
        return c.state()

    ref = np.asarray(jax.jit(dense)())
    assert psi.dtype == getattr(torch, dtype)
    assert np.abs(_np(sv.gather(psi)) - ref).max() < tol
    assert abs(float(sv.expectation_z(psi, [0, 5])) - np.real(_ev_ps(ref, n, z=[0, 5]))) < tol
    assert abs(float(sv.norm_sq(psi)) - np.vdot(ref, ref).real) < tol
    x1 = complex(sv.expectation(psi, [(tc.gates.x().tensor, [1])]))
    assert abs(x1 - _ev_ps(ref, n, x=[1])) < tol
    bits = [int(b) for b in np.random.default_rng(1).integers(0, 2, size=n)]
    assert abs(complex(sv.amplitude(psi, bits)) - ref[int("".join(map(str, bits)), 2)]) < tol
    wires = [n - 2, 0, 3]
    assert np.abs(_np(sv.probability(psi, wires)) - _marginal(ref, wires, n)).max() < tol
    for x, y, z in (([0], [n - 1], [1, 5]), ([n - 3, 1], [2], []), ([], [0, n - 2], [1]), ([], [], [0, n - 1])):
        assert abs(complex(sv.expectation_ps(psi, x, y, z)) - _ev_ps(ref, n, x, y, z)) < tol


def test_sharded_statevec_refusals(cpu, monkeypatch):
    with pytest.raises(ValueError, match="power of two"):
        ShardedStatevec(6, _mesh(3))
    with pytest.raises(ValueError, match="local qubit"):
        ShardedStatevec(2, _mesh(4))
    with pytest.raises(ValueError, match="only"):
        tct.Circuit(6, dim=3, mesh=_mesh(2))
    with pytest.raises(ValueError, match="not the mesh's device"):
        tct.Circuit(6, device="cuda", mesh=_mesh(2))
    c = tct.Circuit(6, mesh=_mesh(2))
    assert c.device == torch.device("cpu")
    c._qir.append({"name": "mystery", "index": (0,), "gate": None})
    with pytest.raises(ValueError, match="mystery"):
        c.state()
    with pytest.raises(ValueError, match="readout error"):
        tct.Circuit(6, mesh=_mesh(2)).sample(batch=4, readout_error=[[0.9, 0.1]] * 6, status=np.full(4, 0.5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh(["cuda:0"] * 4, ("sv",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh("sv")
    assert default_mesh("sv", ["cpu"] * 2).shape == {"sv": 2}


# ----------------------------------------------------------------------
# Circuit(mesh=...) over every item kind
# ----------------------------------------------------------------------


def _kinds(c, n, x):
    """Every QIR item kind the sharded replay takes; wire 0 and 1 are top
    wires on 4 and 8 shards."""
    c.h_layer()
    c.zzrx_layer(_ring(n), x["zz"], x["rx"])  # cross pairs (n-1, 0) and (0, 1)
    c.rx_layer(x["rx2"])
    c.fused_single_qubit_layer(x["g"])
    c.fused_single_qubit_layer(x["h"], constant=True)
    c.rzz_product([(0, n - 1), (1, 2), (3, 5)], x["zz"][:3])
    c.cnot(0, n - 2)  # top control, local target
    c.cnot(1, 0)
    c.multicz(0, 1, n - 1)
    c.rzm(2, n - 3, 0, theta=0.4)
    c.rz(1, theta=0.3)  # diagonal items
    c.cz(0, 4)
    c.s(n - 1)
    c.ry(0, theta=0.2)
    c.swap(0, n - 1)
    return c


def _kind_inputs(mod, n, seed):
    rng = np.random.default_rng(seed)
    x = {k: rng.normal(size=n) * s for k, s in (("zz", 0.3), ("rx", 0.4), ("rx2", 0.5))}
    g = np.stack([_rz(a) @ _ry(b) @ _rz(d) for a, b, d in rng.normal(size=(n, 3))])
    h = np.broadcast_to(np.asarray(tc.gates.h().tensor), (n, 2, 2))
    if mod is tc:
        return {**{k: jnp.asarray(v) for k, v in x.items()}, "g": jnp.asarray(g), "h": h}
    return {**{k: torch.tensor(v) for k, v in x.items()}, "g": torch.tensor(g), "h": h}


@pytest.mark.parametrize("ndev,n", [(2, 8), (4, 9), (8, 10)])
def test_circuit_mesh_item_kinds(dtype, ndev, n):
    tol = TOL[dtype]

    def dense(x, extended):
        c = _kinds(tc.Circuit(n), n, x)
        if extended:
            c.rx(n - 1, theta=0.3)
            c.cnot(n - 1, 1)
        return c.state()

    dense = jax.jit(dense, static_argnums=1)
    cp = _kinds(tct.Circuit(n, mesh=_mesh(ndev)), n, _kind_inputs(tct, n, n))
    ref = np.asarray(dense(_kind_inputs(tc, n, n), False))
    psi = cp.state()
    assert type(psi).__name__ == "ShardedState" and len(psi.shards) == ndev
    assert np.abs(_np(psi.gather()) - ref).max() < tol
    # the kept prefix is extended by later gates, still sharded
    cp.rx(n - 1, theta=0.3)
    cp.cnot(n - 1, 1)
    ref = np.asarray(dense(_kind_inputs(tc, n, n), True))
    assert cp._state_cache is not None and cp._state_cache[2] is psi
    assert np.abs(_np(cp.state().gather()) - ref).max() < tol
    assert abs(float(cp.expectation_zzx_energy(_ring(n), 1.0, 0.7)) - _ising(ref, n, _ring(n), 0.7)) < tol
    op = np.kron(_PAULI["x"], _PAULI["y"])
    assert abs(complex(cp.expectation((op, [0, n - 2]), (tc.gates.z().tensor, [1])))
               - _ev(ref, [(op, [0, n - 2]), (_PAULI["z"], [1])], n)) < tol
    assert abs(complex(cp.expectation_ps(x=[1], y=[n - 1], z=[0])) - _ev_ps(ref, n, [1], [n - 1], [0])) < tol
    assert abs(complex(cp.amplitude("01" * (n // 2) + "1" * (n % 2))) - ref[int("01" * (n // 2) + "1" * (n % 2), 2)]) < tol
    assert np.abs(_np(cp.probability()) - np.abs(ref) ** 2).max() < tol


def test_circuit_mesh_inputs(dtype):
    n = 9
    rng = np.random.default_rng(4)
    psi0 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(dtype)
    th = rng.normal(size=n)

    def build(c):
        c.rx_layer(th)
        c.cnot(0, 5)
        c.h(1)
        return c

    ref = jax.jit(lambda: build(tc.Circuit(n, inputs=jnp.asarray(psi0))).state())()
    cp = build(tct.Circuit(n, inputs=psi0, mesh=_mesh(4)))
    assert np.abs(_np(cp.state().gather()) - np.asarray(ref)).max() < TOL[dtype]


# ----------------------------------------------------------------------
# value and gradient: the n = 9 two-layer TFIM energy on 8 shards
# ----------------------------------------------------------------------


def test_circuit_mesh_vqe_value_and_grad(dtype):
    n = 9
    pairs = _ring(n)
    rng = np.random.default_rng(7)
    zz0, rx0 = rng.normal(size=n) * 0.2, rng.normal(size=n) * 0.3

    def build(mod, zz, rx, **kw):
        c = mod.Circuit(n, **kw)
        c.h_layer()
        c.zzrx_layer(pairs, zz, rx)
        c.zzrx_layer(pairs, zz * 0.8, rx * 1.2)
        return c.expectation_zzx_energy(pairs=pairs, zz_weight=1.0, x_weight=0.7)

    vd, gd = jax.jit(jax.value_and_grad(lambda a, b: build(tc, a, b), argnums=(0, 1)))(jnp.asarray(zz0),
                                                                                         jnp.asarray(rx0))
    zz = torch.tensor(zz0, requires_grad=True)
    rx = torch.tensor(rx0, requires_grad=True)
    v = build(tct, zz, rx, mesh=_mesh(8))
    g = torch.autograd.grad(v, [zz, rx])
    assert abs(v.item() - float(vd)) < TOL[dtype]
    for a, b in zip(g, gd):
        assert np.abs(_np(a) - np.asarray(b)).max() < GRAD_TOL[dtype]


# ----------------------------------------------------------------------
# against the JAX Circuit(mesh=...): sampling, measurement, unitary_kraus
# ----------------------------------------------------------------------

N_MESH = 8


def _sample_circuit(mod, zz, rx, **kw):
    c = mod.Circuit(N_MESH, **kw)
    c.h_layer()
    c.zzrx_layer(_ring(N_MESH), zz, rx)
    c.cnot(0, 5)
    c.ry(6, theta=0.9)
    return c


def _far_statuses(rng, count, boundaries):
    out = []
    while len(out) < count:
        u = rng.uniform()
        if np.min(np.abs(boundaries - u)) > STATUS_MARGIN:
            out.append(u)
    return np.array(out)


def _measure_oracle(psi, qubits, status, n):
    """Outcomes of measuring ``qubits`` in turn (float64), and the distance
    of each status to its cdf boundary."""
    p = np.abs(np.asarray(psi, np.complex128)) ** 2
    p = np.reshape(p, (2,) * n)
    outs, gaps = [], []
    for q, u in zip(qubits, status):
        m = _marginal(np.sqrt(np.reshape(p, (-1,))), [q], n)
        p0 = m[0] / m.sum()
        o = int(u >= p0)
        outs.append(o)
        gaps.append(abs(u - p0))
        sel = [slice(None)] * n
        sel[q] = 1 - o
        p[tuple(sel)] = 0.0
    return outs, min(gaps)


def test_mesh_sampling_against_jax_mesh(cpu):
    rng = np.random.default_rng(21)
    zz, rx = rng.normal(size=N_MESH) * 0.5, rng.normal(size=N_MESH) * 0.6
    dense = np.asarray(jax.jit(lambda a, b: _sample_circuit(tc, a, b).state())(jnp.asarray(zz), jnp.asarray(rx)))
    shots = _far_statuses(rng, 64, np.cumsum(np.abs(dense.astype(np.complex128)) ** 2))
    qubits = [0, 3, 1, 7]
    while True:
        mstatus = rng.uniform(size=len(qubits))
        want, gap = _measure_oracle(dense, qubits, mstatus, N_MESH)
        if gap > STATUS_MARGIN:
            break
    jmesh = JMesh(np.array(jax.devices()[:4]), ("sv",))

    @jax.jit
    def program(zz, rx, shots, mstatus):
        c = _sample_circuit(tc, zz, rx, mesh=jmesh)
        idx = c.sample(batch=len(shots), status=shots, format="sample_int")
        bits, prob = c.measure_jit(*qubits, with_prob=True, status=mstatus)
        return idx, bits, prob

    j_idx, j_bits, j_prob = program(jnp.asarray(zz), jnp.asarray(rx), jnp.asarray(shots), jnp.asarray(mstatus))
    c = _sample_circuit(tct, torch.tensor(zz), torch.tensor(rx), mesh=_mesh(4))
    idx = c.sample(batch=len(shots), status=shots, format="sample_int")
    assert idx.dtype == torch.int32
    assert np.array_equal(_np(idx), np.asarray(j_idx))
    bits, prob = c.measure_jit(*qubits, with_prob=True, status=mstatus)
    assert np.array_equal(_np(bits), np.asarray(j_bits)) and list(_np(bits)) == want
    assert abs(float(prob) - float(j_prob)) < TOL["complex64"]
    legacy = c.sample(batch=3, status=np.stack([shots[:3]] * N_MESH, axis=1))
    assert [int("".join(map(str, _np(b))), 2) for b, _ in legacy] == list(np.asarray(j_idx)[:3])


def test_mesh_unitary_kraus_against_jax_mesh(cpu):
    """A concrete mixed-unitary channel on a top wire and one of tensor
    operators on a local wire, at statuses 1e-3 from the branch
    boundaries: the branches and the state of the JAX mesh circuit, from
    ``Circuit.unitary_kraus`` and from the engine's own ``unitary_kraus``."""
    rng = np.random.default_rng(8)
    zz, rx = rng.normal(size=N_MESH) * 0.5, rng.normal(size=N_MESH) * 0.6
    px = np.array([0.55, 0.2, 0.15, 0.1])
    concrete = [np.sqrt(p) * _PAULI_I[k] for k, p in enumerate(px)]
    a = 0.35
    tensor_ops = np.stack([np.cos(a) * np.eye(2), np.sin(a) * _PAULI["x"]])
    cum_c, cum_t = np.cumsum(px), np.cumsum([np.cos(a) ** 2, np.sin(a) ** 2])
    st = (cum_c[1] + 0.07, cum_t[0] - 0.05)
    assert min(np.min(np.abs(cum_c - st[0])), np.min(np.abs(cum_t - st[1]))) > STATUS_MARGIN
    jmesh = JMesh(np.array(jax.devices()[:4]), ("sv",))

    @jax.jit
    def program(zz, rx, ops):
        c = _sample_circuit(tc, zz, rx, mesh=jmesh)
        b1 = c.unitary_kraus(concrete, 1, status=st[0])
        b2 = c.unitary_kraus(list(ops), 4, status=st[1])
        return b1, b2, c.state()

    jb1, jb2, jstate = program(jnp.asarray(zz), jnp.asarray(rx), jnp.asarray(tensor_ops.astype(np.complex64)))
    c = _sample_circuit(tct, torch.tensor(zz), torch.tensor(rx), mesh=_mesh(4))
    b1 = c.unitary_kraus(concrete, 1, status=st[0])
    b2 = c.unitary_kraus(list(torch.tensor(tensor_ops)), 4, status=st[1])
    assert (int(b1), int(b2)) == (int(jb1), int(jb2)) == (2, 0)
    assert np.abs(_np(c.state().gather()) - np.asarray(jstate)).max() < TOL["complex64"]
    sv = c._mesh_engine
    psi = _sample_circuit(tct, torch.tensor(zz), torch.tensor(rx), mesh=_mesh(4)).state()
    psi, e1 = sv.unitary_kraus(psi, concrete, [1], status=st[0])
    psi, e2 = sv.unitary_kraus(psi, list(torch.tensor(tensor_ops)), [4], status=st[1])
    assert (int(e1), int(e2)) == (2, 0)
    assert np.abs(_np(sv.gather(psi)) - np.asarray(jstate)).max() < TOL["complex64"]


# ----------------------------------------------------------------------
# term sharding and the distributed contractor
# ----------------------------------------------------------------------


def test_term_sharded_expectation_against_jax(cpu):
    ls, ws, th = worker.term_inputs()
    pad = -len(ls) % 8  # the JAX package shards the terms as given over its 8 devices
    j_energy = j_term(lambda p: worker.term_state(tc, p).state(), np.concatenate([ls, np.zeros((pad, ls.shape[1]))]),
                      np.concatenate([ws, np.zeros(pad)]))
    jv, jg = jax.value_and_grad(j_energy)(jnp.asarray(th, dtype=jnp.float32))
    energy = term_sharded_expectation(lambda p: worker.term_state(tct, p).state(), ls, ws, _mesh(4), "sv")
    p = torch.tensor(th, dtype=torch.float32, requires_grad=True)
    v = energy(p)
    (g,) = torch.autograd.grad(v, p)
    assert abs(v.item() - float(jv)) < TOL["complex64"]
    assert np.abs(_np(g) - np.asarray(jg)).max() < GRAD_TOL["complex64"]


DC_N = 8


def _dc_circuit(mod, params):
    c = mod.Circuit(DC_N) if mod is tc else mod.Circuit(DC_N, device="cpu")
    for i in range(DC_N):
        c.ry(i, theta=0.3 * i + 0.2)
    for layer in range(6):
        for i in range(layer % 2, DC_N - 1, 2):
            c.cnot(i, i + 1)
        for i in range(DC_N):
            c.rx(i, theta=params[i] * (layer + 1))
    return c


def _dc_ir(mod):
    return lambda p: _dc_circuit(mod, p).expectation_before((mod.gates.z(), [0]), (mod.gates.z(), [1]))


def test_distributed_contractor_against_jax(cpu, tmp_path):
    """Three shards (four slices padded to six, two masked): the JAX one's
    slices, value and gradients, with ``op=None`` and with |v|^2 applied to
    the total; then a path file written by the JAX package."""
    params0 = np.random.default_rng(2).normal(size=DC_N).astype(np.float32)
    jdc = JDC(_dc_ir(tc), jnp.asarray(params0), options={"target_size": 2**6}, devices=jax.devices()[:3])
    dc = DistributedContractor(_dc_ir(tct), torch.tensor(params0), options={"target_size": 2**6},
                               mesh=Mesh(["cpu"] * 3, ("devices",)))
    rep, jrep = dc.report(), jdc.report()
    assert rep == {**jrep, "sliced_indices": [int(i) for i in jrep["sliced_indices"]]}
    assert rep["num_slices"] == 4 and rep["slices_per_device"] == 2
    p = torch.tensor(params0)
    jp = jnp.asarray(params0)
    sq = (lambda v: torch.abs(v) ** 2, lambda v: jnp.abs(v) ** 2)
    jvalue = None
    for op, jop in ((None, None), sq):
        v, g = dc.value_and_grad(p, op=op)
        jv, jg = jdc.value_and_grad(jp, op=jop)
        jvalue = float(jv) if op is None else jvalue
        assert abs(float(v) - float(jv)) < TOL["complex64"]
        assert np.abs(_np(g) - np.asarray(jg)).max() < TOL["complex64"]
        assert np.abs(_np(dc.grad(p, op=op)) - np.asarray(jg)).max() < TOL["complex64"]
    assert abs(complex(dc.value(p)) - jvalue) < TOL["complex64"]
    path = str(tmp_path / "jax_tree.pkl")
    jdc.find_path(path)
    dc2 = DistributedContractor.from_path(path, _dc_ir(tct), mesh=Mesh(["cpu"] * 2, ("devices",)))
    assert dc2.report()["sliced_indices"] == rep["sliced_indices"]
    assert abs(complex(dc2.value(p)) - jvalue) < TOL["complex64"]
    own = str(tmp_path / "tree.pkl")
    dc.find_path(own)
    dc3 = DistributedContractor.from_path(own, _dc_ir(tct), mesh=Mesh(["cpu"] * 4, ("devices",)))
    assert abs(complex(dc3.value(p)) - complex(dc.value(p))) < TOL["complex64"]


# ----------------------------------------------------------------------
# the process group: two ranks on gloo
# ----------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_references():
    """The JAX dense values of the worker's three checks, each under
    ``jax.jit``."""
    ls, ws, th = worker.term_inputs()

    def term(p):
        c = worker.term_state(tc, p)
        return sum(w * jnp.real(c.expectation_ps(x=[i for i, k in enumerate(l) if k == 1],
                                                 z=[i for i, k in enumerate(l) if k == 3])) for l, w in zip(ls, ws))

    ref = {"term": jax.jit(jax.value_and_grad(term))(jnp.asarray(th, dtype=jnp.float32))}

    def dc(p):
        v = jnp.real(worker.dc_circuit(tc, p).expectation_ps(z=[0, 1]))
        return jnp.abs(v) ** 2, v

    ref["dc"] = jax.jit(jax.value_and_grad(dc, has_aux=True))(jnp.asarray(worker.dc_params(), dtype=jnp.float32))
    zz, rx, theta = worker.sv_inputs()
    pairs = worker.sv_pairs()

    def sv(a, b):
        c = worker.sv_circuit(tc, a, rx, b)
        ez = jnp.real(c.expectation_ps(z=[0, 2]))
        en = c.expectation_zzx_energy(pairs=pairs, zz_weight=1.0, x_weight=0.7)
        return ez, en, jnp.real(c.expectation_ps(x=[0])), c.state()

    args = (jnp.asarray(zz, dtype=jnp.float32), jnp.asarray(theta, dtype=jnp.float32))
    ref["sv"] = jax.jit(sv)(*args)
    ref["sv_grads"] = [jax.jit(jax.grad(lambda a, b, i=i: sv(a, b)[i], argnums=(0, 1)))(*args) for i in (0, 1)]
    return ref


def test_gloo_two_process_group(tmp_path):
    """Two processes form a gloo group (``initialize_distributed``) and run
    ``broadcast_py_object`` and ``_fs``, ``term_sharded_expectation``,
    ``DistributedContractor.value_and_grad`` and a ``Circuit`` on a two-rank
    ``ProcessGroupMesh`` (a top-wire gate, readouts and their gradients):
    the ranks agree with each other and with the JAX dense values."""
    import json

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(r), str(port),
                               str(tmp_path / "bcast.pkl")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        ref = _gloo_references()  # while the ranks run
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["bcast"] == {"from": 0, "v": [1, 2, 3]} and r["bcast_fs"] == {"fs_from": 0}
        assert r["mesh"].startswith(f"ProcessGroupMesh(rank {r['rank']} of 2 on cpu")
    tol, gtol = TOL["complex64"], GRAD_TOL["complex64"]
    for key in ("term", "dc", "sv"):
        a, b = (np.concatenate([np.ravel(np.asarray(v, dtype=float)) for v in r[key]]) for r in res)
        assert np.abs(a - b).max() < tol, key

    jv, jg = ref["term"]
    assert abs(res[0]["term"][0] - float(jv)) < tol
    assert np.abs(np.asarray(res[0]["term"][1]) - np.asarray(jg)).max() < gtol
    (jv, jval), jg = ref["dc"]
    v, g, nslices, val = res[0]["dc"]
    assert nslices == 4
    assert abs(v - float(jv)) < tol and abs(val - float(jval)) < tol
    assert np.abs(np.asarray(g) - np.asarray(jg)).max() < gtol
    ez, ex, gz_zz, gz_th, en, gen_zz, gen_th, state = res[0]["sv"]
    jez, jen, jex, jstate = ref["sv"]
    assert np.abs(np.array([complex(*a) for a in state]) - np.asarray(jstate)).max() < tol
    for got, want in ((ez, jez), (ex, jex), (en, jen)):
        assert abs(got - float(want)) < tol
    (jgz_zz, jgz_th), (jgen_zz, jgen_th) = ref["sv_grads"]
    for got, want in ((gz_zz, jgz_zz), (gz_th, jgz_th), (gen_zz, jgen_zz), (gen_th, jgen_th)):
        assert np.abs(np.asarray(got) - np.asarray(want)).max() < gtol


def test_parallel_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 21 at a small size on CPU meshes (gloo for
    the one-rank group)."""
    import chip_smoke

    times = chip_smoke._parallel_checks(tct, "cpu", (), **chip_smoke.PAR_SMALL)
    assert any(label.startswith("(d)") for label in times)


# ----------------------------------------------------------------------
# F19: the non-unitary channels on a mesh circuit
# ----------------------------------------------------------------------

#: each channel kind of F19 (``ROADMAP.md`` Queue 3) with a fixed status
_F19_KINDS = {
    "amplitudedamping": lambda c, w: c.amplitudedamping(w, gamma=0.3, status=0.35),
    "phasedamping": lambda c, w: c.phasedamping(w, gamma=0.2, status=0.6),
    "reset": lambda c, w: c.reset(w, status=0.4),
    "thermalrelaxation": lambda c, w: c.thermalrelaxation(w, t1=2.0, t2=1.0, time=0.5, status=0.6),
    "general_kraus": lambda c, w: c.general_kraus(
        [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * np.diag([1.0, -1.0])], w, status=0.5),
    "cond_measure": lambda c, w: c.cond_measure(w, status=0.3),
}


@pytest.mark.parametrize("kind", list(_F19_KINDS))
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_f19_mesh_channels_match_jax_dense(cpu, ndev, kind):
    """F19: a mesh circuit takes each channel kind on a top wire (0) and a
    local wire (5) of F19's probe (``chip_smoke.par_probe_circuit`` at n=6),
    its probabilities computed on the shards: the same
    branch as the JAX dense circuit on the same status, and the same state
    within 1e-6 at complex64; the state stays sharded."""
    for w in (0, 5):
        cj = par_probe_circuit(tc, 6)
        rj = int(_F19_KINDS[kind](cj, w))
        cp = par_probe_circuit(tct, 6, mesh=_mesh(ndev))
        rp = int(_F19_KINDS[kind](cp, w))
        psi = cp.state()
        assert type(psi).__name__ == "ShardedState" and len(psi.shards) == ndev
        assert rp == rj
        assert np.abs(_np(psi.gather()) - np.asarray(cj.state())).max() < 1e-6


def test_f19_mesh_noise_conf_matches_jax_dense(cpu):
    """F19 through a ``NoiseConf``: amplitude damping on both wires of each
    cnot, one trajectory of fixed statuses, on 4 shards against the JAX
    dense circuit (states within 1e-6)."""
    status = np.array([0.35, 0.8, 0.97, 0.1])
    ncj, ncp = tc.NoiseConf(), tct.NoiseConf()
    ncj.add_noise("cnot", tc.channels.amplitudedampingchannel(0.3, 1.0))
    ncp.add_noise("cnot", tct.channels.amplitudedampingchannel(0.3, 1.0))
    cj = tc.circuit_with_noise(par_probe_circuit(tc, 6), ncj, status=status)
    cp = tct.circuit_with_noise(par_probe_circuit(tct, 6, mesh=_mesh(4)), ncp, status=status)
    assert np.abs(_np(cp.state().gather()) - np.asarray(cj.state())).max() < 1e-6
