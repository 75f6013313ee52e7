"""The port's hand-written kernels on a CUDA card.

Every test here needs the card and skips without one.  The file imports
neither JAX nor the JAX package, so that it also runs where only PyTorch is
installed; on the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA inputs, and
the circuit on the card (through the kernels) against the circuit on the CPU
(plain versions).  Tolerance: both sides compute in float32 with sums in
another order; amplitudes are O(2^-n/2), so an absolute 2e-6 on a state of
norm 1; the energy, a sum of ~2n terms of size <= 1, within 2e-5 * n.
Gradients are float32 sums over the whole state: each within ``GRAD_RTOL``
of its largest entry (about 100 float32 ulps); a circuit gradient within
1e-4, as in ``tests/test_torch_circuit.py`` at n=20.  K5 (``jacobi_svd``) is
held to ``chip_smoke.py``'s SVD tolerances, which state their reasons, and
``ParallelTEBD`` on the card (float32 Jacobi) to the CPU path in complex128
within 1e-4, as ``chip_smoke.py`` holds it at n=60.  K9-K12 (the
whole-block multilayer and rotx kernels) as K1-K8, and the QAOA cost of
``chip_smoke.qaoa_energy`` on the card in both forms against the CPU path,
1e-4 on energy and gradient.  K3/K4 at the shared row stage's boundaries
(1-11 walked bits) as K3/K4, bit for bit twice; their plan as the card
reports it against ``zzrx_bwd_plan``.  K1/K3 with the row kron (K13/K14)
as K1/K3, the ``FUSE_ROWM`` TFIM gradient as the circuit gradients; K7 at
1-11 walked bits (the gate row passes) with and without the lane, bit for
bit twice, and K9 at 1-12 row bits and 128-1024 lanes, as K1-K8; their
plans as the card reports them against ``row_bwd_plan`` and
``ml_fwd_plan``; K2 at the forward row stage's boundaries (1-11 walked
bits) and every outer dim D = 1-32, and K12 at 1-10 walked bits, as K1-K8
and bit for bit twice, their plans against ``grand_zzrx_fwd_plan`` and
``rotx_bwd_plan``; K6 (with and without the lane) and K11 at 1-11 walked
bits, bit for bit twice, their plans against ``row_fwd_plan`` and
``rotx_fwd_plan``, the forward pass instances of each build without a
spill, and r not a power of two refused; K15 (the staged
micro-benchmark, random non-unitary inputs whose values grow to O(100))
within 1e-5 of its output's largest entry at n=18-21, bit for bit twice,
its plan against ``micro_grand_plan``, and r not a power of two refused
at m2 and m3.  The samplers (``backend.probability_sample`` and the
trajectory sampler) on the card against the CPU with the same status, each
index within its float64 cdf interval (1e-6 at n=10, 1e-4 at n=20: a
float32 cumsum in another order); a generator or a status on another
device refused.  A noisy trajectory (the TFIM with its gradient, the HEA
with ``general_kraus`` sites) and a ``DMCircuit`` with exact channels on
the card against the CPU path with the same status: the branches equal,
each within 1e-5 of its float64 cdf interval, values as the circuit's.
The contraction engine (no kernel of its own: pairwise ``torch.einsum``
steps) on the card against the CPU path: the IR's operands on the card,
a grid amplitude whole and sliced, the n > 30 amplitude, expectation and
their gradients, samples past 2^30 amplitudes bit for bit, ``DMCircuit2``
past its cliff, and ``chip_smoke.py``'s phase 15 at a small size.  The MPS
simulators (no kernel of their own; the card truncates by the Gram-eigh
SVD, a complex64 chain's SVDs and QRs in complex128) against the CPU path:
the MPS VQE value, gradient and step at n=20 within phase 16's ``MPS_TOL``
against the CPU path's exact SVD (set from the CPU path's own drift), its
gradient against the CPU path's Gram route within ``MPS_GRAM_GRAD_TOL``,
the exact SVD's gradient on the card at n=16 against a central difference
on the CPU (1e-8; Queue 3 F9), DMRG at n=8 within 1e-8,
``MPSCircuit.sample`` at complex128 under the bracket rule (1e-6),
``mps_inputs=`` and the QuOperator methods within 1e-5, and
``chip_smoke.py``'s phase 16 at a small size.  The Hamiltonians and the QI
toolbox (no kernel of their own): a 4x4 complex COO product and its
backward in the vector against the CPU, ``PauliStringSum2COO`` at n=12 on
the card equal to the CPU path's bit for bit, the entanglement entropy of
an n=12 TFIM state and its angle gradient (1e-5, 1e-4), the stabilizer
Renyi entropy at n=8 (1e-6), and ``chip_smoke.py``'s phase 17 at a small
size.  The backend's transforms: ``jit`` of the n=18 training step as a
captured CUDA graph (K2 and K4 in it), its replays equal to the
uncaptured step bit for bit and the CPU path within 1e-4, a host read
refused at capture; ``vvag`` over 3 restarts (K2/K4 once a restart, each
within 1e-5 of its eager step); Krylov and Chebyshev evolution in
complex128 at n=12 against the CPU (1e-10); and ``chip_smoke.py``'s phase
18 at a small size.  Phase 20's modules (no kernel of their own but the
stack's on the analog circuit's digital segment): the Pauli propagation's
coefficients twice bit for bit on the card and within 1e-5 of the CPU
path, a free-fermion energy gradient through a chain of ``evol_hp``, the
outcomes and the collapsed correlation matrix against the CPU path (1e-4),
and ``chip_smoke.py``'s phase 20 at a small size.  F19's channels on a
mesh of one card's shards against the dense card circuit (the same branch,
states within 1e-5), a JSON and an OpenQASM round trip of a CUDA circuit
(gate tensors on the card, states within 2e-6), and ``chip_smoke.py``'s
phase 22 at a small size.  The application layer (no kernel of its own):
a VQNHE step (energy, both gradients, 3 Adam steps) on the card against
the CPU path within 1e-4, PixelCNN's log-probs within 1e-5 of their
size and its gradients within 1e-4 with cuDNN's TF32 on globally (the
module computes in float32 regardless), and ``chip_smoke.py``'s phase 24
at a small size.
"""

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import (
    SLICE_SMALL, _slice_checks, fgs_inputs, fgs_layers, pp_circuit,
    PAR_SMALL, _parallel_checks, par_mixed_circuit, PAR_CHANNELS, par_probe_circuit,
    IO_SMALL, _io_checks, MLZX_SMALL, _mlzx_checks, APPS_SMALL, _apps_checks, tfim_rows,
    STAB_SMALL, _stab_checks, detector_statuses, qudit_energy, repetition_program, stab_angles, surface_code_program,
    u1_circuit, u1_energy, xy_gate, clifford_program,
    HAM_SMALL, TRANSFORM_SMALL, _tfim_coo_state, _transform_checks, transform_angles, transform_energy,
    MPS_GRAM_GRAD_TOL, MPS_TOL, SVD_ORTH_TOL, SVD_REC_TOL, SVD_S_TOL, SVD_VEC_TOL, _contraction_checks,
    _hamiltonian_checks, _mps_checks, _mps_reference,
    _ptxas_report, _qop_values, _svd_batches, _svd_checks, brickwork_circuit, grid_angles, grid_circuit,
    hea_energy, mps_bracket_miss, mps_status, mps_vqe_angles, mps_vqe_circuit, mps_vqe_step, noisy_brickwork_dm,
    qaoa_energy, qaoa_graph, tfim_circuit, tfim_energy_ps,
)
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import _build
from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
from tensorcircuit_ng_tpu_torch.core import kernels
from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as kj
from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

pytestmark = pytest.mark.cuda

ATOL = 2e-6
GRAD_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pairs(n, kind):
    if kind == "chain":
        return tuple((i, (i + 1) % n) for i in range(n))  # wraps around
    if kind == "open":
        return tuple((i, i + 1) for i in range(n - 1))
    return ((0, n - 1), (1, n // 2), (2, 3), (n - 2, 0))


def _inputs(n, nkernel, L, npairs, seed, dev):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    d = 2**n // 128 // 2**nkernel
    arrays = {
        "zz": rng.normal(size=(L, npairs)) * 0.5,
        "th": rng.normal(size=(L, nkernel)) * 0.5,
        # general (non-unitary) matrices: the forward assumes nothing of them
        "mlr": rng.normal(size=(L, 128, 128)) / 11,
        "mli": rng.normal(size=(L, 128, 128)) / 11,
        "mor": rng.normal(size=(L, d, d)) / np.sqrt(d),
        "moi": rng.normal(size=(L, d, d)) / np.sqrt(d),
    }
    t = {k: convert.params(v, dev) for k, v in arrays.items()}
    return convert.planes(psi, dev), t


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane",
    [(10, 1, "chain", False), (11, 3, "long", True), (14, 7, "chain", True), (17, 10, "long", True)],
)
def test_zzrx_fwd_kernel_matches_plain(cuda, n, nkernel, pairs, lane):
    pairs = _pairs(n, pairs)
    (sr, si), t = _inputs(n, nkernel, 1, len(pairs), n, cuda)
    mr, mi = (t["mlr"][0], t["mli"][0]) if lane else (None, None)
    krl.zzrx_fwd.launches = 0
    got = krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr, si, mr, mi)
    torch.cuda.synchronize()
    assert krl.zzrx_fwd.launches == 1
    want = krl.zzrx_fwd_plain(pairs, n, t["zz"][0], t["th"][0], sr, si, mr, mi)
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "n,nkernel,L,pairs", [(10, 1, 2, "chain"), (12, 3, 4, "long"), (18, 10, 4, "chain")]
)
def test_grand_zzrx_fwd_kernel_matches_plain(cuda, n, nkernel, L, pairs):
    pairs = _pairs(n, pairs)
    (sr, si), t = _inputs(n, nkernel, L, len(pairs), n + L, cuda)
    mats = [t[k] for k in ("mor", "moi", "mlr", "mli")]
    kg.grand_zzrx_fwd.launches = 0
    got = kg.grand_zzrx_fwd(pairs, n, t["zz"], t["th"], sr, si, *mats)
    torch.cuda.synchronize()
    assert kg.grand_zzrx_fwd.launches == 1
    want = kg.grand_zzrx_fwd_plain(pairs, n, t["zz"], t["th"], sr, si, *mats)
    # (ksr, ksi, yr, yi)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "n,nkernel",
    [(8, 1), (10, 1), (13, 5), (12, 3), (14, 4), (16, 9), (17, 5), (17, 6), (18, 7), (20, 10), (22, 11)],
)
def test_grand_zzrx_fwd_at_row_stage_boundaries(cuda, n, nkernel):
    """K2 at the forward row stage's boundaries (1, 3, 4, 5, 6 walked bits:
    the zz pass alone; 7, 9, 10, 11: the zz pass and the other) and at
    every outer dim it takes (D = 1, 2, 4, 8, 16, 32), L=2, general
    matrices, against its plain version and bit for bit against itself."""
    pairs = _pairs(n, "open")
    (sr, si), t = _inputs(n, nkernel, 2, len(pairs), 3 * n + nkernel, cuda)
    mats = [t[k] for k in ("mor", "moi", "mlr", "mli")]
    args = (pairs, n, t["zz"], t["th"], sr, si, *mats)
    kg.grand_zzrx_fwd.launches = 0
    with torch.no_grad():
        got = kg.grand_zzrx_fwd(*args)
        again = kg.grand_zzrx_fwd(*args)
        torch.cuda.synchronize()
        want = kg.grand_zzrx_fwd_plain(*args)
    assert kg.grand_zzrx_fwd.launches == 2 and t["mor"].shape[1] == 2 ** (n - 7 - nkernel)
    for g, g2, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,nkernel,L", [(8, 1, 2), (12, 3, 3), (17, 5, 2), (20, 10, 4), (22, 11, 4)])
def test_grand_zzrx_fwd_plan_on_card(cuda, n, nkernel, L):
    """K2's stage plan as the card reports it equals the Python arithmetic
    (``grand_zzrx_fwd_plan``), with shared memory within a CTA's 232,448
    B, at least one CTA an SM, no local memory, and no spill of its stage
    kernels in nvcc's report of the zzrx_fwd build."""
    r, npairs = 2 ** (n - 7), n - 1
    got, want = kg.grand_zzrx_fwd_card_plan(r, nkernel, npairs, L), kg.grand_zzrx_fwd_plan(r, nkernel, npairs, L)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    report = _ptxas_report(_build.build_log("zzrx_fwd"), "")
    for needle in ("fwd_row_pass_kernel", "wide_nt_kernel", "outer_fwd_kernel", "transpose_kernel",
                   "ml_pair_records_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits), needle


def _k1_case(n, nkernel, pairs, lane, rmx, seed, dev):
    """K1's inputs: unit-norm state planes, angles, a general lane matrix
    (or none) and an arbitrary (R, R) M7 at rmx > 0 (or none)."""
    (sr, si), t = _inputs(n, nkernel, 1, len(pairs), seed, dev)
    m = (t["mlr"][0], t["mli"][0]) if lane else (None, None)
    m7 = (None, None)
    if rmx:
        R, rng = 2**rmx, np.random.default_rng(seed)
        m7 = tuple(convert.params(rng.normal(size=(R, R)) / np.sqrt(2 * R), dev) for _ in range(2))
    return (pairs, n, t["zz"][0], t["th"][0], sr, si, *m, *m7)


@pytest.mark.parametrize("kind", ["no lane", "lane", "M7"])
@pytest.mark.parametrize("nwalk", range(11))
def test_zzrx_fwd_at_row_stage_boundaries(cuda, nwalk, kind):
    """K1 at every walked-bit count of its row stage (0: the phase alone;
    1-3 in registers; 4-6 with one shared-memory crossing, the zz pass
    alone; 7-10: the zz pass and the other), with two outer row bits (CTA
    bits), without the lane, with it, and with M7 on 2 more row bits and
    the lane, against its plain version, bit for bit against itself, and
    with its input planes unwritten."""
    rmx = 2 if kind == "M7" else 0
    nkernel = nwalk + rmx
    n = nkernel + 9
    args = _k1_case(n, nkernel, _pairs(n, "open"), kind != "no lane", rmx, 7 * n + nwalk, cuda)
    s_in = (args[4].clone(), args[5].clone())
    krl.zzrx_fwd.launches = krl.rowm_fwd.launches = 0
    with torch.no_grad():
        got = krl.zzrx_fwd(*args)
        again = krl.zzrx_fwd(*args)
        torch.cuda.synchronize()
        want = krl.zzrx_fwd_plain(*args)
    assert (krl.zzrx_fwd.launches, krl.rowm_fwd.launches) == (2, 2 if rmx else 0)
    assert torch.equal(args[4], s_in[0]) and torch.equal(args[5], s_in[1])
    for g, g2, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("pairs", ["none", "one", "outer", "lane", "mixed", "row"])
def test_zzrx_fwd_pair_sets(cuda, pairs, lane):
    """K1 with no pair (the records empty), one pair, and pairs on outer row
    bits only (qubits 0 and 1: CTA bits of every pass), on lane bits only
    (qubits n-2 and n-1: the warp's lane bits), across outer, walked and
    lane bits, and on walked row bits only, against its plain version."""
    n, nkernel = 16, 7
    pairs = {"none": (), "one": ((3, 9),), "outer": ((0, 1),), "lane": ((n - 2, n - 1), (n - 5, n - 1)),
             "mixed": ((0, n - 1), (1, 5), (8, 12)), "row": ((2, 4), (5, 8))}[pairs]
    args = _k1_case(n, nkernel, pairs, lane, 0, 3 * n + len(pairs), cuda)
    with torch.no_grad():
        got = krl.zzrx_fwd(*args)
        torch.cuda.synchronize()
        want = krl.zzrx_fwd_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,nkernel,lane,rmx", [(8, 1, False, 0), (9, 0, True, 0), (12, 3, True, 0),
                                                (14, 6, False, 0), (20, 10, False, 0), (20, 10, True, 0),
                                                (20, 10, True, 7), (20, 10, False, 7), (12, 4, True, 4),
                                                (22, 10, True, 0)])
def test_zzrx_fwd_plan_on_card(cuda, n, nkernel, lane, rmx):
    """K1's stage plan as the card reports it equals the Python arithmetic
    (``zzrx_fwd_plan``), with shared memory within a CTA's 232,448 B, at
    least one CTA an SM and no local memory; its scratch holds the records
    and, with the lane, M^T and the plane pair."""
    r, npairs = 2 ** (n - 7), n - 1
    got, want = krl.zzrx_fwd_card_plan(r, nkernel, npairs, lane, rmx), krl.zzrx_fwd_plan(r, nkernel, npairs, lane, rmx)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    floats = _build.library("zzrx_fwd").tcng_zzrx_fwd_scratch(r, nkernel, npairs, int(lane), rmx)
    assert floats >= 4 * npairs + 8 + (2 * 128 * 128 + 2 * r * 128 if lane else 0)


def test_zzrx_fwd_and_row_bwd_const_take_rows_a_power_of_two(cuda):
    """K1 (with and without the lane) and K8 run on the row stage's plan,
    which takes r = 2^k rows only: 96 rows raise ValueError."""
    p96, m, g5 = (torch.zeros(s, device=cuda) for s in ((96, 128), (128, 128), (5, 4)))
    zz, th = torch.zeros(2, device=cuda), torch.zeros(5, device=cuda)
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.zzrx_fwd(((0, 1), (1, 2)), 13, zz, th, p96, p96)
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.zzrx_fwd(((0, 1), (1, 2)), 13, zz, th, p96, p96, m, m)
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.row_bwd_const(g5, g5, p96, p96)


def test_kernel_wrappers_check_their_inputs(cuda):
    n, pairs = 10, _pairs(10, "chain")
    (sr, si), t = _inputs(n, 1, 2, len(pairs), 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr.double(), si)
    with pytest.raises(ValueError, match="contiguous"):
        krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr.t().contiguous().t(), si)
    with pytest.raises(ValueError, match="zzth shape"):
        krl.zzrx_fwd(pairs, n, t["zz"][0, :-1], t["th"][0], sr, si)
    with pytest.raises(ValueError, match="pair qubits"):
        krl.zzrx_fwd(((0, n),), n, t["zz"][0, :1], t["th"][0], sr, si)
    with pytest.raises(ValueError, match="plane shape"):
        kg.grand_zzrx_fwd(
            pairs, n, t["zz"], t["th"], sr, si,
            t["mor"][:, :1], t["moi"][:, :1], t["mlr"], t["mli"],
        )


@pytest.mark.parametrize(
    "n,L,kernel",
    [(12, 4, "zzrx_fwd"), (18, 3, "zzrx_fwd"), (18, 4, "grand_zzrx_fwd"), (20, 4, "grand_zzrx_fwd")],
)
def test_circuit_on_card_matches_cpu(cuda, n, L, kernel):
    pairs = _pairs(n, "open")
    grid = np.random.default_rng(n * L).normal(size=(L, 2, n)) * 0.1
    counter = {"zzrx_fwd": krl.zzrx_fwd, "grand_zzrx_fwd": kg.grand_zzrx_fwd}[kernel]

    def run(dev):
        p = convert.params(grid, dev)
        c = tct.Circuit(n, device=dev)
        c.h_layer()
        for l in range(L):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        return c.expectation_zzx_energy(pairs, 0.7, -1.3).item(), convert.to_numpy(c.state())

    counter.launches = 0
    with torch.no_grad():
        e_card, s_card = run(cuda)
    assert counter.launches >= 2  # the energy and the state
    e_cpu, s_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 2e-5 * n
    assert np.linalg.norm(s_card - s_cpu) <= 2e-6


def _unitary_inputs(n, nkernel, L, npairs, seed, dev):
    """Residual and cotangent planes, angles, and the rx-kron outer and
    lane planes the backward kernels require (unitary)."""
    rng = np.random.default_rng(seed)
    r = 2**n // 128
    planes = [convert.params(rng.normal(size=(L, r, 128)) / 2 ** (n / 2), dev) for _ in range(2)]
    planes += [convert.params(rng.normal(size=(r, 128)) / 2 ** (n / 2), dev) for _ in range(2)]
    rx = convert.params(rng.normal(size=(L, n)) * 0.5, dev)
    nrow = n - 7
    nouter = nrow - nkernel
    mats = [*kst._rx_kron_planes(rx[:, :nouter]), *kst._lane_kron_planes_T(rx[:, nrow:])]
    zz = convert.params(rng.normal(size=(L, npairs)) * 0.5, dev)
    return planes, zz, rx[:, nouter:nrow].contiguous(), mats


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=GRAD_RTOL * want.abs().max().item())


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane",
    [
        (10, 1, "chain", False), (12, 3, "long", True), (17, 10, "chain", False),
        (20, 10, "open", True), (22, 10, "open", True),
    ],
)
def test_zzrx_bwd_kernel_matches_plain(cuda, n, nkernel, pairs, lane):
    pairs = _pairs(n, pairs)
    (ksr, ksi, ctr, cti), zz, th, mats = _unitary_inputs(n, nkernel, 1, len(pairs), n, cuda)
    m = (mats[2][0], mats[3][0]) if lane else ()
    krl.zzrx_bwd.launches = 0
    got = krl.zzrx_bwd(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr, cti, *m)
    torch.cuda.synchronize()
    assert krl.zzrx_bwd.launches == 1
    want = krl.zzrx_bwd_plain(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr, cti, *m)
    assert len(got) == len(want) == (6 if lane else 4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.shape == w.shape
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize(
    "n,nkernel,L,pairs", [(10, 1, 2, "chain"), (12, 3, 3, "long"), (18, 10, 3, "open"), (20, 10, 4, "open")]
)
def test_grand_zzrx_bwd_kernel_matches_plain(cuda, n, nkernel, L, pairs):
    """K4 against its plain version, and bit for bit against itself."""
    pairs = _pairs(n, pairs)
    planes, zz, th, mats = _unitary_inputs(n, nkernel, L, len(pairs), n + L, cuda)
    args = (pairs, n, zz, th, *planes, *mats)
    kg.grand_zzrx_bwd.launches = 0
    got = kg.grand_zzrx_bwd(*args)
    again = kg.grand_zzrx_bwd(*args)
    torch.cuda.synchronize()
    assert kg.grand_zzrx_bwd.launches == 2
    want = kg.grand_zzrx_bwd_plain(*args)
    # (dsr, dsi, dzz, dth, dtho, dmlr, dmli)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


#: walked row bits at the row stage's boundaries (csrc/adjoint_stages.cuh):
#: 1 and 3 in registers only, 4 and 6 with one shared-memory crossing, 7
#: and 10 in two passes
NWALK_CASES = [1, 3, 4, 6, 7, 10]


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("nwalk", NWALK_CASES)
def test_zzrx_bwd_at_row_pass_boundaries(cuda, nwalk, lane):
    """K3 with nkernel = nwalk and two outer row bits (CTA bits of the row
    stage) against its plain version, and bit for bit against itself."""
    n = nwalk + 9
    pairs = _pairs(n, "long" if nwalk % 2 else "chain")
    (ksr, ksi, ctr, cti), zz, th, mats = _unitary_inputs(n, nwalk, 1, len(pairs), 3 * n, cuda)
    m = (mats[2][0], mats[3][0]) if lane else ()
    args = (pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr, cti, *m)
    krl.zzrx_bwd.launches = 0
    got = krl.zzrx_bwd(*args)
    again = krl.zzrx_bwd(*args)
    torch.cuda.synchronize()
    assert krl.zzrx_bwd.launches == 2
    want = krl.zzrx_bwd_plain(*args)
    assert len(got) == len(want) == (6 if lane else 4)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize(
    "n,nkernel",
    [(9, 1), (12, 3), (14, 4), (17, 6), (16, 7), (20, 10), (22, 11)],
)
def test_grand_zzrx_bwd_at_row_pass_boundaries(cuda, n, nkernel):
    """K4 at D = 2, 4, 8 and 16 outer blocks with the row stage at its
    boundaries (nwalk = nkernel = 1, 3, 4, 6, 7, 10, and 11 at n=22: two
    passes of 5 and 6 bits), L=2, against its plain version and bit for bit
    against itself."""
    pairs = _pairs(n, "open")
    planes, zz, th, mats = _unitary_inputs(n, nkernel, 2, len(pairs), 2 * n + nkernel, cuda)
    args = (pairs, n, zz, th, *planes, *mats)
    got = kg.grand_zzrx_bwd(*args)
    again = kg.grand_zzrx_bwd(*args)
    torch.cuda.synchronize()
    want = kg.grand_zzrx_bwd_plain(*args)
    assert got[4].shape == (2, n - 7 - nkernel)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("n,nkernel,rmx", [(12, 5, 0), (14, 7, 0), (20, 10, 0), (20, 10, 7), (22, 10, 0)])
def test_zzrx_bwd_plan_on_card(cuda, n, nkernel, rmx):
    """K3/K4's stage plan as the card reports it equals the Python
    arithmetic (``zzrx_bwd_plan``), with shared memory within a CTA's
    232,448 B, at least one CTA an SM, no local memory, and no spill in
    nvcc's report of the zzrx_bwd build."""
    r, npairs = 2 ** (n - 7), n - 1
    got = krl.zzrx_bwd_card_plan(r, nkernel, npairs, rmx)
    want = krl.zzrx_bwd_plan(r, nkernel, npairs, rmx)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    report = _ptxas_report(_build.build_log("zzrx_bwd"), "")
    for needle in ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel", "ml_pair_records_kernel",
                   "colsum_tree_kernel", "outer_bwd_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize(
    "n,L,kernel",
    [(12, 4, "zzrx_bwd"), (20, 4, "grand_zzrx_bwd"), (20, 3, "grand_zzrx_bwd"), (22, 4, "zzrx_bwd")],
)
def test_circuit_gradient_on_card_matches_cpu(cuda, n, L, kernel):
    """value and gradient of the TFIM energy through ``Circuit`` on the card
    (K3 per layer at n=12 and n=22, K4 at n=20) against the CPU path."""
    pairs = _pairs(n, "open")
    grid = np.random.default_rng(n + L).normal(size=(L, 2, n)) * 0.1
    counter = {"zzrx_bwd": krl.zzrx_bwd, "grand_zzrx_bwd": kg.grand_zzrx_bwd}[kernel]

    def run(dev):
        p = convert.params(grid, dev).requires_grad_()
        c = tct.Circuit(n, device=dev)
        c.h_layer()
        for l in range(L):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        e = c.expectation_zzx_energy(pairs, 1.0, -1.0)
        (g,) = torch.autograd.grad(e, p)
        assert g.device == p.device
        return e.item(), convert.to_numpy(g)

    counter.launches = 0
    e_card, g_card = run(cuda)
    assert counter.launches == (1 if kernel == "grand_zzrx_bwd" else L)
    e_cpu, g_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 2e-5 * n
    np.testing.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-4)


def test_zzrx_row_layer_gradient_on_card(cuda):
    """``zzrx_row_layer`` on the card (K1 forward, K3 backward without the
    lane matrix) against the CPU path, for the loss Re Σ w·y."""
    n, nkernel = 14, 7
    pairs = _pairs(n, "long")
    rng = np.random.default_rng(3)
    psi = (rng.normal(size=(2**n // 128, 128)) + 1j * rng.normal(size=(2**n // 128, 128))) / 2 ** (n / 2)
    w = rng.normal(size=psi.shape) + 1j * rng.normal(size=psi.shape)
    zz = rng.normal(size=len(pairs)) * 0.5
    th = rng.normal(size=nkernel) * 0.5

    def run(dev):
        ts = [convert.state(psi, dev).reshape(psi.shape).requires_grad_(),
              convert.params(zz, dev).requires_grad_(), convert.params(th, dev).requires_grad_()]
        y = krl.zzrx_row_layer(pairs, n, *ts)
        v = torch.real(torch.sum(convert.state(w, dev).reshape(psi.shape) * y))
        return [g.cpu() for g in torch.autograd.grad(v, ts)]

    krl.zzrx_bwd.launches = 0
    got = run(cuda)
    assert krl.zzrx_bwd.launches == 1
    for g, w_ in zip(got, run("cpu")):
        _close(g, w_)


def test_backward_wrappers_check_their_inputs(cuda):
    n, pairs = 12, _pairs(12, "chain")
    (ksr, ksi, ctr, cti), zz, th, mats = _unitary_inputs(n, 3, 2, len(pairs), 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        krl.zzrx_bwd(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr.double(), cti)
    with pytest.raises(ValueError, match="contiguous"):
        krl.zzrx_bwd(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr.t().contiguous().t(), cti)
    with pytest.raises(ValueError, match="zzth shape"):
        krl.zzrx_bwd(pairs, n, zz[0, :-1], th[0], ksr[0], ksi[0], ctr, cti)
    with pytest.raises(ValueError, match="plane shape"):
        kg.grand_zzrx_bwd(pairs, n, zz, th, ksr[:1], ksi[:1], ctr, cti, *mats)
    with pytest.raises(RuntimeError, match="invalid argument"):
        # D = 32 outer blocks: above the kernel's outer stage
        d32 = torch.eye(32, device=cuda).expand(2, 32, 32).contiguous()
        kg.grand_zzrx_bwd(pairs, n, zz, th[:, :0], ksr, ksi, ctr, cti, d32, d32, *mats[2:])


#: random (m, n) batches beside ``_svd_batches``' 128-wide ones
_SVD_SHAPES = {"random 100x96": (100, 96), "random 16x16": (16, 16), "random 160x160": (160, 160)}


@pytest.mark.parametrize(
    "kind,b,with_v",
    [("random", 30, True), ("decaying", 29, True), ("rank-deficient", 30, True),
     ("degenerate", 29, True), ("panel 128x80", 30, True), ("decaying", 30, False),
     ("random", 1, True), ("panel 128x80", 1, True), ("random", 200, True),
     ("random 100x96", 5, True), ("random 16x16", 4, True),
     ("random 160x160", 4, True), ("random 160x160", 40, True)],
)
def test_jacobi_svd_kernel_matches_plain(cuda, kind, b, with_v):
    """K5 through ``jacobi_svd_nodiff`` against its plain version on the same
    CUDA inputs, and bit for bit against itself: one matrix, several waves
    of clusters (B=200), a ragged m (100 elements over the cluster), the
    smallest width, and 80 pairs: two a half-warp (B=4, 8 CTAs a matrix)
    and pairs loaded again after the barrier (B=40, 2 CTAs)."""
    rng = np.random.default_rng(b)
    if kind in _SVD_SHAPES:
        shape = (b,) + _SVD_SHAPES[kind]
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    else:
        a = dict(_svd_batches(rng, b=b))[kind]
    a = torch.as_tensor(a.astype(np.complex64), device=cuda)
    kj.jacobi_rotations.launches = 0
    got = kj.jacobi_svd_nodiff(a, 10, with_v)
    again = kj.jacobi_svd_nodiff(a, 10, with_v)
    torch.cuda.synchronize()
    assert kj.jacobi_rotations.launches == 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = kj.jacobi_svd_nodiff(a, 10, with_v, rotations=kj.jacobi_rotations_plain)
    ds, rec, _, vec, _, orth, _ = _svd_checks(a, got, want)
    assert ds <= SVD_S_TOL and rec <= SVD_REC_TOL and vec <= SVD_VEC_TOL and orth <= SVD_ORTH_TOL


def test_jacobi_wrapper_checks_its_inputs(cuda):
    x = torch.zeros((2, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        kj.jacobi_rotations(x.double(), x, 10, True)
    with pytest.raises(ValueError, match="contiguous"):
        kj.jacobi_rotations(x.transpose(1, 2).contiguous().transpose(1, 2), x, 10, True)
    with pytest.raises(ValueError, match="unsupported shape"):
        y = torch.zeros((2, 15, 32), device=cuda)
        kj.jacobi_rotations(y, y, 10, False)
    with pytest.raises(ValueError, match="unsupported shape"):
        y = torch.zeros((2, 16, 512), device=cuda)
        kj.jacobi_rotations(y, y, 10, False)
    with pytest.raises(ValueError, match="unsupported shape"):
        # V's 908 x 908 planes do not fit a cluster of 8 CTAs
        y = torch.zeros((1, 908, 32), device=cuda)
        kj.jacobi_rotations(y, y, 10, True)


@pytest.mark.parametrize("n,chi,steps", [(12, 16, 6), (60, 64, 3)])
def test_tebd_on_card_matches_cpu_complex128(cuda, n, chi, steps):
    """``ParallelTEBD`` on the card (K5 twice a step) against the port's CPU
    path in complex128: <Z_i> on every site and lambda on every bond."""
    import scipy.linalg

    x = np.array([[0, 1], [1, 0.0]])
    z = np.diag([1.0, -1.0])
    h = -np.kron(z, z) - 0.5 * (np.kron(x, np.eye(2)) + np.kron(np.eye(2), x))
    gate = scipy.linalg.expm(-0.05j * h).astype(np.complex64)

    def run(dev, dtype):
        eng = tct.ParallelTEBD(n, chi, initial="neel", dtype=dtype, device=dev)
        for _ in range(steps):
            eng.trotter_step(gate)
        zs = np.array([eng.expectation_single(z, i).real.item() for i in range(n)])
        return zs, convert.to_numpy(eng.lambdas)

    kj.jacobi_rotations.launches = 0
    with torch.no_grad():
        z_card, lam_card = run(cuda, "complex64")
    assert kj.jacobi_rotations.launches == 2 * steps
    z_cpu, lam_cpu = run("cpu", "complex128")
    np.testing.assert_allclose(z_card, z_cpu, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lam_card, lam_cpu, rtol=0, atol=1e-4)


def _row_inputs(n, nkernel, seed, dev):
    """Unit-norm state and cotangent planes, distinct unitary gates
    (nkernel, 4) on every kernel qubit and a unitary lane matrix: the
    backward kernels rebuild states by un-application."""
    rng = np.random.default_rng(seed)

    def unitaries(k, dim):
        a = rng.normal(size=(k, dim, dim)) + 1j * rng.normal(size=(k, dim, dim))
        return np.linalg.qr(a)[0]

    def unit(size):
        z = rng.normal(size=size) + 1j * rng.normal(size=size)
        return z / np.linalg.norm(z)

    g = unitaries(nkernel, 2).reshape(nkernel, 4)
    m = unitaries(1, 128)[0]
    return {
        "s": convert.planes(unit(2**n), dev),
        "ct": convert.planes(unit(2**n), dev),
        "g": (convert.params(g.real, dev), convert.params(g.imag, dev)),
        "m": (convert.params(m.real, dev), convert.params(m.imag, dev)),
    }


ROW_CASES = [(10, 3, False), (12, 5, True), (18, 11, False), (20, 11, False), (20, 11, True)]


@pytest.mark.parametrize("n,nkernel,lane", ROW_CASES)
def test_row_fwd_kernel_matches_plain(cuda, n, nkernel, lane):
    x = _row_inputs(n, nkernel, n + nkernel, cuda)
    m = x["m"] if lane else ()
    krl.row_fwd.launches = 0
    got = krl.row_fwd(*x["g"], *x["s"], *m)
    torch.cuda.synchronize()
    assert krl.row_fwd.launches == 1
    want = krl.row_fwd_plain(*x["g"], *x["s"], *m)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,nkernel,lane", ROW_CASES)
def test_row_bwd_kernel_matches_plain(cuda, n, nkernel, lane):
    """K7 against its plain version from the layer's output, and bit for
    bit against itself (per-CTA partials added in a fixed order)."""
    x = _row_inputs(n, nkernel, 2 * n + nkernel, cuda)
    m = x["m"] if lane else ()
    with torch.no_grad():
        y = krl.row_fwd_plain(*x["g"], *x["s"], *m)
    krl.row_bwd.launches = 0
    got = krl.row_bwd(*x["g"], *y, *x["ct"], *m)
    again = krl.row_bwd(*x["g"], *y, *x["ct"], *m)
    torch.cuda.synchronize()
    assert krl.row_bwd.launches == 2
    want = krl.row_bwd_plain(*x["g"], *y, *x["ct"], *m)
    # (dsr, dsi, dgr, dgi[, dmr, dmi])
    assert len(got) == len(want) == (6 if lane else 4)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("n,nkernel", [(10, 3), (12, 5), (20, 11)])
def test_row_bwd_const_kernel_matches_plain(cuda, n, nkernel):
    x = _row_inputs(n, nkernel, 3 * n + nkernel, cuda)
    krl.row_bwd_const.launches = 0
    got = krl.row_bwd_const(*x["g"], *x["ct"])
    torch.cuda.synchronize()
    assert krl.row_bwd_const.launches == 1
    want = krl.row_bwd_const_plain(*x["g"], *x["ct"])
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nkernel", range(1, 12))
def test_row_bwd_const_at_row_stage_boundaries(cuda, nkernel):
    """K8 at every walked-bit count of its passes (1-3 in registers only,
    4-6 with one shared-memory crossing, 7-11: the low pass, then the high
    one in place), with two outer row bits (CTA bits), against its plain
    version, bit for bit against itself, and with ct unwritten."""
    n = nkernel + 9
    x = _row_inputs(n, nkernel, 9 * n + nkernel, cuda)
    ct_in = tuple(c.clone() for c in x["ct"])
    krl.row_bwd_const.launches = 0
    with torch.no_grad():
        got = krl.row_bwd_const(*x["g"], *x["ct"])
        again = krl.row_bwd_const(*x["g"], *x["ct"])
        torch.cuda.synchronize()
        want = krl.row_bwd_const_plain(*x["g"], *x["ct"])
    assert krl.row_bwd_const.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(x["ct"], ct_in))
    for g, g2, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,nkernel", [(8, 1), (12, 3), (14, 6), (17, 7), (20, 10), (20, 11), (22, 11)])
def test_row_bwd_const_plan_on_card(cuda, n, nkernel):
    """K8's pass plan as the card reports it equals the Python arithmetic
    (``row_bwd_const_plan``, K6's passes), with shared memory within a
    CTA's 232,448 B, at least one CTA an SM, no local memory, and no spill
    of its pass (the transposed gate kind) in nvcc's report of the
    row_layer build."""
    r = 2 ** (n - 7)
    got, want = krl.row_bwd_const_card_plan(r, nkernel), krl.row_bwd_const_plan(r, nkernel)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    hits = [v for k, v in _ptxas_report(_build.build_log("row_layer"), "").items()
            if "fwd_row_pass_kernelILb0ELb1ELb1E" in k]
    assert len(hits) == 1 and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("nkernel", range(1, 12))
def test_row_bwd_at_row_pass_boundaries(cuda, nkernel, lane):
    """K7 at every walked-bit count of its gate passes (1-3 in registers
    only, 4-6 with one shared-memory crossing, 7-11 in two passes), with two
    outer row bits (CTA bits), against its plain version and bit for bit
    against itself."""
    n = nkernel + 9
    x = _row_inputs(n, nkernel, 5 * n + nkernel, cuda)
    m = x["m"] if lane else ()
    with torch.no_grad():
        y = krl.row_fwd_plain(*x["g"], *x["s"], *m)
    got = krl.row_bwd(*x["g"], *y, *x["ct"], *m)
    again = krl.row_bwd(*x["g"], *y, *x["ct"], *m)
    torch.cuda.synchronize()
    want = krl.row_bwd_plain(*x["g"], *y, *x["ct"], *m)
    assert len(got) == len(want) == (6 if lane else 4)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("n,nkernel,lane", [(8, 1, False), (12, 2, True), (14, 6, False), (20, 11, False),
                                            (20, 11, True), (22, 11, True)])
def test_row_bwd_plan_on_card(cuda, n, nkernel, lane):
    """K7's stage plan as the card reports it equals the Python arithmetic
    (``row_bwd_plan``), with shared memory within a CTA's 232,448 B, at
    least one CTA an SM, no local memory, and no spill of the gate passes
    in nvcc's report of the row_layer build."""
    r = 2 ** (n - 7)
    got, want = krl.row_bwd_card_plan(r, nkernel, lane), krl.row_bwd_plan(r, nkernel, lane)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    hits = list(_ptxas_report(_build.build_log("row_layer"), "gate_row_pass_kernel").values())
    assert len(hits) == 2 and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("nkernel", range(1, 12))
def test_row_fwd_at_row_stage_boundaries(cuda, nkernel, lane):
    """K6 at every walked-bit count of its forward passes (1-3 in
    registers only, 4-6 with one shared-memory crossing, 7-11 in two
    passes), with two outer row bits (CTA bits), with and without the lane,
    against its plain version and bit for bit against itself."""
    n = nkernel + 9
    x = _row_inputs(n, nkernel, 6 * n + nkernel, cuda)
    m = x["m"] if lane else ()
    krl.row_fwd.launches = 0
    with torch.no_grad():
        got = krl.row_fwd(*x["g"], *x["s"], *m)
        again = krl.row_fwd(*x["g"], *x["s"], *m)
        torch.cuda.synchronize()
        want = krl.row_fwd_plain(*x["g"], *x["s"], *m)
    assert krl.row_fwd.launches == 2
    for g, g2, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nkernel", range(1, 12))
def test_rotx_fwd_at_row_stage_boundaries(cuda, nkernel):
    """K11 at every walked-bit count of its passes (1-6: the low pass
    alone; 7-11: the low pass, then the high one in place) on four blocks
    of 2^nkernel rows, against its plain version and bit for bit against
    itself."""
    n = nkernel + 9
    x = _row_inputs(n, nkernel, 13 * nkernel, cuda)
    th = convert.params(np.random.default_rng(5 * nkernel).normal(size=nkernel) * 0.7, cuda)
    krl.rotx_fwd.launches = 0
    with torch.no_grad():
        got = krl.rotx_fwd(th, *x["s"])
        again = krl.rotx_fwd(th, *x["s"])
        torch.cuda.synchronize()
        want = krl.rotx_fwd_plain(th, *x["s"])
    assert krl.rotx_fwd.launches == 2
    for g, g2, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


#: the forward pass instances (fwd_row_pass_kernel<ZZ, GATE, TRANS>) each
#: source builds: K1's, K2's and K9's zz pass and rx pass (zzrx_bwd builds
#: them too, unused: the header's stage functions refer to them), and in
#: row_layer also K6's gate pass and K8's transposed gate pass (K11 runs
#: the rx pass)
FWD_PASS_INSTANCES = {"zzrx_fwd": 2, "zzrx_bwd": 2, "multilayer": 2, "row_layer": 4}


@pytest.mark.parametrize("build", list(FWD_PASS_INSTANCES))
def test_fwd_pass_instances_spill_nothing(cuda, build):
    """nvcc's report of each source's build holds the forward pass
    instances it should build, each without a spill."""
    _build.library(build)
    hits = list(_ptxas_report(_build.build_log(build), "fwd_row_pass_kernel").values())
    assert len(hits) == FWD_PASS_INSTANCES[build] and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize("n,nkernel,lane", [(8, 1, False), (12, 3, True), (14, 6, False), (20, 10, False),
                                            (20, 11, False), (20, 11, True), (22, 11, True)])
def test_row_fwd_plan_on_card(cuda, n, nkernel, lane):
    """K6's stage plan as the card reports it equals the Python arithmetic
    (``row_fwd_plan``), with shared memory within a CTA's 232,448 B, at
    least one CTA an SM, no local memory, and no spill of its pass (the
    gate kind), product or transpose in nvcc's report of the row_layer
    build."""
    r = 2 ** (n - 7)
    got, want = krl.row_fwd_card_plan(r, nkernel, lane), krl.row_fwd_plan(r, nkernel, lane)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    report = _ptxas_report(_build.build_log("row_layer"), "")
    for needle in ("fwd_row_pass_kernelILb0ELb1ELb0E", "wide_nt_kernel", "transpose_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits), needle


@pytest.mark.parametrize("n,nkernel", [(8, 1), (12, 3), (14, 6), (17, 7), (20, 10), (20, 11)])
def test_rotx_fwd_plan_on_card(cuda, n, nkernel):
    """K11's pass plan as the card reports it equals the Python arithmetic
    (``rotx_fwd_plan``), with shared memory within a CTA's 232,448 B, at
    least one CTA an SM, no local memory, and no spill of its pass (the rx
    kind) in nvcc's report of the row_layer build."""
    r = 2 ** (n - 7)
    got, want = krl.rotx_fwd_card_plan(r, nkernel), krl.rotx_fwd_plan(r, nkernel)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    hits = [v for k, v in _ptxas_report(_build.build_log("row_layer"), "").items()
            if "fwd_row_pass_kernelILb0ELb0ELb0E" in k]
    assert len(hits) == 1 and all(regs and not st and not ld for regs, st, ld in hits)


def test_row_and_rotx_fwd_take_rows_a_power_of_two(cuda):
    """K6 (with and without the lane) and K11 run on the row stage's plan,
    which takes r = 2^k rows only: 96 rows raise ValueError."""
    g5, p96, m = (torch.zeros(s, device=cuda) for s in ((5, 4), (96, 128), (128, 128)))
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.row_fwd(g5, g5, p96, p96)
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.row_fwd(g5, g5, p96, p96, m, m)
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.rotx_fwd(torch.zeros(5, device=cuda), p96, p96)


def test_row_wrappers_check_their_inputs(cuda):
    x = _row_inputs(12, 5, 1, cuda)
    (sr, si), (gr, gi) = x["s"], x["g"]
    with pytest.raises(ValueError, match="float32"):
        krl.row_fwd(gr, gi, sr.double(), si)
    with pytest.raises(ValueError, match="contiguous"):
        krl.row_bwd(gr, gi, sr, si, sr.t().contiguous().t(), si)
    with pytest.raises(ValueError, match="unsupported shape"):  # nkernel 12 > 11
        g12 = torch.zeros((12, 4), device=cuda)
        krl.row_fwd(g12, g12, sr, si)
    with pytest.raises(ValueError, match="unsupported shape"):  # 32 rows: not whole blocks of 2^6
        g6 = torch.zeros((6, 4), device=cuda)
        krl.row_bwd_const(g6, g6, sr, si)
    with pytest.raises(ValueError, match="unsupported shape"):  # 96 rows: K7's row stage takes 2^k
        g5, p96 = torch.zeros((5, 4), device=cuda), torch.zeros((96, 128), device=cuda)
        krl.row_bwd(g5, g5, p96, p96, p96, p96)


@pytest.mark.parametrize("n,L", [(12, 2), (20, 4)])
def test_hea_gradient_on_card_matches_cpu(cuda, n, L):
    """The HEA energy and its gradient through ``Circuit`` on the card (K6
    forward, K7 and K8 backward) against the CPU path, and the launches
    one step takes: K6 2L+1, K7 2L, K8 1."""
    w0 = np.random.default_rng(n + L).normal(size=(L, 2, n)) * 0.1

    def run(dev):
        w = convert.params(w0, dev).requires_grad_()
        e = hea_energy(tct, n, w, device=dev)
        (g,) = torch.autograd.grad(e, w)
        assert g.device == w.device
        return e.item(), convert.to_numpy(g)

    for k in (krl.row_fwd, krl.row_bwd, krl.row_bwd_const):
        k.launches = 0
    e_card, g_card = run(cuda)
    launches = (krl.row_fwd.launches, krl.row_bwd.launches, krl.row_bwd_const.launches)
    assert launches == (2 * L + 1, 2 * L, 1)
    e_cpu, g_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 1e-4
    np.testing.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-4)


def _ml_card_inputs(n, L, seed, dev):
    """The whole-block view of n qubits (nrow = min(n-7, 12), lanes the
    rest), unit-norm state and cotangent planes, non-adjacent pairs, angles
    and unitary lane planes (L, lanes, lanes)."""
    rng = np.random.default_rng(seed)
    nrow = min(n - 7, kml.MAX_ML_ROW_QUBITS)
    lanes = 2 ** (n - nrow)

    def unit(size):
        z = rng.normal(size=size) + 1j * rng.normal(size=size)
        return z / np.linalg.norm(z)

    cand = [(a, b) for a in range(n) for b in range(a + 2, n)]
    pairs = tuple(cand[i] for i in rng.choice(len(cand), size=min(37, len(cand)), replace=False))
    m = np.linalg.qr(rng.normal(size=(L, lanes, lanes)) + 1j * rng.normal(size=(L, lanes, lanes)))[0]
    return {
        "pairs": pairs,
        "s": convert.planes(unit(2**n), dev, lanes=lanes),
        "ct": convert.planes(unit(2**n), dev, lanes=lanes),
        "zz": convert.params(rng.normal(size=(L, len(pairs))) * 0.5, dev),
        "th": convert.params(rng.normal(size=(L, nrow)) * 0.5, dev),
        "m": (convert.params(m.real, dev), convert.params(m.imag, dev)),
    }


@pytest.mark.parametrize("n,L", [(12, 3), (14, 2), (20, 4), (21, 2), (22, 2)])
def test_ml_kernels_match_plain(cuda, n, L):
    """K9 and K10 against their plain versions at 128 (n=12: one row pass;
    n=14: nrow=7, two passes of 1 and 6 row bits), 256 (n=20), 512 (n=21)
    and 1024 (n=22) lanes, and K10 bit for bit against itself."""
    x = _ml_card_inputs(n, L, n + L, cuda)
    args = (x["pairs"], n, x["zz"], x["th"])
    kml.ml_fwd.launches = kml.ml_bwd.launches = 0
    with torch.no_grad():
        y = kml.ml_fwd(*args, *x["s"], *x["m"])
        got = kml.ml_bwd(*args, *y, *x["ct"], *x["m"])
        again = kml.ml_bwd(*args, *y, *x["ct"], *x["m"])
        torch.cuda.synchronize()
        assert (kml.ml_fwd.launches, kml.ml_bwd.launches) == (1, 2)
        for g, w in zip(y, kml.ml_fwd_plain(*args, *x["s"], *x["m"])):
            assert g.is_cuda and g.shape == w.shape
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        want = kml.ml_bwd_plain(*args, *y, *x["ct"], *x["m"])
    # (dsr, dsi, dzz, dth, dmr, dmi)
    assert len(got) == len(want) == 6
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("nrow,lanes", [(5, 128), (7, 128), (12, 128), (12, 256), (12, 512), (12, 1024)])
def test_ml_plan_on_card(cuda, nrow, lanes):
    """K9/K10's stage kernels at these shapes: grids that cover the planes,
    shared memory within a CTA's 232,448 B, at least one CTA an SM, no local
    memory, and no spill in nvcc's report."""
    r, npairs = 2**nrow, 37
    plan = kml.ml_plan(r, lanes, nrow, npairs)
    for p in plan.values():
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    for key in ("bwd_lane", "fwd_lane"):
        p = plan[key]
        assert p["ctas"] == -(-r // p["rows"]) * (lanes // p["cols"])
    assert plan["dm"]["chunks"] * plan["dm"]["chunk_rows"] == r
    hi, lo = plan["row_hi"], plan["row_lo"]
    assert lo["ctas"] * lo["tile"] == r * lanes and hi["bits"] + lo["bits"] == nrow
    assert (hi["ctas"] == 0) == (nrow <= 6) and hi["ctas"] in (0, lo["ctas"])
    report = _ptxas_report(_build.build_log("multilayer"), "")
    for needle in ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize(
    "nrow,lanes", [(k, 128) for k in range(1, 13)] + [(12, 256), (12, 512), (12, 1024)]
)
def test_ml_fwd_at_row_pass_boundaries(cuda, nrow, lanes):
    """K9 at every row-bit count of its forward passes (1-6: the zz pass
    alone; 7-12: the zz pass and the other) at 128 lanes, and at 12 row
    bits at 256, 512 and 1024 lanes, L=2, against its plain version."""
    n = nrow + lanes.bit_length() - 1
    rng = np.random.default_rng(7 * n + nrow)

    def unit(size):
        z = rng.normal(size=size) + 1j * rng.normal(size=size)
        return z / np.linalg.norm(z)

    cand = [(a, b) for a in range(n) for b in range(a + 1, n)]
    pairs = tuple(cand[i] for i in rng.choice(len(cand), size=min(37, len(cand)), replace=False))
    m = np.linalg.qr(rng.normal(size=(2, lanes, lanes)) + 1j * rng.normal(size=(2, lanes, lanes)))[0]
    args = (pairs, n, convert.params(rng.normal(size=(2, len(pairs))) * 0.5, cuda),
            convert.params(rng.normal(size=(2, nrow)) * 0.5, cuda))
    planes = (*convert.planes(unit(2**n), cuda, lanes=lanes), convert.params(m.real, cuda),
              convert.params(m.imag, cuda))
    kml.ml_fwd.launches = 0
    with torch.no_grad():
        got = kml.ml_fwd(*args, *planes)
        torch.cuda.synchronize()
        want = kml.ml_fwd_plain(*args, *planes)
    assert kml.ml_fwd.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape == (2**nrow, lanes)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nrow,lanes", [(1, 128), (4, 128), (7, 128), (12, 256), (12, 1024)])
def test_ml_fwd_plan_on_card(cuda, nrow, lanes):
    """K9's records of the card's plan (``ml_plan``) equal the Python
    arithmetic (``ml_fwd_plan``), and its forward passes spill nothing."""
    r, npairs = 2**nrow, 37
    got, want = kml.ml_plan(r, lanes, nrow, npairs), kml.ml_fwd_plan(r, lanes, nrow, npairs)
    for stage, p in want.items():
        assert {k: got[stage][k] for k in p} == p, stage
        assert got[stage]["local_bytes"] == 0 and got[stage]["ctas_per_sm"] >= 1
    hits = list(_ptxas_report(_build.build_log("multilayer"), "fwd_row_pass_kernel").values())
    assert len(hits) == 2 and all(regs and not st and not ld for regs, st, ld in hits)


@pytest.mark.parametrize("n,nkernel", [(9, 2), (20, 10)])
def test_rotx_kernels_match_plain(cuda, n, nkernel):
    """K11 and K12 against their plain versions (n=20: nkernel 10, r=8192,
    the QAOA path's shape), and K12 bit for bit against itself."""
    x = _row_inputs(n, nkernel, 4 * n + nkernel, cuda)
    th = convert.params(np.random.default_rng(n).normal(size=nkernel) * 0.7, cuda)
    krl.rotx_fwd.launches = krl.rotx_bwd.launches = 0
    with torch.no_grad():
        y = krl.rotx_fwd(th, *x["s"])
        got = krl.rotx_bwd(th, *y, *x["ct"])
        again = krl.rotx_bwd(th, *y, *x["ct"])
        torch.cuda.synchronize()
        assert (krl.rotx_fwd.launches, krl.rotx_bwd.launches) == (1, 2)
        for g, w in zip(y, krl.rotx_fwd_plain(th, *x["s"])):
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        want = krl.rotx_bwd_plain(th, *y, *x["ct"])
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("nkernel", range(1, 11))
def test_rotx_bwd_at_row_stage_boundaries(cuda, nkernel):
    """K12 at every walked-bit count of its passes (1-6: the last pass
    alone; 7-10: the first and the last) on two blocks of 2^nkernel rows
    (n >= 9), unitary inputs from K11's plain version, against its plain
    version and bit for bit against itself."""
    n = max(9, nkernel + 8)
    x = _row_inputs(n, nkernel, 11 * nkernel, cuda)
    th = convert.params(np.random.default_rng(nkernel).normal(size=nkernel) * 0.7, cuda)
    krl.rotx_bwd.launches = 0
    with torch.no_grad():
        y = krl.rotx_fwd_plain(th, *x["s"])
        got = krl.rotx_bwd(th, *y, *x["ct"])
        again = krl.rotx_bwd(th, *y, *x["ct"])
        torch.cuda.synchronize()
        want = krl.rotx_bwd_plain(th, *y, *x["ct"])
    assert krl.rotx_bwd.launches == 2
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _close(g, w)


@pytest.mark.parametrize("n,nkernel", [(8, 1), (12, 3), (14, 6), (17, 7), (20, 10), (20, 11)])
def test_rotx_bwd_plan_on_card(cuda, n, nkernel):
    """K12's pass plan as the card reports it equals the Python arithmetic
    (``rotx_bwd_plan``), with shared memory within a CTA's 232,448 B, at
    least one CTA an SM, no local memory, and no spill of its passes in
    nvcc's report of the row_layer build."""
    r = 2 ** (n - 7)
    got, want = krl.rotx_bwd_card_plan(r, nkernel), krl.rotx_bwd_plan(r, nkernel)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1 and p["local_bytes"] == 0
    report = _ptxas_report(_build.build_log("row_layer"), "")
    for needle in ("ml_row_pass_kernel", "rx_row_pass_kernel", "colsum_tree_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits), needle


def test_ml_and_rotx_wrappers_check_their_inputs(cuda):
    x = _ml_card_inputs(12, 2, 1, cuda)
    args = (x["pairs"], 12, x["zz"], x["th"])
    sr, si = x["s"]
    with pytest.raises(ValueError, match="float32"):
        kml.ml_fwd(*args, sr.double(), si, *x["m"])
    with pytest.raises(ValueError, match="unsupported shape"):  # 2048 lanes
        w = torch.zeros((2, 2048), device=cuda)
        kml.ml_fwd(x["pairs"], 12, x["zz"], x["th"][:, :1], w, w, *x["m"])
    with pytest.raises(ValueError, match="zzth shape"):
        kml.ml_bwd(x["pairs"], 12, x["zz"][:, :-1], x["th"], sr, si, sr, si, *x["m"])
    with pytest.raises(ValueError, match="plane shape"):
        kml.ml_fwd(*args, sr, si, x["m"][0][:1], x["m"][1][:1])
    r = _row_inputs(12, 5, 1, cuda)
    with pytest.raises(ValueError, match="unsupported shape"):  # nkernel 6: 32 rows
        krl.rotx_fwd(torch.zeros(6, device=cuda), *r["s"])
    with pytest.raises(ValueError, match="contiguous"):
        krl.rotx_bwd(torch.zeros(5, device=cuda), *r["s"], r["ct"][0].t().contiguous().t(), r["ct"][1])


@pytest.mark.parametrize("n,form", [(12, "zzrx"), (20, "zzrx"), (12, "rzz_rx"), (20, "rzz_rx")])
def test_qaoa_on_card_matches_cpu(cuda, n, form, monkeypatch):
    """The QAOA MaxCut cost at p=4 and its gradient on the card, form (a)
    under ML_MODE="pallas" (K9 and K10 once each) and form (b) under
    USE_ROTX (K11 and K12 four times each from n=8 on), against the CPU
    path."""
    edges, params = qaoa_graph(n, 4)
    monkeypatch.setattr(kernels, "ML_MODE", "pallas" if form == "zzrx" else "stack")
    monkeypatch.setattr(kernels, "USE_ROTX", form != "zzrx")

    def run(dev):
        p = convert.params(params, dev).requires_grad_()
        e = qaoa_energy(tct, lambda a: convert.params(a, dev), n, edges, p, form, device=dev)
        (g,) = torch.autograd.grad(e, p)
        return e.item(), convert.to_numpy(g)

    counters = (kml.ml_fwd, kml.ml_bwd, krl.rotx_fwd, krl.rotx_bwd)
    for k in counters:
        k.launches = 0
    e_card, g_card = run(cuda)
    launches = tuple(k.launches for k in counters)
    assert launches == ((1, 1, 0, 0) if form == "zzrx" else (0, 0, 4, 4))
    e_cpu, g_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 1e-4
    np.testing.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-4)


def _grad_close(got, want):
    torch.testing.assert_close(got, want, atol=GRAD_RTOL * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize(
    "n,nkernel,rmx,lane",
    [(10, 3, 1, True), (14, 7, 1, False), (12, 5, 2, True), (13, 6, 3, False), (16, 8, 4, True),
     (17, 10, 5, True), (20, 10, 7, True), (20, 10, 7, False), (21, 10, 7, False), (17, 10, 3, True),
     (18, 10, 1, False)],
)
def test_rowm_kernels_match_plain(cuda, n, nkernel, rmx, lane):
    """K1 and K3 with the row kron M7 (stages K13/K14): the forward with an
    arbitrary M7, the backward with the unitary M7 = kron(rx) from the
    forward's output, K3 twice and equal bit for bit (n=20, rmx=7 is the
    FUSE_ROWM path's shape).  R = 2 at n=10 leaves K13's one tile of 1024
    columns half empty; n=21, rmx=7 gives 512 and 1024 column tiles, not a
    multiple of the persistent grid; rmx=3 and rmx=1 at nkernel=10 leave 7
    and 9 bits to the row stage: two passes after K14."""
    pairs = _pairs(n, "open")
    (sr, si), t = _inputs(n, nkernel, 1, len(pairs), 3 * n + rmx, cuda)
    zz, th = t["zz"][0], t["th"][0]
    rng = np.random.default_rng(n)
    mr = mi = None
    if lane:  # unitary: the backward un-applies it
        mr, mi = (m[0] for m in kst._lane_kron_planes_T(convert.params(rng.normal(size=(1, 7)), cuda)))
    R = 2**rmx
    a7r, a7i = (convert.params(rng.normal(size=(R, R)) / np.sqrt(2 * R), cuda) for _ in range(2))
    krl.rowm_fwd.launches = krl.rowm_bwd.launches = 0
    got = krl.rowm_fwd(pairs, n, zz, th, sr, si, a7r, a7i, mr, mi)
    torch.cuda.synchronize()
    for g, w in zip(got, krl.zzrx_fwd_plain(pairs, n, zz, th, sr, si, mr, mi, a7r, a7i)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    m7r, m7i = (m[0] for m in kst._rx_kron_planes(th[None, :rmx]))
    yr, yi = krl.zzrx_fwd_plain(pairs, n, zz, th, sr, si, mr, mi, m7r, m7i)
    (ctr, cti), _ = _inputs(n, nkernel, 1, len(pairs), n + 1, cuda)
    got = krl.rowm_bwd(pairs, n, zz, th, yr, yi, ctr, cti, m7r, m7i, mr, mi)
    again = krl.rowm_bwd(pairs, n, zz, th, yr, yi, ctr, cti, m7r, m7i, mr, mi)
    torch.cuda.synchronize()
    assert (krl.rowm_fwd.launches, krl.rowm_bwd.launches) == (1, 2)
    want = krl.zzrx_bwd_plain(pairs, n, zz, th, yr, yi, ctr, cti, mr, mi, m7r, m7i)
    assert len(got) == len(want) == (8 if lane else 6) and got[3].shape == (nkernel - rmx,)
    for i, (g, g2, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, g2)
        if i < 2:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        else:
            _grad_close(g, w)


@pytest.mark.parametrize("n,nkernel,rmx", [(12, 5, 2), (20, 10, 7)])
def test_rowm_fwd_in_place_matches_plain(cuda, n, nkernel, rmx):
    """K1 with M7 through its C entry point with the output planes the
    input planes themselves (the row stage and K13 then both run in
    place)."""
    pairs = _pairs(n, "open")
    (sr, si), t = _inputs(n, nkernel, 1, len(pairs), 5 * n + rmx, cuda)
    zz, th = t["zz"][0], t["th"][0]
    rng = np.random.default_rng(rmx)
    R = 2**rmx
    m7r, m7i = (convert.params(rng.normal(size=(R, R)) / np.sqrt(2 * R), cuda) for _ in range(2))
    want = krl.zzrx_fwd_plain(pairs, n, zz, th, sr, si, None, None, m7r, m7i)
    yr, yi = sr.clone(), si.clone()
    shifts = krl._pair_shifts(pairs, n, str(cuda))
    lib = _build.library("zzrx_fwd")
    scratch = torch.empty(lib.tcng_zzrx_fwd_scratch(yr.shape[0], nkernel, len(pairs), 0, rmx), device=cuda)
    err = lib.tcng_zzrx_fwd(
        yr.data_ptr(), yi.data_ptr(), yr.data_ptr(), yi.data_ptr(), zz.data_ptr(), shifts.data_ptr(),
        len(pairs), th.data_ptr(), nkernel, None, None, m7r.data_ptr(), m7i.data_ptr(), rmx, scratch.data_ptr(),
        yr.shape[0], torch.cuda.current_stream().cuda_stream,
    )
    _build.check("zzrx_fwd", err, "zzrx_fwd in place")
    torch.cuda.synchronize()
    for g, w in zip((yr, yi), want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rmx", [1, 4, 7])
def test_rowm_plan_on_card(cuda, rmx):
    """The row-kron stages' plan at n=20: a persistent grid no larger than
    the card's slots, a tile that fits, and no local memory (spills) at the
    path's R=128 or below."""
    r = 2**13
    plan = krl.rowm_plan(rmx, r)
    slots = torch.cuda.get_device_properties(0).multi_processor_count
    for key in ("fwd", "bwd"):
        p = plan[key]
        assert p["grid"] == min(p["tiles"], slots * p["ctas_per_sm"]) and p["ctas_per_sm"] >= 1
        assert p["tiles"] * p["cw"] >= r * 128 >> rmx > (p["tiles"] - 1) * p["cw"]
        assert p["smem"] <= 232448 and p["local_bytes"] == 0
    dm = plan["dm"]
    assert dm["chunks"] * dm["chunk_cols"] == r * 128 >> rmx and dm["local_bytes"] == 0
    assert dm["tiles"] * dm["tile"] ** 2 == 4**rmx and dm["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n", [12, 20])
def test_rowm_gradient_on_card_matches_cpu(cuda, n, monkeypatch):
    """The TFIM value and grad at L=4 under FUSE_ROWM on the card (K1/K3
    with M7 once a layer; no K2/K4) against the CPU path."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    p0 = np.random.default_rng(n).normal(size=(4, 2, n)) * 0.1
    monkeypatch.setattr(kst, "FUSE_ROWM", True)

    def run(dev):
        p = convert.params(p0, dev).requires_grad_()
        c = tct.Circuit(n, device=dev)
        c.h_layer()
        for l in range(4):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        e = c.expectation_zzx_energy(pairs, 1.0, -1.0)
        (g,) = torch.autograd.grad(e, p)
        return e.item(), convert.to_numpy(g)

    counters = (krl.rowm_fwd, krl.rowm_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd)
    for k in counters:
        k.launches = 0
    e_card, g_card = run(cuda)
    rmx = kst._rowm_qubits(kst._shapes(n)[1])
    assert tuple(k.launches for k in counters) == ((4, 4, 0, 0) if rmx else (0, 0, 0, 0))
    e_cpu, g_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 1e-4
    np.testing.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,level", [(18, 1), (18, 3), (19, 3), (20, 1), (20, 2), (20, 3), (21, 3)])
def test_micro_grand_matches_plain(cuda, n, level):
    """K15 at each level on the example's inputs (n=20: 8 blocks; n=18: 2)
    against its plain version, within 1e-5 of the output's largest entry."""
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    args = km.micro_inputs(cuda, seed=level, n=n)
    km.micro_grand.launches = 0
    got = km.micro_grand(level, *args)
    torch.cuda.synchronize()
    assert km.micro_grand.launches == 1
    for g, w in zip(got, km.micro_grand_plain(level, *args)):
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item(), rtol=0)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_micro_grand_twice_bit_identical(cuda, level):
    """K15 at n=20 twice on the same inputs: equal bit for bit (no sum
    crosses a CTA), and the caller's planes unwritten."""
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    args = km.micro_inputs(cuda, seed=level)
    before = [a.clone() for a in args[-2:]]
    first, second = km.micro_grand(level, *args), km.micro_grand(level, *args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(args[-2:], before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("n", [18, 19, 20, 21])
def test_micro_grand_plan_on_card(cuda, n, level):
    """K15's stage plan as the card reports it equals the Python arithmetic
    (``micro_grand_plan``), each stage it runs with shared memory within a
    CTA's 232,448 B, at least one CTA an SM and no local memory, and no
    spill of its kernels in nvcc's report of the micro_grand build."""
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    r = 2 ** (n - 7)
    got, want = km.micro_grand_card_plan(level, r, 4), km.micro_grand_plan(level, r, 4)
    assert got.keys() == want.keys()
    for stage, p in got.items():
        assert {k: p[k] for k in want[stage]} == want[stage], stage
        assert p["local_bytes"] == 0
        if p["ctas"]:
            assert p["smem"] <= 232448 and p["ctas_per_sm"] >= 1
    report = _ptxas_report(_build.build_log("micro_grand"), "")
    for needle in ("fwd_row_pass_kernelILb0ELb1ELb0E", "wide_nt_kernel", "outer_fwd_kernel", "transpose_kernel",
                   "micro_gates_kernel", "copy_kernel"):
        hits = [v for k, v in report.items() if needle in k]
        assert hits and all(regs and not st and not ld for regs, st, ld in hits), needle


@pytest.mark.parametrize("level", [2, 3])
def test_micro_grand_refuses_r_not_power_of_two(cuda, level):
    """Three blocks (r = 3072) at m2 and m3 on the card: ValueError; m1
    copies them."""
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    g = torch.Generator(device=cuda).manual_seed(level)
    draw = lambda *shape: torch.randn(*shape, generator=g, device=cuda)  # noqa: E731
    args = (draw(4, 10, 2), draw(4, 128, 128), draw(4, 128, 128), draw(4, 3, 3), draw(4, 3, 3),
            draw(3072, 128), draw(3072, 128))
    with pytest.raises(ValueError, match="power of two"):
        km.micro_grand(level, *args)
    yr, yi = km.micro_grand(1, *args)
    assert torch.equal(yr, args[-2]) and torch.equal(yi, args[-1])


@pytest.mark.parametrize("n", [10, 20])
def test_samplers_on_card_match_cpu(cuda, n):
    """``backend.probability_sample`` and the trajectory sampler
    (``statevec.sample_trajectories``) on the card against the CPU with the
    same status, the card's indices the same on a second call: every index within its float64 cdf interval
    (``chip_smoke.bracket_miss``, 1e-6 at n=10, 1e-4 at n=20: a float32
    cumsum over 2^n entries in another order), each trajectory's probability
    within a relative 1e-4 of p(bits)."""
    from chip_smoke import bracket_miss, trajectory_bracket_miss
    from tensorcircuit_ng_tpu_torch.core import statevec

    rng = np.random.default_rng(n)
    p = (np.abs(rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)) ** 2).astype(np.float32)
    u = rng.random(4096).astype(np.float32)
    big = rng.random((512, n)).astype(np.float32)
    tol = 1e-6 if n <= 10 else 1e-4
    pc = torch.as_tensor(p, device=cuda)
    idx = tct.backend.probability_sample(4096, pc, status=torch.as_tensor(u, device=cuda))
    assert idx.device.type == "cuda" and idx.dtype == torch.int32
    again = tct.backend.probability_sample(4096, pc, status=torch.as_tensor(u, device=cuda))
    assert torch.equal(idx, again)  # the cdf's sums in a fixed order
    idx_cpu = tct.backend.probability_sample(4096, torch.as_tensor(p), status=u)
    assert bracket_miss(idx.cpu().numpy(), u, p) <= tol
    assert bracket_miss(idx_cpu.numpy(), u, p) <= tol
    bits, prob = statevec.sample_trajectories(pc, torch.as_tensor(big, device=cuda))
    bits_cpu, _ = statevec.sample_trajectories(torch.as_tensor(p), torch.as_tensor(big))
    assert bits.device.type == "cuda" and bits.shape == (512, n)
    for b in (bits.cpu().numpy(), bits_cpu.numpy()):
        assert trajectory_bracket_miss(b, big, p) <= tol
    want = p.astype(np.float64)[bits.cpu().numpy().astype(np.int64) @ (2 ** np.arange(n - 1, -1, -1))] / p.sum()
    np.testing.assert_allclose(prob.cpu().numpy(), want, rtol=1e-4)


def test_sampling_circuit_runs_on_card(cuda):
    """``tct.Circuit(n).sample`` defaults to the card; a generator or a
    status tensor on another device is a ValueError naming both devices; a
    generator on the card repeats itself."""
    c = tct.Circuit(5)
    c.h(0)
    c.cnot(0, 3)
    assert c.sample(batch=8, allow_state=True, format="sample_int").device.type == "cuda"
    assert c.sample(batch=8, format="sample_bin").device.type == "cuda"
    g = torch.Generator().manual_seed(1)
    for call in (lambda: c.sample(batch=4, allow_state=True, random_generator=g),
                 lambda: c.sample(batch=4, random_generator=g),
                 lambda: c.sample_expectation_ps(z=[0], shots=4, random_generator=g),
                 lambda: c.measure(0, generator=g)):
        with pytest.raises(ValueError, match="cpu.*cuda"):
            call()
    with pytest.raises(ValueError, match="cpu.*cuda"):
        c.sample(batch=2, allow_state=True, status=torch.zeros(2))
    runs = [c.sample(batch=64, random_generator=tct.backend.get_random_state(3, device=cuda), format="sample_int")
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    m = c.cond_measurement(0, status=torch.tensor(0.9, device=cuda))
    c.conditional_gate(m, [np.eye(2), np.array([[0.0, 1.0], [1.0, 0.0]])], 1)
    assert m.device.type == "cuda" and abs(torch.linalg.vector_norm(c.state()).item() - 1) < 1e-6


@pytest.mark.parametrize("n", [10, 20])
def test_noisy_trajectories_on_card_match_cpu(cuda, n):
    """One trajectory of the TFIM at L=2 with a depolarizing channel after
    each ``zzrx_layer`` (value and gradient: K1 and K3 a layer) and one of
    the HEA at L=2 with amplitude damping after each CNOT (``general_kraus``
    reads the state at each site; K6), on the card and on the CPU with the
    same status: the same branches, each within 1e-5 of its float64 cdf
    interval on both devices, the energy within 2e-5 n, the gradient within
    1e-4; the ``noise_conf=`` entry points on a circuit of the default
    device give a value on the card."""
    from chip_smoke import branch_miss, channel_branches, channel_probs, hea_circuit, tfim_circuit

    nl = 2
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.3
    pairs = [(i, i + 1) for i in range(n - 1)]
    nc = tct.NoiseConf()
    nc.add_noise("zzrx_layer", tct.channels.depolarizingchannel(0.05, 0.05, 0.05))
    nc_hea = tct.NoiseConf()
    nc_hea.add_noise("cnot", tct.channels.amplitudedampingchannel(0.1, 1.0))
    st = np.random.default_rng(n).random(nl * n).astype(np.float32)
    st_hea = np.random.default_rng(n + 1).random(2 * nl * (n - 1)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = convert.params(g0, dev).requires_grad_()
        cn = tct.circuit_with_noise(tfim_circuit(tct, p, n, nl, device=dev), nc, status=torch.as_tensor(st, device=dev))
        e = cn.expectation_zzx_energy(pairs, 1.0, -1.0)
        (g,) = torch.autograd.grad(e, p)
        with torch.no_grad():
            ch = tct.circuit_with_noise(hea_circuit(tct, n, p, device=dev), nc_hea,
                                        status=torch.as_tensor(st_hea, device=dev))
            eh = ch.expectation_zzx_energy(pairs, 1.0, -1.0)
        out[dev.type] = (e.item(), g.cpu(), channel_branches(cn).cpu(), eh.item(), channel_branches(ch).cpu(),
                         channel_probs(ch).double().cpu().numpy())
    card, cpu = out["cuda"], out["cpu"]
    assert torch.equal(card[2], cpu[2]) and torch.equal(card[4], cpu[4])
    for o in (card, cpu):
        assert branch_miss(o[4].numpy(), st_hea, o[5]) <= 1e-5
    assert abs(card[0] - cpu[0]) <= 2e-5 * n and abs(card[3] - cpu[3]) <= 2e-5 * n
    assert (card[1] - cpu[1]).abs().max().item() <= 1e-4
    c = tfim_circuit(tct, convert.params(g0, cuda), n, nl)
    assert c.device.type == "cuda"
    v = c.expectation_ps(z=[0, 1], noise_conf=nc, nmc=4)
    assert v.device.type == "cuda" and -1 <= v.item() <= 1


def test_dmcircuit_on_card_matches_cpu(cuda):
    """A 6-qubit ``DMCircuit`` (fused layers, dense gates, every exact
    channel kind, a collapse) on the card against the CPU: ρ within 2e-6,
    its trace 1, its purity and an expectation within 1e-5."""

    def build(device):
        rng = np.random.default_rng(5)
        c = tct.DMCircuit(6, device=device)
        c.h_layer()
        c.zzrx_layer([(i, i + 1) for i in range(5)], rng.normal(size=5), rng.normal(size=6))
        c.ry_layer(rng.normal(size=6))
        c.cnot(0, 4)
        c.depolarizing(1, px=0.1, py=0.05, pz=0.08)
        c.amplitudedamping(2, gamma=0.3, p=0.8)
        c.generaldepolarizing(3, 5, p=0.02, num_qubits=2)
        c.cond_measurement(4, status=0.3)
        c.rx(2, theta=0.3)
        return c

    d, dc = build(cuda), build("cpu")
    rho = d.densitymatrix()
    assert rho.device.type == "cuda" and rho.shape == (64, 64)
    assert (rho.cpu() - dc.densitymatrix()).abs().max().item() <= ATOL
    assert abs(torch.trace(rho).real.item() - 1) <= 1e-5
    assert abs(d.purity().item() - dc.purity().item()) <= 1e-5
    assert abs(d.expectation_ps(x=[0], z=[2]).real.item() - dc.expectation_ps(x=[0], z=[2]).real.item()) <= 1e-5


def test_grid_amplitude_on_card_matches_cpu(cuda):
    """A 4x5 grid amplitude's IR operands lie on the card; its contraction,
    whole and sliced, equals the CPU path's and the dense state's."""
    from tensorcircuit_ng_tpu_torch.core import contractor as ctr

    ang = grid_angles(20, 8)
    c = grid_circuit(tct, 4, 5, 8, ang, device=cuda)
    ir = c.amplitude_before("0" * 20)
    assert all(t.is_cuda and t.dtype == torch.complex64 for t in ir.tensors)
    want = ctr.contract_ir(grid_circuit(tct, 4, 5, 8, ang, device="cpu").amplitude_before("0" * 20))
    got = ctr.contract_ir(ir)
    sliced = ctr.sliced_contract_ir(ir, ctr.choose_slices(ir, 2**6))
    scale = abs(want.item())
    for v in (got, sliced, c.state()[0]):
        assert abs(v.item() - want.item()) <= 1e-4 * scale


def test_wide_routes_on_card_match_cpu(cuda):
    """Past the dense cliff (a 4x8 grid, n=32): the amplitude, <Z> and
    their gradients in the angles on the card against the CPU path."""
    ang = grid_angles(32, 3)
    z = np.diag([1.0, -1.0])
    out = {}
    for dev in ("cpu", cuda):
        th = torch.tensor(ang, dtype=torch.float32, device=dev, requires_grad=True)
        amp = grid_circuit(tct, 4, 8, 3, th, device=dev).amplitude("01" * 16)
        (ga,) = torch.autograd.grad(torch.abs(amp) ** 2, th)
        e = grid_circuit(tct, 4, 8, 3, th, device=dev).expectation((z, [13])).real
        (ge,) = torch.autograd.grad(e, th)
        out[str(dev)] = [x.detach().cpu() for x in (amp, ga, e, ge)]
    (a0, ga0, e0, ge0), (a1, ga1, e1, ge1) = out["cpu"], out["cuda"]
    assert abs(a1 - a0) <= 1e-4 * abs(a0)
    assert (ga1 - ga0).abs().max() <= 1e-4 * ga0.abs().max()
    assert abs(e1 - e0) <= 1e-5 and (ge1 - ge0).abs().max() <= 1e-5


def test_sample_past_cliff_on_card_matches_cpu(cuda):
    """31-qubit shots with a status and a readout error: the card's bits
    are the CPU path's."""
    st = np.random.default_rng(3).random((2, 31))
    ro = [[0.97, 0.95]] * 31
    got, want = (brickwork_circuit(tct, 31, 2, device=dev).sample(batch=2, status=st, readout_error=ro,
                                                                  format="sample_bin").cpu()
                 for dev in (cuda, "cpu"))
    assert torch.equal(got, want)


def test_dmcircuit2_on_card_matches_cpu(cuda):
    """``DMCircuit2`` past its cliff (n=16) on the card against the CPU."""
    z = np.diag([1.0, -1.0])
    vals = []
    for dev in (cuda, "cpu"):
        c = noisy_brickwork_dm(tct, 16, 2, device=dev)
        vals.append([c.expectation((z, [8])).real.cpu(), c.probability(2, 8, 13).cpu(),
                     c.measure_jit(1, 8, 9, status=np.array([0.2, 0.7, 0.4]))[0].cpu(), c.amplitude("0" * 16).cpu()])
    (e1, p1, m1, a1), (e0, p0, m0, a0) = vals
    assert abs(e1 - e0) <= 1e-5 and (p1 - p0).abs().max() <= 1e-5 and torch.equal(m1, m0)
    assert abs(a1 - a0) <= 1e-4 * abs(a0)


def test_contraction_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 15 at a small size on the card."""
    got = _contraction_checks(tct, cuda, grid_a=(3, 4, 6), grid_b=(4, 8, 2), slice_target=2**4, ghz=(31, 8),
                              brick=(31, 2, 2), dm2=(16, 2), dm2_small=6)
    assert got["sliced"] and all(cost is not None for cost in got["once"].values())


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_mps_vqe_on_card_matches_cpu(cuda, dtype, monkeypatch):
    """Phase 16 (a)'s step at n=20, chi=16, depth 4 (chi binding in the
    middle): the card's Gram route against the CPU path's complex128 exact
    SVD (value, gradient, the step), and its gradient against the CPU
    path's Gram route."""
    from tensorcircuit_ng_tpu_torch.core import linalg

    g0 = mps_vqe_angles(20, 4)
    with tct.set_dtype(dtype):
        got = mps_vqe_step(tct, cuda, g0, 20, 16)
    with tct.set_dtype("complex128"):
        want = mps_vqe_step(tct, "cpu", g0, 20, 16)
        monkeypatch.setattr(linalg, "USE_GRAM_SVD", True)
        gram = mps_vqe_step(tct, "cpu", g0, 20, 16)
    tol_e, tol_g, tol_e1 = MPS_TOL[dtype]
    assert got[3].get_bond_dimensions() == want[3].get_bond_dimensions()
    assert abs(got[0].item() - want[0].item()) <= tol_e * abs(want[0].item())
    assert (got[1].cpu().double() - want[1]).abs().max().item() <= tol_g * want[1].abs().max().item()
    assert abs(got[2].item() - want[2].item()) <= tol_e1 * abs(want[2].item())
    gg = gram[1]
    assert (got[1].cpu().double() - gg).abs().max().item() <= MPS_GRAM_GRAD_TOL[dtype] * gg.abs().max().item()


def test_dmrg_on_card_matches_cpu(cuda):
    mpo = tct.dmrg.xxz_mpo(8, 1.4, 0.2)
    e1, a1 = tct.dmrg.dmrg(mpo, chi=16, sweeps=4, device=cuda)
    e0, a0 = tct.dmrg.dmrg(mpo, chi=16, sweeps=4, device="cpu")
    assert a1[0].device.type == "cuda" and abs(e1 - e0) <= 1e-8
    assert abs(tct.dmrg.mps_energy(a1, mpo, device=cuda) - e0) <= 1e-8
    assert abs(abs(tct.dmrg.mps_overlap([t.cpu() for t in a1], a0, device="cpu")) - 1.0) <= 1e-8


def test_mps_sample_on_card_matches_cpu(cuda):
    """1024 shots of an n=20 chi=16 MPS at complex128 with one status: each
    outcome within 1e-6 of its float64 cdf interval on the CPU path's chain."""
    g0 = mps_vqe_angles(20, 4)
    status = mps_status(1024, 20)
    with tct.set_dtype("complex128"):
        c1 = mps_vqe_step(tct, cuda, g0, 20, 16)[3]
        c0 = mps_vqe_step(tct, "cpu", g0, 20, 16)[3]
        bits = c1.sample(1024, status=status, format="sample_bin")
        want = c0.sample(1024, status=status, format="sample_bin")
        assert bits.device.type == "cuda"
        assert mps_bracket_miss(c0._right_canonical(), bits.cpu(), status) <= 1e-6
        assert int((bits.cpu() != want).any(dim=1).sum()) <= 2
        with pytest.raises(ValueError, match="generator"):
            c1.sample(4, random_generator=torch.Generator(device="cpu"))


def test_mps_inputs_and_quoperators_on_card_match_cpu(cuda):
    got, want = _qop_values(tct, cuda, 8), _qop_values(tct, "cpu", 8)
    for key in want:
        assert got[key].device.type == "cuda", key
        assert (got[key].cpu() - want[key]).abs().max().item() <= 1e-5, key


def test_mps_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 16 at a small size on the card."""
    small = dict(n=10, chi=8, depth=4, n_b=8, depth_b=2, shots=256, n_d=6, chi_d=8, sweeps_d=3, n_e=6)
    with tct.set_device("cpu"):
        ref = _mps_reference(tct, **small, drift=False)
    # at n_b=8 the dense side runs the plain path: K2/K4's launches are the
    # smoke's check, at n=20
    got = _mps_checks(tct, cuda, ref, (), **small)
    assert got["c64"].tensors[0].device.type == "cuda"


def test_exact_svd_gradient_on_card_matches_central_difference(cuda, monkeypatch):
    """Queue 3 F9 on the card: the exact SVD's gradient of phase 16 (a)'s
    step at n=16, chi=16, depth 10 (complex128) at the angle (2, 1, 13),
    where the JAX package's adjoint rule is 4.3e-5 off, against a central
    difference of the CPU path's energy (h=1e-5), within 1e-8."""
    from tensorcircuit_ng_tpu_torch.core import linalg

    n, chi, angle = 16, 16, (2, 1, 13)
    g0 = mps_vqe_angles(n, 10)
    monkeypatch.setattr(linalg, "USE_GRAM_SVD", False)
    with tct.set_dtype("complex128"):
        g = mps_vqe_step(tct, cuda, g0, n, chi)[1]
        e = []
        with torch.no_grad():
            for sign in (1.0, -1.0):
                p = g0.copy()
                p[angle] += sign * 1e-5
                e.append(tfim_energy_ps(mps_vqe_circuit(tct, torch.as_tensor(p), n, chi, device="cpu"), n).item())
    assert g.device.type == "cuda"
    assert abs(g[angle].item() - (e[0] - e[1]) / 2e-5) < 1e-8


def test_coo_matvec_and_its_backward_on_card(cuda):
    """A 4x4 complex64 COO matrix (a duplicate entry summed) times a vector
    on the card, and the gradient of Re <v|A v> in v, against the CPU and
    the dense matrix."""
    idx = np.array([[0, 1], [1, 0], [2, 2], [3, 0], [0, 1], [1, 3]])
    vals = np.array([1 + 1j, 2.0, -1.0, 0.5j, 0.25, 0.3 - 0.2j], dtype=np.complex64)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        m = tct.backend.coo_sparse_matrix(idx, torch.as_tensor(vals, device=dev), (4, 4))
        assert m.device.type == dev.type and m.is_coalesced()
        v = torch.as_tensor(np.arange(4) + 1j * np.arange(4)[::-1], dtype=torch.complex64, device=dev)
        v.requires_grad_()
        mv = m @ v
        (g,) = torch.autograd.grad(torch.real(torch.vdot(v, mv)), v)
        out[dev.type] = (m.indices().cpu(), m.values().cpu(), mv.detach().cpu(), g.cpu(), m.to_dense().cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and torch.equal(out["cuda"][1], out["cpu"][1])
    for k in (2, 3, 4):
        assert (out["cuda"][k] - out["cpu"][k]).abs().max().item() <= 1e-6, k
    dense = out["cpu"][4].numpy()
    v = np.arange(4) + 1j * np.arange(4)[::-1]
    np.testing.assert_allclose(out["cuda"][2].numpy(), dense @ v, atol=1e-5)


def test_pauli_sum_coo_on_card_matches_cpu(cuda):
    """``PauliStringSum2COO`` of the TFIM and of random strings at n=12,
    built on the card: indices and values equal to the CPU path's bit for
    bit; ``PauliStringSum2Dense`` is its ``to_dense``."""
    rng = np.random.default_rng(3)
    ls = rng.integers(0, 4, size=(20, 12)).tolist() + [[3, 3] + [0] * 10, [0] * 12]
    w = rng.normal(size=len(ls)).tolist()
    for strings, weights in ((ls, w), (None, None)):
        if strings is None:
            got, want = (tct.templates.hamiltonians.tfim_hamiltonian(12, device=d) for d in (cuda, "cpu"))
        else:
            got, want = (tct.PauliStringSum2COO(strings, weights, device=d) for d in (cuda, "cpu"))
        assert got.device.type == "cuda" and got.is_coalesced()
        assert torch.equal(got.indices().cpu(), want.indices()) and torch.equal(got.values().cpu(), want.values())
    assert torch.equal(tct.PauliStringSum2Dense(ls, w, device=cuda),
                       tct.PauliStringSum2COO(ls, w, device=cuda).to_dense())


def test_entanglement_entropy_and_its_gradient_on_card_match_cpu(cuda):
    """The half-chain entanglement entropy of the n=12, L=4 TFIM state and
    its gradient in the angles, on the card against the CPU path."""
    g0 = np.random.default_rng(5).normal(size=(4, 2, 12)) * 0.5
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = convert.params(g0, dev).requires_grad_()
        s = tct.quantum.entanglement_entropy(tfim_circuit(tct, p, 12, 4, device=dev).state(), 6)
        (g,) = torch.autograd.grad(s, p)
        out[dev.type] = (s.item(), g.cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-4


def test_stabilizer_renyi_entropy_on_card_matches_cpu(cuda):
    """The SRE of an n=8 state (alpha 1 and 2) on the card against the CPU."""
    rng = np.random.default_rng(2)
    psi = rng.normal(size=256) + 1j * rng.normal(size=256)
    psi = psi / np.linalg.norm(psi)
    for alpha in (1, 2):
        got = tct.quantum.stabilizer_renyi_entropy(torch.as_tensor(psi, dtype=torch.complex64, device=cuda), alpha)
        want = tct.quantum.stabilizer_renyi_entropy(torch.as_tensor(psi, dtype=torch.complex64), alpha)
        assert got.device.type == "cuda" and abs(got.item() - want.item()) <= 1e-6


def test_hamiltonian_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 17 at a small size on the card (at n=8 the
    TFIM state takes the plain path: K2's and K3's launches are the
    smoke's check, at n=20)."""
    got = _hamiltonian_checks(tct, cuda, (), **HAM_SMALL)
    assert got["nnz"] == 9 * 2**8


def test_jit_captures_the_training_step_on_card(cuda):
    """Phase 18 (a) at n=18, L=4 (K2/K4's smallest width): ``jit`` of
    ``value_and_grad`` captures K2 and K4 into a CUDA graph at its first
    call, its replays equal the uncaptured step bit for bit and the CPU path
    within 1e-4; a later signature is captured again; a host read inside
    raises with the capture's reason."""
    K = tct.backend
    n, nl = 18, 4
    vg = K.value_and_grad(transform_energy(tct, n, nl, cuda), argnums=(0, 1))
    zz, rx = (convert.params(a, cuda) for a in transform_angles(n, nl))
    jvg = K.jit(vg)
    kg.grand_zzrx_fwd.launches = kg.grand_zzrx_bwd.launches = 0
    jvg(zz, rx)
    assert (kg.grand_zzrx_fwd.launches, kg.grand_zzrx_bwd.launches) == (2, 2) and jvg.captures == 1
    got = [jvg(zz, rx) for _ in range(2)]
    want = vg(zz, rx)
    for e, g in got:
        assert torch.equal(e, want[0]) and all(torch.equal(a, b) for a, b in zip(g, want[1]))
    e_cpu, g_cpu = K.value_and_grad(transform_energy(tct, n, nl, "cpu"), argnums=(0, 1))(
        *(convert.params(a, "cpu") for a in transform_angles(n, nl)))
    assert abs(got[0][0].item() - e_cpu.item()) <= 1e-4
    assert max((a.cpu() - b).abs().max().item() for a, b in zip(got[0][1], g_cpu)) <= 1e-4
    jvg(zz.double(), rx.double())
    assert jvg.captures == 2
    with pytest.raises(RuntimeError, match="cannot be captured"):
        K.jit(lambda x: x * x.sum().item())(zz)


def test_vvag_runs_the_kernels_once_a_restart_on_card(cuda):
    """Phase 18 (b) at n=18, L=4 over 3 restarts: K2 and K4 once a restart,
    each value and gradient within 1e-5 of its eager step, relative, and
    within 1e-4 of the CPU path; under ``jit`` the same values."""
    K = tct.backend
    n, nl, b = 18, 4, 3

    def energy_p(dev):
        energy = transform_energy(tct, n, nl, dev)
        return lambda p: energy(p[:, 0, : n - 1], p[:, 1])

    ps = convert.params(transform_angles(n, nl, b), cuda)
    kg.grand_zzrx_fwd.launches = kg.grand_zzrx_bwd.launches = 0
    vs, gs = K.vvag(energy_p(cuda), argnums=0, vectorized_argnums=0)(ps)
    assert (kg.grand_zzrx_fwd.launches, kg.grand_zzrx_bwd.launches) == (b, b)
    jvs, jgs = K.jit(K.vvag(energy_p(cuda), argnums=0, vectorized_argnums=0))(ps)
    for i in range(b):
        e1, g1 = K.value_and_grad(energy_p(cuda))(ps[i])
        e_cpu, g_cpu = K.value_and_grad(energy_p("cpu"))(ps[i].cpu())
        for e, g in ((vs[i], gs[i]), (jvs[i], jgs[i])):
            assert abs(e.item() - e1.item()) <= 1e-5 * abs(e1.item())
            assert (g - g1).abs().max().item() <= 1e-5 * g1.abs().max().item()
            assert abs(e.item() - e_cpu.item()) <= 1e-4 and (g.cpu() - g_cpu).abs().max().item() <= 1e-4


def test_time_evolution_on_card_matches_cpu(cuda):
    """Phase 18 (e) at n=12: Krylov and Chebyshev of the TFIM COO built on
    each device in complex128, from the same state (the CPU path's), on
    the card against the CPU path (1e-10) and each other."""
    te = tct.timeevol
    psi = _tfim_coo_state(tct, "cpu", 12, 2)[1]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        h, _, bounds = _tfim_coo_state(tct, dev, 12, 2)
        x = psi.to(dev)
        outs[dev.type] = (te.krylov_evol(h, x, [0.2, 0.5], 30), te.chebyshev_evol(h, x, 0.5, bounds))
    kc, cc = outs["cuda"]
    assert kc.device.type == "cuda" and kc.dtype == torch.complex128
    assert (kc.cpu() - outs["cpu"][0]).abs().max().item() <= 1e-10
    assert (cc.cpu() - outs["cpu"][1]).abs().max().item() <= 1e-10
    assert (kc[1] - cc).abs().max().item() <= 1e-10


def test_transform_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 18 at a small size on the card (the plain
    path at n=8: no kernel launch is required there; its jit captures the
    plain torch ops)."""
    _transform_checks(tct, cuda, (), **TRANSFORM_SMALL)


def test_surface_code_detectors_on_card_match_cpu(cuda):
    """Phase 19 (a) at 2 rounds, 64 shots: the card's bits equal the CPU
    path's with the same statuses, but for shots within 1e-6 of a cdf
    boundary; twice on the card, bit for bit."""
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        c = surface_code_program(tct, 3, 2, 0.01, device=dev)
        st, sc = detector_statuses(c, 64)
        outs[dev.type] = c.sample_detector(64, status=st, statusc=sc, with_observable=True, with_margin=True)
        if dev.type == "cuda":
            again = c.sample_detector(64, status=st, statusc=sc, with_observable=True, with_margin=True)
            assert all(torch.equal(a, b) for a, b in zip(outs["cuda"], again))
    (dc, oc, mc), (dp, op, mp) = outs["cuda"], outs["cpu"]
    assert dc.device.type == "cuda" and dc.dtype == torch.int32
    differ = ((dc.cpu() != dp).any(dim=1) | (oc.cpu() != op).any(dim=1)).numpy()
    margin = np.minimum(mc.cpu().numpy(), mp.numpy())
    assert not (differ & (margin > 1e-6)).any()


def test_exact_detector_probabilities_on_card_match_cpu(cuda):
    got = repetition_program(tct, 5, 2, 0.05, device=cuda).detector_probabilities_exact()
    want = repetition_program(tct, 5, 2, 0.05, device="cpu").detector_probabilities_exact()
    assert got.device.type == "cuda" and (got.cpu() - want).abs().max().item() <= 1e-6


def test_stabilizer_states_on_card(cuda):
    c = clifford_program(tct, 12, 20, 3, device=cuda)
    replayed, rebuilt = c.state(), tct.StabilizerCircuit(12, tableau_inputs=c.get_tableau(), device=cuda).state()
    assert replayed.device.type == rebuilt.device.type == "cuda"
    assert abs(torch.abs(torch.vdot(replayed, rebuilt)).item() - 1.0) <= 1e-5
    cpu = clifford_program(tct, 12, 20, 3, device="cpu").state()
    assert (replayed.cpu() - cpu).abs().max().item() <= 1e-6
    assert c.expectation_ps(z=[0]).device.type == "cuda"


@pytest.mark.parametrize("kind", ["qudit", "u1"])
def test_qudit_u1_energy_and_grad_on_card_match_cpu(cuda, kind):
    res = {}
    for dev in (cuda, torch.device("cpu")):
        if kind == "qudit":
            p = convert.params(stab_angles(2, 6, 23), dev).requires_grad_()
            c, e = qudit_energy(tct, p, 6, 3, 2, device=dev)
        else:
            p = convert.params(stab_angles(2, 12, 29), dev).requires_grad_()
            c, e = u1_energy(tct, p, 12, 6, 2, device=dev)
        (g,) = torch.autograd.grad(e, p)
        res[dev.type] = (c.state().detach().cpu(), e.item(), g.cpu())
    (sc, ec, gc), (sp, ep, gp) = res["cuda"], res["cpu"]
    assert (sc - sp).abs().max().item() <= 1e-5 and abs(ec - ep) <= 1e-5 and (gc - gp).abs().max().item() <= 1e-5


def test_u1_gate_twice_bit_for_bit_on_card(cuda):
    """The gather form sums each amplitude's terms in one order."""
    p = convert.params(stab_angles(2, 16, 31), cuda)
    outs = [u1_circuit(tct, p, 16, 8, 2, device=cuda).state() for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    c = tct.U1Circuit(16, k=8, device=cuda)
    c.unitary(3, 4, unitary=xy_gate(torch.tensor(0.3, device=cuda), torch.complex64))
    assert c._maps[(3, 4)][1].device.type == "cuda"


def test_stab_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 19 at a small size on the card."""
    _stab_checks(tct, cuda, **STAB_SMALL)


def test_slice_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 20 at a small size on the card (its own CPU
    path as the reference)."""
    _slice_checks(tct, cuda, **SLICE_SMALL)


def test_pauli_propagation_on_card_bit_for_bit_and_cpu(cuda):
    """The dense engine's gather form sums each coefficient in one order:
    twice the same bits on the card; against the CPU path within 1e-5."""
    c, _ = pp_circuit(tct, 8, 3, device=cuda)
    ps = [0, 0, 0, 3, 3, 0, 0, 0]
    eng = tct.PauliPropagationEngine(8, 3, device=cuda)
    outs = [eng.propagate(c, ps) for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and outs[0].device.type == "cuda"
    cpu = tct.PauliPropagationEngine(8, 3, device="cpu").propagate(pp_circuit(tct, 8, 3, device="cpu")[0], ps)
    assert (outs[0].cpu() - cpu).abs().max().item() <= 1e-5


def test_fgs_gradient_and_measurement_on_card_match_cpu(cuda):
    x = fgs_inputs(24, 2, 4, 6, 16)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        last = torch.as_tensor(x["chi"][-1]).to(device=dev, dtype=torch.complex64).requires_grad_()
        f = fgs_layers(tct, x, dev, last)
        e = torch.real(torch.sum(torch.as_tensor(x["hop"]).to(dev, torch.complex64) * f.get_cmatrix().T)) / 2
        (g,) = torch.autograd.grad(e, last)
        f = tct.FGSSimulator(24, alpha=f.alpha.detach(), device=dev)
        f.evol_hamiltonian(x["m"], 0.3)
        out = torch.stack([f.cond_measure(int(i), float(u)) for i, u in zip(x["sites"], x["status"])])
        res[dev.type] = (e.item(), g.cpu(), out.cpu(), f.get_cmatrix().cpu())
    (ec, gc, oc, cc), (ep, gp, op, cp) = res["cuda"], res["cpu"]
    assert abs(ec - ep) <= 1e-4 and (gc - gp).abs().max().item() <= 1e-4
    assert torch.equal(oc, op) and (cc - cp).abs().max().item() <= 1e-4


# ----------------------------------------------------------------------
# phase 21: the sharded statevector, term sharding, slices, the group
# ----------------------------------------------------------------------


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_vqe_step_on_card_launches_k1_k3_a_shard(cuda, shards):
    """The n=12 two-layer TFIM energy on a mesh of one card's shards: K1
    forward and K3 backward once a shard a layer (8 local qubits), energy
    and gradient against the same mesh on the CPU (plain versions)."""
    from tensorcircuit_ng_tpu_torch.parallel import Mesh

    n = 12
    x = np.random.default_rng(5).normal(size=(2, 2, n)) * 0.3

    def step(dev):
        p = torch.tensor(x, dtype=torch.float32, device=dev, requires_grad=True)
        c = tct.Circuit(n, mesh=Mesh([dev] * shards, ("sv",)))
        c.h_layer()
        for layer in range(2):
            c.zzrx_layer(_ring(n), p[layer, 0], p[layer, 1])
        e = c.expectation_zzx_energy(_ring(n), 1.0, 0.7)
        return e.item(), torch.autograd.grad(e, p)[0].cpu()

    krl.zzrx_fwd.launches = krl.zzrx_bwd.launches = 0
    e, g = step(cuda)
    torch.cuda.synchronize()
    assert (krl.zzrx_fwd.launches, krl.zzrx_bwd.launches) == (2 * shards, 2 * shards)
    e_cpu, g_cpu = step(torch.device("cpu"))
    assert abs(e - e_cpu) < 2e-5 * n
    torch.testing.assert_close(g, g_cpu, atol=1e-4, rtol=0)


def test_sharded_mixed_forward_and_shots_on_card_match_cpu(cuda):
    """``chip_smoke.par_mixed_circuit`` at n=12 on 4 shards of the card
    against the same mesh on the CPU: the gathered state, and 2,048 shots
    by ``sample_direct`` within 1e-6 of their float64 cdf interval."""
    from chip_smoke import bracket_miss
    from tensorcircuit_ng_tpu_torch.parallel import Mesh

    n = 12
    u = np.random.default_rng(3).uniform(size=2048)
    psi = {}
    for dev in (cuda, torch.device("cpu")):
        c = par_mixed_circuit(tct, n, 0.83, mesh=Mesh([dev] * 4, ("sv",)))
        psi[dev.type] = c.state().gather().cpu()
        if dev.type == "cuda":
            idx = c.sample(batch=len(u), status=torch.tensor(u, dtype=torch.float32, device=dev),
                           format="sample_int")
    torch.testing.assert_close(psi["cuda"], psi["cpu"], atol=ATOL, rtol=0)
    p = (psi["cpu"].abs() ** 2).numpy()
    assert bracket_miss(idx.cpu().numpy(), u, p) <= 1e-6


def test_export_of_a_kernel_path_on_card_raises(cuda, tmp_path):
    """``jax_jitted_function_save`` of a function that launches K1 (a CUDA
    input) raises, naming the ctypes launch; the same function on CPU
    inputs exports its plain version."""
    from tensorcircuit_ng_tpu_torch import experimental

    n = 10

    def energy(zz, rx):
        c = tct.Circuit(n, device=zz.device)
        c.h_layer()
        c.zzrx_layer(_ring(n), zz, rx)
        return c.expectation_zzx_energy(_ring(n), 1.0, 0.7)

    zz, rx = torch.full((n,), 0.1, device=cuda), torch.full((n,), 0.2, device=cuda)
    with pytest.raises(Exception, match="ctypes"):
        experimental.jax_jitted_function_save(str(tmp_path / "k.pt2"), energy, zz, rx)
    experimental.jax_jitted_function_save(str(tmp_path / "c.pt2"), energy, zz.cpu(), rx.cpu())
    f = experimental.jax_jitted_function_load(str(tmp_path / "c.pt2"))
    assert abs(f(zz.cpu(), rx.cpu()).item() - energy(zz, rx).item()) < 2e-5 * n


def test_parallel_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 21 at a small size (NCCL for the one-rank
    group)."""
    counters = (krl.zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd)
    _parallel_checks(tct, cuda, counters, **PAR_SMALL)


# ----------------------------------------------------------------------
# phase 21 (f) and phase 22: F19 on the card's shards, the circuits' I/O
# ----------------------------------------------------------------------


@pytest.mark.parametrize("label", list(PAR_CHANNELS))
def test_f19_channels_on_card_shards_match_dense(cuda, label):
    """Each channel of phase 21 (f) at n=10 on 4 shards of the card: the
    branch of the dense card circuit and its state within 1e-5."""
    from tensorcircuit_ng_tpu_torch.parallel import Mesh

    n = 10
    with torch.no_grad():
        cd = par_probe_circuit(tct, n, device=cuda)
        bd = int(PAR_CHANNELS[label](cd))
        cs = par_probe_circuit(tct, n, mesh=Mesh([cuda] * 4, ("sv",)))
        bs = int(PAR_CHANNELS[label](cs))
        psi = cs.state()
        assert type(psi).__name__ == "ShardedState" and bs == bd
        torch.testing.assert_close(psi.gather(), cd.state(), atol=1e-5, rtol=0)


def test_json_and_qasm_round_trip_of_a_cuda_circuit(cuda):
    """A CUDA circuit with fused layers and a ``unitary`` through JSON and
    OpenQASM: the circuits built on the card, JSON's gate tensors there,
    the JSON circuit's state within 2e-6 of the original's, the OpenQASM
    circuit's up to a global phase (the ``unitary`` is written as a ``u``
    gate, which drops its phase) within 2e-6 in |<a|b>|."""
    n = 10
    rng = np.random.default_rng(4)
    c = tct.Circuit(n, device=cuda)
    c.h_layer()
    c.zzrx_layer(_ring(n), torch.tensor(rng.normal(size=n), dtype=torch.float32, device=cuda),
                 torch.tensor(rng.normal(size=n), dtype=torch.float32, device=cuda))
    c.unitary(3, unitary=np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0])
    c.cnot(0, n - 1)
    cj = tct.Circuit.from_json(c.to_json(), device=cuda)
    cq = tct.Circuit.from_openqasm(c.to_openqasm(), device=cuda)
    tensors = [it["gate"].tensor for it in cj.to_qir() if it.get("gatef") is None]
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    assert cj.device.type == cq.device.type == "cuda"
    torch.testing.assert_close(cj.state(), c.state(), atol=ATOL, rtol=0)
    assert abs(abs(torch.vdot(cq.state(), c.state()).item()) - 1) < ATOL


def test_io_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 22 at a small size."""
    counters = (krl.zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd)
    _io_checks(tct, cuda, counters, **IO_SMALL)


def test_quantum_net_on_card_matches_cpu(cuda):
    """``torchnn.QuantumNet`` on the TFIM path at n=20, L=4 (K2/K4) and n=12,
    eager and under ``use_jit=True`` (a captured CUDA graph after the first
    step), 3 SGD steps each against the same module on the CPU: energies
    within 1e-4, parameters within 1e-6."""
    from tensorcircuit_ng_tpu_torch import torchnn

    for n, nl in ((20, 4), (12, 2)):
        pairs = [(i, i + 1) for i in range(n - 1)]
        g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1
        runs = {}
        for dev, jit in ((cuda, False), (cuda, True), ("cpu", False)):
            def energy(p, dev=dev):
                return tfim_circuit(tct, p, n, nl, device=dev).expectation_zzx_energy(pairs, 1.0, -1.0)

            with tct.set_device(dev):
                net = torchnn.QuantumNet(energy, (nl, 2, n), initializer=lambda shape: g0, use_jit=jit)
            opt = torch.optim.SGD(net.parameters(), lr=0.01)
            out = []
            for _ in range(3):
                opt.zero_grad()
                e = net()
                e.backward()
                opt.step()
                out.append((e.item(), net.ws[0].detach().cpu().clone()))
            runs[(str(dev), jit)] = out
        for key in ((str(cuda), False), (str(cuda), True)):
            for (e, p), (ec, pc) in zip(runs[key], runs[("cpu", False)]):
                assert abs(e - ec) < 1e-4
                torch.testing.assert_close(p, pc, atol=1e-6, rtol=0)


def test_zx_sample_fn_on_card_matches_cpu(cuda):
    """``zx``'s compiled sampler of the d=3 surface code (17 qubits, one
    round) on the card against the CPU path on the same f-bits and
    uniforms: a record differs only where its uniform lies within 1e-6 of
    its threshold; the prefix probabilities within 1e-5."""
    from tensorcircuit_ng_tpu_torch import zx
    from tensorcircuit_ng_tpu_torch.zx import scalar_graph

    sc = surface_code_program(tct, 3, 1, 0.01, tableau=True, cls=zx.StabilizerTCircuit, seed=3, device=cuda)
    program, sampler, prepared = sc._compile()
    f = sampler.sample_jax(64)[0]
    u = torch.rand((64, len(prepared.visible_pos)), generator=torch.Generator(device=cuda).manual_seed(1),
                   device=cuda)
    bits, margin = program.components[0].sample_fn(f, u, with_margin=True)
    assert bits.device.type == "cuda"
    cpu = scalar_graph.compile_program(prepared, device="cpu").components[0]
    cbits, cmargin = cpu.sample_fn(f.cpu(), u.cpu(), with_margin=True)
    differ = (bits.cpu() != cbits).any(dim=1)
    assert torch.all(torch.minimum(margin.cpu(), cmargin)[differ] < 1e-6)
    i = prepared.num_records
    params = torch.cat([f[:16].float(), bits[:16, :i], torch.ones((16, 1), device=cuda)], dim=1)
    torch.testing.assert_close(program.components[0].compiled_scalar_graphs[i].eval(params).cpu(),
                               cpu.compiled_scalar_graphs[i].eval(params.cpu()), atol=1e-5, rtol=0)


def test_dlpack_into_torch_makes_no_copy_on_card(cuda):
    """``general_args_to_backend`` of CUDA tensors into torch through DLPack
    keeps their memory; a dtype cast and a numpy array copy."""
    from tensorcircuit_ng_tpu_torch.interfaces import tensortrans

    t = torch.randn(3, 1024, device=cuda)
    with tct.set_device(cuda):
        out = tensortrans.general_args_to_backend({"a": t, "b": [t[1]]})
        assert out["a"].data_ptr() == t.data_ptr() and out["b"][0].data_ptr() == t[1].data_ptr()
        cast = tensortrans.general_args_to_backend(t, dtype="float64")
        assert cast.dtype == torch.float64 and cast.device.type == "cuda"
        arr = tensortrans.general_args_to_backend(np.ones(4, np.float32))
        assert arr.device.type == "cuda"
    assert tensortrans.tensor_to_backend_jittable(t) is t


def test_mlzx_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 23 at a small size."""
    counters = (krl.zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd)
    _mlzx_checks(tct, cuda, counters, **MLZX_SMALL)


def test_vqnhe_step_on_card_matches_cpu(cuda):
    """VQNHE on the n=10 periodic TFIM (complex model, hea): the energy and
    both gradients on the card against the CPU path, then 3 joint Adam
    steps (the card's through ``backend.jit``) energy for energy."""
    from tensorcircuit_ng_tpu_torch.applications import vqes

    out = {}
    for dev in ("cpu", cuda):
        v = vqes.VQNHE(10, tfim_rows(10), model_type="complex", ansatz="hea", nlayers=2, units=16, device=dev)
        assert v.h.device.type == torch.device(dev).type
        e, (gc, gm) = tct.backend.value_and_grad(v.energy, argnums=(0, 1))(v.circuit_params, v.model_params)
        hist = []
        v.training(maxiter=3, history=hist)
        out[str(dev)] = (e.item(), gc.cpu(), {k: x.cpu() for k, x in gm.items()}, hist)
    (e0, gc0, gm0, h0), (e1, gc1, gm1, h1) = out["cpu"], out[str(cuda)]
    assert abs(e0 - e1) < 1e-4
    assert (gc0 - gc1).abs().max().item() < 1e-4
    for k in gm0:
        assert (gm0[k] - gm1[k]).abs().max().item() < 1e-4, k
    assert max(abs(a - b) for a, b in zip(h0, h1)) < 1e-4


def test_pixelcnn_on_card_without_tf32_matches_cpu(cuda):
    """PixelCNN (8x8, depth 3, 16 filters) from one generator on both
    devices, with cuDNN's TF32 switched on around it (PyTorch's default):
    its convolutions still compute in float32 (TF32 errs by ~1e-3), so the
    card's log-probs stay within 1e-5 of their size of the CPU path's and
    their parameter gradients within 1e-4 of the largest, and the global
    setting is left as it was; a sample's shape and values."""
    from tensorcircuit_ng_tpu_torch.applications import van

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.as_tensor(np.random.default_rng(3).integers(0, 2, size=(64, 8, 8)))
        out = {}
        for dev in ("cpu", cuda):
            pc = van.PixelCNN(2, 3, 16, device=dev, generator=torch.Generator().manual_seed(9))
            lp = pc.log_prob(x.to(dev))
            grads = torch.autograd.grad(lp.sum(), list(pc.parameters()))
            out[str(dev)] = (lp.detach().cpu(), [g.cpu() for g in grads])
            assert torch.backends.cudnn.allow_tf32
        (a, ga), (b, gb) = out[str(cuda)], out["cpu"]
        assert ((a - b).abs() / b.abs().clamp(min=1.0)).max().item() < 1e-5
        for g1, g2 in zip(ga, gb):
            assert (g1 - g2).abs().max().item() < 1e-4 * max(1.0, g2.abs().max().item())
        with torch.no_grad():
            s = pc.sample(torch.Generator(device=cuda).manual_seed(1), 16, 8, 8)
        assert s.shape == (16, 8, 8) and s.device.type == "cuda" and set(s.unique().tolist()) <= {0, 1}
    finally:
        torch.backends.cudnn.allow_tf32 = was


def test_apps_phase_checks_on_card(cuda):
    """``chip_smoke.py``'s phase 24 at a small size."""
    counters = (krl.zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        times = _apps_checks(tct, cuda, counters, **APPS_SMALL)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert {label[:3] for label in times} == {"(a)", "(b)", "(c)", "(d)", "(e)"}
