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
within 1e-5 of its output's largest entry.
"""

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu_torch as tct
from chip_smoke import (
    SVD_ORTH_TOL, SVD_REC_TOL, SVD_S_TOL, SVD_VEC_TOL, _ptxas_report, _svd_batches, _svd_checks,
    hea_energy, qaoa_energy, qaoa_graph,
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


@pytest.mark.parametrize("n,level", [(18, 1), (18, 3), (20, 1), (20, 2), (20, 3)])
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
