"""The arithmetic around K3/K4's adjoint stages that runs without a card.

``kernels_rowlayer.zzrx_bwd_plan`` computes the stage plan of
``csrc/zzrx_bwd.cu`` (grids, dM's row chunks, the row passes and their
shared bytes) in Python; ``tests/test_torch_cuda.py`` holds it against the
card's own report.  Here it is held against values worked out by hand from
the constants of ``csrc/adjoint_stages.cuh``, at n = 12, 20 and 22.  And
``chip_smoke._k34_stage_work`` (each stage's bound) must add up to the
whole kernels' work (``_k3_work``, ``_k4_work``).
"""

import pytest

from chip_smoke import _k34_stage_work, _k3_work, _k4_work
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl


def _row_smem(tb, nb, npairs, last):
    """A row pass's shared bytes: the exchange tile (4 planes) past 3
    walked bits, a warp's sums (6 dθ slots and the pairs), cos/sin of 6
    bits, 8 slot offsets, and the last pass's 16-byte pair records."""
    floats = (4 << tb if nb > 3 else 0) + (1 << (tb - 3)) // 32 * (6 + npairs) + 12 + 8
    return 4 * floats + (16 * npairs if last else 0)


def test_row_smem_by_hand():
    # n=20: 2^11 elements, 8 warps, 19 pairs
    assert _row_smem(11, 4, 19, False) == 4 * (8192 + 8 * 25 + 20) == 33648
    assert _row_smem(11, 6, 19, True) == 33648 + 16 * 19 == 33952
    assert _row_smem(11, 3, 19, True) == 4 * (8 * 25 + 20) + 304 == 1184


# (n, nkernel, rmx): the plan's numbers worked out by hand
PLANS = {
    # r = 32: one dM chunk of 32 rows, a tile of 2^11 of the 2^12
    # amplitudes (2 CTAs), one pass of 5 walked bits, no outer stage (D = 1)
    (12, 5, 0): {
        "lane": (2, 110592), "dm": (4, 1, 32), "row_hi": (0, 0, _row_smem(11, 5, 11, False)),
        "row_lo": (2, 5, _row_smem(11, 5, 11, True)), "outer": (0, 1, 0),
    },
    # r = 8192: 64 dM chunks of 128 rows (256 CTAs), 512 tiles, passes of
    # 4 then 6 walked bits, the outer stage on D = 8 (512 CTAs of 256)
    (20, 10, 0): {
        "lane": (256, 110592), "dm": (256, 64, 128), "row_hi": (512, 4, 33648),
        "row_lo": (512, 6, 33952), "outer": (512, 8, 3),
    },
    # the row kron: 3 walked bits, one pass in registers only; no outer
    (20, 10, 7): {
        "lane": (256, 110592), "dm": (256, 64, 128), "row_hi": (0, 0, _row_smem(11, 3, 19, False)),
        "row_lo": (512, 3, 1184), "outer": (0, 8, 0),
    },
    # r = 32768: chunks of 512 rows, 2048 tiles; D = 32 is past K4's outer
    # stage (K3 carries n = 22)
    (22, 10, 0): {
        "lane": (1024, 110592), "dm": (256, 64, 512), "row_hi": (2048, 4, _row_smem(11, 4, 21, False)),
        "row_lo": (2048, 6, _row_smem(11, 6, 21, True)), "outer": (0, 32, 0),
    },
}


@pytest.mark.parametrize("n,nkernel,rmx", list(PLANS))
def test_zzrx_bwd_plan_by_hand(n, nkernel, rmx):
    """``zzrx_bwd_plan``'s grids, chunks, passes and shared bytes against
    the hand-worked values above."""
    plan = krl.zzrx_bwd_plan(2 ** (n - 7), nkernel, n - 1, rmx)
    want = PLANS[(n, nkernel, rmx)]
    lane, dm, hi, lo, outer = (plan[k] for k in ("lane", "dm", "row_hi", "row_lo", "outer"))
    assert (lane["ctas"], lane["smem"], lane["rows"], lane["cols"]) == want["lane"] + (64, 64)
    assert (dm["ctas"], dm["chunks"], dm["chunk_rows"], dm["smem"]) == want["dm"] + (65536,)
    assert (hi["ctas"], hi["bits"], hi["smem"]) == want["row_hi"]
    assert (lo["ctas"], lo["bits"], lo["smem"]) == want["row_lo"]
    assert (outer["ctas"], outer["d"], outer["nouter"], outer["smem"]) == want["outer"] + (0,)
    assert lo["tile"] == hi["tile"] == 2048 and lo["threads"] == 256
    assert all(p["threads"] == 256 for p in (lane, dm, outer))
    # the walked bits split over the passes, and the tiles cover the state
    assert hi["bits"] + lo["bits"] == nkernel - rmx
    assert lo["ctas"] * lo["tile"] == 2**n


@pytest.mark.parametrize("n,nkernel,rmx", [(9, 2, 0), (8, 1, 1), (20, 10, 11)])
def test_zzrx_bwd_plan_small_and_bad_shapes(n, nkernel, rmx):
    """A state below one tile (2^9, 2^8 amplitudes: one CTA of 2^n / 8
    threads) and the row kron taking every row bit (no walked bit) plan;
    more kron bits than kernel bits do not."""
    r = 2 ** (n - 7)
    if rmx > nkernel:
        with pytest.raises(ValueError, match="unsupported shape"):
            krl.zzrx_bwd_plan(r, nkernel, n - 1, rmx)
        return
    plan = krl.zzrx_bwd_plan(r, nkernel, n - 1, rmx)
    lo = plan["row_lo"]
    assert lo["ctas"] == 1 and lo["tile"] == 2**n and lo["threads"] == 2**n // 8
    assert lo["bits"] == nkernel - rmx and plan["row_hi"]["ctas"] == 0
    assert plan["dm"]["chunks"] == 1 and plan["dm"]["chunk_rows"] == r


@pytest.mark.parametrize("n", [20, 22])
def test_k3_stage_work_adds_up(n):
    """``_k34_stage_work``'s flops add up to K3's with the lane matrix; its
    bytes once the planes the stages hand each other are taken out: psi
    and w written and read by the row stage, psi and ct read again by dM
    (48 B an amplitude)."""
    r, npairs, nkernel = 2 ** (n - 7), n - 1, 10
    stages = _k34_stage_work(r, npairs, nkernel, 0)
    assert set(stages) == {"lane pair", "dM", "row"}
    nbytes, flops = _k3_work(r, npairs, nkernel, True)
    assert sum(f for _, f in stages.values()) == flops
    assert sum(b for b, _ in stages.values()) == nbytes + 48 * r * 128


@pytest.mark.parametrize("L", [3, 4])
def test_k4_stage_work_adds_up(L):
    """A layer's stages, L times, against K4 at n=20 (D = 8): the flops
    exactly; the bytes once a layer's handoffs are taken out (ct read and w
    written by the outer stage, w read again by the lane pair and dM, the
    residual again by the lane pair, psi and w out of it and into the row
    stage, psi again by dM, ds written: 88 B an amplitude), less the seed
    read and ds written, which K4 counts once (16 B)."""
    r, npairs, nkernel, nouter = 2**13, 19, 10, 3
    amps = r * 128
    stages = _k34_stage_work(r, npairs, nkernel, nouter)
    assert set(stages) == {"outer", "lane pair", "dM", "row"}
    nbytes, flops = _k4_work(r, npairs, nkernel, nouter, L)
    assert L * sum(f for _, f in stages.values()) == flops
    assert L * sum(b for b, _ in stages.values()) == nbytes + (88 * L - 16) * amps
