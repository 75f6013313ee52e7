"""The arithmetic around the adjoint stages that runs without a card.

``kernels_rowlayer.zzrx_bwd_plan`` computes the stage plan of
``csrc/zzrx_bwd.cu`` (K3/K4: grids, dM's row chunks, the row passes and
their shared bytes) in Python, ``kernels_rowlayer.row_bwd_plan`` K7's (the
gate row passes of ``csrc/row_layer.cu``) and
``kernels_multilayer.ml_fwd_plan`` K9's (the forward row passes and the
product of ``csrc/multilayer.cu``); ``tests/test_torch_cuda.py`` holds them
against the card's own report.  Here they are held against values worked
out by hand from the constants of ``csrc/adjoint_stages.cuh``.  And
``chip_smoke._k34_stage_work``, ``_k7_stage_work`` and ``_k9_stage_work``
(each stage's bound) must add up to the whole kernels' work (``_k3_work``,
``_k4_work``, ``_row_work``, ``_ml_work``).
"""

import pytest

from chip_smoke import (
    _k34_stage_work, _k3_work, _k4_work, _k7_stage_work, _k9_stage_work, _ml_work, _row_work,
)
from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml
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


def _gate_smem(tb, lo):
    """A K7 gate pass's shared bytes (both passes take the larger one's):
    the exchange tile (4 planes) past 3 walked bits, then the warps' dg
    sums and the gates, 48 floats each (8 sums or gate floats a bit, up to
    6 bits)."""
    return 4 * ((4 << tb if lo > 3 else 0) + ((1 << (tb - 3)) // 32 + 1) * 48)


# (n, nkernel): K7's row passes worked out by hand: (CTAs, threads, tile,
# bits of the first pass, bits of the last, shared bytes)
K7_PLANS = {
    # r = 8192 (nrb = 13): 2^20 / 2^11 = 512 tiles of 256 threads; the 11
    # walked bits in a pass of 5 (row bits 6..10) and one of 6 (0..5)
    (20, 11): (512, 256, 2048, 5, 6, 4 * (8192 + 9 * 48)),
    # one pass: nkernel = 6 at r = 128 (n = 14), 8 tiles
    (14, 6): (8, 256, 2048, 0, 6, 34496),
    # fewer than 3 register bits: nkernel = 1 and 2 at r = 32 (n = 12), no
    # exchange tile
    (12, 1): (2, 256, 2048, 0, 1, 4 * 9 * 48),
    (12, 2): (2, 256, 2048, 0, 2, 1728),
    # a state below one tile: r = 2 (n = 8), 2^8 elements, 32 threads
    (8, 1): (1, 32, 256, 0, 1, 4 * 2 * 48),
}


@pytest.mark.parametrize("n,nkernel", list(K7_PLANS))
@pytest.mark.parametrize("lane", [False, True])
def test_row_bwd_plan_by_hand(n, nkernel, lane):
    """``row_bwd_plan``'s passes against the hand-worked values; the lane
    pair and dM as K3's, with 0 CTAs without the lane."""
    r = 2 ** (n - 7)
    plan = krl.row_bwd_plan(r, nkernel, lane)
    ctas, threads, tile, hi_bits, lo_bits, smem = K7_PLANS[(n, nkernel)]
    hi, lo = plan["row_hi"], plan["row_lo"]
    assert (lo["ctas"], lo["threads"], lo["tile"], lo["bits"], lo["smem"]) == (ctas, threads, tile, lo_bits, smem)
    assert (hi["ctas"], hi["bits"], hi["smem"]) == ((ctas, hi_bits, smem) if hi_bits else (0, 0, smem))
    assert smem == _gate_smem(tile.bit_length() - 1, lo_bits)
    assert hi["bits"] + lo["bits"] == nkernel and lo["ctas"] * lo["tile"] == 2**n
    k3 = krl.zzrx_bwd_plan(r, nkernel, n - 1)
    for stage in ("lane", "dm"):
        want = dict(k3[stage], ctas=k3[stage]["ctas"] if lane else 0)
        assert plan[stage] == want


@pytest.mark.parametrize("r,nkernel", [(8192, 12), (8192, 0), (3 * 2048, 11), (16, 5), (1, 1)])
def test_row_bwd_plan_refuses_bad_shapes(r, nkernel):
    """More than 11 kernel bits or none, rows that are not a power of two,
    more kernel bits than row bits, and a single row (below 2^8 elements)."""
    with pytest.raises(ValueError, match="unsupported shape"):
        krl.row_bwd_plan(r, nkernel)


@pytest.mark.parametrize("lanes,ctas", [(128, 256), (256, 512), (1024, 2048)])
def test_ml_fwd_plan_by_hand(lanes, ctas):
    """K9 at nrow = 12: two forward passes of 6 row bits on tiles of 2^11
    (2^(12 + lw) / 2^11 CTAs of 256 threads), the zz pass with the 37
    pairs' 16-byte records: 4 (2 · 2048 + 12 + 8) + 16 · 37 = 17,056 bytes,
    the other 16,464; the product's 64 x 64 tiles (64 row tiles by lanes /
    64) with two buffered chunks of four 64 x 36 planes, 73,728 bytes."""
    plan = kml.ml_fwd_plan(4096, lanes, 12, 37)
    zz, hi, prod = plan["fwd_row_zz"], plan["fwd_row_hi"], plan["fwd_lane"]
    assert (zz["ctas"], zz["threads"], zz["tile"], zz["bits"], zz["smem"]) == (ctas, 256, 2048, 6, 17056)
    assert (hi["ctas"], hi["threads"], hi["tile"], hi["bits"], hi["smem"]) == (ctas, 256, 2048, 6, 16464)
    assert (prod["ctas"], prod["threads"], prod["smem"], prod["rows"], prod["cols"]) == (
        64 * lanes // 64, 256, 73728, 64, 64)


@pytest.mark.parametrize("nrow", [1, 3, 4, 6])
def test_ml_fwd_plan_one_pass(nrow):
    """Up to 6 row bits one zz pass (the other has 0 CTAs); from 4 bits it
    holds the exchange tile of two planes."""
    plan = kml.ml_fwd_plan(2**nrow, 128, nrow, 5)
    zz, hi = plan["fwd_row_zz"], plan["fwd_row_hi"]
    tb = min(nrow + 7, 11)
    assert (zz["ctas"], zz["bits"], hi["ctas"], hi["bits"]) == (2 ** (nrow + 7 - tb), nrow, 0, 0)
    assert zz["smem"] == 4 * ((2 << tb if nrow > 3 else 0) + 20) + 16 * 5


@pytest.mark.parametrize("r,lanes,nrow,npairs", [(4096, 2048, 12, 37), (8192, 256, 13, 37), (4096, 256, 12, 129),
                                                 (2048, 256, 12, 37), (4096, 96, 12, 37)])
def test_ml_fwd_plan_refuses_bad_shapes(r, lanes, nrow, npairs):
    with pytest.raises(ValueError, match="unsupported shape"):
        kml.ml_fwd_plan(r, lanes, nrow, npairs)


@pytest.mark.parametrize("nkernel", [6, 11])
def test_k7_stage_work_adds_up(nkernel):
    """``_k7_stage_work``'s flops add up to K7's with the lane matrix; its
    bytes once the planes the stages hand each other are taken out (psi and
    w written by the pair and read by the row stage, psi and ct read again
    by dM: 48 B an amplitude); without the lane the row stage is K7."""
    r = 8192
    stages = _k7_stage_work(r, nkernel)
    assert set(stages) == {"lane pair", "dM", "row"}
    nbytes, flops = _row_work(r, nkernel, "bwd", lane=True)
    assert sum(f for _, f in stages.values()) == flops
    assert sum(b for b, _ in stages.values()) == nbytes + 48 * r * 128
    assert stages["row"] == _row_work(r, nkernel, "bwd")


@pytest.mark.parametrize("L,lanes", [(4, 256), (2, 1024)])
def test_k9_stage_work_adds_up(L, lanes):
    """L layers of ``_k9_stage_work`` and the pair shifts read once a call
    (8 B a pair) against K9's work: the flops exactly; the bytes once the
    handoffs are taken out (a layer's row stage writes its output and the
    product reads it, and between layers the product writes y and the next
    row stage reads it: 32 B an amplitude a layer, less the state read and
    y written once, 16 B)."""
    r, npairs, nrow = 4096, 37, 12
    stages = _k9_stage_work(r, lanes, npairs, nrow)
    assert set(stages) == {"row", "product"}
    nbytes, flops = _ml_work(r, lanes, npairs, nrow, L, "fwd")
    assert L * sum(f for _, f in stages.values()) == flops
    assert L * sum(b for b, _ in stages.values()) + 8 * npairs == nbytes + (32 * L - 16) * r * lanes
