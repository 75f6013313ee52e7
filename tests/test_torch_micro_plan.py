"""K15's stage plan and shape rule, which run without a card.

``kernels_micro.micro_grand_plan`` computes the plan of
``csrc/micro_grand.cu`` in Python: at m2 and m3 the gate build, the
transpose of the L lane matrices, K6's two row passes and the product
(``csrc/adjoint_stages.cuh``), at m3 K2's outer pass, at m1 the copy pass;
``tests/test_torch_cuda.py`` holds it against the card's own report.  Here
it is held against values worked out by hand from the constants of
``csrc/adjoint_stages.cuh`` (tiles of 2^11 elements, 256 threads, 6
walked bits a pass, 64 x 64 product tiles) at n = 18..21, L = 4.  The
shape rule (r = D * 1024 with D in 1..16; at m2 and m3 a power of two; at
m3 D >= 2) holds for the plan and for ``micro_grand`` on CPU tensors.
And ``chip_smoke._micro_stage_work`` (each stage's bound) adds up to
``_micro_work``, and ``chip_smoke._micro_call_stages`` reads each stage of
the complete calls of a profiler trace in launch order, leaving out the
calls the profiler recorded only in part.
"""

import pytest
import torch

from chip_smoke import _micro_call_stages, _micro_stage_work, _micro_work
from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

#: n -> (row pass CTAs, product CTAs, D, copy CTAs): 2^(n - 11) tiles of
#: 2^11 elements, (r / 64) x 2 product tiles, r / 1024 blocks, a float4 of
#: each plane a thread over r x 128 / 4 vectors
HAND = {18: (128, 64, 2, 256), 19: (256, 128, 4, 512), 20: (512, 256, 8, 1024), 21: (1024, 512, 16, 2048)}
#: a pass's shared bytes: the exchange tile of two planes (2 x 2^11
#: floats), 8 gate floats for 6 bits and 8 slot offsets
ROW_SMEM = 4 * (2 * 2048 + 8 * 6 + 8)


def _zeros(*own):
    return dict.fromkeys(("ctas", "threads", "smem") + own, 0)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("n", sorted(HAND))
def test_micro_grand_plan_hand_values(n, level):
    r, L = 2 ** (n - 7), 4
    rows, prod, d, copy = HAND[n]
    want = {
        "gates": {"ctas": 1, "threads": 256, "smem": 0, "layers": L, "gates": 10},
        "transpose": {"ctas": 16 * L, "threads": 256, "smem": 0, "layers": L, "planes": 2},
        "row_lo": {"ctas": rows, "threads": 256, "smem": ROW_SMEM, "tile": 2048, "bits": 6},
        "row_hi": {"ctas": rows, "threads": 256, "smem": ROW_SMEM, "tile": 2048, "bits": 4},
        "lane": {"ctas": prod, "threads": 256, "smem": 73728, "rows": 64, "cols": 64},
        "outer": {"ctas": 512, "threads": 256, "smem": 0, "d": d, "nouter": d.bit_length() - 1},
        "copy": {"ctas": copy, "threads": 256, "smem": 0, "vectors": r * 32, "planes": 2},
    }
    runs = {1: {"copy"}, 2: {"gates", "transpose", "row_lo", "row_hi", "lane"}}
    runs[3] = runs[2] | {"outer"}
    for stage, rec in want.items():
        if stage not in runs[level]:
            want[stage] = _zeros(*list(rec)[3:])
    got = km.micro_grand_plan(level, r, L)
    assert list(got) == ["gates", "transpose", "row_lo", "row_hi", "lane", "outer", "copy"]
    assert got == want


@pytest.mark.parametrize("L,ctas", [(1, 1), (25, 1), (26, 2)])
def test_micro_grand_plan_gate_ctas(L, ctas):
    """The gate build: a thread a gate, 10 gates a layer, 256 a CTA."""
    plan = km.micro_grand_plan(2, 8192, L)
    assert plan["gates"]["ctas"] == ctas and plan["transpose"]["ctas"] == 16 * L


@pytest.mark.parametrize("level,blocks", [(2, 3), (2, 5), (2, 12), (3, 3), (3, 6), (3, 12), (3, 1), (1, 17),
                                          (2, 32), (3, 0)])
def test_micro_grand_plan_refuses(level, blocks):
    """r not a power of two at m2 and m3, one block at m3, more than 16
    blocks or none: ValueError."""
    with pytest.raises(ValueError):
        km.micro_grand_plan(level, blocks * km.RB, 4)


@pytest.mark.parametrize("r", [1000, 1536])
def test_micro_grand_plan_refuses_partial_blocks(r):
    with pytest.raises(ValueError):
        km.micro_grand_plan(1, r, 4)


@pytest.mark.parametrize("blocks", [1, 3, 5, 12, 16])
def test_micro_grand_plan_m1_any_blocks(blocks):
    """m1 copies any D = 1..16 blocks."""
    r = blocks * km.RB
    plan = km.micro_grand_plan(1, r, 4)
    assert plan["copy"]["vectors"] == r * 32 and plan["copy"]["ctas"] == r // 8


def _cpu_inputs(blocks, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, d = blocks * km.RB, blocks
    draw = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float32)  # noqa: E731
    return draw(4, 10, 2), draw(4, 128, 128), draw(4, 128, 128), draw(4, d, d), draw(4, d, d), draw(r, 128), \
        draw(r, 128)


@pytest.mark.parametrize("level", [2, 3])
def test_micro_grand_refuses_r_not_power_of_two_on_cpu(level):
    """The wrapper takes the card's shapes on the CPU too: three blocks
    (r = 3072) at m2 and m3 raise ValueError before the plain version runs."""
    with pytest.raises(ValueError, match="power of two"):
        km.micro_grand(level, *_cpu_inputs(3))


def test_micro_grand_m1_three_blocks_on_cpu():
    """m1 copies: three blocks come back unchanged."""
    args = _cpu_inputs(3)
    yr, yi = km.micro_grand(1, *args)
    assert torch.equal(yr, args[-2]) and torch.equal(yi, args[-1])


@pytest.mark.parametrize("level", [2, 3])
def test_micro_gate_planes_match_butterflies(level):
    """The gate planes K15 builds hold [[c, -i s], [-i s, c]]: K6's plain
    row stage with them, then the lane product and (m3) the outer pass, is
    K15's plain version on two blocks, within 1e-5 of its largest entry."""
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl

    cs, mlr, mli, mor, moi, sr, si = _cpu_inputs(2, seed=level)
    mlr, mli = 0.05 * mlr, 0.05 * mli
    gr, gi = km.micro_gate_planes(cs)
    assert gr.shape == gi.shape == (4, 10, 4)
    x = (sr, si)
    for l in range(4):
        x = krl._lane_apply(mlr[l], mli[l], *krl.row_fwd_plain(gr[l], gi[l], *x))
        if level == 3:
            x = krl._outer_apply(mor[l], moi[l], *x)
    want = km.micro_grand_plain(level, cs, mlr, mli, mor, moi, sr, si)
    for g, w in zip(x, want):
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item(), rtol=0)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("n", [18, 20, 21])
def test_micro_stage_work_adds_up(n, level):
    """``_micro_stage_work``'s flops a layer (the row passes, the product
    and, at m3, the outer pass) times L add up to ``_micro_work``'s; its
    bytes cover the state's planes in and out."""
    r, L = 2 ** (n - 7), 4
    d = r // km.RB
    stages = _micro_stage_work(r, L, d)
    layer = ("row lo", "row hi", "product") + (("outer",) if level == 3 else ())
    nbytes, flops = _micro_work(level, n, L)
    if level == 1:
        assert flops == 0 and stages["copy"][0] == nbytes
    else:
        assert L * sum(stages[k][1] for k in layer) == flops
        assert all(stages[k][0] >= 16 * r * 128 for k in layer)


#: demangled names of K15's kernels as the profiler reports them
_NAMES = {"gates": "void (anonymous namespace)::micro_gates_kernel(float const*, float4*, float4*, int)",
          "transpose": "void (anonymous namespace)::transpose_kernel(float const*, float*, int)",
          "row": "void (anonymous namespace)::fwd_row_pass_kernel<false, true, false>(...)",
          "product": "void (anonymous namespace)::wide_nt_kernel<1, false>(...)",
          "outer": "void (anonymous namespace)::outer_fwd_kernel<8>(...)"}


def _call(level, nl, call):
    """One call's trace: (name, µs) with µs = 100 * call + the launch's
    index, so each launch's origin can be read back."""
    kinds = ["gates", "transpose", "transpose"] + (["row", "row", "product"]
                                                   + (["outer"] if level == 3 else [])) * nl
    return [(_NAMES[k], 100.0 * call + i) for i, k in enumerate(kinds)]


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("drop", [0, 1, 5, 9])
def test_micro_call_stages_reads_complete_calls(level, drop):
    """Three calls, the first with its first ``drop`` launches missing: the
    complete calls are read in launch order (the low row pass before the
    high one in each layer), the partial one left out."""
    nl = 4
    trace = _call(level, nl, 0)[drop:] + _call(level, nl, 1) + _call(level, nl, 2)
    stages, calls = _micro_call_stages(trace, level, nl)
    assert calls == (3 if drop == 0 else 2)
    first = 0 if drop == 0 else 1
    k = 4 if level == 3 else 3
    assert stages["gates"] == [100.0 * c for c in range(first, 3)]
    assert stages["transpose"] == [x for c in range(first, 3) for x in (100.0 * c + 1, 100.0 * c + 2)]
    for j, lab in enumerate(["row lo", "row hi", "product"] + (["outer"] if level == 3 else [])):
        assert stages[lab] == [100.0 * c + 3 + l * k + j for c in range(first, 3) for l in range(nl)]
    assert ("outer" in stages) == (level == 3)


def test_micro_call_stages_skips_a_call_with_a_missing_launch():
    """A call whose middle lost one launch is not read."""
    nl = 4
    middle = _call(3, nl, 1)
    trace = _call(3, nl, 0) + middle[:7] + middle[8:] + _call(3, nl, 2)
    stages, calls = _micro_call_stages(trace, 3, nl)
    assert calls == 2 and stages["gates"] == [0.0, 200.0]
