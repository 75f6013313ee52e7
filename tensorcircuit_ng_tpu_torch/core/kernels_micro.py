"""The staged micro-benchmark of the grand forward kernel's design: K15.

Counterpart of ``examples/micro_grand_fusion.py`` ``run_micro``, whose
Pallas kernel (``_micro_kernel``) measures the skeleton of K2 in three
levels at n=20, L=4: 13 row qubits, blocks of ``RB`` = 1024 rows (10 row
qubits) and D = 8 blocks.  Layer by layer over a ping-pong pair of planes:

- level 1 (m1): the state copied to the other buffer;
- level 2 (m2): the 10 butterflies ``[[c, -i s], [-i s, c]]`` with raw
  ``(c, s) = cs[l, q]`` (random, not cos/sin) on the in-block row bit of
  stride ``RB >> (q + 1)``, then the 128x128 lane product ``x @ M[l]``;
- level 3 (m3): m2, then the (D, D) left-matmul by ``mo[l]`` across the
  D blocks at the end of each layer.

``micro_grand`` launches kernel K15 (``csrc/micro_grand.cu``,
``tcng_micro_grand``) on CUDA tensors and runs :func:`micro_grand_plain`
on CPU tensors; ``run_micro`` times it on the card as the example times
its kernel.  On the card levels 2 and 3 run the stages of K6 with the lane
and K2 (``csrc/adjoint_stages.cuh``): the gates built once a call as K6's
(:func:`micro_gate_planes` is the plain mirror), K6's two row passes, the
forward product on M^T and K2's outer pass; ``micro_grand_plan`` /
``micro_grand_card_plan`` give their plan.  The inputs are random and not
unitary, as in the example.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import kernels_rowlayer as krl

__all__ = [
    "micro_grand",
    "micro_grand_plain",
    "micro_gate_planes",
    "micro_grand_plan",
    "micro_grand_card_plan",
    "micro_inputs",
    "run_micro",
    "RB",
]

#: rows of a block (10 row qubits), and the example's shapes
RB = 1024
N, L, K = 20, 4, 250
_LANES = 128
_NBF = 10
#: the most blocks K15 takes (``MAX_D`` in ``csrc/micro_grand.cu``)
MAX_BLOCKS = 16
#: K15's stages in launch order, each with its two own plan keys
_MICRO_OWN = {"gates": ("layers", "gates"), "transpose": ("layers", "planes"), "row_lo": ("tile", "bits"),
              "row_hi": ("tile", "bits"), "lane": ("rows", "cols"), "outer": ("d", "nouter"),
              "copy": ("vectors", "planes")}


def micro_grand_plain(level, cs, mlr, mli, mor, moi, sr, si):
    """K15's plain version: the ``level`` of the micro-benchmark in torch
    ops on the (r, 128) planes; ``cs`` (L, 10, 2), ``mlr/mli`` (L, 128,
    128), ``mor/moi`` (L, D, D) with D = r / RB.  Returns the output planes."""
    r = sr.shape[0]
    d = r // RB
    x = torch.complex(sr, si)
    for l in range(cs.shape[0]):
        if level >= 2:
            v = torch.reshape(x, (d, RB, _LANES))
            for q in range(_NBF):
                s = RB >> (q + 1)
                c, sn = cs[l, q, 0], cs[l, q, 1]
                w = torch.reshape(v, (d, RB // (2 * s), 2, s, _LANES))
                lo, hi = w[:, :, 0], w[:, :, 1]
                v = torch.stack([c * lo - 1j * sn * hi, c * hi - 1j * sn * lo], dim=2)
            x = torch.reshape(v, (r, _LANES)) @ torch.complex(mlr[l], mli[l])
        if level >= 3:
            x = torch.reshape(torch.complex(mor[l], moi[l]) @ torch.reshape(x, (d, -1)), (r, _LANES))
    return x.real.contiguous(), x.imag.contiguous()


def micro_gate_planes(cs):
    """The gates of K6's kind that K15 builds from ``cs`` (L, 10, 2) once a
    call: ``g[l, q] = [[c, -i s], [-i s, c]]`` as (L, 10, 4) planes ``gr =
    (c, 0, 0, c)``, ``gi = (0, -s, -s, 0)``, entries (g00, g01, g10, g11)."""
    c, s = cs[..., 0], cs[..., 1]
    zero = torch.zeros_like(c)
    return torch.stack([c, zero, zero, c], -1), torch.stack([zero, -s, -s, zero], -1)


def _check_shape(what: str, level: int, r: int, lanes: int, nl: int) -> int:
    """The blocks D of a K15 call, or ``ValueError``: L >= 1 layers of (r,
    128) planes, r = D * RB with D in 1..16; at levels 2 and 3 r a power of
    two (the row stage's plan), at level 3 D in {2, 4, 8, 16}."""
    d = r // RB
    if level not in (1, 2, 3) or lanes != _LANES or nl < 1 or r % RB or not 1 <= d <= MAX_BLOCKS:
        raise ValueError(f"{what}: unsupported level {level} or shape r={r}, lanes={lanes}, L={nl}")
    if level >= 2 and r & (r - 1):
        raise ValueError(f"{what}: levels 2 and 3 take r a power of two, not {r}")
    if level == 3 and d == 1:
        raise ValueError(f"{what}: the outer stage takes 2, 4, 8 or 16 blocks, not {d}")
    return d


def micro_grand_plan(level: int, r: int, L: int) -> dict:
    """K15's stage plan at ``level`` with r rows of 128 lanes and L layers,
    computed as ``csrc/micro_grand.cu`` makes it (no card needed), in launch
    order: at levels 2 and 3 the gate build ``"gates"`` (L, 10 gates a
    layer), the transpose of the L lane matrices ``"transpose"`` (CTAs a
    launch, two launches a call), K6's row passes ``"row_lo"`` (the low 6
    row bits, first) and ``"row_hi"`` (the high 4) and the product
    ``"lane"`` (:func:`kernels_rowlayer.row_fwd_plan`'s at nkernel = 10),
    at level 3 K2's outer pass ``"outer"`` (a thread an in-block position,
    RB · 128 of them), at level 1 the copy pass ``"copy"`` (a float4 of
    each plane a thread).  Each ``ctas``, ``threads`` and ``smem`` (dynamic
    shared bytes) and two of its own; a stage the level does not run has
    zeros."""
    d = _check_shape("micro_grand_plan", level, r, _LANES, L)
    plan = {k: dict.fromkeys(("ctas", "threads", "smem") + own, 0) for k, own in _MICRO_OWN.items()}
    if level == 1:
        vectors = r * _LANES // 4
        plan["copy"] = {"ctas": -(-vectors // krl._THREADS), "threads": krl._THREADS, "smem": 0,
                        "vectors": vectors, "planes": 2}
        return plan
    k6 = krl.row_fwd_plan(r, _NBF, lane=True)
    plan["gates"] = {"ctas": -(-L * _NBF // krl._THREADS), "threads": krl._THREADS, "smem": 0, "layers": L,
                     "gates": _NBF}
    plan["transpose"] = {"ctas": 16 * L, "threads": 256, "smem": 0, "layers": L, "planes": 2}
    plan.update(row_lo=k6["row_lo"], row_hi=k6["row_hi"], lane=k6["lane"])
    if level == 3:
        positions = RB * _LANES
        plan["outer"] = {"ctas": -(-positions // krl._THREADS), "threads": krl._THREADS, "smem": 0, "d": d,
                         "nouter": d.bit_length() - 1}
    return plan


def micro_grand_card_plan(level: int, r: int, L: int) -> dict:
    """The same plan as the card's C code reports it
    (``tcng_micro_grand_plan``), with each stage kernel's ``ctas_per_sm``,
    ``registers`` and ``local_bytes`` a thread besides (zeros for a stage
    the level does not run).  Needs the card."""
    return krl._card_records("micro_grand", "tcng_micro_grand_plan", _MICRO_OWN, level, r, L)


def _launch(level, cs, mlr, mli, mor, moi, sr, si):
    _build.refuse_trace("micro_grand")
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"micro_grand: no kernel for device {dev}")
    r = sr.shape[0]
    nl = cs.shape[0]
    d = r // RB
    shapes = {
        "cs": (cs, (nl, _NBF, 2)), "mlr": (mlr, (nl, _LANES, _LANES)), "mli": (mli, (nl, _LANES, _LANES)),
        "mor": (mor, (nl, d, d)), "moi": (moi, (nl, d, d)), "sr": (sr, (r, _LANES)), "si": (si, (r, _LANES)),
    }
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"micro_grand: {name} must be contiguous float32 {shape} on {dev}")
    # the copy and the product move 16-byte vectors
    sr, si = krl._aligned16(sr), krl._aligned16(si)
    lib = _build.library("micro_grand")
    floats = lib.tcng_micro_grand_scratch(level, r, nl)
    if floats < 0:
        raise ValueError(f"micro_grand: unsupported level {level} or shape {tuple(sr.shape)}")
    scratch = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
    yr, yi = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)
    ar, ai = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)  # the ping-pong pair
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        micro_grand.launches += 1
        err = lib.tcng_micro_grand(
            level, cs.data_ptr(), mlr.data_ptr(), mli.data_ptr(), mor.data_ptr(), moi.data_ptr(),
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nl, r, stream,
        )
    _build.check("micro_grand", err, "micro_grand")
    return yr, yi


def micro_grand(level, cs, mlr, mli, mor, moi, sr, si):
    """K15: the ``level`` (1, 2 or 3) of the micro-benchmark over L =
    ``cs.shape[0]`` layers of (r, 128) planes (``ValueError`` for a shape
    K15 does not take: r = D · 1024 with D in 1..16, at levels 2 and 3 a
    power of two, at level 3 D >= 2).  CUDA tensors launch the kernel
    (``micro_grand.launches`` counts the launches); CPU tensors run
    :func:`micro_grand_plain`."""
    _check_shape("micro_grand", level, sr.shape[0], sr.shape[-1], cs.shape[0])
    if sr.device.type == "cpu":
        return micro_grand_plain(level, cs, mlr, mli, mor, moi, sr, si)
    return _launch(level, cs, mlr, mli, mor, moi, sr, si)


micro_grand.launches = 0


def micro_inputs(device, seed=0, n=N, nl=L):
    """The example's random inputs, float32 on ``device``: ``cs`` (L, 10, 2)
    standard normal, lane planes (L, 128, 128) * 0.05, outer planes (L, D,
    D) * 0.2, then the state planes (r, 128) * 1e-3."""
    rng = np.random.default_rng(seed)
    r = 2 ** (n - 7)
    d = r // RB

    def draw(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=device)

    cs = draw(nl, _NBF, 2)
    mlr, mli = draw(nl, _LANES, _LANES, scale=0.05), draw(nl, _LANES, _LANES, scale=0.05)
    mor, moi = draw(nl, d, d, scale=0.2), draw(nl, d, d, scale=0.2)
    sr, si = draw(r, _LANES, scale=1e-3), draw(r, _LANES, scale=1e-3)
    return cs, mlr, mli, mor, moi, sr, si


def run_micro(level, device="cuda", calls=K, rounds=3):
    """ms a call of K15 at ``level`` on the example's shapes, by CUDA events
    over ``calls`` back-to-back calls, each taking the previous call's
    output as the example's scan does; the best of ``rounds``, after one
    warm-up call."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("run_micro times the kernel on the card")
    cs, mlr, mli, mor, moi, sr, si = micro_inputs(dev)
    micro_grand(level, cs, mlr, mli, mor, moi, sr, si)
    best = float("inf")
    for _ in range(rounds):
        a, b = sr, si
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            a, b = micro_grand(level, cs, mlr, mli, mor, moi, a, b)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / calls)
    return best
