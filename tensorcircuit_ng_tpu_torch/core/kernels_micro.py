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
its kernel.  The inputs are random and not unitary, as in the example.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["micro_grand", "micro_grand_plain", "micro_inputs", "run_micro", "RB"]

#: rows of a block (10 row qubits), and the example's shapes
RB = 1024
N, L, K = 20, 4, 250
_LANES = 128
_NBF = 10


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


def _launch(level, cs, mlr, mli, mor, moi, sr, si):
    dev = sr.device
    if dev.type != "cuda":
        raise ValueError(f"micro_grand: no kernel for device {dev}")
    r, lanes = sr.shape
    nl = cs.shape[0]
    d = r // RB
    if level not in (1, 2, 3) or lanes != _LANES or r % RB or not 1 <= d <= 16:
        raise ValueError(f"micro_grand: unsupported level {level} or shape {tuple(sr.shape)}")
    if level == 3 and d not in (2, 4, 8, 16):
        raise ValueError(f"micro_grand: the outer stage takes 2, 4, 8 or 16 blocks, not {d}")
    shapes = {
        "cs": (cs, (nl, _NBF, 2)), "mlr": (mlr, (nl, _LANES, _LANES)), "mli": (mli, (nl, _LANES, _LANES)),
        "mor": (mor, (nl, d, d)), "moi": (moi, (nl, d, d)), "sr": (sr, (r, _LANES)), "si": (si, (r, _LANES)),
    }
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"micro_grand: {name} must be contiguous float32 {shape} on {dev}")
    yr, yi = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)
    ar, ai = torch.empty((2, r, _LANES), dtype=torch.float32, device=dev)  # the ping-pong pair
    lib = _build.library("micro_grand")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        micro_grand.launches += 1
        err = lib.tcng_micro_grand(
            level, cs.data_ptr(), mlr.data_ptr(), mli.data_ptr(), mor.data_ptr(), moi.data_ptr(),
            sr.data_ptr(), si.data_ptr(), yr.data_ptr(), yi.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            nl, r, stream,
        )
    _build.check("micro_grand", err, "micro_grand")
    return yr, yi


def micro_grand(level, cs, mlr, mli, mor, moi, sr, si):
    """K15: the ``level`` (1, 2 or 3) of the micro-benchmark over L =
    ``cs.shape[0]`` layers.  CUDA tensors launch the kernel
    (``micro_grand.launches`` counts the launches); CPU tensors run
    :func:`micro_grand_plain`."""
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
