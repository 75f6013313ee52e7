#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, drives the N=20 TFIM energy path
and its training step (also under ``FUSE_ROWM`` and every switch of the
stack), the n=60 TEBD path, the n=20 HEA training step and the n=20, p=4
QAOA MaxCut training step through the public API, runs the staged
micro-benchmark of K2's design, and times them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the kernels from ``tensorcircuit_ng_tpu_torch/core/csrc`` (one
     nvcc for each source, all at once, into ``build/kernels/``); print the
     build time and the card's name and power limit;
  2. kernel parity on the card at the n=20 shapes: K1 ``zzrx_fwd`` with and
     without the lane matrix (and with it at n=22, the shape the n=22 step
     gives K1), K2 ``grand_zzrx_fwd`` at L=4, K3 ``zzrx_bwd`` with and
     without the lane matrix (and with it at n=22, the shape the training
     path gives K3), K4 ``grand_zzrx_bwd`` at L=4 and L=3 (K1-K4 twice: the
     two results must be equal bit for bit),
     each against its plain version on the same CUDA inputs, with unitary
     rx-kron outer and lane matrices; K1's and K2's input planes unwritten;
     K1 alone by a replayed CUDA graph in each of its three variants, and
     one ``torch.matmul`` of its product's shapes at n=22;
  3. the forward path: ``Circuit(20)`` h_layer + 4 zzrx_layer +
     ``expectation_zzx_energy`` for 5 seeded parameter sets (and the state
     of the first), then L=3 once (K1 through the circuit), with the launch
     counts reset just before and read just after; energies against the
     port's CPU path, the state's norm against 1;
  4. the training path, the main path of the training slice: 5 SGD steps
     ``p <- p - 0.01 dE/dp`` (``torch.autograd.grad``) at n=20, L=4 from
     the benchmark's seeded parameters, then one step at n=20, L=3 (K1
     forward + K4 backward) and one at n=22, L=4 (K1 forward, K3 backward
     with the lane matrix), with the launch counts reset just before and
     read just after; energies and gradients against the same steps on the
     port's CPU path;
  5. timings (CUDA events, after warm-up): the evaluation and the training
     step (median of 20), each kernel at its path's shape (K3 at n=22, the
     others at n=20) over 3 rounds of 20 medians and its plain version over
     3 rounds of 5 single calls, reported as median and spread; K2 also by
     a replayed CUDA graph;
  6. torch.profiler windows over 10 L=4 evaluations and 10 L=4 training
     steps: device busy share and device time by kernel name; K3/K4's
     adjoint stages (``csrc/adjoint_stages.cuh``): their plan at n=20 (also
     under the row kron) and n=22 as the card reports it, against the
     Python arithmetic, without local memory; nvcc's registers and spills
     of each stage kernel (a spill fails); dM alone at 32, 64 and 128 row
     chunks; each stage (the outer walk with its sum, the lane pair, dM with
     its colsum, the row stage's two passes and their sum) by device time
     a layer on the training step, beside its bound and one PyTorch call of
     each product (a replayed CUDA graph); K2's stages
     (``csrc/zzrx_fwd.cu`` on the forward row stage and product of
     ``csrc/adjoint_stages.cuh``): its plan at n=20 L=4 as the card reports
     it against the Python arithmetic, registers and spills (a spill
     fails), and each stage (the two row passes, the product beside one
     ``torch.matmul``, the outer pass) by device time a layer on the
     training step beside its bound; K1's stages (``csrc/zzrx_fwd.cu`` on
     the same forward row stage and product): its plan at n=20 with the
     lane as the card reports it against ``zzrx_fwd_plan``, registers and
     spills, and each stage (the zz pass, the other pass, the transpose of
     M, the product beside one ``torch.matmul``) by device time a launch
     on the n=20 L=3 training step (K1 three times a step) beside its
     bound;
  7. the TEBD path, the main path of the TEBD slice: ``ParallelTEBD(60, 64,
     initial="neel")`` on the card for 10 trotter steps with the gate
     stacks of ``bench.py``'s TEBD workload, the launch counts reset just
     before and read just after (K5 must run twice a step); <Z_i> on all
     60 sites, lambda at bond 30 and the norm against the same steps on the
     port's CPU path in complex128, with the complex64 CPU Gram run's
     errors printed beside them; then K5 ``jacobi_svd`` against its plain
     version on the card: the path's own B=30 and B=29 thetas, random,
     decaying, rank-deficient and degenerate 128x128 batches of 30 and a
     (30, 128, 80) panel with V, the random batch without; K5 equal to
     itself over two runs; the trotter step timed (CUDA events), K5, its
     plain version and ``torch.linalg.svd`` timed on the B=30 thetas, K5's
     cluster size, the card's cluster occupancy, K5 at every cluster size
     that runs and K5's time a round, and a torch.profiler window over 3
     steps (one K5 kernel name);
  8. the HEA path, the main path of the single-qubit-layer slice: K6
     ``row_fwd`` and K7 ``row_bwd`` with and without the lane matrix and K8
     ``row_bwd_const`` against their plain versions at n=20 (nkernel=11,
     r=8192; distinct unitary gates, K7 twice, equal bit for bit); 5 SGD
     steps of :func:`hea_energy` at n=20, L=4 on the card, the launch
     counts reset just before and read just after (K6 9, K7 8 and K8 1 a
     step), energies and gradients against the same steps on the port's CPU
     path; the step timed (CUDA events) and profiled, each kernel and its
     plain version timed at the path's shape over 3 rounds (K6 and K7 also
     with the lane); K6's and K7's stage plans at n=20 with and without the
     lane and K8's (each stage kernel's CTAs, threads, shared bytes, CTAs
     an SM, registers, local bytes) against the Python arithmetic, nvcc's
     registers and spills of their passes, K6's product and the transpose
     (a spill fails), and each of their row passes (K6 and K8, one kernel
     instance each: the low pass, then the high one, told apart by their
     order in the trace; K7: the first, the last with its colsum) by device
     time a launch on the HEA step, beside its bound; K6 (with and without
     the lane), K7 and K8 alone by a replayed CUDA graph;
  9. the QAOA path, the main path of the QAOA slice: MaxCut on the n=20
     graph of ``examples/qaoa_maxcut_fused.py`` (37 edges, p=4); K9
     ``ml_fwd`` and K10 ``ml_bwd`` (whole block, 12 row qubits, 256 lanes)
     and K11 ``rotx_fwd`` and K12 ``rotx_bwd`` (nkernel=10, r=8192) against
     their plain versions at the path's shapes (K10 and K12 twice, equal bit
     for bit); the start energy of form (a) (``zzrx_layer`` under
     ``ML_MODE="pallas"``), form (b) (``rzz_product`` + ``rx_layer`` under
     ``USE_ROTX``) and form (a) under the default "stack", within 1e-5
     relative; 5 Adam steps (lr 0.05) of each form on the card, the launch
     counts reset just before and read just after each (K9 and K10 once a
     step, K11 and K12 four times), against the same steps on the port's
     CPU path; each step timed (CUDA events) and profiled, each kernel and
     its plain version timed; the switches restored to their defaults;
     K10's plan at 128, 256, 512 and 1024 lanes (each stage kernel's CTAs,
     threads, shared bytes, CTAs an SM, registers, local bytes; a spill
     fails) and each of its stages (the lane pair, dM with its colsum, the
     row stage's two passes and their sums) by device time a layer on the
     form (a) step, beside its bound and one PyTorch call of each product
     (a replayed CUDA graph); K9's plan at the same widths against the
     Python arithmetic and its stages (the zz pass, the other row pass,
     the product) the same way; K9, K11 and K12 alone by a replayed CUDA
     graph; K11's and K12's plans as the card reports them against the
     Python arithmetic, registers and spills, and their passes (K12's with
     its colsum) by device time a launch on the form (b) step beside their
     bounds;
 10. the FUSE_ROWM path, the main path of the row-kron slice: K1 and K3
     with the row kron M7 (stages K13 ``rowm_fwd`` and K14 ``rowm_bwd``,
     rmx=7, a 128x128 complex M7) with and without the lane against their
     plain versions at n=20 (K3 twice, equal bit for bit); 5 SGD steps of
     the n=20, L=4 TFIM step under ``kernels_stack.FUSE_ROWM = True``, the
     launch counts reset just before and read just after (K1, K3, K13 and
     K14 four times a step, K2 and K4 never), against the default card
     path (K2/K4) and the port's CPU path from the same parameters; the
     start point's value and grad under each setting of the stack's
     switches (FUSE_GRAND, FUSE_GRAND_BWD, both, FUSE_LANE off, FUSE_ROWM
     on) with the launches each gives; K1/K3 with M7 timed with their
     bounds, the step timed under each setting and profiled stage by
     stage under FUSE_ROWM; the switches restored to their defaults; the
     stages' plan at R=128 (tile, grid, shared bytes, CTAs an SM,
     registers, spills: none allowed) and each stage (K13, K14a, K14b with
     its colsum) by device time a launch on the step, its bound and one
     PyTorch call that computes the same product at the same shapes; K1
     with M7 by stage: its plan at rmx=7 against ``zzrx_fwd_plan``, and its
     zz pass (3 walked bits, the only pass), K13, the transpose and the
     product by device time a launch on the step beside their bounds;
 11. the staged micro-benchmark of K2's design (``examples/
     micro_grand_fusion.py`` ``run_micro``): K15 ``micro_grand`` at m1, m2
     and m3 against its plain version on the example's n=20, L=4 inputs,
     then each level timed by ``kernels_micro.run_micro`` (250 back-to-back
     calls, its launches read) with its bound.

Prints the kernels JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.  Needs no network and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N = 20
L = 4
#: the training path's width past the grand path (K3 through _adjoint_chain)
N22 = 22
SEEDS = 5
PAIRS = [(i, i + 1) for i in range(N - 1)]
#: kernel vs plain version, both float32 on the card: relative Frobenius
#: error and max-abs error over max |plain| (sums in another order; the
#: lane matmul sums 128 products)
KERNEL_RTOL = 1e-5
#: energy on the card vs the port's CPU path (E ~ -19, float32 sums over
#: 2^20 amplitudes in another order)
ENERGY_ATOL = 1e-4
#: gradient on the card vs the port's CPU path, max abs over the (L, 2, n)
#: grid (entries up to ~1; each a float32 sum over 2^20 amplitudes a layer)
GRAD_ATOL = 1e-4
#: the training step: SGD rate and number of steps at n=20, L=4
LR = 0.01
STEPS = 5
NORM_ATOL = 1e-5
#: the card's peaks for the bound (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the TEBD path: bench.py's TEBD workload, 10 trotter steps
TEBD_N, TEBD_CHI, TEBD_STEPS, TEBD_SWEEPS = 60, 64, 10, 10
#: card (float32 K5 Jacobi) vs the port's CPU path in complex128: max |d<Z_i>|
#: over the 60 sites, max |d lambda| at bond 30, and |psi|^2 - 1 (the float32
#: Jacobi with the INV_S_REL floor tracks float64; the complex64 Gram path
#: does not)
TEBD_ATOL = 1e-4
#: K5 vs its plain version, both float32 on the card, per matrix (s_max its
#: largest singular value); the levels quoted are this script's output on
#: an H100:
#: - s within 1e-5 s_max (the same rounds, sums in another order; <= 2.9e-6);
SVD_S_TOL = 1e-5
#: - reconstruction |u diag(s) vh - a|_F / |a|_F <= 1e-4: the algorithm itself,
#:   the plain version, reaches 1.3-2.7e-5 on the random, decaying,
#:   rank-deficient and degenerate batches after 1,270 rounds of float32
#:   rotations, so 1e-5 would fail the plain version too;
SVD_REC_TOL = 1e-4
#: - u columns and vh rows elementwise, where the gap of s_j to its
#:   neighbours (and to 0) exceeds 1e-3 s_max, within 2e-5 s_max / gap_j: a
#:   backward error of 1e-5 s_max on each side moves a singular vector by at
#:   most that over its gap.  Compared after aligning the phase of each pair
#:   (u_j, vh_j), a gauge that the iteration fixes from rounding-level
#:   inputs, so that K5 and its plain version may pick different phases;
SVD_GAP = 1e-3
SVD_VEC_TOL = 2e-5
#: - max |(u^H u - I)_jk| over columns with s > 1e-6 s_max <= 5e-3: about
#:   2e-7 on the thetas and the random batch, but 10 sweeps, the JAX
#:   package's fixed count, leave the degenerate batch (clusters of 32 equal
#:   s) and some decaying matrices unconverged: the plain version itself
#:   stays at 9.2e-4 and 1.2e-4 there.
SVD_ORTH_TOL = 5e-3


def hea_energy(mod, n, w, **kw):
    """The hardware-efficient-ansatz VQE energy, written against the public
    ``Circuit`` API that the port shares with the JAX package (``mod`` is
    either; the CPU tests pass both): h_layer (folded on |0...0>), then for
    each of the L rows of ``w`` (L, 2, n) an ry_layer, a CNOT ladder and an
    rz_layer, a final h_layer (a constant layer, not folded), and the
    open-chain TFIM energy ZZ - X."""
    pairs = [(q, q + 1) for q in range(n - 1)]
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for l in range(w.shape[0]):
        c.ry_layer(w[l, 0])
        for q in range(n - 1):
            c.cnot(q, q + 1)
        c.rz_layer(w[l, 1])
    c.h_layer()
    return c.expectation_zzx_energy(pairs, 1.0, -1.0)


def qaoa_graph(n, p, seed=7):
    """The weighted MaxCut graph and start parameters of
    ``examples/qaoa_maxcut_fused.py``: vertex i takes ``min(2, n-1-i)``
    partners above it with weights uniform in [0.5, 1.5], then 2p angles
    (γ_1..γ_p, β_1..β_p) uniform in [0.1, 0.5], float32, from the same rng.
    Returns ``(edges [(a, b, w)], params)``."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        cand = np.arange(i + 1, n)
        if len(cand):
            for j in rng.choice(cand, size=min(2, len(cand)), replace=False):
                edges.append((i, int(j), float(rng.uniform(0.5, 1.5))))
    return edges, rng.uniform(0.1, 0.5, size=2 * p).astype(np.float32)


def qaoa_energy(mod, arr, n, edges, params, form="zzrx", **kw):
    """The QAOA MaxCut cost Σ w/2 ⟨Z_a Z_b⟩ written against the public
    ``Circuit`` API that the port shares with the JAX package (``mod`` is
    either; ``arr`` makes a float32 array of that framework from numpy):
    h_layer, then for each round r either one ``zzrx_layer(edges, w·γ_r,
    2β_r)`` (``form="zzrx"``) or ``rzz_product(edges, w·γ_r)`` and
    ``rx_layer(2β_r)`` (``form="rzz_rx"``), the same circuit."""
    p = params.shape[0] // 2
    pairs = [(a, b) for a, b, _ in edges]
    w = arr([x for _, _, x in edges])
    ones = arr(np.ones(n))
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for r in range(p):
        if form == "zzrx":
            c.zzrx_layer(pairs, w * params[r], ones * (2.0 * params[p + r]))
        else:
            c.rzz_product(pairs, w * params[r])
            c.rx_layer(ones * (2.0 * params[p + r]))
    return c.expectation_ising_sum(zz_terms=[(a, b, 0.5 * x) for a, b, x in edges])


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _errors(a, b):
    import torch

    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    return diff, scale, rel


def _time_ms(fn, reps: int = 20, inner: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of CUDA-event time per call of ``inner`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _time_rounds(fn, rounds: int = 3, **kw):
    """(median, min, max) of :func:`_time_ms` over ``rounds`` rounds."""
    ts = [_time_ms(fn, **kw) for _ in range(rounds)]
    return statistics.median(ts), min(ts), max(ts)


#: a plain version is timed over fewer calls (median of 5 single calls a
#: round): it is a yardstick of what the kernel replaces, not a metric
PLAIN_TIMING = {"reps": 5, "inner": 1, "warmup": 1}


def _graph_ms(fn, calls: int = 10):
    """(median, min, max) ms of one call of ``fn`` over 3 rounds of CUDA
    events around the replay of a CUDA graph of ``calls`` calls: device time
    with the host's launch cost taken out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return tuple(t / calls for t in _time_rounds(graph.replay, inner=1))


def _profile(fn, reps: int = 10):
    """(host ms, device-busy ms, [(kernel, ms, launches)]) per call of
    ``fn`` over ``reps`` calls under torch.profiler (host time includes the
    profiler's own cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) * 1e3 / reps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return host, busy, [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps) for e in kernels]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _k1_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) K1 must move and compute: state planes in and out (and
    the lane planes); zz exponent 2 flops a pair + 6 for the phase, 6 a
    butterfly stage, 8·128 for the complex lane row-matmul, per amplitude.
    With the row kron (rmx > 0, stage K13) its (R, R) planes in, rmx fewer
    butterfly stages and one complex R-deep left product, 8·R."""
    amps = r * 128
    nbytes = 4 * 4 * amps + 4 * (npairs + nkernel + 2 * npairs)
    flops = amps * (2 * npairs + 6 + 6 * (nkernel - rmx))
    if lane:
        nbytes += 2 * 4 * 128 * 128
        flops += amps * 8 * 128
    if rmx:
        nbytes += 2 * 4 * 4**rmx
        flops += amps * 8 * 2**rmx
    return nbytes, flops


def _k3_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) K3 must move and compute: y and ct in, ds out (and the
    lane planes in, dM out); per amplitude 20 flops a butterfly stage (the
    un-apply, the ct walk, the two dθ sums), 4 a pair + 9 for the zz stage
    (exponent, dzz sum, phase walk) and, with the lane matrix, three complex
    128-deep products (un-lane, ct walk, dM): 3·8·128.  With the row kron
    (stage K14) its planes in and dM7 out, rmx fewer butterfly stages and
    three complex R-deep products (un-apply, ct walk, dM7): 3·8·R."""
    amps = r * 128
    nbytes = 6 * 4 * amps + 4 * (4 * npairs + 2 * (nkernel - rmx))
    flops = amps * (20 * (nkernel - rmx) + 4 * npairs + 9)
    if lane:
        nbytes += 4 * 4 * 128 * 128
        flops += amps * 3 * 8 * 128
    if rmx:
        nbytes += 4 * 4 * 4**rmx
        flops += amps * 3 * 8 * 2**rmx
    return nbytes, flops


def _k4_work(r, npairs, nkernel, nouter, L):
    """(bytes, flops) of K4: L layers of K3 with the lane matrix plus, a
    layer, the outer walk (8·D flops an amplitude) and dθ_outer (4 an outer
    qubit); the L residuals and the seed in, ds out, the outer and lane
    matrices in and the dM planes out."""
    amps = r * 128
    d = 2**nouter
    _, f3 = _k3_work(r, npairs, nkernel, True)
    nbytes = 4 * 4 * amps + L * 2 * 4 * amps
    nbytes += L * (4 * 4 * 128 * 128 + 2 * 4 * d * d + 4 * (4 * npairs + 2 * nkernel + nouter))
    flops = L * (f3 + amps * (8 * d + 4 * nouter))
    return nbytes, flops


def _k2_work(r, npairs, nkernel, nouter, L):
    """(bytes, flops) of K2: the state in and y out, the L residuals out
    and, a layer, the lane and outer planes in; per layer and amplitude
    K1's flops with the lane matrix (:func:`_k1_work`) and the outer
    product, 8·D."""
    amps, d = r * 128, 2**nouter
    _, f1 = _k1_work(r, npairs, nkernel, True)
    nbytes = 4 * 4 * amps + L * 2 * 4 * amps + L * (2 * 4 * 128 * 128 + 2 * 4 * d * d)
    return nbytes, L * (f1 + amps * 8 * d)


def _k2_stage_work(r, npairs, nkernel, nouter):
    """(bytes, flops) of each of K2's stages a layer, by name: the row stage
    (x in, its output out, the layer's angles in; 2 flops a pair + 6 for the
    phase, 6 an rx stage), the product (that output and M in, ks[l] out;
    8·128) and the outer pass (ks[l] and the (D, D) planes in, y out;
    8·D).  L layers of them add up to :func:`_k2_work`'s flops; their bytes
    to it plus what the stages and layers hand each other and the angles."""
    amps, d = r * 128, 2**nouter
    return {
        "row": (16 * amps + 4 * (npairs + nkernel), (2 * npairs + 6 + 6 * nkernel) * amps),
        "product": (16 * amps + 2 * 4 * 128 * 128, 8 * 128 * amps),
        "outer": (16 * amps + 2 * 4 * d * d, 8 * d * amps),
    }


def _k34_stage_work(r, npairs, nkernel, nouter):
    """(bytes, flops) of each stage of K3 with the lane matrix, and of a K4
    layer, by name: the lane pair psi = y @ conj(M)^T and w = ct @ M^T (y
    and ct in, psi and w out, M in; 16·128 flops an amplitude), dM = psiᵀ
    ct (psi and ct in, dM out; 8·128), the row stage (psi and w in, ds out,
    the angles and pair shifts in and the layer's gradients out; 20 flops an
    rx stage, 4 a pair + 9 for the zz stage) and, with nouter > 0 (K4), the
    outer stage (ct and the residual in, w out, the (D, D) planes in and
    dθ_outer out; 8·D flops an amplitude and 4 an outer qubit).  Their flops
    add up to :func:`_k3_work`'s (nouter = 0) and to a layer of
    :func:`_k4_work`'s; their bytes to it plus what the stages hand each
    other."""
    amps, mat = r * 128, 2 * 4 * 128 * 128
    out = {
        "lane pair": (32 * amps + mat, 16 * 128 * amps),
        "dM": (16 * amps + mat, 8 * 128 * amps),
        "row": (24 * amps + 16 * npairs + 8 * nkernel, (20 * nkernel + 4 * npairs + 9) * amps),
    }
    if nouter:
        d = 2**nouter
        out["outer"] = (24 * amps + 2 * 4 * d * d + 4 * nouter, (8 * d + 4 * nouter) * amps)
    return out


#: K4's stages on the TFIM step, by kernel name (csrc/adjoint_stages.cuh
#: and csrc/zzrx_bwd.cu); "+colsum" takes the partials' sum launched
#: right after each
K4_STAGES = {
    "outer+colsum": lambda k: "outer_bwd_kernel" in k,
    "lane pair": lambda k: "wide_nt_kernel<2, true>" in k,
    "dM+colsum": lambda k: "wide_dm_kernel" in k,
    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
    "row lo+colsum": lambda k: "ml_row_pass_kernel<true>" in k,
    "pair records": lambda k: "ml_pair_records_kernel" in k,
}
#: dM's row chunks measured at n=20 (dm_chunks takes 64 at 128 lanes)
DM_CHUNK_SWEEP = (32, 64, 128)


def _k4_stages(krl, card, stage_us, y, ct, m, pairs22):
    """K3/K4's adjoint stages at the TFIM step's shapes: the plan at n=20
    (and under the row kron, rmx=7) and n=22 as the card reports it, each
    record equal to the Python arithmetic's (``zzrx_bwd_plan``) and without
    local memory; nvcc's registers and spills of every stage kernel in the
    zzrx_bwd and row_layer builds (a spill fails); dM alone at 32, 64 and
    128 row chunks (CUDA events, against psiᵀ ct); each stage's device time
    a layer on the n=20 L=4 step (``stage_us``, from :func:`_stage_times`)
    beside its bound, and one PyTorch call computing each product on the
    same operands (a replayed CUDA graph; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import _build

    r = y[0].shape[0]
    nkernel, nouter = 10, r.bit_length() - 1 - 10
    npairs = N - 1
    for label, rr, npp, rmx in ((f"n={N}", r, npairs, 0), (f"n={N} rmx=7", r, npairs, 7),
                                (f"n={N22}", 4 * r, len(pairs22), 0)):
        _plan_check(f"K3/K4 at {label}", card, krl.zzrx_bwd_card_plan(rr, nkernel, npp, rmx),
                    krl.zzrx_bwd_plan(rr, nkernel, npp, rmx))
    _ptxas_check("zzrx_bwd", ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel", "ml_pair_records_kernel",
                              "colsum_tree_kernel", "outer_bwd_kernel"))
    _ptxas_check("row_layer", ("wide_nt_kernel", "wide_dm_kernel"))
    # dM alone at each chunk count, through the C entry point (the kernels
    # take the rule's count)
    lib = _build.library("zzrx_bwd")
    part = torch.empty(2 * max(DM_CHUNK_SWEEP) * 128 * 128, device=y[0].device)
    dm = torch.empty((2, 128, 128), device=y[0].device)
    want = torch.complex(*y).T @ torch.complex(*ct)

    def dm_at(nc):
        err = lib.tcng_lane_dm(y[0].data_ptr(), y[1].data_ptr(), ct[0].data_ptr(), ct[1].data_ptr(),
                               part.data_ptr(), dm.data_ptr(), r, nc, torch.cuda.current_stream().cuda_stream)
        _build.check("zzrx_bwd", err, f"dM at {nc} chunks")

    nc_rule = krl.zzrx_bwd_plan(r, nkernel, npairs)["dm"]["chunks"]
    for nc in DM_CHUNK_SWEEP:
        dm_at(nc)
        diff, scale, rel = _errors(torch.complex(dm[0], dm[1]), want)
        if rel > KERNEL_RTOL or diff > KERNEL_RTOL * scale:
            _fail(f"dM at {nc} chunks disagrees with psi^T ct: max_abs {diff:.3e}, rel {rel:.3e}")
        t = _time_rounds(lambda nc=nc: dm_at(nc))
        print(f"K3/K4 dM alone at n={N}, {nc} row chunks ({4 * nc} CTAs{', the rule' if nc == nc_rule else ''}; "
              f"with its colsum; CUDA events, median of 3 rounds), {card}: {1e3 * t[0]:.2f} us (min "
              f"{1e3 * t[1]:.2f}, max {1e3 * t[2]:.2f}); max_abs {diff:.2e} from psi^T ct")
    # the products' operands as complex matrices, built outside the timed calls
    yc, cc = torch.complex(*y), torch.complex(*ct)
    mc = torch.complex(*m)
    a2 = torch.stack([yc, cc])
    b2 = torch.stack([mc.conj().T, mc.T]).contiguous()
    psi = yc @ b2[0]
    library = {"lane pair": lambda: torch.matmul(a2, b2), "dM": lambda: torch.matmul(psi.T, cc)}
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    work = _k34_stage_work(r, npairs, nkernel, nouter)
    rows = {"outer": ["outer+colsum"], "lane pair": ["lane pair"], "dM": ["dM+colsum"],
            "row": ["row hi", "row lo+colsum"]}
    layer = 0.0
    for stage, labels in rows.items():
        us = sum(stage_us[k][0] for k in labels)
        layer += us
        per_step = stage_us[labels[0]][1]
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms.get(stage)
        lib_txt = (f"library call {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min "
                   f"{1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
        parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
        print(f"K4 stage {stage} at n={N} L={L}, {card}: {us:.2f} us device a layer ({parts}; torch.profiler "
              f"over 10 training steps, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; {lib_txt}")
    rec = stage_us["pair records"]
    print(f"K4 a layer at n={N} L={L}, {card}: {layer:.2f} us device (the stages above), plus "
          f"{rec[0]:.2f} us a call for the pair records (x{rec[1]:g} a step)")


#: K1's stages by kernel name (csrc/adjoint_stages.cuh, launched from
#: csrc/zzrx_fwd.cu) on a step that runs no other forward kernel of the
#: header (the n=20 L=3 TFIM step, the FUSE_ROWM step); the transpose of M
#: runs once a call
K1_STAGES = {
    "row zz": lambda k: "fwd_row_pass_kernel<true, false, false>" in k,
    "row hi": lambda k: "fwd_row_pass_kernel<false, false, false>" in k,
    "transpose": lambda k: "transpose_kernel" in k,
    "product": lambda k: "wide_nt_kernel<1, false>" in k,
}
#: K2's stages on the TFIM step: K1's and the outer pass
K2_STAGES = {**K1_STAGES, "outer": lambda k: "outer_fwd_kernel" in k}


def _k2_stages(kg, card, stage_us, x, m, npairs, nkernel, nouter):
    """K2's stages at the TFIM step's shapes: the plan at n=20 L=4 as the
    card reports it, each record equal to ``grand_zzrx_fwd_plan``'s and
    without local memory; nvcc's registers and spills of its stage kernels
    in the zzrx_fwd build (a spill fails); each stage's device time a layer
    on the n=20 L=4 step (``stage_us``, from :func:`_stage_times`) beside
    its bound, and one ``torch.matmul`` of the product's shapes on the
    same operands (a replayed CUDA graph; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    r = x[0].shape[0]
    _plan_check(f"K2 at n={N} L={L}", card, kg.grand_zzrx_fwd_card_plan(r, nkernel, npairs, L),
                kg.grand_zzrx_fwd_plan(r, nkernel, npairs, L))
    _ptxas_check("zzrx_fwd", ("fwd_row_pass_kernel", "wide_nt_kernel", "outer_fwd_kernel", "transpose_kernel",
                              "ml_pair_records_kernel"))
    xc, mc = torch.complex(*x), torch.complex(*m)
    with torch.no_grad():
        lib_ms = {"product": _graph_ms(lambda: torch.matmul(xc, mc))}
    work = _k2_stage_work(r, npairs, nkernel, nouter)
    rows = {"row": ["row zz", "row hi"], "product": ["product"], "outer": ["outer"]}
    layer = 0.0
    for stage, labels in rows.items():
        us = sum(stage_us[k][0] for k in labels)
        layer += us
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms.get(stage)
        lib_txt = (f"library call torch.matmul {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, "
                   f"min {1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
        parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
        print(f"K2 stage {stage} at n={N} L={L}, {card}: {us:.2f} us device a layer ({parts}; torch.profiler "
              f"over 10 training steps, x{stage_us[labels[0]][1]:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; {lib_txt}")
    tr = stage_us["transpose"]
    print(f"K2 a layer at n={N} L={L}, {card}: {layer:.2f} us device (the stages above), plus {tr[0]:.2f} us a "
          f"launch for the transpose of M (x{tr[1]:g} a step) and the pair records (in K4's line)")
    return layer


def _k1_stage_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) of each of K1's stages a launch, by name: "row zz"
    (the zz pass: x in, its output out, the pairs' angles and shifts and
    its bits' angles in; 2 flops a pair + 6 for the phase, 6 an rx bit on
    the low min(6, nkernel - rmx) walked bits), "row hi" (the walked bits
    past 6, in place) where there are two passes, with M7 "K13"
    (:func:`_rowm_stage_work`), and with the lane "transpose" (M in, M^T
    out) and "product" (the row stage's output and M^T in, y out; 8·128).
    Their flops add up to :func:`_k1_work`'s; their bytes to it plus what
    the stages hand each other (the state and M^T), less the rmx angles
    that K13 does not read."""
    amps, mat = r * 128, 2 * 4 * 128 * 128
    nwalk = nkernel - rmx
    lo = min(nwalk, 6)
    hi = nwalk - lo
    out = {"row zz": (16 * amps + 4 * (3 * npairs + lo), (2 * npairs + 6 + 6 * lo) * amps)}
    if hi:
        out["row hi"] = (16 * amps + 4 * hi, 6 * hi * amps)
    if rmx:
        out["K13"] = _rowm_stage_work(r, rmx)["K13"]
    if lane:
        out["transpose"] = (2 * mat, 0)
        out["product"] = (16 * amps + mat, 8 * 128 * amps)
    return out


def _k1_stages(krl, card, stage_us, x, m, npairs, nkernel, rmx, steps):
    """K1 with the lane at the shape of the profiled ``steps`` (the n=20
    L=3 TFIM steps, or the FUSE_ROWM steps with rmx = 7): the plan as the
    card reports it, each record equal to ``zzrx_fwd_plan``'s and without
    local memory; nvcc's registers and spills of its stage kernels in the
    zzrx_fwd build (a spill fails); each stage's device time a call on the
    step (``stage_us``, from :func:`_stage_times`: the zz and the other
    pass are two instances of the pass kernel, told apart by name; the
    transpose runs twice a call) beside its bound, and one ``torch.matmul``
    of the product's shapes on its operands (a replayed CUDA graph; never
    called by the port; ``allow_tf32`` is False)."""
    import torch

    r = x[0].shape[0]
    shape = f"n={N} nkernel={nkernel}" + (f" rmx={rmx}" if rmx else "")
    _plan_check(f"K1 at {shape} with the lane", card, krl.zzrx_fwd_card_plan(r, nkernel, npairs, True, rmx),
                krl.zzrx_fwd_plan(r, nkernel, npairs, True, rmx))
    _ptxas_check("zzrx_fwd", ("fwd_row_pass_kernel", "wide_nt_kernel", "transpose_kernel",
                              "ml_pair_records_kernel"))
    xc, mc = torch.complex(*x), torch.complex(*m)
    with torch.no_grad():
        lib = _graph_ms(lambda: torch.matmul(xc, mc))
    plan = krl.zzrx_fwd_plan(r, nkernel, npairs, True, rmx)
    bits = {"row zz": plan["fwd_row_zz"]["bits"], "row hi": plan["fwd_row_hi"]["bits"]}
    total = 0.0
    for stage, work in _k1_stage_work(r, npairs, nkernel, True, rmx).items():
        us, per_step = stage_us[stage]
        k = 2 if stage == "transpose" else 1  # launches a call: M's two planes
        total += k * us
        bound, by = _bound_ms(*work)
        lib_txt = (f"library call torch.matmul {1e3 * lib[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, "
                   f"min {1e3 * lib[1]:.2f}, max {1e3 * lib[2]:.2f})" if stage == "product" else "no library call")
        walked = f" ({bits[stage]} walked bits)" if stage in bits else ""
        print(f"K1 stage {stage}{walked} at {shape}, {card}: {k * us:.2f} us device a call ({k} x {us:.2f} a launch; "
              f"torch.profiler over 10 {steps}, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / (k * us):.1f} % of it reached; {lib_txt}")
    bound, by = _bound_ms(*_k1_work(r, npairs, nkernel, True, rmx))
    print(f"K1 a call at {shape} with the lane, {card}: {total:.2f} us device (the stages above, plus the pair "
          f"records in K4's line); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


def _rowm_stage_work(r, rmx):
    """(bytes, flops) of each row-kron stage alone, by name: K13 y = M7 x
    (x in, y out, M7 in; 8·R flops an amplitude), K14a x = M7† y and c' =
    M7ᵀ c (y, c in, x, c' out; 16·R), K14b dM7 = Σ c xᵀ (c, x in, dM7 out;
    8·R)."""
    amps, R = r * 128, 2**rmx
    m7 = 2 * 4 * R * R
    return {
        "K13": (16 * amps + m7, 8 * R * amps),
        "K14a": (32 * amps + m7, 16 * R * amps),
        "K14b": (16 * amps + m7, 8 * R * amps),
    }


def _ptxas_report(log: str, needle: str):
    """(registers, spill store bytes, spill load bytes) of each kernel whose
    mangled name holds ``needle``, from nvcc's ``-Xptxas -v`` output."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or needle not in name:
            continue
        regs, spill = out.get(name, (None, None, None)), re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[name] = (regs[0], int(spill.group(1)), int(spill.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m.group(1)), regs[1], regs[2])
    return out


def _stage_times(fn, stages, reps: int = 10):
    """(device µs a launch, launches a call) of each stage of ``fn`` under
    torch.profiler: ``stages`` maps a label to a kernel-name test; a label
    ending in "+colsum" adds the colsum_kernel or colsum_tree_kernel
    launched right after each of its kernels (found in the trace's time
    order).  A stage given as ``(test, k, m)`` is the k-th launch of every
    m adjacent launches that match ``test`` in the trace's time order: the
    passes of one call that share a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = [e for e in prof.key_averages() if e.device_type == cuda]
    trace = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
    out = {}
    for label, test in stages.items():
        if isinstance(test, tuple):
            test, k, m = test
            idx = [i for i, e in enumerate(trace) if test(e.name)]
            groups = [idx[g:g + m] for g in range(0, len(idx), m)]
            if not idx or any(len(g) != m or g[-1] - g[0] != m - 1 for g in groups):
                _fail(f"stage {label}: the launches of {label} do not come in adjacent groups of {m}")
            us = sum(trace[g[k]].time_range.elapsed_us() for g in groups) / len(groups)
            out[label] = (us, len(groups) / reps)
            continue
        hits = [e for e in by_name if test(e.key)]
        count = sum(e.count for e in hits)
        if count == 0:
            _fail(f"stage {label}: no kernel launched in the profile")
        us = sum(e.self_device_time_total for e in hits) / count
        if label.endswith("+colsum"):
            after = [trace[i + 1] for i, e in enumerate(trace[:-1]) if test(e.name)]
            if not after or any("colsum" not in e.name for e in after):
                _fail(f"{label}: no colsum right after each launch in the trace")
            us += sum(e.time_range.elapsed_us() for e in after) / len(after)
        out[label] = (us, count / reps)
    return out


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _k5_work(b, n, m, sweeps):
    """(bytes, flops) K5 with V must move and compute: A's planes in and out
    and V's planes out; per pair and round 36·m flops on A (16 for the four
    column sums, 20 for the rotation) and 20·n on V."""
    nbytes = 4 * 4 * b * n * m + 2 * 4 * b * n * n
    flops = b * (n // 2) * sweeps * (n - 1) * (36 * m + 20 * n)
    return nbytes, flops


def _svd_batches(rng, b=30, n=128):
    """K5's parity batches beside the path's thetas: (label, (b, m, k)
    complex numpy), spectra that 10 sweeps converge."""

    def g(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def with_spectrum(s, m, k):
        q1 = np.linalg.qr(g(b, m, k))[0]
        q2 = np.linalg.qr(g(b, k, k))[0]
        return (q1 * s[None, None, :]) @ q2

    return [
        ("random", g(b, n, n)),
        ("decaying", with_spectrum(np.exp(-np.linspace(0, 4, n)), n, n)),
        ("rank-deficient", with_spectrum(
            np.where(np.arange(n) < 21, np.exp(-np.linspace(0, 5, n)), 0.0), n, n)),
        ("degenerate", with_spectrum(np.repeat([1.0, 0.5, 0.25, 0.1], n // 4), n, n)),
        (f"panel {n}x80", with_spectrum(np.exp(-np.linspace(0, 4, 80)), n, 80)),
    ]


def _svd_checks(a, got, want):
    """K5's (u, s, vh) on ``a`` against its plain version's, in complex128:
    (ds / s_max, reconstruction, the plain version's reconstruction, the
    largest |d vector| * gap / s_max over separated columns, how many,
    orthogonality, max |ds|); see the SVD_* tolerances."""
    import torch

    c128 = torch.complex128
    a = a.to(c128)
    u, vh, up, vhp = (x.to(c128) for x in (got[0], got[2], want[0], want[2]))
    s, sp = got[1].double(), want[1].double()
    smax = sp[..., :1]

    def rec(u, s, vh):
        r = u * s[..., None, :].to(c128) @ vh - a
        return (torch.linalg.matrix_norm(r) / torch.linalg.matrix_norm(a)).max().item()

    nxt = torch.cat([sp[..., 1:], torch.zeros_like(smax)], -1)
    prv = torch.cat([torch.full_like(smax, float("inf")), sp[..., :-1]], -1)
    gap = torch.minimum(prv - sp, sp - nxt)
    sep = gap > SVD_GAP * smax
    ph = (up.conj() * u).sum(-2)
    ph = ph / ph.abs().clamp_min(1e-30)  # the gauge phase of each pair
    du = (u * ph.conj()[..., None, :] - up).abs().amax(-2)
    dv = (vh * ph[..., :, None] - vhp).abs().amax(-1)
    vec = torch.where(sep, torch.maximum(du, dv) * gap / smax, torch.zeros_like(du)).max().item()
    keep = s > 1e-6 * s[..., :1]
    eye = torch.eye(u.shape[-1], dtype=c128, device=u.device)
    uhu = (u.conj().transpose(-1, -2) @ u - eye).abs()
    orth = torch.where(keep[..., :, None] & keep[..., None, :], uhu, torch.zeros_like(uhu)).max().item()
    ds = (s - sp).abs()
    return (ds / smax).max().item(), rec(u, s, vh), rec(up, sp, vhp), vec, int(sep.sum()), orth, ds.max().item()


def _mps_norm(eng) -> float:
    """<psi|psi> of a ParallelTEBD state by transfer matrices (the padded
    edge bonds use slot 0 only)."""
    import torch

    ts = eng.to_mps_tensors()
    env = torch.ones((1, 1), dtype=ts[0].dtype, device=ts[0].device)
    for i, t in enumerate(ts):
        t = t[:1] if i == 0 else t
        env = torch.einsum("ab,adc,bde->ce", env, t.conj(), t)
    return env[0, 0].real.item()


def _check_parity(cases, twice=()):
    """Each kernel variant of ``cases`` ({name: [(label, kernel, plain)]})
    against its plain version on the same CUDA inputs, output by output
    (``KERNEL_RTOL``); the kernels named in ``twice`` run twice and must
    agree bit for bit.  Returns the largest max-abs error of each kernel."""
    import torch

    max_err = {}
    with torch.no_grad():
        for kname, variants in cases.items():
            max_err[kname] = 0.0
            for label, kern, plain in variants:
                got = kern()
                again = kern() if kname in twice else got
                torch.cuda.synchronize()
                want = plain()
                if len(got) != len(want):
                    _fail(f"{kname} [{label}] returns {len(got)} outputs, its plain version {len(want)}")
                for i, (a, a2, b) in enumerate(zip(got, again, want)):
                    diff, scale, rel = _errors(a, b)
                    ok = a.shape == b.shape and rel <= KERNEL_RTOL and diff <= KERNEL_RTOL * scale
                    print(f"parity {kname} [{label}] out{i} {tuple(a.shape)}: max_abs {diff:.3e} "
                          f"(max|plain| {scale:.3e}), rel_frob {rel:.3e}, "
                          f"tol {KERNEL_RTOL:g} -> {'ok' if ok else 'FAIL'}")
                    if not ok:
                        _fail(f"{kname} [{label}] disagrees with its plain version")
                    if not torch.equal(a, a2):
                        _fail(f"{kname} [{label}] out{i} differs between two runs")
                    max_err[kname] = max(max_err[kname], diff)
                if kname in twice:
                    print(f"parity {kname} [{label}]: two runs equal bit for bit")
    return max_err


def _row_work(r, nkernel, kind, lane=False):
    """(bytes, flops) of a row kernel: K6 ("fwd") and K8 ("const") read two
    state planes and write two, 14 flops an amplitude a gate (two complex
    products and a sum); K7 ("bwd") reads y and ct and writes ds, 44 flops
    an amplitude a gate (the un-apply, the four dg sums, the ct walk), and
    writes dg; with the lane matrix, its planes in and one complex
    128-deep product an amplitude (K6) or three (K7: un-lane, ct walk, dM)
    with dM out."""
    amps = r * 128
    gates = 2 * 4 * 4 * nkernel
    if kind == "bwd":
        nbytes, flops = 6 * 4 * amps + 2 * gates, 44 * nkernel * amps
    else:
        nbytes, flops = 4 * 4 * amps + gates, 14 * nkernel * amps
    if lane:
        k = 3 if kind == "bwd" else 1
        nbytes += (2 if kind == "bwd" else 1) * 2 * 4 * 128 * 128
        flops += k * 8 * 128 * amps
    return nbytes, flops


def _k7_stage_work(r, nkernel):
    """(bytes, flops) of each stage of K7 with the lane matrix, by name:
    the lane pair and dM as K3's (:func:`_k34_stage_work`), and the row
    stage (psi and w in, ds out, the gates in and dg out; 44 flops an
    amplitude a gate).  Without the lane the row stage is all of K7.  Their
    flops add up to :func:`_row_work`'s; their bytes to it plus what the
    stages hand each other."""
    amps, gates = r * 128, 2 * 4 * 4 * nkernel
    lane = _k34_stage_work(r, 0, nkernel, 0)
    return {"lane pair": lane["lane pair"], "dM": lane["dM"],
            "row": (24 * amps + 2 * gates, 44 * nkernel * amps)}


def _k6_stage_work(r, nkernel, lane=False):
    """(bytes, flops) of each stage of K6 a launch, by name: the row
    stage's "row lo" pass (the low 6 walked bits, launched first: two
    planes in, two out, its gates in; 14 flops an amplitude a bit), "row
    hi" (the walked bits past 6, in place) where there are two passes, and
    with the lane "product" (the row stage's output and M in, y out; one
    complex 128-deep product an amplitude).  Their flops add up to
    :func:`_row_work`'s; their bytes to it plus the planes the stages hand
    each other."""
    amps = r * 128
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {"row lo": (16 * amps + 32 * lo, 14 * lo * amps)}
    if hi:
        out["row hi"] = (16 * amps + 32 * hi, 14 * hi * amps)
    if lane:
        out["product"] = (16 * amps + 2 * 4 * 128 * 128, 8 * 128 * amps)
    return out


def _fwd_pass_stages(instance):
    """The two passes of K6, K8 or K11 on a step, by kernel name: both are
    ``fwd_row_pass_kernel<false, GATE, TRANS>`` (csrc/adjoint_stages.cuh),
    the low bits launched first and the high ones right after."""
    test = lambda k: f"fwd_row_pass_kernel<{instance}>" in k  # noqa: E731
    return {"row lo": (test, 0, 2), "row hi": (test, 1, 2)}


#: K6's, K8's and K11's passes on their steps (the gate, the transposed
#: gate and rx)
K6_STAGES = {f"K6 {k}": v for k, v in _fwd_pass_stages("false, true, false").items()}
K8_STAGES = {f"K8 {k}": v for k, v in _fwd_pass_stages("false, true, true").items()}
K11_STAGES = {f"K11 {k}": v for k, v in _fwd_pass_stages("false, false, false").items()}


def _plan_check(name, card, got, want):
    """A stage plan as the card reports it: each record equal to the Python
    arithmetic and without local memory."""
    for stage, p in got.items():
        print(f"{name} plan, {stage}, {card}: {p}")
        if p["local_bytes"] or any(p[k] != v for k, v in want[stage].items()):
            _fail(f"{name} stage {stage}: card plan {p}, Python plan {want[stage]}")


def _ptxas_check(build, needles):
    """nvcc's registers and spills of each kernel of the ``build`` whose
    mangled name holds one of ``needles`` (a spill fails, and so does a
    needle that no kernel's name holds)."""
    from tensorcircuit_ng_tpu_torch.core import _build

    report = {k: v for k, v in _ptxas_report(_build.build_log(build), "").items()
              if any(x in k for x in needles)}
    for m in needles:
        if not any(m in k for k in report):
            _fail(f"no ptxas report of {m} in {build}: {list(report)}")
    for kname, (regs, st, ld) in report.items():
        print(f"ptxas[{build}] ({kname[-60:]}): {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads")
        if regs is None or st or ld:
            _fail(f"{kname} spills or has no register count")


#: the mangled names of K6's, K8's and K11's pass kernels,
#: fwd_row_pass_kernel<false, true, false>, <false, true, true> and
#: <false, false, false>
K6_PASS, K8_PASS, K11_PASS = ("fwd_row_pass_kernelILb0ELb1ELb0E", "fwd_row_pass_kernelILb0ELb1ELb1E",
                              "fwd_row_pass_kernelILb0ELb0ELb0E")


def _k6_k8_plan(krl, card, r, nkernel):
    """K6's stage plan at the HEA shape with and without the lane against
    :func:`kernels_rowlayer.row_fwd_plan` and K8's against
    :func:`kernels_rowlayer.row_bwd_const_plan`, and nvcc's registers and
    spills of their passes and K6's product and transpose in the row_layer
    build."""
    for lane in (False, True):
        _plan_check(f"K6 at n={N} nkernel={nkernel}{' with the lane' if lane else ''}", card,
                    krl.row_fwd_card_plan(r, nkernel, lane), krl.row_fwd_plan(r, nkernel, lane))
    _plan_check(f"K8 at n={N} nkernel={nkernel}", card, krl.row_bwd_const_card_plan(r, nkernel),
                krl.row_bwd_const_plan(r, nkernel))
    _ptxas_check("row_layer", (K6_PASS, K8_PASS, "wide_nt_kernel", "transpose_kernel"))


#: K7's stages on the HEA step, by kernel name (csrc/adjoint_stages.cuh)
K7_STAGES = {
    "row hi": lambda k: "gate_row_pass_kernel<false>" in k,
    "row lo+colsum": lambda k: "gate_row_pass_kernel<true>" in k,
}


def _k7_plan(krl, card, r, nkernel):
    """K7's stage plan at the HEA shape with and without the lane as the
    card reports it, each record equal to :func:`kernels_rowlayer.row_bwd_plan`
    and without local memory, and nvcc's registers and spills of its gate
    passes (a spill fails)."""
    for lane in (False, True):
        _plan_check(f"K7 at n={N} nkernel={nkernel}{' with the lane' if lane else ''}", card,
                    krl.row_bwd_card_plan(r, nkernel, lane), krl.row_bwd_plan(r, nkernel, lane))
    # the two gate passes, gate_row_pass_kernel<false> and <true>
    _ptxas_check("row_layer", ("gate_row_pass_kernelILb0E", "gate_row_pass_kernelILb1E"))


def _hea_phase(tct, krl, dev, card):
    """Phase 8, the HEA path (the main path of the single-qubit-layer
    slice): K6/K7/K8 against their plain versions at the n=20 shapes, 5 SGD
    steps of :func:`hea_energy` at n=20, L=4 on the card against the CPU
    path with the launches of each kernel read, the step timed and
    profiled, each kernel timed at its path shape (K7 also with the lane
    and by a replayed CUDA graph), K6's, K8's (:func:`_k6_k8_plan`) and
    K7's plans (:func:`_k7_plan`) and their row passes a launch on the step
    beside their bound.  Returns the kernels line's entries."""
    import torch

    nrow = N - 7
    nkernel = min(nrow, krl.MAX_KERNEL_QUBITS)
    r = 2**nrow
    rng = np.random.default_rng(17)

    def unitaries(k, dim):
        a = rng.normal(size=(k, dim, dim)) + 1j * rng.normal(size=(k, dim, dim))
        return np.linalg.qr(a)[0]

    def unit_planes():
        z = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
        return tct.convert.planes(z / np.linalg.norm(z), dev)

    # distinct unitary gates on every kernel qubit and a unitary lane
    # matrix: the backward rebuilds states by un-application
    g = unitaries(nkernel, 2).reshape(nkernel, 4)
    gr, gi = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in (g.real, g.imag))
    m = unitaries(1, 128)[0]
    mr, mi = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in (m.real, m.imag))
    sr, si = unit_planes()
    ctr, cti = unit_planes()
    with torch.no_grad():
        y = krl.row_fwd_plain(gr, gi, sr, si)
        y_lane = krl.row_fwd_plain(gr, gi, sr, si, mr, mi)
    cases = {
        "row_fwd": [
            ("no lane", lambda: krl.row_fwd(gr, gi, sr, si), lambda: krl.row_fwd_plain(gr, gi, sr, si)),
            ("lane", lambda: krl.row_fwd(gr, gi, sr, si, mr, mi),
             lambda: krl.row_fwd_plain(gr, gi, sr, si, mr, mi)),
        ],
        "row_bwd": [
            ("no lane", lambda: krl.row_bwd(gr, gi, *y, ctr, cti),
             lambda: krl.row_bwd_plain(gr, gi, *y, ctr, cti)),
            ("lane", lambda: krl.row_bwd(gr, gi, *y_lane, ctr, cti, mr, mi),
             lambda: krl.row_bwd_plain(gr, gi, *y_lane, ctr, cti, mr, mi)),
        ],
        "row_bwd_const": [
            ("no lane", lambda: krl.row_bwd_const(gr, gi, ctr, cti),
             lambda: krl.row_bwd_const_plain(gr, gi, ctr, cti)),
        ],
    }
    print(f"row-layer parity at n={N}: nkernel={nkernel}, r={r}, distinct unitary gates")
    max_err = _check_parity(cases, twice=("row_bwd",))

    # 5 SGD steps through the public API, on the card and on the CPU
    w0 = np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1
    counters = (krl.row_fwd, krl.row_bwd, krl.row_bwd_const)

    def step(w):
        e = hea_energy(tct, N, w, device=w.device)
        (gw,) = torch.autograd.grad(e, w)
        with torch.no_grad():
            w.sub_(LR * gw)
        return e, gw

    for k in counters:
        k.launches = 0
    w = tct.convert.params(w0, dev).requires_grad_()
    card_steps = [tuple(t.detach().cpu().numpy() for t in step(w)) for _ in range(STEPS)]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    print(f"HEA path launches ({STEPS} steps, n={N} L={L}): {launches}")
    want = {"row_fwd": 2 * L + 1, "row_bwd": 2 * L, "row_bwd_const": 1}
    if any(launches[k] != STEPS * v for k, v in want.items()):
        _fail(f"the HEA path did not launch K6/K7/K8 {want} times a step: {launches}")
    w = tct.convert.params(w0, "cpu").requires_grad_()
    for i in range(STEPS):
        e, gw = (t.detach().numpy() for t in step(w))
        e_card, g_card = card_steps[i]
        de = abs(float(e_card) - float(e))
        dg = float(np.abs(g_card - gw).max())
        print(f"HEA step {i}: E card {float(e_card):.7f} cpu {float(e):.7f} |dE| {de:.2e} (tol {ENERGY_ATOL:g}); "
              f"max|dgrad| {dg:.2e} of max|grad| {float(np.abs(gw).max()):.3e} (tol {GRAD_ATOL:g})")
        if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (L, 2, N)):
            _fail("HEA step: non-finite or misshapen result")
        if de > ENERGY_ATOL or dg > GRAD_ATOL:
            _fail(f"HEA step {i} on the card disagrees with the CPU path")
    if not card_steps[-1][0] < card_steps[0][0]:
        _fail(f"{STEPS} HEA SGD steps did not lower the energy")

    # timings: the step, each kernel (the path's variant) and its plain
    # version; K7 also with the lane
    wt = tct.convert.params(w0, dev).requires_grad_()
    step_ms = _time_ms(lambda: step(wt)[0].item(), inner=1)
    prof = _profile(lambda: step(wt)[0].item())
    stage_us = _stage_times(lambda: step(wt)[0].item(), {**K7_STAGES, **K6_STAGES, **K8_STAGES})
    timed = {k: cases[k][0] for k in cases}  # the path runs no lane variant
    with torch.no_grad():
        times = {k: (_time_rounds(v[1]), _time_rounds(v[2], **PLAIN_TIMING)) for k, v in timed.items()}
        lanes = {k: (_time_rounds(cases[k][1][1]), _time_rounds(cases[k][1][2], **PLAIN_TIMING))
                 for k in ("row_fwd", "row_bwd")}
    print(f"HEA training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    host, busy, by_kernel = prof
    print(f"profile HEA step (torch.profiler, 10 runs), {card}: host {host:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; {100 * busy / step_ms:.1f} % of "
          f"the unprofiled {step_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:14]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    # the kernels' own device time a launch on the path (the event timing
    # of back-to-back wrapper calls below also holds the wrapper's host time)
    for kname, stage in (("row_fwd", "fwd_row_pass_kernel<false, true, false>"),
                         ("row_bwd", "gate_row_pass_kernel"), ("row_bwd", "colsum_tree_kernel"),
                         ("row_bwd_const", "fwd_row_pass_kernel<false, true, true>")):
        for name, ms, count in by_kernel:
            if stage in name:
                print(f"device time a launch on the HEA step, {kname} {name[:60]}: {1e3 * ms / count:.2f} us "
                      f"(x{count:g}/step)")
    # K6's, K8's and K7's stages: the plan, and each row pass a launch
    # beside its bound (K8's passes move and compute what K6's do)
    _k6_k8_plan(krl, card, r, nkernel)
    work = _k6_stage_work(r, nkernel)
    for kname, stages, plan, kind in (("K6", K6_STAGES, krl.row_fwd_plan(r, nkernel), "fwd"),
                                      ("K8", K8_STAGES, krl.row_bwd_const_plan(r, nkernel), "const")):
        for label in stages:
            us, per_step = stage_us[label]
            stage = label.removeprefix(f"{kname} ")
            bound, by = _bound_ms(*work[stage])
            print(f"{kname} stage {stage} ({plan[stage.replace(' ', '_')]['bits']} walked bits) at n={N} "
                  f"nkernel={nkernel}, {card}: {us:.2f} us device a launch (torch.profiler over 10 HEA steps, "
                  f"x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it "
                  f"reached; no library call")
        k_us = sum(stage_us[k][0] for k in stages)
        bound, by = _bound_ms(*_row_work(r, nkernel, kind))
        print(f"{kname} a launch at n={N} nkernel={nkernel}, {card}: {k_us:.2f} us device (the passes above); bound "
              f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / k_us:.1f} % of it reached")
    _k7_plan(krl, card, r, nkernel)
    plan = krl.row_bwd_plan(r, nkernel)
    work = _k7_stage_work(r, nkernel)
    k7_us = sum(stage_us[k][0] for k in K7_STAGES)
    bound, by = _bound_ms(*work["row"])
    for label in K7_STAGES:
        us, per_step = stage_us[label]
        bits = plan["row_hi" if label == "row hi" else "row_lo"]["bits"]
        print(f"K7 stage {label} ({bits} walked bits) at n={N} nkernel={nkernel}, {card}: {us:.2f} us device a "
              f"launch (torch.profiler over 10 HEA steps, x{per_step:g} a step)")
    print(f"K7 row stage a launch at n={N} nkernel={nkernel}, {card}: {k7_us:.2f} us device (the passes above); "
          f"bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / k7_us:.1f} % of it reached")
    kind = {"row_fwd": "fwd", "row_bwd": "bwd", "row_bwd_const": "const"}
    replaces = {"row_fwd": 296, "row_bwd": 344, "row_bwd_const": 799}
    # each kernel's device time of a call without the host's launch cost
    # (the event timing below of back-to-back wrapper calls is host-bound
    # at this size); K6 also with the lane
    graphs = {("K6", "no lane"): cases["row_fwd"][0][1], ("K6", "lane"): cases["row_fwd"][1][1],
              ("K7", "no lane"): cases["row_bwd"][0][1], ("K8", "no lane"): cases["row_bwd_const"][0][1]}
    with torch.no_grad():
        graphs = {k: _graph_ms(f) for k, f in graphs.items()}
    for (kname, label), g in graphs.items():
        print(f"{kname} alone [{label}, n={N} nkernel={nkernel}] by a replayed CUDA graph of 10 calls (median of "
              f"3 rounds), {card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    for name, (t, tp) in lanes.items():
        bound, by = _bound_ms(*_row_work(r, nkernel, kind[name], lane=True))
        print(f"kernel {name} [lane, n={N} nkernel={nkernel} r={r}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms (min {tp[1]:.4f}, max "
              f"{tp[2]:.4f}); bound {bound:.4f} ms ({by}); not on the HEA path")
    entries = []
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*_row_work(r, nkernel, kind[name]))
        print(f"kernel {name} [no lane, n={N} nkernel={nkernel} r={r}] over 3 rounds, {card}: median "
              f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms "
              f"(min {tp[1]:.4f}, max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); "
              f"launches {launches[name]} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": "tensorcircuit_ng_tpu_torch/core/csrc/row_layer.cu",
            "replaces": f"tensorcircuit_ng_tpu/core/kernels_rowlayer.py:{replaces[name]}",
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    return entries


#: QAOA: rounds, Adam rate (``optax.adam(0.05)``'s defaults), and the
#: relative spread allowed between the energies of the two forms and the
#: stack path at the start parameters (one function, float32 sums over 2^20
#: amplitudes taken in three orders)
QAOA_P = 4
QAOA_LR = 0.05
QAOA_FORMS_RTOL = 1e-5


def _ml_work(r, lanes, npairs, nrow, L, kind):
    """(bytes, flops) of K9 ("fwd") or K10 ("bwd") at L layers on the
    (r, lanes) planes.  K9 reads two state planes and writes two, reads the
    angles and the L lane planes; per layer and amplitude 2 flops a pair + 6
    for the phase, 6 an rx stage and 8·lanes for the complex lane product.
    K10 reads y and ct and writes ds, reads the lane planes and writes dM;
    per layer and amplitude three complex lane products (un-lane, ct walk,
    dM), 20 flops an rx stage (un-apply, the two dθ sums, the walk) and 4 a
    pair + 9 for the zz stage (exponent, dzz sum, phase walk and
    un-apply)."""
    amps = r * lanes
    mats = L * 2 * 4 * lanes * lanes
    angles = 4 * L * (npairs + nrow)
    if kind == "fwd":
        return 4 * 4 * amps + mats + angles + 8 * npairs, L * amps * (2 * npairs + 6 + 6 * nrow + 8 * lanes)
    return (6 * 4 * amps + 2 * mats + 2 * angles + 8 * npairs,
            L * amps * (3 * 8 * lanes + 20 * nrow + 4 * npairs + 9))


def _ml_stage_work(r, lanes, npairs, nrow):
    """(bytes, flops) of each of K10's stages a layer, by name: the lane
    pair psi = y @ conj(M)^T and w = ct @ M^T (y, ct and M in, psi and w
    out; 16·lanes flops an amplitude), dM = psiᵀ ct (psi and ct in, dM out;
    8·lanes) and the row stage (psi, w, the angles and the pair shifts in,
    x, ds and the layer's gradients out; 20 flops an rx stage, 4 a pair + 9
    for the zz stage).  Their flops add up to :func:`_ml_work`'s K10 total
    over L layers; their bytes to it plus what the stages hand each other."""
    amps, mat = r * lanes, 2 * 4 * lanes * lanes
    grads = 4 * (npairs + nrow)
    return {
        "lane pair": (32 * amps + mat, 16 * lanes * amps),
        "dM": (16 * amps + mat, 8 * lanes * amps),
        "row": (32 * amps + 2 * grads + 8 * npairs, (20 * nrow + 4 * npairs + 9) * amps),
    }


def _k9_stage_work(r, lanes, npairs, nrow):
    """(bytes, flops) of each of K9's stages a layer, by name: the row
    stage (x in, the row stage's output out, the layer's angles in; 2 flops
    a pair + 6 for the phase, 6 an rx stage) and the product (that output
    and M in, y out; 8·lanes).  L layers of them and the pair shifts read
    once a call add up to :func:`_ml_work`'s K9 flops; their bytes to it
    plus what the stages and layers hand each other."""
    amps = r * lanes
    return {
        "row": (16 * amps + 4 * (npairs + nrow), (2 * npairs + 6 + 6 * nrow) * amps),
        "product": (16 * amps + 2 * 4 * lanes * lanes, 8 * lanes * amps),
    }


#: K9's stages on the form (a) step, by kernel name (csrc/adjoint_stages.cuh,
#: csrc/multilayer.cu)
K9_STAGES = {
    "row zz": lambda k: "fwd_row_pass_kernel<true, false, false>" in k,
    "row hi": lambda k: "fwd_row_pass_kernel<false, false, false>" in k,
    "product": lambda k: "wide_nt_kernel<1, false>" in k,
}


def _rotx_work(r, nkernel, kind):
    """(bytes, flops) of K11 ("fwd": two state planes in, two out, 6 flops
    an amplitude a qubit) or K12 ("bwd": y and ct in, ds and dθ out, 20
    flops an amplitude a qubit: un-apply, the two dθ sums, the walk)."""
    amps = r * 128
    if kind == "fwd":
        return 4 * 4 * amps + 4 * nkernel, 6 * nkernel * amps
    return 6 * 4 * amps + 2 * 4 * nkernel, 20 * nkernel * amps


def _k11_stage_work(r, nkernel):
    """(bytes, flops) of each of K11's passes a launch, by name: "row lo"
    (the low 6 walked bits, launched first: two planes in, two out, its
    angles in; 6 flops an amplitude a bit) and "row hi" (the bits past 6,
    in place) where there are two passes.  Their flops add up to
    :func:`_rotx_work`'s K11 flops; their bytes to it plus the planes the
    first pass hands the second."""
    amps = r * 128
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {"row lo": (16 * amps + 4 * lo, 6 * lo * amps)}
    if hi:
        out["row hi"] = (16 * amps + 4 * hi, 6 * hi * amps)
    return out


def _k12_stage_work(r, nkernel):
    """(bytes, flops) of each of K12's stages a launch, by name: the first
    row pass "row hi" (the walked bits past the low 6; y and ct in, psi and
    ct out, its angles in and its dθ partials out; 20 flops an amplitude a
    bit) where there are two passes, the last "row lo" (psi and ct in, ds
    out, the low bits' angles in and partials out) and the partials' sum
    "colsum" (one partial a tile of 2^11 amplitudes and a bit in, dθ out;
    one add each).  Their flops add up to :func:`_rotx_work`'s K12 flops
    plus the colsum's adds; their bytes to it plus the handoffs."""
    amps = r * 128
    ctas = amps // min(amps, 2048)
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {}
    if hi:
        out["row hi"] = (32 * amps + 4 * hi + 4 * ctas * hi, 20 * hi * amps)
    out["row lo"] = (24 * amps + 4 * lo + 4 * ctas * lo, 20 * lo * amps)
    out["colsum"] = (4 * ctas * nkernel + 4 * nkernel, ctas * nkernel)
    return out


def _qaoa_phase(tct, krl, dev, card, counters):
    """Phase 9, the QAOA path (the main path of the QAOA slice): K9-K12
    against their plain versions at the path's shapes; the start energy of
    form (a) under ML_MODE="pallas", form (b) under USE_ROTX and form (a)
    under the default "stack"; 5 Adam steps of each form on the card with
    every kernel's launches read, against the same steps on the CPU; the
    steps timed and profiled, each kernel timed at its path shape (K9 also
    by a replayed CUDA graph), K9's and K10's stages (:func:`_ml_stages`).
    The switches are restored afterwards.  Returns the kernels line's
    entries."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import kernels, kernels_multilayer as kml
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    n = N
    edges, params0 = qaoa_graph(n, QAOA_P)
    npairs = len(edges)
    pairs = tuple((a, b) for a, b, _ in edges)
    nrow = min(n - 7, kml.MAX_ML_ROW_QUBITS)
    lanes, r = 2 ** (n - nrow), 2**nrow
    nk = min(n - 7, krl.MAX_KERNEL_QUBITS_ROTX)
    rng = np.random.default_rng(19)

    def unit_planes(width):
        z = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        return tct.convert.planes(z / np.linalg.norm(z), dev, lanes=width)

    # the path's angles: zz = w·γ_r, rx = 2β_r on every qubit; the lane
    # planes are the transposed rx krons the dispatch builds (unitary)
    p0 = tct.convert.params(params0, dev)
    w = tct.convert.params([x for _, _, x in edges], dev)
    zz = w[None, :] * p0[:QAOA_P, None]
    rx = (2.0 * p0[QAOA_P:, None]).expand(QAOA_P, n).contiguous()
    mr, mi = kst._lane_kron_planes_T(rx[:, nrow:])
    th_row = rx[:, :nrow].contiguous()
    sr, si = unit_planes(lanes)
    ctr, cti = unit_planes(lanes)
    th_k = rx[0, n - 7 - nk:n - 7].contiguous()
    xr, xi = unit_planes(128)
    c2r, c2i = unit_planes(128)
    with torch.no_grad():
        y_ml = kml.ml_fwd_plain(pairs, n, zz, th_row, sr, si, mr, mi)
        y_rx = krl.rotx_fwd_plain(th_k, xr, xi)
    ml = (pairs, n, zz, th_row)
    cases = {
        "ml_fwd": [(f"L={QAOA_P} lanes={lanes}", lambda: kml.ml_fwd(*ml, sr, si, mr, mi),
                    lambda: kml.ml_fwd_plain(*ml, sr, si, mr, mi))],
        "ml_bwd": [(f"L={QAOA_P} lanes={lanes}", lambda: kml.ml_bwd(*ml, *y_ml, ctr, cti, mr, mi),
                    lambda: kml.ml_bwd_plain(*ml, *y_ml, ctr, cti, mr, mi))],
        "rotx_fwd": [(f"nkernel={nk} r={2**(n - 7)}", lambda: krl.rotx_fwd(th_k, xr, xi),
                      lambda: krl.rotx_fwd_plain(th_k, xr, xi))],
        "rotx_bwd": [(f"nkernel={nk} r={2**(n - 7)}", lambda: krl.rotx_bwd(th_k, *y_rx, c2r, c2i),
                      lambda: krl.rotx_bwd_plain(th_k, *y_rx, c2r, c2i))],
    }
    print(f"QAOA kernel parity at n={n}: {npairs} edges, whole-block nrow={nrow}, {lanes} lanes; "
          f"rotx nkernel={nk}")
    max_err = _check_parity(cases, twice=("ml_bwd", "rotx_bwd"))

    forms = {"a": ("zzrx", "pallas", False), "b": ("rzz_rx", "stack", True), "a-stack": ("zzrx", "stack", False)}

    def energy(p, form, device):
        return qaoa_energy(tct, lambda a: tct.convert.params(a, device), n, edges, p, forms[form][0],
                           device=device)

    def use(form):
        kernels.ML_MODE, kernels.USE_ROTX = forms[form][1:]

    def start(device):
        # a copy: on the CPU the tensor would share the numpy start angles,
        # which Adam updates in place
        return tct.convert.params(params0, device).clone().requires_grad_()

    def adam_steps(form, device, steps):
        p = start(device)
        opt = torch.optim.Adam([p], lr=QAOA_LR)
        out = []
        for _ in range(steps):
            e = energy(p, form, device)
            (p.grad,) = torch.autograd.grad(e, p)
            out.append((e.item(), p.grad.cpu().numpy().copy()))
            opt.step()
        return out

    entries, launches = [], {}
    try:
        with torch.no_grad():
            e0 = {}
            for form in forms:
                use(form)
                e0[form] = energy(p0, form, dev).item()
        spread = max(abs(e - e0["a-stack"]) for e in e0.values()) / abs(e0["a-stack"])
        print(f"QAOA n={n} p={QAOA_P} start energy: (a) pallas {e0['a']:.7f}, (b) rotx {e0['b']:.7f}, "
              f"(a) stack {e0['a-stack']:.7f}; relative spread {spread:.2e} (tol {QAOA_FORMS_RTOL:g})")
        if not (np.isfinite(list(e0.values())).all() and spread <= QAOA_FORMS_RTOL):
            _fail("the QAOA forms disagree at the start parameters")

        card_steps = {}
        for form in ("a", "b"):
            use(form)
            for k in counters:
                k.launches = 0
            card_steps[form] = adam_steps(form, dev, STEPS)
            torch.cuda.synchronize()
            launches[form] = {k.__name__: k.launches for k in counters if k.launches}
            print(f"QAOA form ({form}) path launches ({STEPS} Adam steps, n={n} p={QAOA_P}): {launches[form]}")
        want = {"a": {"ml_fwd": STEPS, "ml_bwd": STEPS},
                "b": {"rotx_fwd": QAOA_P * STEPS, "rotx_bwd": QAOA_P * STEPS}}
        if launches != want:
            _fail(f"the QAOA path did not launch {want}: {launches}")
        for form in ("a", "b"):
            use(form)
            cpu = adam_steps(form, "cpu", STEPS)
            for i, ((e_card, g_card), (e, g)) in enumerate(zip(card_steps[form], cpu)):
                de, dg = abs(e_card - e), float(np.abs(g_card - g).max())
                print(f"QAOA form ({form}) step {i}: E card {e_card:.7f} cpu {e:.7f} |dE| {de:.2e} "
                      f"(tol {ENERGY_ATOL:g}); max|dgrad| {dg:.2e} of max|grad| {float(np.abs(g).max()):.3e} "
                      f"(tol {GRAD_ATOL:g})")
                if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (2 * QAOA_P,)):
                    _fail("QAOA step: non-finite or misshapen result")
                if de > ENERGY_ATOL or dg > GRAD_ATOL:
                    _fail(f"QAOA form ({form}) step {i} on the card disagrees with the CPU path")
            if not card_steps[form][-1][0] < card_steps[form][0][0]:
                _fail(f"{STEPS} Adam steps of QAOA form ({form}) did not lower the cost")

        # timings: each form's step (value, grad, Adam update), profiled
        step_ms = {}
        for form in ("a", "b"):
            use(form)
            p = start(dev)
            opt = torch.optim.Adam([p], lr=QAOA_LR)

            def step():
                e = energy(p, form, dev)
                (p.grad,) = torch.autograd.grad(e, p)
                opt.step()
                return e.item()

            step_ms[form] = _time_ms(step, inner=1)
            host, busy, by_kernel = _profile(step)
            print(f"QAOA form ({form}) training step n={n} p={QAOA_P} (value, grad, Adam update; CUDA "
                  f"events, ends in .item()), {card}: {step_ms[form]:.3f} ms (median of 20)")
            print(f"profile QAOA form ({form}) step (torch.profiler, 10 runs), {card}: host {host:.3f} ms "
                  f"under the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
                  f"{100 * busy / step_ms[form]:.1f} % of the unprofiled {step_ms[form]:.3f} ms), "
                  f"{len(by_kernel)} kernel names")
            for name, ms, count in by_kernel[:12]:
                print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
            # the kernels' own device time a launch on the step, stage by stage
            stages = {"a": ("fwd_row_pass_kernel", "transpose_kernel", "wide_nt_kernel<1, false>",
                            "ml_pair_records_kernel", "wide_nt_kernel<2, true>", "wide_dm_kernel", "colsum_kernel",
                            "ml_row_pass_kernel<false>", "ml_row_pass_kernel<true>", "colsum_tree_kernel"),
                      "b": ("fwd_row_pass_kernel<false, false, false>", "ml_row_pass_kernel<false>",
                            "rx_row_pass_kernel", "colsum_tree_kernel")}[form]
            for stage in stages:
                for name, ms, count in by_kernel:
                    if stage in name:
                        print(f"device time a launch on the QAOA form ({form}) step, {name[:60]}: "
                              f"{1e3 * ms / count:.2f} us (x{count:g}/step)")
            if form == "a":
                stage_us = _stage_times(step, {
                    "lane pair": lambda k: "wide_nt_kernel<2, true>" in k,
                    "dM+colsum": lambda k: "wide_dm_kernel" in k,
                    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
                    "row lo": lambda k: "ml_row_pass_kernel<true>" in k,
                    "row sums": lambda k: "colsum_tree_kernel" in k,
                    **{f"K9 {k}": v for k, v in K9_STAGES.items()},
                })
            else:
                k12_us = _stage_times(step, {**K12_STAGES, **K11_STAGES})
    finally:
        kernels.ML_MODE, kernels.USE_ROTX = "stack", False

    with torch.no_grad():
        times = {k: (_time_rounds(v[0][1]), _time_rounds(v[0][2], **PLAIN_TIMING)) for k, v in cases.items()}
        k9_graph = _graph_ms(cases["ml_fwd"][0][1])
        k11_graph = _graph_ms(cases["rotx_fwd"][0][1])
        k12_graph = _graph_ms(cases["rotx_bwd"][0][1])
    for kname, label, g in (("K9", f"L={QAOA_P} lanes={lanes}", k9_graph), ("K11", f"nkernel={nk}", k11_graph),
                            ("K12", f"nkernel={nk}", k12_graph)):
        print(f"{kname} alone [{label}, n={n}] by a replayed CUDA graph of 10 calls (median of 3 rounds), "
              f"{card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    _ml_stages(kml, card, stage_us, y_ml, (ctr, cti), (mr, mi), npairs, nrow)
    _k11_stages(krl, card, {k: k12_us[k] for k in K11_STAGES}, 2 ** (n - 7), nk)
    _k12_stages(krl, card, {k: k12_us[k] for k in K12_STAGES}, 2 ** (n - 7), nk)
    work = {
        "ml_fwd": _ml_work(r, lanes, npairs, nrow, QAOA_P, "fwd"),
        "ml_bwd": _ml_work(r, lanes, npairs, nrow, QAOA_P, "bwd"),
        "rotx_fwd": _rotx_work(2 ** (n - 7), nk, "fwd"),
        "rotx_bwd": _rotx_work(2 ** (n - 7), nk, "bwd"),
    }
    source = {"ml_fwd": "multilayer", "ml_bwd": "multilayer", "rotx_fwd": "row_layer", "rotx_bwd": "row_layer"}
    replaces = {"ml_fwd": "kernels_multilayer.py:326", "ml_bwd": "kernels_multilayer.py:358",
                "rotx_fwd": "kernels_rowlayer.py:650", "rotx_bwd": "kernels_rowlayer.py:680"}
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*work[name])
        n_launch = launches["a" if name.startswith("ml") else "b"][name]
        print(f"kernel {name} [{cases[name][0][0]}, n={n}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms (min {tp[1]:.4f}, "
              f"max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); launches {n_launch} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{source[name]}.cu",
            "replaces": f"tensorcircuit_ng_tpu/core/{replaces[name]}", "launches": n_launch,
            "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0], "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    return entries


#: K12's stages on the form (b) step, by kernel name (csrc/adjoint_stages.cuh)
K12_STAGES = {
    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
    "row lo": lambda k: "rx_row_pass_kernel" in k,
    "colsum": lambda k: "colsum_tree_kernel" in k,
}


def _k11_stages(krl, card, stage_us, r, nkernel):
    """K11's passes at the QAOA form (b) path's shape: the plan as the card
    reports it against ``rotx_fwd_plan``, nvcc's registers and spills of
    its pass kernel in the row_layer build (a spill fails), and each pass's
    device time a launch on the form (b) step (``stage_us``) beside its
    bound (no one PyTorch call computes a pass)."""
    _plan_check(f"K11 at n={N} nkernel={nkernel}", card, krl.rotx_fwd_card_plan(r, nkernel),
                krl.rotx_fwd_plan(r, nkernel))
    _ptxas_check("row_layer", (K11_PASS,))
    plan = krl.rotx_fwd_plan(r, nkernel)
    work = _k11_stage_work(r, nkernel)
    for label, (us, per_step) in stage_us.items():
        stage = label.removeprefix("K11 ")
        bound, by = _bound_ms(*work[stage])
        print(f"K11 stage {stage} ({plan[stage.replace(' ', '_')]['bits']} walked bits) at n={N} nkernel={nkernel}, "
              f"{card}: {us:.2f} us device a launch (torch.profiler over 10 form (b) steps, x{per_step:g} a "
              f"step); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; "
              f"no library call")
    total = sum(v[0] for v in stage_us.values())
    bound, by = _bound_ms(*_rotx_work(r, nkernel, "fwd"))
    print(f"K11 a launch at n={N} nkernel={nkernel}, {card}: {total:.2f} us device (the passes above); bound "
          f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


def _k12_stages(krl, card, stage_us, r, nkernel):
    """K12's passes at the QAOA form (b) path's shape: the plan as the card
    reports it, each record equal to ``rotx_bwd_plan``'s and without local
    memory; nvcc's registers and spills of its passes in the row_layer
    build (a spill fails); each stage's device time a launch on the form
    (b) step (``stage_us``, from :func:`_stage_times`) beside its bound (no
    one PyTorch call computes a stage)."""
    _plan_check(f"K12 at n={N} nkernel={nkernel}", card, krl.rotx_bwd_card_plan(r, nkernel),
                krl.rotx_bwd_plan(r, nkernel))
    _ptxas_check("row_layer", ("ml_row_pass_kernel", "rx_row_pass_kernel", "colsum_tree_kernel"))
    work = _k12_stage_work(r, nkernel)
    total = 0.0
    for stage, (us, per_step) in stage_us.items():
        total += us
        bound, by = _bound_ms(*work[stage])
        print(f"K12 stage {stage} at n={N} nkernel={nkernel}, {card}: {us:.2f} us device a launch (torch.profiler "
              f"over 10 form (b) steps, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; no library call")
    bound, by = _bound_ms(*_rotx_work(r, nkernel, "bwd"))
    print(f"K12 a launch at n={N} nkernel={nkernel}, {card}: {total:.2f} us device (the stages above); bound "
          f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


#: K9's and K10's widths whose plan phase 9 prints (nrow = 12: n = 19..22)
ML_PLAN_LANES = (128, 256, 512, 1024)


def _ml_stages(kml, card, stage_us, y, ct, m, npairs, nrow):
    """K9's and K10's stages at the QAOA path's shape: the plan at every
    width of ``ML_PLAN_LANES`` (each stage kernel's CTAs, threads, shared
    bytes, CTAs an SM, registers and local bytes; a spill fails; K9's
    records equal to ``ml_fwd_plan``'s), each stage's device time a layer on
    the form (a) step (``stage_us``, from :func:`_stage_times`) beside its
    bound, and one PyTorch call computing each product on the same operands
    (K9's on operands of its shapes; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    r, lanes = y[0].shape
    for w in ML_PLAN_LANES:
        plan = kml.ml_plan(2**nrow, w, nrow, npairs)
        for stage, p in plan.items():
            print(f"K9/K10 plan at nrow={nrow} lanes={w} (n={nrow + w.bit_length() - 1}), {stage}, {card}: {p}")
            if p["local_bytes"]:
                _fail(f"K9/K10 stage {stage} uses local memory at lanes={w}: {p}")
        for stage, p in kml.ml_fwd_plan(2**nrow, w, nrow, npairs).items():
            if any(plan[stage][k] != v for k, v in p.items()):
                _fail(f"K9 stage {stage} at lanes={w}: card plan {plan[stage]}, Python plan {p}")
    _ptxas_check("multilayer", ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel", "ml_pair_records_kernel",
                                "fwd_row_pass_kernel"))
    # the products' operands as complex matrices, built outside the timed calls
    yc, cc = torch.complex(*y), torch.complex(*ct)
    mc = torch.complex(m[0][0], m[1][0])
    a2 = torch.stack([yc, cc])
    b2 = torch.stack([mc.conj().T, mc.T]).contiguous()
    psi = yc @ b2[0]
    # K9's product on operands of its shapes: (r, lanes) @ (lanes, lanes)
    library = {"lane pair": lambda: torch.matmul(a2, b2), "dM": lambda: torch.matmul(psi.T, cc),
               "K9 product": lambda: torch.matmul(yc, mc)}
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    n = r.bit_length() - 1 + lanes.bit_length() - 1
    for kname, work, rows in (
        ("K10", _ml_stage_work(r, lanes, npairs, nrow),
         {"lane pair": ["lane pair"], "dM": ["dM+colsum"], "row": ["row hi", "row lo", "row sums"]}),
        ("K9", {f"K9 {k}": v for k, v in _k9_stage_work(r, lanes, npairs, nrow).items()},
         {"K9 row": ["K9 row zz", "K9 row hi"], "K9 product": ["K9 product"]}),
    ):
        for stage, labels in rows.items():
            us = sum(stage_us[k][0] for k in labels)
            per_step = stage_us[labels[0]][1]
            bound, by = _bound_ms(*work[stage])
            lm = lib_ms.get(stage)
            lib = (f"library call {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min "
                   f"{1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
            parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
            print(f"{kname} stage {stage.removeprefix('K9 ')} at n={n} lanes={lanes}, {card}: {us:.2f} us device "
                  f"a layer ({parts}; torch.profiler over 10 form (a) steps, x{per_step:g} a step); bound "
                  f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; {lib}")


#: the FUSE_ROWM step against the default card path from the same
#: parameters (one function, float32 sums in another order)
ROWM_ATOL = 1e-4
#: the switch settings of the stack (module globals of kernels_stack) and
#: the launches a value-and-grad at n=20, L=4 should give under each
SWITCHES = {
    "default": ({}, {"zzrx_fwd": 0, "grand_zzrx_fwd": 1, "zzrx_bwd": 0, "grand_zzrx_bwd": 1}),
    "FUSE_GRAND=False": ({"FUSE_GRAND": False},
                         {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": 0, "grand_zzrx_bwd": 1}),
    "FUSE_GRAND_BWD=False": ({"FUSE_GRAND_BWD": False},
                             {"zzrx_fwd": 0, "grand_zzrx_fwd": 1, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "both False": ({"FUSE_GRAND": False, "FUSE_GRAND_BWD": False},
                   {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "FUSE_LANE=False": ({"FUSE_LANE": False},
                        {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "FUSE_ROWM=True": ({"FUSE_ROWM": True},
                       {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0,
                        "rowm_fwd": L, "rowm_bwd": L}),
}


def _tfim_step(tct, p, device, nl=L, n=N):
    """The TFIM value and grad of the training path: h_layer, nl
    zzrx_layers, the open-chain ZZ - X energy."""
    import torch

    pairs = [(i, i + 1) for i in range(n - 1)]
    c = tct.Circuit(n, device=device)
    c.h_layer()
    for l in range(nl):
        c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
    e = c.expectation_zzx_energy(pairs, 1.0, -1.0)
    (g,) = torch.autograd.grad(e, p)
    return e, g


def _rowm_phase(tct, krl, kst, dev, card, counters):
    """Phase 10, the FUSE_ROWM path (the main path of the row-kron slice):
    K1 and K3 with the row kron M7 (stages K13/K14, rmx=7) against their
    plain versions at the path's n=20 shapes (K3 twice, equal bit for bit);
    5 SGD steps of the TFIM step at n=20, L=4 under ``FUSE_ROWM = True``
    against the default card path (K2/K4) and the port's CPU path, with
    every kernel's launches read; the value and grad at the start point
    under each switch setting with its launches; K1/K3 with M7 timed with
    their bounds, the step timed under each setting and profiled under
    FUSE_ROWM, K13/K14 and K1's stages (:func:`_k1_stages`) a launch on
    it.  The switches are restored afterwards.  Returns the kernels line's
    entries."""
    import torch

    nrow, nkernel, nouter, _ = kst._shapes(N)
    rmx = kst._rowm_qubits(nkernel)
    R, r = 2**rmx, 2**nrow
    pairs = tuple(PAIRS)
    rng = np.random.default_rng(23)

    def unit_planes():
        z = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
        return tct.convert.planes(z / np.linalg.norm(z), dev)

    # the path's operands: unitary rx krons M7 (top rmx kernel bits) and lane
    zz = torch.as_tensor(rng.normal(size=N - 1) * 0.4, dtype=torch.float32, device=dev)
    rx = torch.as_tensor(rng.normal(size=(1, N)) * 0.4, dtype=torch.float32, device=dev)
    th = rx[0, nouter:nrow].contiguous()
    m7r, m7i = (m[0] for m in kst._rx_kron_planes(rx[:, nouter:nouter + rmx]))
    mlr, mli = (m[0] for m in kst._lane_kron_planes_T(rx[:, nrow:]))
    sr, si = unit_planes()
    ctr, cti = unit_planes()
    with torch.no_grad():
        y = krl.zzrx_fwd_plain(pairs, N, zz, th, sr, si, mlr, mli, m7r, m7i)
        y0 = krl.zzrx_fwd_plain(pairs, N, zz, th, sr, si, None, None, m7r, m7i)
    f_lane = (pairs, N, zz, th, sr, si, mlr, mli, m7r, m7i)
    f_bare = (pairs, N, zz, th, sr, si, None, None, m7r, m7i)
    b_lane = (pairs, N, zz, th, *y, ctr, cti, mlr, mli, m7r, m7i)
    b_bare = (pairs, N, zz, th, *y0, ctr, cti, None, None, m7r, m7i)
    cases = {
        "rowm_fwd": [
            ("lane", lambda: krl.rowm_fwd(pairs, N, zz, th, sr, si, m7r, m7i, mlr, mli),
             lambda: krl.zzrx_fwd_plain(*f_lane)),
            ("no lane", lambda: krl.rowm_fwd(pairs, N, zz, th, sr, si, m7r, m7i),
             lambda: krl.zzrx_fwd_plain(*f_bare)),
        ],
        "rowm_bwd": [
            ("lane", lambda: krl.rowm_bwd(pairs, N, zz, th, *y, ctr, cti, m7r, m7i, mlr, mli),
             lambda: krl.zzrx_bwd_plain(*b_lane)),
            ("no lane", lambda: krl.rowm_bwd(pairs, N, zz, th, *y0, ctr, cti, m7r, m7i),
             lambda: krl.zzrx_bwd_plain(*b_bare)),
        ],
    }
    print(f"row-kron parity at n={N}: r={r}, nkernel={nkernel}, rmx={rmx} (M7 {R}x{R}), "
          f"{nkernel - rmx} butterfly bits")
    max_err = _check_parity(cases, twice=("rowm_bwd",))

    defaults = {name: getattr(kst, name) for name in ("FUSE_LANE", "FUSE_ROWM", "FUSE_GRAND", "FUSE_GRAND_BWD")}

    def use(**flags):
        for name, value in {**defaults, **flags}.items():
            setattr(kst, name, value)

    p0 = np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1

    def sgd_steps(device, steps, **flags):
        use(**flags)
        p = tct.convert.params(p0, device).requires_grad_()
        out = []
        for _ in range(steps):
            e, g = _tfim_step(tct, p, device)
            out.append((e.item(), g.cpu().numpy()))
            with torch.no_grad():
                p.sub_(LR * g)
        return out

    entries = []
    try:
        for k in counters:
            k.launches = 0
        rowm_steps = sgd_steps(dev, STEPS, FUSE_ROWM=True)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in counters if k.launches}
        print(f"FUSE_ROWM path launches ({STEPS} SGD steps, n={N} L={L}): {launches}")
        want = {"zzrx_fwd": L * STEPS, "zzrx_bwd": L * STEPS, "rowm_fwd": L * STEPS, "rowm_bwd": L * STEPS}
        if launches != want:
            _fail(f"the FUSE_ROWM path did not launch {want}: {launches}")
        default_steps = sgd_steps(dev, STEPS)
        cpu_steps = sgd_steps("cpu", STEPS, FUSE_ROWM=True)
        for i, ((e, g), (ed, gd), (ec, gc)) in enumerate(zip(rowm_steps, default_steps, cpu_steps)):
            dd, gdd = abs(e - ed), float(np.abs(g - gd).max())
            dc, gdc = abs(e - ec), float(np.abs(g - gc).max())
            print(f"FUSE_ROWM step {i}: E {e:.7f}, default card {ed:.7f} |dE| {dd:.2e} max|dgrad| {gdd:.2e} "
                  f"(tol {ROWM_ATOL:g}); cpu {ec:.7f} |dE| {dc:.2e} max|dgrad| {gdc:.2e} (tol {ENERGY_ATOL:g}, "
                  f"{GRAD_ATOL:g}); max|grad| {float(np.abs(gc).max()):.3e}")
            if not (np.isfinite(e) and np.all(np.isfinite(g)) and g.shape == (L, 2, N)):
                _fail("FUSE_ROWM step: non-finite or misshapen result")
            if dd > ROWM_ATOL or gdd > ROWM_ATOL:
                _fail(f"FUSE_ROWM step {i} disagrees with the default card path")
            if dc > ENERGY_ATOL or gdc > GRAD_ATOL:
                _fail(f"FUSE_ROWM step {i} on the card disagrees with the CPU path")
        if not rowm_steps[-1][0] < rowm_steps[0][0]:
            _fail(f"{STEPS} FUSE_ROWM SGD steps did not lower the energy")

        # the start point under each switch setting, with its launches
        base = None
        for label, (flags, want) in SWITCHES.items():
            for k in counters:
                k.launches = 0
            (e, g), = sgd_steps(dev, 1, **flags)
            torch.cuda.synchronize()
            got = {k.__name__: k.launches for k in counters if k.launches}
            want = {k: v for k, v in want.items() if v}
            base = base or (e, g)
            de, dg = abs(e - base[0]), float(np.abs(g - base[1]).max())
            print(f"switches {label}: E {e:.7f} |dE| {de:.2e} max|dgrad| {dg:.2e} vs default "
                  f"(tol {ROWM_ATOL:g}); launches {got}")
            if got != want:
                _fail(f"switches {label}: launches {got}, expected {want}")
            if de > ROWM_ATOL or dg > ROWM_ATOL:
                _fail(f"switches {label}: value or grad differs from the default")

        # timings: the step under each switch setting (FUSE_ROWM last, then
        # profiled), K1 and K3 with M7 at the path's shape
        pt = tct.convert.params(p0, dev).requires_grad_()

        def step():
            e, g = _tfim_step(tct, pt, "cuda")
            with torch.no_grad():
                pt.sub_(LR * g)
            return e.item()

        for label, (flags, _) in SWITCHES.items():
            use(**flags)
            step_ms = _time_ms(step, inner=1)
            print(f"training step n={N} L={L} under switches {label} (CUDA events, ends in .item()), {card}: "
                  f"{step_ms:.3f} ms (median of 20)")
        host, busy, by_kernel = _profile(step)
        # K1's stages but K13 (its row stage walks nkernel - rmx = 3 bits:
        # one pass), K13 and K14
        k1_stages = {k: K1_STAGES[k] for k in _k1_stage_work(r, len(pairs), nkernel, True, rmx) if k in K1_STAGES}
        stage_us = _stage_times(step, {
            **k1_stages,
            "K13": lambda s: f"rowm_apply_kernel<{R}, false>" in s,
            "K14a": lambda s: f"rowm_apply_kernel<{R}, true>" in s,
            "K14b+colsum": lambda s: f"rowm_dm_kernel<{R}>" in s,
        })
    finally:
        use()
    print(f"FUSE_ROWM training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    print(f"profile FUSE_ROWM step (torch.profiler, 10 runs), {card}: host {host:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; {100 * busy / step_ms:.1f} % of the "
          f"unprofiled {step_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:14]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    for stage in ("fwd_row_pass_kernel<true, false, false>", f"rowm_apply_kernel<{R}, false>", "transpose_kernel",
                  "wide_nt_kernel<1, false>", "ml_pair_records_kernel", "wide_nt_kernel<2, true>", "wide_dm_kernel",
                  f"rowm_apply_kernel<{R}, true>", f"rowm_dm_kernel<{R}>", "ml_row_pass_kernel<true>",
                  "colsum_kernel", "colsum_tree_kernel"):
        for name, ms, count in by_kernel:
            if stage in name:
                print(f"device time a launch on the FUSE_ROWM step, {stage}: {1e3 * ms / count:.2f} us "
                      f"(x{count:g}/step)")
    with torch.no_grad():
        times = {k: (_time_rounds(v[0][1]), _time_rounds(v[0][2], **PLAIN_TIMING)) for k, v in cases.items()}
    _rowm_stages(krl, card, stage_us, y, ctr, cti, m7r, m7i, nkernel, rmx, r)
    _k1_stages(krl, card, stage_us, y, (mlr, mli), len(pairs), nkernel, rmx, "FUSE_ROWM steps")
    work = {"rowm_fwd": _k1_work(r, len(pairs), nkernel, True, rmx),
            "rowm_bwd": _k3_work(r, len(pairs), nkernel, True, rmx)}
    source = {"rowm_fwd": "zzrx_fwd.cu", "rowm_bwd": "zzrx_bwd.cu"}
    replaces = {"rowm_fwd": 966, "rowm_bwd": 979}
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*work[name])
        print(f"kernel {name} [K{'1' if name == 'rowm_fwd' else '3'} with M7 and the lane, n={N} rmx={rmx}] "
              f"over 3 rounds, {card}: median {t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f}); plain median "
              f"{tp[0]:.4f} ms (min {tp[1]:.4f}, max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); "
              f"launches {launches[name]} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{source[name]}",
            "replaces": f"tensorcircuit_ng_tpu/core/kernels_rowlayer.py:{replaces[name]}",
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    return entries


def _rowm_stages(krl, card, stage_us, y, ctr, cti, m7r, m7i, nkernel, rmx, r):
    """The row-kron stages at the path's shape: their plan (tile, grid,
    shared bytes, CTAs an SM, registers and spills; a spill at R=128
    fails), each stage's device time a launch on the FUSE_ROWM step
    (``stage_us``, from :func:`_stage_times`), its bound, and one PyTorch
    call computing the same product on operands of the same shapes (the
    port never calls it; ``allow_tf32`` is False)."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import _build

    R = 2**rmx
    plan = krl.rowm_plan(rmx, r)
    for stage, p in (("K13", plan["fwd"]), ("K14a", plan["bwd"]), ("K14b dM7", plan["dm"])):
        print(f"row-kron plan {stage} at R={R}, r={r}, {card}: {p}")
    for lib, needle in (("zzrx_fwd", f"rowm_apply_kernelILi{R}ELb0E"), ("zzrx_bwd", f"rowm_apply_kernelILi{R}ELb1E"),
                        ("zzrx_bwd", f"rowm_dm_kernelILi{R}E")):
        report = _ptxas_report(_build.build_log(lib), needle)
        if len(report) != 1:
            _fail(f"ptxas report of {needle}: {report}")
        (name, (regs, st, ld)), = report.items()
        print(f"ptxas {needle}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
        if regs is None or st or ld:
            _fail(f"{needle} spills or has no register count at R={R}")
    for key in ("fwd", "bwd", "dm"):
        if plan[key]["local_bytes"]:
            _fail(f"row-kron stage {key} uses local memory at R={R}: {plan[key]}")
    for m in range(1, krl.MAX_ROWM_QUBITS + 1):  # every instantiation the stack can take
        p = krl.rowm_plan(m, r)
        print(f"row-kron stages at R={2**m}: " + "; ".join(
            f"{k} {v['registers']} registers, {v['local_bytes']} B local, {v['ctas_per_sm']} CTAs an SM, "
            f"{v['smem']} B shared" for k, v in zip(("K13", "K14a", "K14b"), p.values())))
    # the stages' operands as complex (B, R, C) views, built outside the timed calls
    view = lambda p_r, p_i: torch.reshape(
        krl._rowm_view(torch.complex(p_r, p_i), nkernel, R), (r >> nkernel, R, -1))
    xc = view(*y)
    cc = view(ctr, cti)
    m7 = torch.complex(m7r, m7i)
    a14 = torch.stack([m7.conj().T, m7.T]).unsqueeze(1).contiguous()
    yc = torch.stack([xc, cc])
    library = {
        "K13": lambda: torch.matmul(m7, xc),
        "K14a": lambda: torch.matmul(a14, yc),
        "K14b": lambda: torch.einsum("bic,bjc->ij", cc, xc),
    }
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    work = _rowm_stage_work(r, rmx)
    for stage in ("K13", "K14a", "K14b"):
        us, per_call = stage_us[stage if stage != "K14b" else "K14b+colsum"]
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms[stage]
        print(f"stage {stage}{' (with its colsum)' if stage == 'K14b' else ''} at n={N} R={R}, {card}: "
              f"{us:.2f} us device a launch (torch.profiler over 10 FUSE_ROWM steps, x{per_call:g} a step); "
              f"bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; library call "
              f"{1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min {1e3 * lm[1]:.2f}, "
              f"max {1e3 * lm[2]:.2f}); {8 * 2**rmx * (2 if stage == 'K14a' else 1)} flops an amplitude")


def _micro_work(level, n, nl):
    """(bytes, flops) of K15 at ``level`` over nl layers: the state planes in
    once and out once (m2/m3 also the lane and outer planes and the angles
    in); per layer and amplitude 6 flops a butterfly (10) and 8·128 for the
    lane product (m2, m3), 8·D for the outer product (m3)."""
    amps = 2**n
    d = 2 ** (n - 17)
    nbytes = 4 * 4 * amps
    if level == 1:
        return nbytes, 0
    nbytes += nl * 4 * (2 * 128 * 128 + 20) + (nl * 2 * 4 * d * d if level == 3 else 0)
    return nbytes, nl * amps * (6 * 10 + 8 * 128 + (8 * d if level == 3 else 0))


def _micro_phase(tct, dev, card):
    """Phase 11, the staged micro-benchmark of K2's design: K15 at m1, m2
    and m3 against its plain version on the example's n=20, L=4 inputs,
    then each level timed by ``run_micro`` (250 back-to-back calls) with
    its bound.  Returns the kernels line's entry (the m3 level, the whole
    skeleton)."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    args = km.micro_inputs(dev)
    cases = {"micro_grand": [
        (f"m{lv}", lambda lv=lv: km.micro_grand(lv, *args), lambda lv=lv: km.micro_grand_plain(lv, *args))
        for lv in (1, 2, 3)]}
    print(f"micro-benchmark parity at n={km.N}, L={km.L}: blocks of {km.RB} rows, random non-unitary inputs")
    max_err = _check_parity(cases)
    km.micro_grand.launches = 0
    ms = {lv: km.run_micro(lv) for lv in (1, 2, 3)}
    torch.cuda.synchronize()
    launches = km.micro_grand.launches
    with torch.no_grad():
        plain = {lv: _time_ms(lambda lv=lv: km.micro_grand_plain(lv, *args), **PLAIN_TIMING) for lv in (1, 2, 3)}
    for lv in (1, 2, 3):
        bound, by = _bound_ms(*_micro_work(lv, km.N, km.L))
        print(f"kernel micro_grand m{lv} (run_micro: best of 3 x {km.K} back-to-back calls, L={km.L} layers), "
              f"{card}: {ms[lv]:.4f} ms a call; plain {plain[lv]:.4f} ms; bound {bound:.4f} ms ({by})")
    print(f"micro_grand launches in run_micro (3 levels x (1 + 3 x {km.K})): {launches}")
    if launches != 3 * (1 + 3 * km.K):
        _fail(f"run_micro did not launch K15 {3 * (1 + 3 * km.K)} times: {launches}")
    bound, by = _bound_ms(*_micro_work(3, km.N, km.L))
    return [{
        "name": "micro_grand", "route": "cuda", "source": "tensorcircuit_ng_tpu_torch/core/csrc/micro_grand.cu",
        "replaces": "examples/micro_grand_fusion.py:132", "launches": launches,
        "max_abs_err": max_err["micro_grand"], "ms": ms[3], "plain_ms": plain[3], "bound_ms": bound,
        "bound_by": by, "library_ms": None,
    }]


def main() -> int:
    import torch

    t_start = time.time()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tensorcircuit_ng_tpu_torch as tct
    from tensorcircuit_ng_tpu_torch.core import _build
    from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    if not os.path.abspath(tct.__file__).startswith(here + os.sep):
        _fail(f"imported the port from {tct.__file__}, not from this checkout")
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tensorcircuit_ng_tpu."))]
    if bad or "tensorcircuit_ng_tpu" in sys.modules:
        _fail(f"JAX modules imported: {bad}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    built = _build.build_all()
    build_s = time.time() - t0
    card = _card()
    print(f"build: {build_s:.2f} s for {built or 'nothing (cached)'} in {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    print(f"phase 1 ended at {time.time() - t_start:.1f} s")

    # ---- 2. kernel parity at the n=20 shapes -----------------------------
    nrow, nkernel, nouter, _ = kst._shapes(N)
    r = 2**nrow
    rng = np.random.default_rng(7)
    psi = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
    psi /= np.linalg.norm(psi)
    sr, si = tct.convert.planes(psi, dev)
    zz = torch.as_tensor(rng.normal(size=(L, N - 1)) * 0.4, dtype=torch.float32, device=dev)
    # unitary rx krons: the backward kernels rebuild states by un-application
    rx = torch.as_tensor(rng.normal(size=(L, N)) * 0.4, dtype=torch.float32, device=dev)
    mor, moi = kst._rx_kron_planes(rx[:, :nouter])
    mlr, mli = kst._lane_kron_planes_T(rx[:, nrow:])
    thk = rx[:, nouter:nrow].contiguous()
    pairs = tuple(PAIRS)
    with torch.no_grad():
        # backward inputs: the forward's residuals and a seeded cotangent
        ksr, ksi, _, _ = kg.grand_zzrx_fwd(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli)
    ctr, cti = tct.convert.planes(rng.normal(size=2**N) + 1j * rng.normal(size=2**N), dev)
    ctr, cti = ctr / 2 ** (N / 2), cti / 2 ** (N / 2)
    k4 = {nl: (pairs, N, zz[:nl], thk[:nl], ksr[:nl], ksi[:nl], ctr, cti,
               mor[:nl], moi[:nl], mlr[:nl], mli[:nl]) for nl in (L, 3)}
    # K3's main-path shape: the n=22 step (nrow=15, past the grand path)
    # takes K3 with the lane matrix once a layer, on a K1-fused residual
    nrow22, nkernel22, nouter22, _ = kst._shapes(N22)
    r22 = 2**nrow22
    pairs22 = tuple((i, i + 1) for i in range(N22 - 1))
    psi22 = rng.normal(size=2**N22) + 1j * rng.normal(size=2**N22)
    s22r, s22i = tct.convert.planes(psi22 / np.linalg.norm(psi22), dev)
    zz22 = torch.as_tensor(rng.normal(size=N22 - 1) * 0.4, dtype=torch.float32, device=dev)
    rx22 = torch.as_tensor(rng.normal(size=(1, N22)) * 0.4, dtype=torch.float32, device=dev)
    ml22r, ml22i = (m[0] for m in kst._lane_kron_planes_T(rx22[:, nrow22:]))
    th22 = rx22[0, nouter22:nrow22].contiguous()
    with torch.no_grad():
        k22r, k22i = krl.zzrx_fwd(pairs22, N22, zz22, th22, s22r, s22i, ml22r, ml22i)
    c22r, c22i = tct.convert.planes(rng.normal(size=2**N22) + 1j * rng.normal(size=2**N22), dev)
    c22r, c22i = c22r / 2 ** (N22 / 2), c22i / 2 ** (N22 / 2)
    k3_22 = (pairs22, N22, zz22, th22, k22r, k22i, c22r, c22i, ml22r, ml22i)
    k1_22 = (pairs22, N22, zz22, th22, s22r, s22i, ml22r, ml22i)
    cases = {
        "zzrx_fwd": [
            ("no lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si)),
            ("lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0]),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0])),
            (f"lane n={N22}", lambda: krl.zzrx_fwd(*k1_22), lambda: krl.zzrx_fwd_plain(*k1_22)),
        ],
        "grand_zzrx_fwd": [
            (f"L={L}", lambda: kg.grand_zzrx_fwd(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli),
             lambda: kg.grand_zzrx_fwd_plain(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli)),
        ],
        "zzrx_bwd": [
            ("no lane", lambda: krl.zzrx_bwd(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti),
             lambda: krl.zzrx_bwd_plain(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti)),
            ("lane", lambda: krl.zzrx_bwd(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti, mlr[0], mli[0]),
             lambda: krl.zzrx_bwd_plain(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti, mlr[0], mli[0])),
            (f"lane n={N22}", lambda: krl.zzrx_bwd(*k3_22), lambda: krl.zzrx_bwd_plain(*k3_22)),
        ],
        "grand_zzrx_bwd": [
            (f"L={nl}", lambda nl=nl: kg.grand_zzrx_bwd(*k4[nl]),
             lambda nl=nl: kg.grand_zzrx_bwd_plain(*k4[nl]))
            for nl in (L, 3)
        ],
    }
    s_in = (sr.clone(), si.clone(), s22r.clone(), s22i.clone())
    max_err = _check_parity(cases, twice=("zzrx_fwd", "grand_zzrx_fwd", "zzrx_bwd", "grand_zzrx_bwd"))
    if not all(torch.equal(a, b) for a, b in zip(s_in, (sr, si, s22r, s22i))):
        _fail("K1 or K2 wrote its input planes")
    # K1 alone by a replayed CUDA graph (with the lane, without it, and at
    # n=22, K1's shape on the n=22 step), and one torch.matmul of the
    # product's shapes at n=22 (never called by the port)
    with torch.no_grad():
        k1_graph = {label: _graph_ms(kern) for label, kern, _ in cases["zzrx_fwd"]}
        x22c, m22c = torch.complex(s22r, s22i), torch.complex(ml22r, ml22i)
        k1_lib22 = _graph_ms(lambda: torch.matmul(x22c, m22c))
    for label, g in k1_graph.items():
        print(f"K1 alone [{label}{'' if 'n=' in label else f', n={N}'}] by a replayed CUDA graph of 10 calls (median "
              f"of 3 rounds), {card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    print(f"K1's product at n={N22}: library call torch.matmul {1e3 * k1_lib22[0]:.2f} us (CUDA graph of 10 calls, "
          f"median of 3 rounds, min {1e3 * k1_lib22[1]:.2f}, max {1e3 * k1_lib22[2]:.2f}), {card}")

    print(f"phase 2 ended at {time.time() - t_start:.1f} s")

    # ---- 3. the forward path through the public API ----------------------
    def circuit_energy(params, nl, device, n=N):
        pp = [(i, i + 1) for i in range(n - 1)]
        c = tct.Circuit(n, device=device)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(pp, params[l, 0, : n - 1], params[l, 1])
        return c, c.expectation_zzx_energy(pp, 1.0, -1.0)

    prng = np.random.default_rng(42)
    grids = [prng.normal(size=(L, 2, N)) * 0.1 for _ in range(SEEDS)]
    grid3 = prng.normal(size=(3, 2, N)) * 0.1
    krl.zzrx_fwd.launches = 0
    kg.grand_zzrx_fwd.launches = 0
    with torch.no_grad():
        on_card = []
        for i, g in enumerate(grids):
            c, e = circuit_energy(tct.convert.params(g, dev), L, "cuda")
            on_card.append(e)
            if i == 0:
                norm0 = torch.linalg.vector_norm(c.state())
        _, e3 = circuit_energy(tct.convert.params(grid3, dev), 3, "cuda")
        torch.cuda.synchronize()
    launches = {"zzrx_fwd": krl.zzrx_fwd.launches, "grand_zzrx_fwd": kg.grand_zzrx_fwd.launches}
    print(f"forward path launches: {launches}")
    if launches["grand_zzrx_fwd"] < SEEDS or launches["zzrx_fwd"] < 3:
        _fail(f"the forward path did not go through the kernels: {launches}")
    with torch.no_grad():
        for i, g in enumerate(grids + [grid3]):
            nl = g.shape[0]
            _, e_cpu = circuit_energy(tct.convert.params(g, "cpu"), nl, "cpu")
            e = (on_card + [e3])[i].item()
            de = abs(e - e_cpu.item())
            print(f"energy L={nl} set {i}: card {e:.7f} cpu {e_cpu.item():.7f} |dE| {de:.2e} (tol {ENERGY_ATOL:g})")
            if not (np.isfinite(e) and de <= ENERGY_ATOL):
                _fail("energy on the card disagrees with the CPU path")
    if abs(norm0.item() - 1.0) > NORM_ATOL:
        _fail(f"state norm {norm0.item()}")
    print(f"state norm {norm0.item():.7f} (tol {NORM_ATOL:g})")

    print(f"phase 3 ended at {time.time() - t_start:.1f} s")

    # ---- 4. the training path through the public API ---------------------
    def value_and_grad(p, nl, device, n=N):
        _, e = circuit_energy(p, nl, device, n)
        (g,) = torch.autograd.grad(e, p)
        return e, g

    def sgd(p, g):
        with torch.no_grad():
            p.sub_(LR * g)

    train = [  # (label, n, L, steps, parameters from the benchmark's seed)
        (f"n={N} L={L}", N, L, STEPS, np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1),
        (f"n={N} L=3", N, 3, 1, np.random.default_rng(43).normal(size=(3, 2, N)) * 0.1),
        (f"n={N22} L={L}", N22, L, 1, np.random.default_rng(44).normal(size=(L, 2, N22)) * 0.1),
    ]
    counters = (krl.zzrx_fwd, kg.grand_zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_bwd)
    for k in counters:
        k.launches = 0
    card_steps = []
    for label, n, nl, steps, g0 in train:
        p = tct.convert.params(g0, dev).requires_grad_()
        for _ in range(steps):
            e, g = value_and_grad(p, nl, "cuda", n)
            card_steps.append((e.item(), g.cpu().numpy()))
            sgd(p, g)
    torch.cuda.synchronize()
    train_launches = {k.__name__: k.launches for k in counters}
    print(f"training path launches: {train_launches}")
    if train_launches["grand_zzrx_bwd"] < STEPS + 1 or train_launches["zzrx_bwd"] < L:
        _fail(f"the training path did not go through the backward kernels: {train_launches}")
    i = 0
    for label, n, nl, steps, g0 in train:
        p = tct.convert.params(g0, "cpu").requires_grad_()
        for step in range(steps):
            e, g = value_and_grad(p, nl, "cpu", n)
            e_card, g_card = card_steps[i]
            i += 1
            de = abs(e_card - e.item())
            dg = float(np.abs(g_card - g.numpy()).max())
            print(f"training {label} step {step}: E card {e_card:.7f} cpu {e.item():.7f} |dE| {de:.2e} "
                  f"(tol {ENERGY_ATOL:g}); max|dgrad| {dg:.2e} of max|grad| "
                  f"{float(np.abs(g.numpy()).max()):.3e} (tol {GRAD_ATOL:g})")
            if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (nl, 2, n)):
                _fail(f"training {label}: non-finite or misshapen result")
            if de > ENERGY_ATOL or dg > GRAD_ATOL:
                _fail(f"training {label} step {step} on the card disagrees with the CPU path")
            sgd(p, g)
    if not card_steps[STEPS - 1][0] < card_steps[0][0]:
        _fail("5 SGD steps did not lower the energy")

    print(f"phase 4 ended at {time.time() - t_start:.1f} s")

    # ---- 5. timings --------------------------------------------------------
    p4 = tct.convert.params(grids[0], dev)
    p3 = tct.convert.params(grid3, dev)
    pt = tct.convert.params(grids[0], dev).requires_grad_()

    def train_step():
        e, g = value_and_grad(pt, L, "cuda")
        sgd(pt, g)
        return e.item()

    step_ms = _time_ms(train_step, inner=1)
    with torch.no_grad():
        # one evaluation ends in ``.item()``, which waits for the card
        e4_ms = _time_ms(lambda: circuit_energy(p4, L, "cuda")[1].item(), inner=1)
        e3_ms = _time_ms(lambda: circuit_energy(p3, 3, "cuda")[1].item(), inner=1)
        timed = {  # the main-path variant of each kernel, at its path's shape
            "zzrx_fwd": cases["zzrx_fwd"][1],
            "grand_zzrx_fwd": cases["grand_zzrx_fwd"][0],
            "zzrx_bwd": cases["zzrx_bwd"][2],
            "grand_zzrx_bwd": cases["grand_zzrx_bwd"][0],
        }
        times = {k: (_time_rounds(v[1]), _time_rounds(v[2], **PLAIN_TIMING)) for k, v in timed.items()}
        k2_graph = _graph_ms(timed["grand_zzrx_fwd"][1])
    for name, (t, tp) in times.items():
        print(f"kernel {name} [{timed[name][0]}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms "
              f"(min {tp[1]:.4f}, max {tp[2]:.4f})")
    print(f"K2 alone [L={L}, n={N}] by a replayed CUDA graph of 10 calls (median of 3 rounds), {card}: "
          f"{1e3 * k2_graph[0]:.2f} us (min {1e3 * k2_graph[1]:.2f}, max {1e3 * k2_graph[2]:.2f})")
    print(f"energy evaluation (CUDA events, ends in .item()), {card}: "
          f"L={L} {e4_ms:.3f} ms, L=3 {e3_ms:.3f} ms (median of 20)")
    print(f"training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    work = {
        "zzrx_fwd": _k1_work(r, len(PAIRS), nkernel, True),
        "grand_zzrx_fwd": _k2_work(r, len(PAIRS), nkernel, nouter, L),
        "zzrx_bwd": _k3_work(r22, len(pairs22), nkernel22, True),
        "grand_zzrx_bwd": _k4_work(r, len(PAIRS), nkernel, nouter, L),
    }
    replaces = {
        "zzrx_fwd": "tensorcircuit_ng_tpu/core/kernels_rowlayer.py:1208",
        "grand_zzrx_fwd": "tensorcircuit_ng_tpu/core/kernels_grand.py:147",
        "zzrx_bwd": "tensorcircuit_ng_tpu/core/kernels_rowlayer.py:1276",
        "grand_zzrx_bwd": "tensorcircuit_ng_tpu/core/kernels_grand.py:392",
    }
    sources = {"zzrx_fwd": "zzrx_fwd", "grand_zzrx_fwd": "zzrx_fwd",
               "zzrx_bwd": "zzrx_bwd", "grand_zzrx_bwd": "zzrx_bwd"}
    # each kernel's launches on its path: the forward path for K1/K2, the
    # training path for K3/K4
    path_launches = {**launches, "zzrx_bwd": train_launches["zzrx_bwd"],
                     "grand_zzrx_bwd": train_launches["grand_zzrx_bwd"]}
    kernels_line = {"kernels": []}
    for name in timed:
        bound, by = _bound_ms(*work[name])
        kernels_line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{sources[name]}.cu",
            "replaces": replaces[name], "launches": path_launches[name],
            "max_abs_err": max_err[name], "ms": times[name][0][0], "plain_ms": times[name][1][0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    for k in kernels_line["kernels"]:
        n_path = N22 if k["name"] == "zzrx_bwd" else N
        print(f"kernel {k['name']} (n={n_path}), {card}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), launches {k['launches']}")

    print(f"phase 5 ended at {time.time() - t_start:.1f} s")

    # ---- 6. where the time of an evaluation and of a step goes -----------
    with torch.no_grad():
        prof_eval = _profile(lambda: circuit_energy(p4, L, "cuda")[1].item())
    prof_step = _profile(train_step)
    for what, unprofiled, (host, busy, by_kernel) in (
        ("evaluation", e4_ms, prof_eval), ("training step", step_ms, prof_step)
    ):
        print(f"profile L={L} {what} (torch.profiler, 10 runs), {card}: host {host:.3f} ms "
              f"under the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
              f"{100 * busy / unprofiled:.1f} % of the unprofiled {unprofiled:.3f} ms), "
              f"{len(by_kernel)} kernel names")
        for name, ms, count in by_kernel[:12]:
            print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    # K4's and K2's stages a layer on the step, their bounds and one torch
    # call of each product
    step_stages = _stage_times(train_step, {**K4_STAGES, **{f"K2 {k}": v for k, v in K2_STAGES.items()}})
    _k4_stages(krl, card, step_stages, (ksr[L - 1], ksi[L - 1]), (ctr, cti), (mlr[L - 1], mli[L - 1]), pairs22)
    _k2_stages(kg, card, {k[3:]: v for k, v in step_stages.items() if k.startswith("K2 ")}, (sr, si),
               (mlr[0], mli[0]), len(PAIRS), nkernel, nouter)
    # K1's stages a launch on the n=20 L=3 step (K1 a layer, then K4)
    pt3 = tct.convert.params(grid3, dev).requires_grad_()

    def train_step3():
        e, g = value_and_grad(pt3, 3, "cuda")
        sgd(pt3, g)
        return e.item()

    _k1_stages(krl, card, _stage_times(train_step3, K1_STAGES), (sr, si), (mlr[0], mli[0]), len(PAIRS), nkernel,
               0, "n=20 L=3 steps")

    print(f"phase 6 ended at {time.time() - t_start:.1f} s")

    # ---- 7. the TEBD path through the public API ------------------------
    import scipy.linalg
    from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as kj

    px = np.array([[0, 1], [1, 0.0]])
    pz = np.diag([1.0, -1.0])
    hb = -np.kron(pz, pz) - 0.5 * (np.kron(px, np.eye(2)) + np.kron(np.eye(2), px))
    gate = scipy.linalg.expm(-0.05j * hb).astype(np.complex64)  # bench.py's gate
    even = np.stack([gate] * len(range(0, TEBD_N - 1, 2)))
    odd = np.stack([gate] * len(range(1, TEBD_N - 1, 2)))
    mid = TEBD_N // 2

    def tebd_run(device, dtype="complex64"):
        eng = tct.ParallelTEBD(TEBD_N, TEBD_CHI, initial="neel", dtype=dtype, device=device)
        for _ in range(TEBD_STEPS):
            eng.trotter_step(even, odd)
        return eng

    def observables(eng):
        zs = np.array([eng.expectation_single(pz, i).real.item() for i in range(TEBD_N)])
        return zs, eng.lambdas[mid].double().cpu().numpy(), _mps_norm(eng)

    all_counters = counters + (kj.jacobi_rotations,)
    for k in all_counters:
        k.launches = 0
    with torch.no_grad():
        eng_card = tebd_run("cuda")
        torch.cuda.synchronize()
    tebd_launches = {k.__name__: k.launches for k in all_counters}
    print(f"TEBD path launches ({TEBD_STEPS} trotter steps): {tebd_launches}")
    if tebd_launches["jacobi_rotations"] != 2 * TEBD_STEPS:
        _fail(f"the TEBD path did not run K5 twice a step: {tebd_launches}")
    with torch.no_grad():
        on_card = observables(eng_card)
        ref = observables(tebd_run("cpu", "complex128"))
        gram32 = observables(tebd_run("cpu", "complex64"))
    for label, (zs, lam, nrm) in (("card (K5 Jacobi, float32)", on_card),
                                  ("CPU Gram complex64, contrast", gram32)):
        dz = float(np.abs(zs - ref[0]).max())
        dl = float(np.abs(lam - ref[1]).max())
        print(f"TEBD n={TEBD_N} chi={TEBD_CHI} {TEBD_STEPS} steps, {label} vs CPU complex128: "
              f"max|d<Z_i>| {dz:.3e}, max|d lambda_{mid}| {dl:.3e}, |psi|^2 {nrm:.7f} "
              f"(CPU complex128 {ref[2]:.7f})")
        if label.startswith("card"):
            if not (np.all(np.isfinite(zs)) and np.all(np.isfinite(lam)) and zs.shape == (TEBD_N,)):
                _fail("TEBD on the card: non-finite or misshapen observables")
            if dz > TEBD_ATOL or dl > TEBD_ATOL or abs(nrm - 1.0) > TEBD_ATOL:
                _fail(f"TEBD on the card disagrees with the complex128 CPU path (tol {TEBD_ATOL:g})")
    print(f"TEBD tolerance {TEBD_ATOL:g} on <Z_i>, lambda_{mid} and |psi|^2 - 1")

    with torch.no_grad(), tct.config.full_float32():
        th_even = eng_card._layer_thetas(even, 0)[0]
        th_odd = eng_card._layer_thetas(odd, 1)[0]
    batches = [("path thetas B=30", th_even, True), ("path thetas B=29", th_odd, True)]
    batches += [(label, torch.as_tensor(a.astype(np.complex64), device=dev), True)
                for label, a in _svd_batches(np.random.default_rng(11))]
    # without V, vh = S^-1 U^H A amplifies U's noise columns by 1/s: a
    # full-rank batch (on the rank-deficient thetas the plain version itself
    # reconstructs to 0.18 only)
    batches.append(("random, no V", batches[2][1], False))
    k5_err = 0.0
    with torch.no_grad():
        for label, a, with_v in batches:
            got = kj.jacobi_svd_nodiff(a, TEBD_SWEEPS, with_v)
            torch.cuda.synchronize()
            want = kj.jacobi_svd_nodiff(a, TEBD_SWEEPS, with_v, rotations=kj.jacobi_rotations_plain)
            ds, rec, rec_plain, vec, nsep, orth, ds_abs = _svd_checks(a, got, want)
            orth_plain = _svd_checks(a, want, want)[5]
            ok = (ds <= SVD_S_TOL and rec <= SVD_REC_TOL and vec <= SVD_VEC_TOL
                  and orth <= SVD_ORTH_TOL and got[0].shape == want[0].shape)
            print(f"parity jacobi_svd [{label}] {tuple(a.shape)}: max|ds|/s_max {ds:.2e} (tol {SVD_S_TOL:g}), "
                  f"rec {rec:.2e} (plain {rec_plain:.2e}, tol {SVD_REC_TOL:g}), vectors on {nsep} "
                  f"separated columns {vec:.2e} s_max/gap (tol {SVD_VEC_TOL:g}), "
                  f"|u^H u - I| {orth:.2e} (plain {orth_plain:.2e}, tol {SVD_ORTH_TOL:g}) "
                  f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"jacobi_svd [{label}] disagrees with its plain version")
            k5_err = max(k5_err, ds_abs)
        at = th_even.transpose(-1, -2)
        ar, ai = at.real.contiguous(), at.imag.contiguous()
        once = kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True)
        again = kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(once, again)):
            _fail("jacobi_svd differs between two runs")
        print("parity jacobi_svd [path thetas B=30]: two runs equal bit for bit")

        g0, l0 = eng_card.gammas.clone(), eng_card.lambdas.clone()

        def tebd_steps():
            eng = tct.ParallelTEBD.from_state(g0, l0)
            for _ in range(TEBD_STEPS):
                eng.trotter_step(even, odd)
            return eng.lambdas[mid, 0].item()

        tebd_ms = _time_ms(tebd_steps, reps=5, inner=1) / TEBD_STEPS
        k5_t = _time_rounds(lambda: kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True))
        plain_reps = 3
        k5_plain = _time_ms(lambda: kj.jacobi_rotations_plain(ar, ai, TEBD_SWEEPS, True),
                            reps=plain_reps, inner=1, warmup=1)
        k5_lib = _time_ms(lambda: torch.linalg.svd(th_even, full_matrices=False), reps=10, inner=1)
        eng_p = tct.ParallelTEBD.from_state(g0, l0)
        prof_tebd = _profile(lambda: (eng_p.trotter_step(even, odd), eng_p.lambdas[mid, 0].item()), reps=3)
    print(f"TEBD trotter step n={TEBD_N} chi={TEBD_CHI} (even + odd layer; CUDA events over "
          f"{TEBD_STEPS} steps ending in .item(), median of 5), {card}: {tebd_ms:.3f} ms")
    print(f"kernel jacobi_svd [B=30 path thetas, with V] over 3 rounds, {card}: median {k5_t[0]:.4f} ms "
          f"(min {k5_t[1]:.4f}, max {k5_t[2]:.4f}); plain median of {plain_reps} calls {k5_plain:.2f} ms; "
          f"torch.linalg.svd {k5_lib:.4f} ms (median of 10)")
    rounds = TEBD_SWEEPS * (th_even.shape[-1] - 1)
    nb, m_, n_ = th_even.shape
    k5_c = kj.cluster_size(dev, nb, n_, m_, True)
    active = {c: kj._max_active_clusters(torch.cuda.current_device(), n_, m_, True, c) for c in kj._CLUSTERS
              if kj._smem_bytes(n_, m_, True, c) <= kj._MAX_SMEM_BYTES}
    print(f"K5 cluster: {k5_c} CTAs a matrix ({nb * k5_c} CTAs) for B={nb} {n_}x{m_} with V; "
          f"cudaOccupancyMaxActiveClusters by cluster size {active}, {card}")
    # the rule's evidence: the same call at every cluster size that runs,
    # through the C entry point (the wrapper has no cluster argument)
    lib = _build.library("jacobi_svd")
    outs = [torch.empty_like(ar), torch.empty_like(ai), torch.empty((nb, n_, n_), device=dev),
            torch.empty((nb, n_, n_), device=dev)]

    def k5_at(c):
        err = lib.tcng_jacobi_svd(ar.data_ptr(), ai.data_ptr(), *[o.data_ptr() for o in outs], nb, n_, m_,
                                  TEBD_SWEEPS, c, torch.cuda.current_stream().cuda_stream)
        _build.check("jacobi_svd", err, f"jacobi_svd at cluster size {c}")

    by_c = {c: _time_ms(lambda c=c: k5_at(c), reps=5, inner=5, warmup=1) for c in active}
    print("kernel jacobi_svd by cluster size (ms, median of 5): "
          + ", ".join(f"C={c} {t:.4f}" for c, t in by_c.items()) + f"; the rule took {k5_c}, {card}")
    print(f"kernel jacobi_svd a round: {k5_t[0] / rounds * 1e3:.3f} us (median {k5_t[0]:.4f} ms / {rounds} "
          f"rounds), {card}")
    host, busy, by_kernel = prof_tebd
    k5_names = [(name, ms, count) for name, ms, count in by_kernel if "jacobi" in name]
    for name, ms, count in k5_names:
        print(f"profile K5 kernel: {name} device {ms:.4f} ms x{count:g} a trotter step, {card}")
    if len(k5_names) != 1:
        _fail(f"the profiler shows {len(k5_names)} K5 kernel names, not one: {k5_names}")
    print(f"profile TEBD trotter step (torch.profiler, 3 steps), {card}: host {host:.3f} ms under the "
          f"profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
          f"{100 * busy / tebd_ms:.1f} % of the unprofiled {tebd_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:12]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    bound, by = _bound_ms(*_k5_work(th_even.shape[0], 128, 128, TEBD_SWEEPS))
    kernels_line["kernels"].append({
        "name": "jacobi_svd", "route": "cuda",
        "source": "tensorcircuit_ng_tpu_torch/core/csrc/jacobi_svd.cu",
        "replaces": "tensorcircuit_ng_tpu/core/kernels_jacobi.py:416",
        "launches": tebd_launches["jacobi_rotations"], "max_abs_err": k5_err,
        "ms": k5_t[0], "plain_ms": k5_plain, "bound_ms": bound, "bound_by": by, "library_ms": k5_lib,
    })
    print(f"kernel jacobi_svd (B=30, 128x128, {TEBD_SWEEPS} sweeps, with V), {card}: {k5_t[0]:.4f} ms, "
          f"plain {k5_plain:.2f} ms, bound {bound:.4f} ms ({by}), torch.linalg.svd {k5_lib:.4f} ms, "
          f"launches {tebd_launches['jacobi_rotations']}")
    print(f"phase 7 ended at {time.time() - t_start:.1f} s")

    # ---- 8. the HEA path: K6, K7 and K8 --------------------------------
    hea_line = _hea_phase(tct, krl, dev, card)
    kernels_line["kernels"].extend(hea_line)
    print(f"phase 8 ended at {time.time() - t_start:.1f} s")

    # ---- 9. the QAOA path: K9, K10, K11 and K12 ------------------------
    from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml

    every_counter = all_counters + (krl.row_fwd, krl.row_bwd, krl.row_bwd_const, kml.ml_fwd,
                                    kml.ml_bwd, krl.rotx_fwd, krl.rotx_bwd)
    kernels_line["kernels"].extend(_qaoa_phase(tct, krl, dev, card, every_counter))
    print(f"phase 9 ended at {time.time() - t_start:.1f} s")

    # ---- 10. the FUSE_ROWM path: K13 and K14 inside K1 and K3 ----------
    every_counter += (krl.rowm_fwd, krl.rowm_bwd)
    kernels_line["kernels"].extend(_rowm_phase(tct, krl, kst, dev, card, every_counter))
    print(f"phase 10 ended at {time.time() - t_start:.1f} s")

    # ---- 11. the staged micro-benchmark: K15 ----------------------------
    kernels_line["kernels"].extend(_micro_phase(tct, dev, card))
    print(f"phase 11 ended at {time.time() - t_start:.1f} s")
    print(f"smoke total: {time.time() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
