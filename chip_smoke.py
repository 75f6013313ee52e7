#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, drives the N=20 TFIM energy path
through the public ``Circuit`` API and times it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the kernels from ``tensorcircuit_ng_tpu_torch/core/csrc`` (nvcc,
     into ``build/kernels/``); print the build time and the card's name and
     power limit;
  2. kernel parity on the card at the n=20 shapes: K1 ``zzrx_fwd`` with and
     without the lane matrix, K2 ``grand_zzrx_fwd`` at L=4, each against
     its plain version on the same CUDA inputs;
  3. the main path: ``Circuit(20)`` h_layer + 4 zzrx_layer +
     ``expectation_zzx_energy`` for 5 seeded parameter sets (and the state
     of the first), then L=3 once (K1 through the circuit), with the launch
     counts reset just before and read just after; energies against the
     port's CPU path, the state's norm against 1;
  4. timings (CUDA events, after warm-up; each kernel and its plain
     version over 3 rounds of 20 medians, reported as median and spread);
  5. a torch.profiler window over 10 L=4 evaluations: device busy share
     and device time by kernel name.

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
SEEDS = 5
PAIRS = [(i, i + 1) for i in range(N - 1)]
#: kernel vs plain version, both float32 on the card: relative Frobenius
#: error and max-abs error over max |plain| (sums in another order; the
#: lane matmul sums 128 products)
KERNEL_RTOL = 1e-5
#: energy on the card vs the port's CPU path (E ~ -19, float32 sums over
#: 2^20 amplitudes in another order)
ENERGY_ATOL = 1e-4
NORM_ATOL = 1e-5
#: the card's peaks for the bound (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _errors(a, b):
    import torch

    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    return diff, scale, rel


def _time_ms(fn, reps: int = 20, inner: int = 5) -> float:
    """Median over ``reps`` of CUDA-event time per call of ``inner`` calls."""
    import torch

    for _ in range(3):
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


def _time_rounds(fn, rounds: int = 3):
    """(median, min, max) of :func:`_time_ms` over ``rounds`` rounds."""
    ts = [_time_ms(fn) for _ in range(rounds)]
    return statistics.median(ts), min(ts), max(ts)


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


def _k1_work(r, npairs, nkernel, lane):
    """(bytes, flops) K1 must move and compute: state planes in and out (and
    the lane planes); zz exponent 2 flops a pair + 6 for the phase, 6 a
    butterfly stage, 8·128 for the complex lane row-matmul, per amplitude."""
    amps = r * 128
    nbytes = 4 * 4 * amps + 4 * (npairs + nkernel + 2 * npairs)
    flops = amps * (2 * npairs + 6 + 6 * nkernel)
    if lane:
        nbytes += 2 * 4 * 128 * 128
        flops += amps * 8 * 128
    return nbytes, flops


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

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

    # ---- 2. kernel parity at the n=20 shapes -----------------------------
    nrow, nkernel, nouter, _ = kst._shapes(N)
    r = 2**nrow
    rng = np.random.default_rng(7)
    psi = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
    psi /= np.linalg.norm(psi)
    sr, si = tct.convert.planes(psi, dev)
    zz = torch.as_tensor(rng.normal(size=(L, N - 1)) * 0.4, dtype=torch.float32, device=dev)
    rx = torch.as_tensor(rng.normal(size=(L, N)) * 0.4, dtype=torch.float32, device=dev)
    mor, moi = kst._rx_kron_planes(rx[:, :nouter])
    mlr, mli = kst._lane_kron_planes_T(rx[:, nrow:])
    thk = rx[:, nouter:nrow].contiguous()
    pairs = tuple(PAIRS)
    cases = {
        "zzrx_fwd": [
            ("no lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si)),
            ("lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0]),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0])),
        ],
        "grand_zzrx_fwd": [
            (f"L={L}", lambda: kg.grand_zzrx_fwd(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli),
             lambda: kg.grand_zzrx_fwd_plain(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli)),
        ],
    }
    max_err = {}
    with torch.no_grad():
        for kname, variants in cases.items():
            max_err[kname] = 0.0
            for label, kern, plain in variants:
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                for i, (a, b) in enumerate(zip(got, want)):
                    diff, scale, rel = _errors(a, b)
                    ok = rel <= KERNEL_RTOL and diff <= KERNEL_RTOL * scale
                    print(f"parity {kname} [{label}] out{i}: max_abs {diff:.3e} "
                          f"(max|plain| {scale:.3e}), rel_frob {rel:.3e}, "
                          f"tol {KERNEL_RTOL:g} -> {'ok' if ok else 'FAIL'}")
                    if not ok:
                        _fail(f"{kname} [{label}] disagrees with its plain version")
                    max_err[kname] = max(max_err[kname], diff)

    # ---- 3. the main path through the public API -------------------------
    def circuit_energy(params, nl, device):
        c = tct.Circuit(N, device=device)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(PAIRS, params[l, 0, : N - 1], params[l, 1])
        return c, c.expectation_zzx_energy(PAIRS, 1.0, -1.0)

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
    print(f"main path launches: {launches}")
    if launches["grand_zzrx_fwd"] < SEEDS or launches["zzrx_fwd"] < 3:
        _fail(f"the main path did not go through the kernels: {launches}")
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

    # ---- 4. timings --------------------------------------------------------
    p4 = tct.convert.params(grids[0], dev)
    p3 = tct.convert.params(grid3, dev)
    with torch.no_grad():
        # one evaluation ends in ``.item()``, which waits for the card
        e4_ms = _time_ms(lambda: circuit_energy(p4, L, "cuda")[1].item(), inner=1)
        e3_ms = _time_ms(lambda: circuit_energy(p3, 3, "cuda")[1].item(), inner=1)
        k1 = cases["zzrx_fwd"][1]
        k2 = cases["grand_zzrx_fwd"][0]
        k1_t, k1_plain_t = _time_rounds(k1[1]), _time_rounds(k1[2])
        k2_t, k2_plain_t = _time_rounds(k2[1]), _time_rounds(k2[2])
    k1_ms, k1_plain, k2_ms, k2_plain = k1_t[0], k1_plain_t[0], k2_t[0], k2_plain_t[0]
    for name, t, tp in (("zzrx_fwd", k1_t, k1_plain_t), ("grand_zzrx_fwd", k2_t, k2_plain_t)):
        print(f"kernel {name} over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms "
              f"(min {tp[1]:.4f}, max {tp[2]:.4f})")
    print(f"energy evaluation (CUDA events, ends in .item()), {card}: "
          f"L={L} {e4_ms:.3f} ms, L=3 {e3_ms:.3f} ms (median of 20)")
    b1, f1 = _k1_work(r, len(PAIRS), nkernel, True)
    b2 = 4 * 4 * r * 128 + L * 2 * 4 * r * 128 + L * (2 * 4 * 128 * 128 + 2 * 4 * 2**(2 * nouter))
    f2 = L * (f1 + r * 128 * 8 * 2**nouter)
    bound1, by1 = _bound_ms(b1, f1)
    bound2, by2 = _bound_ms(b2, f2)
    kernels_line = {"kernels": [
        {"name": "zzrx_fwd", "route": "cuda",
         "source": "tensorcircuit_ng_tpu_torch/core/csrc/zzrx_fwd.cu",
         "replaces": "tensorcircuit_ng_tpu/core/kernels_rowlayer.py:1208",
         "launches": launches["zzrx_fwd"], "max_abs_err": max_err["zzrx_fwd"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": bound1, "bound_by": by1,
         "library_ms": None},
        {"name": "grand_zzrx_fwd", "route": "cuda",
         "source": "tensorcircuit_ng_tpu_torch/core/csrc/zzrx_fwd.cu",
         "replaces": "tensorcircuit_ng_tpu/core/kernels_grand.py:147",
         "launches": launches["grand_zzrx_fwd"], "max_abs_err": max_err["grand_zzrx_fwd"],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": bound2, "bound_by": by2,
         "library_ms": None},
    ]}
    for k in kernels_line["kernels"]:
        print(f"kernel {k['name']} (n={N}), {card}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), launches {k['launches']}")

    # ---- 5. where the time of one evaluation goes -------------------------
    with torch.no_grad():
        host, busy, by_kernel = _profile(lambda: circuit_energy(p4, L, "cuda")[1].item())
    print(f"profile L={L} evaluation (torch.profiler, 10 runs), {card}: host {host:.3f} ms "
          f"under the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
          f"{100 * busy / e4_ms:.1f} % of the unprofiled {e4_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:8]:
        print(f"  device {ms:.4f} ms x{count:g}/eval  {name[:90]}")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
