#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone on a CUDA card, then where its time
goes.

    python3 tools/apps_profile.py [--no-checks]

It builds the port's kernels and runs ``chip_smoke._apps_checks`` at its
full sizes, the CPU references computed in this process (``--no-checks``
skips this).  Then it times, by CUDA events, the parts of the application
layer's two training loops at phase 24's sizes:

- the QUBO-QAOA loss (20 assets, p=3) and its gradient: eager (the first
  call and warm ones), the forward alone, the first ``backend.jit`` call
  (an eager run and the capture) and its replays, the kernels that one
  eager call launches and their device time (``torch.profiler``);
- ``QUBO_QAOA``'s 20 Adam steps as a user calls it;
- VQNHE at n=14: building the dense H, 5 warm eager steps, 20 jitted;
- PixelCNN (16x16, depth 3, 32 filters): 256 log-probs, first and warm.

Each line carries the card's name and power limit.  Needs a card; exits
non-zero without one or when a check fails.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("apps_profile: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import tensorcircuit_ng_tpu_torch as tct
    from tensorcircuit_ng_tpu_torch.applications import finance, optimization, van, vqes
    from tensorcircuit_ng_tpu_torch.core import _build
    from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = cs._card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    K = tct.backend

    if "--no-checks" not in sys.argv[1:]:
        counters = (krl.zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_fwd, kg.grand_zzrx_bwd, krl.row_fwd, krl.row_bwd,
                    krl.rotx_fwd, krl.rotx_bwd)
        times = cs._apps_checks(tct, dev, counters)
        for label, (ms, how, peak) in times.items():
            mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
            print(f"phase 24 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")

    def timed(label, fn, reps=1):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        print(f"{label}: {a.elapsed_time(b) / reps:.3f} ms a call (CUDA events, {reps} calls), {card}", flush=True)
        return out

    s = cs.APPS_SIZES
    Q = cs.portfolio_qubo(finance, s["qa_n"], s["qa_days"], s["qa_budget"])
    structures, weights, offset = tct.templates.conversions.QUBO_to_Ising(Q)
    energies = optimization.ising_energy_vector(structures, weights, offset, device=dev)

    def loss(p):
        c = tct.templates.ansatz.QAOA_ansatz_for_Ising(p, s["qa_nl"], structures, weights, device=dev)
        pr = c.probability()
        return torch.sum(pr / torch.sum(pr) * energies)

    p = torch.as_tensor(np.random.default_rng(42).uniform(0.0, 0.5, 2 * s["qa_nl"]), dtype=torch.float32,
                        device=dev)
    vg = K.value_and_grad(loss)
    head = f"QAOA {s['qa_n']} assets, p={s['qa_nl']}"
    timed(f"{head}: value and gradient eager, the first call", lambda: vg(p))
    timed(f"{head}: value and gradient eager, warm", lambda: vg(p), 3)
    with torch.no_grad():
        timed(f"{head}: the loss alone, warm", lambda: loss(p), 3)
    jv = K.jit(vg)
    timed(f"{head}: backend.jit's first call (an eager run and the capture)", lambda: jv(p))
    timed(f"{head}: backend.jit's replay", lambda: jv(p), 10)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        vg(p)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"{head}: one eager value and gradient launches {len(kernels)} kernels, {busy:.3f} ms of device time "
          f"(torch.profiler), {card}")
    timed(f"QUBO_QAOA {s['qa_n']} assets, p={s['qa_nl']}: {s['qa_steps']} Adam steps through backend.jit",
          lambda: optimization.QUBO_QAOA(Q, nlayers=s["qa_nl"], steps=s["qa_steps"], device=dev))

    n = s["vq_n"]
    v = timed(f"VQNHE n={n}: construction (the dense H on the card)",
              lambda: vqes.VQNHE(n, cs.tfim_rows(n), model_type="complex", ansatz="hea", nlayers=s["vq_nl"],
                                 units=s["vq_units"], device=dev))
    v.training(maxiter=1, jit=False)
    timed(f"VQNHE n={n}: 5 eager steps, warm", lambda: v.training(maxiter=5, jit=False))
    timed(f"VQNHE n={n}: {s['vq_steps']} steps through backend.jit",
          lambda: v.training(maxiter=s["vq_steps"], jit=True))

    side = s["pc_side"]
    pc = van.PixelCNN(2, s["pc_depth"], s["pc_filters"], device=dev, generator=torch.Generator().manual_seed(53))
    ys = torch.as_tensor(np.random.default_rng(59).integers(0, 2, size=(s["pc_k"], side, side)), device=dev)
    with torch.no_grad():
        head = f"PixelCNN {side}x{side} depth {s['pc_depth']} filters {s['pc_filters']}, {s['pc_k']} log-probs"
        timed(f"{head}: the first call", lambda: pc.log_prob(ys))
        timed(f"{head}: warm", lambda: pc.log_prob(ys), 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
