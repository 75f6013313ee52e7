#!/usr/bin/env python3
"""K2 and K12 on one CUDA card, checkout against checkout, in turns.

    python3 tools/ab_k2_k12.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo (the working tree, or an older commit
unpacked with ``git archive`` into a git-ignored directory).  For each, in
the order given, a process of its own (the packages of two checkouts share
names) imports the port and ``chip_smoke.py`` from that root, builds the
kernels there, and measures at the main paths' shapes (n = 20):

- K2 ``grand_zzrx_fwd`` at L = 4 (TFIM, open chain) and K12 ``rotx_bwd`` at
  nkernel = 10 (QAOA form (b)): CUDA events over back-to-back wrapper calls
  (median of 3 rounds of 20 medians) and a replayed CUDA graph of 10 calls
  (median of 3 rounds);
- device busy (torch.profiler, 10 runs) and wall time (CUDA events, median
  of 20, each run ending in ``.item()``) of the TFIM L = 4 evaluation, the
  TFIM L = 4 training step and the QAOA form (b) Adam step.

Prints one line a measurement with the card's name and power limit, and a
JSON line a root.  Give the roots as A B B A to see the spread between
calls beside the difference.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np


def _measure(root: str) -> dict:
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    import tensorcircuit_ng_tpu_torch as tct
    from tensorcircuit_ng_tpu_torch.core import _build
    from tensorcircuit_ng_tpu_torch.core import kernels
    from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    if not os.path.abspath(tct.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported the port from {tct.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    n, L = cs.N, cs.L
    out = {"root": root}

    # K2 at the TFIM path's shape, inputs as chip_smoke.py's phase 2
    nrow, nkernel, nouter, _ = kst._shapes(n)
    rng = np.random.default_rng(7)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    sr, si = tct.convert.planes(psi / np.linalg.norm(psi), dev)
    zz = torch.as_tensor(rng.normal(size=(L, n - 1)) * 0.4, dtype=torch.float32, device=dev)
    rx = torch.as_tensor(rng.normal(size=(L, n)) * 0.4, dtype=torch.float32, device=dev)
    mor, moi = kst._rx_kron_planes(rx[:, :nouter])
    mlr, mli = kst._lane_kron_planes_T(rx[:, nrow:])
    thk = rx[:, nouter:nrow].contiguous()
    pairs = tuple(cs.PAIRS)
    # K12 at the QAOA form (b) path's shape: nkernel = 10, r = 8192
    nk = min(n - 7, krl.MAX_KERNEL_QUBITS_ROTX)
    th = torch.as_tensor(rng.normal(size=nk) * 0.4, dtype=torch.float32, device=dev)
    yr, yi = tct.convert.planes(rng.normal(size=2**n) + 1j * rng.normal(size=2**n), dev)
    cr, ci = tct.convert.planes(rng.normal(size=2**n) + 1j * rng.normal(size=2**n), dev)
    calls = {
        "K2 grand_zzrx_fwd": lambda: kg.grand_zzrx_fwd(pairs, n, zz, thk, sr, si, mor, moi, mlr, mli),
        "K12 rotx_bwd": lambda: krl.rotx_bwd(th, yr, yi, cr, ci),
    }
    with torch.no_grad():
        for name, fn in calls.items():
            out[f"{name} events ms"] = cs._time_rounds(fn)[0]
            out[f"{name} graph ms"] = cs._graph_ms(fn)[0]

    # the paths: TFIM evaluation and step, QAOA form (b) step
    grid = tct.convert.params(np.random.default_rng(42).normal(size=(L, 2, n)) * 0.1, dev)
    pt = grid.clone().requires_grad_()

    def evaluation():
        pp = [(i, i + 1) for i in range(n - 1)]
        with torch.no_grad():
            c = tct.Circuit(n, device="cuda")
            c.h_layer()
            for l in range(L):
                c.zzrx_layer(pp, grid[l, 0, : n - 1], grid[l, 1])
            return c.expectation_zzx_energy(pp, 1.0, -1.0).item()

    def tfim_step():
        e, g = cs._tfim_step(tct, pt, "cuda")
        with torch.no_grad():
            pt.sub_(cs.LR * g)
        return e.item()

    edges, params0 = cs.qaoa_graph(n, cs.QAOA_P)
    pq = tct.convert.params(params0, dev).clone().requires_grad_()
    opt = torch.optim.Adam([pq], lr=cs.QAOA_LR)

    def qaoa_b_step():
        e = cs.qaoa_energy(tct, lambda a: tct.convert.params(a, dev), n, edges, pq, "rzz_rx", device=dev)
        (pq.grad,) = torch.autograd.grad(e, pq)
        opt.step()
        return e.item()

    # form (b) runs K11/K12 only under USE_ROTX
    for name, fn, rotx in (("TFIM evaluation", evaluation, False), ("TFIM step", tfim_step, False),
                           ("QAOA (b) step", qaoa_b_step, True)):
        kernels.USE_ROTX = rotx
        out[f"{name} wall ms"] = cs._time_ms(fn, inner=1)
        out[f"{name} busy ms"] = cs._profile(fn)[1]
    kernels.USE_ROTX = False
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("ab_k2_k12: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(_measure(os.path.abspath(sys.argv[2]))))
        return 0
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for i, root in enumerate(roots):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for key, v in got.items():
            if key != "root":
                print(f"run {i} [{root}] {key}: {v:.4f} ({card})")
        print(json.dumps({"run": i, "card": card, **got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
