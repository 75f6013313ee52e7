#!/usr/bin/env python3
"""K1, K2, K6, K8, K11 and K12 on one CUDA card, checkout against
checkout, in turns.

    python3 tools/ab_kernels.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo (the working tree, or an older commit
unpacked with ``git archive`` into a git-ignored directory).  For each, in
the order given, a process of its own (the packages of two checkouts share
names) imports the port and ``chip_smoke.py`` from that root, builds the
kernels there, and measures at the main paths' shapes (n = 20):

- K2 ``grand_zzrx_fwd`` at L = 4 (TFIM, open chain), K1 ``zzrx_fwd`` at
  nkernel = 10 with the lane (the TFIM L = 3 step's), without it, with the
  row kron M7 (rmx = 7, the ``FUSE_ROWM`` step's) and with the lane at
  n = 22 (the n = 22 step's), K6 ``row_fwd`` and K8 ``row_bwd_const`` at
  nkernel = 11 without the lane (HEA), K11 ``rotx_fwd`` and K12
  ``rotx_bwd`` at nkernel = 10 (QAOA form (b)): CUDA events over
  back-to-back wrapper calls (median of 3 rounds of 20 medians), a replayed
  CUDA graph of 10 calls (median of 3 rounds), and the device time of a
  call and of each of its kernels a launch (torch.profiler over 10 calls;
  the kernels' names differ between checkouts);
- device busy (torch.profiler, 10 runs) and wall time (CUDA events, median
  of 20, each run ending in ``.item()``) of the TFIM L = 4 evaluation, the
  TFIM L = 4 and L = 3 training steps, the TFIM L = 4 step under
  ``FUSE_ROWM``, the HEA L = 4 training step and the QAOA form (b) Adam
  step.

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
    # K11 and K12 at the QAOA form (b) path's shape: nkernel = 10, r = 8192
    nk = min(n - 7, krl.MAX_KERNEL_QUBITS_ROTX)
    th = torch.as_tensor(rng.normal(size=nk) * 0.4, dtype=torch.float32, device=dev)
    yr, yi = tct.convert.planes(rng.normal(size=2**n) + 1j * rng.normal(size=2**n), dev)
    cr, ci = tct.convert.planes(rng.normal(size=2**n) + 1j * rng.normal(size=2**n), dev)
    # K6 at the HEA path's shape: nkernel = 11, r = 8192, unitary gates
    n6 = min(n - 7, krl.MAX_KERNEL_QUBITS)
    g = np.linalg.qr(rng.normal(size=(n6, 2, 2)) + 1j * rng.normal(size=(n6, 2, 2)))[0].reshape(n6, 4)
    gr, gi = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in (g.real, g.imag))
    # K1's M7 (the top rmx = 7 kernel bits' rx kron) and its n = 22 shape
    rmx = kst._rowm_qubits(nkernel)
    m7r, m7i = (m[0] for m in kst._rx_kron_planes(rx[:1, nouter:nouter + rmx]))
    n22 = n + 2
    nrow22, _, nouter22, _ = kst._shapes(n22)
    pairs22 = tuple((i, i + 1) for i in range(n22 - 1))
    s22r, s22i = tct.convert.planes(rng.normal(size=2**n22) + 1j * rng.normal(size=2**n22), dev)
    zz22 = torch.as_tensor(rng.normal(size=n22 - 1) * 0.4, dtype=torch.float32, device=dev)
    rx22 = torch.as_tensor(rng.normal(size=(1, n22)) * 0.4, dtype=torch.float32, device=dev)
    ml22r, ml22i = (m[0] for m in kst._lane_kron_planes_T(rx22[:, nrow22:]))
    th22 = rx22[0, nouter22:nrow22].contiguous()
    calls = {
        "K2 grand_zzrx_fwd": lambda: kg.grand_zzrx_fwd(pairs, n, zz, thk, sr, si, mor, moi, mlr, mli),
        "K1 zzrx_fwd lane": lambda: krl.zzrx_fwd(pairs, n, zz[0], thk[0], sr, si, mlr[0], mli[0]),
        "K1 zzrx_fwd no lane": lambda: krl.zzrx_fwd(pairs, n, zz[0], thk[0], sr, si),
        "K1 zzrx_fwd M7": lambda: krl.rowm_fwd(pairs, n, zz[0], thk[0], sr, si, m7r, m7i, mlr[0], mli[0]),
        f"K1 zzrx_fwd lane n={n22}": lambda: krl.zzrx_fwd(pairs22, n22, zz22, th22, s22r, s22i, ml22r, ml22i),
        "K12 rotx_bwd": lambda: krl.rotx_bwd(th, yr, yi, cr, ci),
        "K6 row_fwd": lambda: krl.row_fwd(gr, gi, sr, si),
        "K8 row_bwd_const": lambda: krl.row_bwd_const(gr, gi, cr, ci),
        "K11 rotx_fwd": lambda: krl.rotx_fwd(th, sr, si),
    }
    with torch.no_grad():
        for name, fn in calls.items():
            out[f"{name} events ms"] = cs._time_rounds(fn)[0]
            out[f"{name} graph ms"] = cs._graph_ms(fn)[0]
            _, busy, by_kernel = cs._profile(fn)
            out[f"{name} device us a call"] = 1e3 * busy
            for kname, ms, count in by_kernel:
                short = kname.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0]
                out[f"{name} device us a launch, {short}"] = 1e3 * ms / count

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

    # the L = 3 step: K1 a layer, K4 backward
    p3 = tct.convert.params(np.random.default_rng(43).normal(size=(3, 2, n)) * 0.1, dev).requires_grad_()

    def tfim3_step():
        e, g = cs._tfim_step(tct, p3, "cuda", nl=3)
        with torch.no_grad():
            p3.sub_(cs.LR * g)
        return e.item()

    wh = tct.convert.params(np.random.default_rng(42).normal(size=(L, 2, n)) * 0.1, dev).requires_grad_()

    def hea_step():
        e = cs.hea_energy(tct, n, wh, device=wh.device)
        (gw,) = torch.autograd.grad(e, wh)
        with torch.no_grad():
            wh.sub_(cs.LR * gw)
        return e.item()

    edges, params0 = cs.qaoa_graph(n, cs.QAOA_P)
    pq = tct.convert.params(params0, dev).clone().requires_grad_()
    opt = torch.optim.Adam([pq], lr=cs.QAOA_LR)

    def qaoa_b_step():
        e = cs.qaoa_energy(tct, lambda a: tct.convert.params(a, dev), n, edges, pq, "rzz_rx", device=dev)
        (pq.grad,) = torch.autograd.grad(e, pq)
        opt.step()
        return e.item()

    # form (b) runs K11/K12 only under USE_ROTX; the FUSE_ROWM step K1 and
    # K3 with M7 a layer
    for name, fn, rotx, rowm in (("TFIM evaluation", evaluation, False, False),
                                 ("TFIM step", tfim_step, False, False),
                                 ("TFIM L=3 step", tfim3_step, False, False),
                                 ("FUSE_ROWM step", tfim_step, False, True),
                                 ("HEA step", hea_step, False, False),
                                 ("QAOA (b) step", qaoa_b_step, True, False)):
        kernels.USE_ROTX, kst.FUSE_ROWM = rotx, rowm
        out[f"{name} wall ms"] = cs._time_ms(fn, inner=1)
        out[f"{name} busy ms"] = cs._profile(fn)[1]
    kernels.USE_ROTX, kst.FUSE_ROWM = False, False
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("ab_kernels: no CUDA device", file=sys.stderr)
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
