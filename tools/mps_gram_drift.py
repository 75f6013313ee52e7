"""How far the card's truncation SVD moves ``chip_smoke.py``'s phase 16 (a)
from the exact SVD, measured on the CPU.

Runs phase 16's CPU references at their full sizes (``chip_smoke.MPS_SIZES``:
the MPS VQE step at n=60, chi=64, depth 10) on the port's CPU path: the
exact SVD at complex128, then the Gram-eigh SVD (the route a CUDA tensor
takes, ``core/linalg.USE_GRAM_SVD = True``) at complex128 and complex64 and
the exact SVD at complex64, and prints each run's relative distance from the
first in the energy, the gradient and the energy after the SGD step, with
its wall time, then a central difference of the energy in the angle where
the two complex128 gradients differ most.  That distance predicts the
card's against the CPU path before a card run::

    python3 tools/mps_gram_drift.py [THREADS]

Needs no card and no network.
"""

import os
import sys
import time

import numpy as np
import torch

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)

import chip_smoke as cs  # noqa: E402
import tensorcircuit_ng_tpu_torch as tct  # noqa: E402


def main() -> int:
    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else os.cpu_count())
    t0 = time.perf_counter()
    with tct.set_device("cpu"):
        ref = cs._mps_reference(tct, **cs.MPS_SIZES, log=lambda line: print(line, flush=True))
    print(f"sizes {cs.MPS_SIZES}, {torch.get_num_threads()} threads, torch {torch.__version__}")
    print(f"exact complex128: E {ref['e']:.12f}, E after the step {ref['e1']:.12f}, bonds {ref['bonds']}")
    for key in sorted(k for k in ref if k.startswith("drift ")):
        de, dg, de1 = ref[key]
        print(f"{key[6:]}: |dE|/|E| {de:.3e}, max |dgrad|/max |grad| {dg:.3e}, |dE after|/|E after| {de1:.3e}")
    print("seconds: " + ", ".join(f"{k[8:]} {v:.1f}" for k, v in ref.items() if k.startswith("seconds ")))
    print(f"DMRG {ref['dmrg']:.12f}, exact ground {ref['ground']:.12f}; total {time.perf_counter() - t0:.1f} s")
    # which gradient is right where the two complex128 routes differ most:
    # a central difference of the exact route's energy
    diff = (ref["g gram128"].double() - ref["g"]).abs()
    idx = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    sizes = cs.MPS_SIZES
    g0 = cs.mps_vqe_angles(sizes["n"], sizes["depth"])
    with tct.set_device("cpu"), tct.set_dtype("complex128"), torch.no_grad():
        for h in (1e-4, 1e-5):
            e = []
            for sign in (1.0, -1.0):
                p = g0.copy()
                p[idx] += sign * h
                c = cs.mps_vqe_circuit(tct, torch.as_tensor(p), sizes["n"], sizes["chi"], device="cpu")
                e.append(cs.tfim_energy_ps(c, sizes["n"]).item())
            print(f"angle {tuple(int(i) for i in idx)}: exact-SVD gradient {ref['g'][idx].item():.9f}, Gram "
                  f"{ref['g gram128'][idx].item():.9f}, central difference (h={h:g}) {(e[0] - e[1]) / (2 * h):.9f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
