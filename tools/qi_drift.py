"""How far rounding moves ``chip_smoke.py``'s phase 17 quantities, measured
on the CPU: :func:`chip_smoke._hamiltonian_values` at phase 17's full
sizes on the port's CPU path at complex64 and at complex128, and each
quantity's distance between the two (the largest entry's for a tensor).
The negativities, fidelity and trace distance take the density matrix of
the state promoted to complex128 (phase 17's route), so theirs is what
the complex64 state alone moves; the negativity and the fidelity of the
complex64 density matrix are printed beside them.  These distances set phase 17's
``QI_TOL`` before a card run::

    python3 tools/qi_drift.py [THREADS]

Needs no card and no network (about 4 GiB and half a minute on 4 threads).
"""

import os
import sys
import time

import torch

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)

import chip_smoke as cs  # noqa: E402
import tensorcircuit_ng_tpu_torch as tct  # noqa: E402


def main() -> int:
    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    out = {}
    for dtype in ("complex128", "complex64"):
        t0 = time.perf_counter()
        with tct.set_device("cpu"), tct.set_dtype(dtype):
            out[dtype] = cs._hamiltonian_values(tct, "cpu", **cs.HAM_SIZES)
        print(f"{dtype}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"sizes {cs.HAM_SIZES}, {torch.get_num_threads()} threads, torch {torch.__version__}")
    a, b = out["complex128"], out["complex64"]
    for key in sorted(a):
        x, y = a[key], b[key]
        if isinstance(x, torch.Tensor):
            print(f"{key}: complex64 against complex128 {(y.to(x.dtype) - x).abs().max().item():.3e} "
                  f"(largest entry {x.abs().max().item():.4g})")
        elif isinstance(x, float):
            print(f"{key}: complex128 {x:.12f}, complex64 {y:.12f}, distance {abs(x - y):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
