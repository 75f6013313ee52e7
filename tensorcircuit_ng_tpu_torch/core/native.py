"""The native simulated-annealing contraction-tree optimizer (TreeSA).

Counterpart of ``tensorcircuit_ng_tpu/core/native.py``.  The C++ source
``native/treesa.cpp`` of this package (the JAX package's, byte for byte, so
that one seed gives one path) is compiled at first use, never at import:

    g++ -O2 -shared -fPIC -std=c++17 -o build/native/libtreesa_<hash>.so treesa.cpp

into ``build/native/`` at the root of the checkout (git-ignored), named by a
hash of the source and the flags, and loaded with ctypes.  A failed build
raises: nothing falls back to another optimizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

from opt_einsum.paths import PathOptimizer

__all__ = ["treesa_available", "treesa_path", "TreeSAOptimizer", "BUILD_DIR", "library_path"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "treesa.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtreesa_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the TreeSA contraction-path optimizer is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        base = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        ]
        lib.treesa_optimize.restype = ctypes.c_double
        lib.treesa_optimize.argtypes = base + [ctypes.POINTER(ctypes.c_int)]
        lib.treesa_optimize_seeded.restype = ctypes.c_double
        lib.treesa_optimize_seeded.argtypes = base + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def treesa_available() -> bool:
    """True once the library is built and loaded (builds it; a failed
    build raises)."""
    return _load() is not None


def treesa_path(
    inputs: Sequence[Sequence[Any]],
    output: Sequence[Any],
    size_dict: dict,
    n_iters: int = 2000,
    t0: float = 10.0,
    t1: float = 0.05,
    size_weight: float = 0.6,
    seed: int = 42,
    init_path: Optional[List[Tuple[int, int]]] = None,
) -> List[Tuple[int, int]]:
    """An annealed contraction path in opt_einsum's linear format.

    ``init_path`` (linear format) seeds the annealer with a known plan (the
    greedy one, say) in place of its own greedy tree."""
    lib = _load()
    ids = sorted({i for inp in inputs for i in inp} | set(output))
    id2pos = {x: k for k, x in enumerate(ids)}
    flat: List[int] = []
    offsets = [0]
    for inp in inputs:
        flat.extend(id2pos[i] for i in inp)
        offsets.append(len(flat))
    out_inds = [id2pos[i] for i in output]
    log2_sizes = [math.log2(size_dict[i]) for i in ids]
    n = len(inputs)
    flat_a = (ctypes.c_int * max(len(flat), 1))(*flat)
    off_a = (ctypes.c_int * len(offsets))(*offsets)
    out_a = (ctypes.c_int * max(len(out_inds), 1))(*out_inds)
    sz_a = (ctypes.c_double * len(log2_sizes))(*log2_sizes)
    path_a = (ctypes.c_int * (2 * (n - 1)))()
    common = (n, len(ids), flat_a, off_a, out_a, len(out_inds), sz_a,
              int(n_iters), float(t0), float(t1), float(size_weight), int(seed))
    if init_path is not None:
        flat_ssa = [x for pair in _linear_to_ssa(init_path, n) for x in pair]
        init_a = (ctypes.c_int * len(flat_ssa))(*flat_ssa)
        score = lib.treesa_optimize_seeded(*common, init_a, path_a)
    else:
        score = lib.treesa_optimize(*common, path_a)
    if score < 0:
        raise RuntimeError("treesa optimization failed")
    ssa = [(path_a[2 * k], path_a[2 * k + 1]) for k in range(n - 1)]
    return _ssa_to_linear(ssa, n)


def _linear_to_ssa(path: List[Tuple[int, ...]], n: int) -> List[Tuple[int, int]]:
    """An opt_einsum linear path as pairs of SSA ids."""
    ids = list(range(n))
    out = []
    next_ssa = n
    for pair in path:
        ia, ib = pair if len(pair) == 2 else (pair[0], pair[0])
        if ia > ib:
            ia, ib = ib, ia
        out.append((ids[ia], ids[ib]))
        ids.pop(ib)
        ids.pop(ia)
        ids.append(next_ssa)
        next_ssa += 1
    return out


def _ssa_to_linear(ssa: List[Tuple[int, int]], n: int) -> List[Tuple[int, int]]:
    """Pairs of SSA ids as an opt_einsum linear path (positions in the live list)."""
    ids = list(range(n))
    out = []
    next_ssa = n
    for a, b in ssa:
        ia, ib = sorted((ids.index(a), ids.index(b)))
        out.append((ia, ib))
        ids.pop(ib)
        ids.pop(ia)
        ids.append(next_ssa)
        next_ssa += 1
    return out


class TreeSAOptimizer(PathOptimizer):
    """opt_einsum-compatible path optimizer on the native annealer: pass it
    as ``optimize=`` or ``tct.set_contractor("custom", optimizer=TreeSAOptimizer())``.

    It starts from opt_einsum's greedy path and keeps the cheapest of it and
    ``restarts`` annealed paths; a greedy path cheaper than
    10^``skip_below_log10_flops`` FLOPs is returned as it is (annealing
    cannot buy back its search time there)."""

    def __init__(
        self,
        n_iters: int = 2000,
        size_weight: float = 0.6,
        seed: int = 42,
        seed_from_greedy: bool = True,
        restarts: int = 2,
        skip_below_log10_flops: float = 9.0,
    ):
        self.n_iters = n_iters
        self.size_weight = size_weight
        self.seed = seed
        self.seed_from_greedy = seed_from_greedy
        self.restarts = max(1, restarts)
        self.skip_below_log10_flops = float(skip_below_log10_flops)

    @staticmethod
    def _path_cost(path, inputs, output, size_dict) -> float:
        import opt_einsum as oe

        shapes = [tuple(size_dict[i] for i in inp) for inp in inputs]
        expr = ",".join("".join(inp) for inp in inputs) + "->" + "".join(output)
        _, info = oe.contract_path(expr, *shapes, shapes=True, optimize=path)
        return float(info.opt_cost)

    def __call__(self, inputs, output, size_dict, memory_limit=None):
        import opt_einsum as oe

        # opt_einsum passes sets of symbols: sort them, as the JAX package does
        inputs = [sorted(inp) for inp in inputs]
        output = sorted(output)
        if len(inputs) == 1:
            return [(0,)]
        init = None
        if self.seed_from_greedy:
            init = list(oe.paths.greedy([frozenset(i) for i in inputs], frozenset(output), size_dict))
            if (self.skip_below_log10_flops > 0
                    and self._path_cost(init, inputs, output, size_dict) < 10.0**self.skip_below_log10_flops):
                return init
        candidates = [] if init is None else [init]
        for r in range(self.restarts):
            candidates.append(treesa_path(
                inputs, output, size_dict, n_iters=self.n_iters, t0=2.0 if init is not None else 10.0,
                size_weight=self.size_weight, seed=self.seed + 1000 * r, init_path=init,
            ))
        return min(candidates, key=lambda p: self._path_cost(p, inputs, output, size_dict))
