"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>_<hash>.so <name>.cu

The output goes to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads the library already built.
``build_all()`` starts one nvcc for each source together.  Nothing here
runs when the module is imported, so the CPU path never needs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "build_log", "check"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel sources, by library name
SOURCES: Dict[str, Path] = {
    "zzrx_fwd": _CSRC / "zzrx_fwd.cu",
    "zzrx_bwd": _CSRC / "zzrx_bwd.cu",
    "jacobi_svd": _CSRC / "jacobi_svd.cu",
    "row_layer": _CSRC / "row_layer.cu",
    "multilayer": _CSRC / "multilayer.cu",
    "micro_grand": _CSRC / "micro_grand.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name -> argtypes (every entry point returns a cudaError_t,
#: except those named in ``_RESTYPES``; each library also exports
#: ``tcng_error_string``)
_SIGNATURES = {
    "zzrx_fwd": {
        "tcng_zzrx_fwd_scratch": [_I, _I, _I, _I, _I],
        "tcng_zzrx_fwd_plan": [_I, _I, _I, _I, _I, _P],
        "tcng_zzrx_fwd": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I, _P],
        "tcng_rowm_fwd_plan": [_I, _I, _P],
        "tcng_grand_zzrx_fwd_scratch": [_I, _I, _I, _I],
        "tcng_grand_zzrx_fwd_plan": [_I, _I, _I, _I, _P],
        "tcng_grand_zzrx_fwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P,
        ],
    },
    "zzrx_bwd": {
        "tcng_zzrx_bwd_scratch": [_I, _I, _I, _I, _I],
        "tcng_zzrx_bwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P,
            _I, _P,
        ],
        "tcng_rowm_bwd_plan": [_I, _I, _P],
        "tcng_zzrx_bwd_plan": [_I, _I, _I, _I, _P],
        "tcng_lane_dm": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "tcng_grand_zzrx_bwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P,
            _P, _I, _P,
        ],
    },
    "jacobi_svd": {
        "tcng_jacobi_max_clusters": [_I, _I, _I, _I],
        "tcng_jacobi_svd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "row_layer": {
        "tcng_row_fwd_scratch": [_I, _I, _I],
        "tcng_row_fwd_plan": [_I, _I, _I, _P],
        "tcng_row_fwd": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P],
        "tcng_row_bwd_scratch": [_I, _I, _I],
        "tcng_row_bwd_plan": [_I, _I, _I, _P],
        "tcng_row_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P],
        "tcng_row_bwd_const_plan": [_I, _I, _P],
        "tcng_row_bwd_const": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "tcng_rotx_fwd_plan": [_I, _I, _P],
        "tcng_rotx_fwd": [_P, _P, _P, _P, _P, _I, _I, _P],
        "tcng_rotx_bwd_scratch": [_I, _I],
        "tcng_rotx_bwd_plan": [_I, _I, _P],
        "tcng_rotx_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P],
    },
    "micro_grand": {
        "tcng_micro_grand": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "multilayer": {
        "tcng_ml_scratch": [_I, _I, _I, _I, _I, _I],
        "tcng_ml_plan": [_I, _I, _I, _I, _P],
        "tcng_ml_fwd": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
        "tcng_ml_bwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P,
        ],
    },
}
_RESTYPES = {
    name: ctypes.c_long
    for name in ("tcng_zzrx_bwd_scratch", "tcng_row_fwd_scratch", "tcng_row_bwd_scratch",
                 "tcng_rotx_bwd_scratch", "tcng_ml_scratch", "tcng_grand_zzrx_fwd_scratch",
                 "tcng_zzrx_fwd_scratch")
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):  # the headers the sources share
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of a build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> List[str]:
    """Compile every source that has no library yet, all nvcc at once;
    returns the names built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [p[0] for p in procs]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = _RESTYPES.get(fn, ctypes.c_int)
        lib.tcng_error_string.argtypes = [ctypes.c_int]
        lib.tcng_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` returned a CUDA error."""
    if err != 0:
        msg = library(name).tcng_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
