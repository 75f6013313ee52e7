"""The bit-packed CHP tableau in C++ (``native/tableau.cpp``), through ctypes.

Counterpart of ``tensorcircuit_ng_tpu/core/native_tableau.py``, with the
method surface of :class:`tableau.Tableau` (``x``/``z``/``r`` as unpacked
planes, the gates, ``measure``, ``expectation_pauli``, ``sample(shots,
seed)`` and the entropy rank).  The C++ source of this package is the JAX
package's, byte for byte, so that one seed gives one sample.  It is
compiled at first use, never at import::

    g++ -O3 -shared -fPIC -std=c++17 -o build/native/libtableau_<hash>.so tableau.cpp

into ``build/native/`` at the root of the checkout (git-ignored), named by a
hash of the source and the flags.  A failed build raises, and
``make_tableau(n)`` returns a :class:`NativeTableau` or raises: the numpy
engine is taken only when asked for (``prefer_native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .tableau import Tableau

__all__ = ["NativeTableau", "native_tableau_available", "make_tableau", "BUILD_DIR", "library_path"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "tableau.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None

_GATE_CODES = {
    "h": 0, "s": 1, "sd": 2, "x_gate": 3, "y_gate": 4, "z_gate": 5,
    "sx": 6, "cnot": 7, "cz": 8, "cy": 9, "swap": 10, "iswap": 11,
}


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtableau_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native stabilizer tableau is built with it")
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
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.tab_new.restype = ctypes.c_void_p
        lib.tab_new.argtypes = [ctypes.c_int]
        lib.tab_free.argtypes = [ctypes.c_void_p]
        lib.tab_copy.restype = ctypes.c_void_p
        lib.tab_copy.argtypes = [ctypes.c_void_p]
        lib.tab_gate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.tab_measure.restype = ctypes.c_int
        lib.tab_measure.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.tab_expect.restype = ctypes.c_int
        lib.tab_expect.argtypes = [ctypes.c_void_p, u64, u64]
        lib.tab_sample.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, u8]
        lib.tab_entropy_rank.restype = ctypes.c_int
        lib.tab_entropy_rank.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                                         ctypes.c_int]
        lib.tab_is_random.restype = ctypes.c_int
        lib.tab_is_random.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tab_get.argtypes = [ctypes.c_void_p, u8, u8, u8]
        _LIB = lib
    return _LIB


def native_tableau_available() -> bool:
    """True once the library is built and loaded (builds it; a failed
    build raises)."""
    return _load() is not None


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(n,) uint8 -> little-endian packed uint64 words."""
    n = bits.shape[0]
    w = (n + 63) // 64
    padded = np.zeros(w * 64, dtype=np.uint8)
    padded[:n] = bits
    b = np.packbits(padded.reshape(w, 64), axis=1, bitorder="little")
    return b.view(np.uint64).reshape(w).copy()


class NativeTableau:
    """CHP tableau on the C++ bit-packed engine (the method surface of
    :class:`tableau.Tableau`)."""

    def __init__(self, n: int, _handle: Optional[int] = None):
        self._lib = _load()
        self.n = n
        self._h = _handle if _handle is not None else self._lib.tab_new(n)

    def __del__(self):  # pragma: no cover - interpreter teardown
        if getattr(self, "_h", None) and getattr(self, "_lib", None) is not None:
            self._lib.tab_free(self._h)
            self._h = None

    def copy(self) -> "NativeTableau":
        return NativeTableau(self.n, _handle=self._lib.tab_copy(self._h))

    def _g1(self, name: str, q: int) -> None:
        self._lib.tab_gate(self._h, _GATE_CODES[name], int(q), -1)

    def _g2(self, name: str, a: int, b: int) -> None:
        self._lib.tab_gate(self._h, _GATE_CODES[name], int(a), int(b))

    def h(self, q: int) -> None: self._g1("h", q)
    def s(self, q: int) -> None: self._g1("s", q)
    def sd(self, q: int) -> None: self._g1("sd", q)
    def x_gate(self, q: int) -> None: self._g1("x_gate", q)
    def y_gate(self, q: int) -> None: self._g1("y_gate", q)
    def z_gate(self, q: int) -> None: self._g1("z_gate", q)
    def sx(self, q: int) -> None: self._g1("sx", q)
    def cnot(self, c: int, t: int) -> None: self._g2("cnot", c, t)
    def cz(self, c: int, t: int) -> None: self._g2("cz", c, t)
    def cy(self, c: int, t: int) -> None: self._g2("cy", c, t)
    def swap(self, a: int, b: int) -> None: self._g2("swap", a, b)
    def iswap(self, a: int, b: int) -> None: self._g2("iswap", a, b)

    def is_random(self, q: int) -> bool:
        return bool(self._lib.tab_is_random(self._h, int(q)))

    def measure(self, q: int, status: Optional[float] = None) -> int:
        """Z measurement of ``q`` with collapse; a random outcome is
        ``status >= 0.5``, or a draw of ``np.random.randint(2)`` without it
        (the draw is made even where the outcome is determined)."""
        rnd = int(np.random.randint(2)) if status is None else int(float(status) >= 0.5)
        return self._lib.tab_measure(self._h, int(q), rnd) & 1

    def expectation_pauli(self, xs: Sequence[int], zs: Sequence[int], ys: Sequence[int] = ()) -> int:
        """⟨P⟩ of a Pauli string, +1, -1 or 0, without collapse."""
        px = np.zeros(self.n, dtype=np.uint8)
        pz = np.zeros(self.n, dtype=np.uint8)
        for q in xs:
            px[q] = 1
        for q in zs:
            pz[q] = 1
        for q in ys:
            px[q] ^= 1
            pz[q] ^= 1
        return int(self._lib.tab_expect(self._h, _pack_bits(px), _pack_bits(pz)))

    def sample(self, shots: int, seed: int = 0) -> np.ndarray:
        """[shots, n] uint8 Z samples of the whole register, each from a
        fresh copy of the tableau; ``seed`` 0 takes the engine's fixed
        default seed."""
        out = np.zeros((shots, self.n), dtype=np.uint8)
        self._lib.tab_sample(self._h, int(shots), np.uint64(seed or 0x2545F4914F6CDD1D), out)
        return out

    def entanglement_entropy(self, region: Sequence[int]) -> float:
        """S_A = (rank_GF2 of the stabilizers on A - |A|) ln 2."""
        reg = np.asarray(sorted(int(r) for r in region), dtype=np.int32)
        rank = self._lib.tab_entropy_rank(self._h, reg, len(reg))
        return float((rank - len(reg)) * np.log(2.0))

    def _planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self.n
        x = np.zeros((2 * n, n), dtype=np.uint8)
        z = np.zeros((2 * n, n), dtype=np.uint8)
        r = np.zeros(2 * n, dtype=np.uint8)
        self._lib.tab_get(self._h, x, z, r)
        return x, z, r

    def stabilizers(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        x, z, r = self._planes()
        return x[self.n:], z[self.n:], r[self.n:]

    @property
    def x(self) -> np.ndarray:
        """The (2n, n) X plane, unpacked (a copy)."""
        return self._planes()[0]

    @property
    def z(self) -> np.ndarray:
        """The (2n, n) Z plane, unpacked (a copy)."""
        return self._planes()[1]

    @property
    def r(self) -> np.ndarray:
        """The (2n,) sign bits (a copy)."""
        return self._planes()[2]


def make_tableau(n: int, prefer_native: bool = True):
    """The C++ tableau (a failed build raises), or the numpy engine when
    ``prefer_native`` is False."""
    if prefer_native:
        return NativeTableau(n)
    return Tableau(n)
