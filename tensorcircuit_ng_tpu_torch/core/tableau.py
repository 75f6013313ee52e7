"""The CHP stabilizer tableau (Aaronson-Gottesman) on the host, in numpy.

Counterpart of ``tensorcircuit_ng_tpu/core/tableau.py``, line for line in
meaning: the 2n x (2n+1) binary tableau (rows 0..n-1 destabilizers, n..2n-1
stabilizers) on ``uint8`` planes, the rowsum g-function, measurement with
collapse, ``expectation_pauli`` by peeking, and the entanglement entropy
from a GF(2) rank.  Measurement row reduction is sequential, so the engine
stays on the host; the bit-packed C++ engine of ``native_tableau.py`` is the
fast one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["Tableau"]


class Tableau:
    """CHP tableau: rows 0..n-1 destabilizers, n..2n-1 stabilizers."""

    def __init__(self, n: int):
        self.n = n
        self.x = np.zeros((2 * n, n), dtype=np.uint8)
        self.z = np.zeros((2 * n, n), dtype=np.uint8)
        self.r = np.zeros(2 * n, dtype=np.uint8)  # sign bit (0: +, 1: -)
        for i in range(n):
            self.x[i, i] = 1  # destabilizer X_i
            self.z[n + i, i] = 1  # stabilizer Z_i

    def copy(self) -> "Tableau":
        t = Tableau.__new__(Tableau)
        t.n = self.n
        t.x = self.x.copy()
        t.z = self.z.copy()
        t.r = self.r.copy()
        return t

    # ------------------------------------------------------------ gates

    def h(self, q: int) -> None:
        self.r ^= self.x[:, q] & self.z[:, q]
        self.x[:, q], self.z[:, q] = self.z[:, q].copy(), self.x[:, q].copy()

    def s(self, q: int) -> None:
        self.r ^= self.x[:, q] & self.z[:, q]
        self.z[:, q] ^= self.x[:, q]

    def sd(self, q: int) -> None:
        self.s(q)
        self.s(q)
        self.s(q)

    def x_gate(self, q: int) -> None:
        self.r ^= self.z[:, q]

    def z_gate(self, q: int) -> None:
        self.r ^= self.x[:, q]

    def y_gate(self, q: int) -> None:
        self.r ^= self.x[:, q] ^ self.z[:, q]

    def sx(self, q: int) -> None:  # sqrt(X) = H S H
        self.h(q)
        self.s(q)
        self.h(q)

    def cnot(self, c: int, t: int) -> None:
        self.r ^= self.x[:, c] & self.z[:, t] & (self.x[:, t] ^ self.z[:, c] ^ 1)
        self.x[:, t] ^= self.x[:, c]
        self.z[:, c] ^= self.z[:, t]

    def cz(self, c: int, t: int) -> None:
        self.h(t)
        self.cnot(c, t)
        self.h(t)

    def cy(self, c: int, t: int) -> None:
        self.sd(t)
        self.cnot(c, t)
        self.s(t)

    def swap(self, a: int, b: int) -> None:
        self.cnot(a, b)
        self.cnot(b, a)
        self.cnot(a, b)

    def iswap(self, a: int, b: int) -> None:
        self.swap(a, b)
        self.cz(a, b)
        self.s(a)
        self.s(b)

    # --------------------------------------------------------- internals

    @staticmethod
    def _g(x1: np.ndarray, z1: np.ndarray, x2: np.ndarray, z2: np.ndarray) -> np.ndarray:
        """CHP g-function: phase exponent contribution per qubit (-1, 0, 1 mod 4)."""
        g = np.zeros_like(x1, dtype=np.int64)
        # x1 z1 = 00 -> 0
        m = (x1 == 1) & (z1 == 1)  # Y
        g[m] = (z2[m].astype(np.int64) - x2[m].astype(np.int64))
        m = (x1 == 1) & (z1 == 0)  # X
        g[m] = (z2[m].astype(np.int64) * (2 * x2[m].astype(np.int64) - 1))
        m = (x1 == 0) & (z1 == 1)  # Z
        g[m] = (x2[m].astype(np.int64) * (1 - 2 * z2[m].astype(np.int64)))
        return g

    def _rowsum(self, h: int, i: int) -> None:
        """Row h <- row h * row i with correct sign (CHP rowsum)."""
        phase = 2 * (self.r[h].astype(np.int64) + self.r[i].astype(np.int64))
        phase += int(np.sum(self._g(self.x[i], self.z[i], self.x[h], self.z[h])))
        self.r[h] = (phase % 4) // 2
        self.x[h] ^= self.x[i]
        self.z[h] ^= self.z[i]

    def _rowsum_into(
        self, xh: np.ndarray, zh: np.ndarray, rh: int, i: int
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        phase = 2 * (rh + int(self.r[i]))
        phase += int(np.sum(self._g(self.x[i], self.z[i], xh, zh)))
        return xh ^ self.x[i], zh ^ self.z[i], (phase % 4) // 2

    # ------------------------------------------------------ measurement

    def is_random(self, q: int) -> bool:
        """True iff a Z measurement on q has a random outcome."""
        return bool(np.any(self.x[self.n :, q]))

    def measure(self, q: int, status: Optional[float] = None) -> int:
        """Projective Z measurement on qubit q (collapses the tableau)."""
        n = self.n
        ps = [p for p in range(n, 2 * n) if self.x[p, q]]
        if ps:
            p = ps[0]
            for i in range(2 * n):
                if i != p and self.x[i, q]:
                    self._rowsum(i, p)
            self.x[p - n] = self.x[p].copy()
            self.z[p - n] = self.z[p].copy()
            self.r[p - n] = self.r[p]
            self.x[p] = 0
            self.z[p] = 0
            self.z[p, q] = 1
            outcome = (
                int(np.random.randint(2)) if status is None else int(status >= 0.5)
            )
            self.r[p] = outcome
            return outcome
        # deterministic
        xh = np.zeros(n, dtype=np.uint8)
        zh = np.zeros(n, dtype=np.uint8)
        rh = 0
        for i in range(n):
            if self.x[i, q]:
                xh, zh, rh = self._rowsum_into(xh, zh, rh, i + n)
        return int(rh)

    def expectation_pauli(
        self, xs: Sequence[int], zs: Sequence[int], ys: Sequence[int] = ()
    ) -> int:
        """⟨P⟩ for a Pauli string: +1/-1/0 without collapsing (peek)."""
        n = self.n
        px = np.zeros(n, dtype=np.uint8)
        pz = np.zeros(n, dtype=np.uint8)
        for q in xs:
            px[q] = 1
        for q in zs:
            pz[q] = 1
        ny = 0
        for q in ys:
            px[q] ^= 1
            pz[q] ^= 1
            ny += 1
        # commutation with each stabilizer: symplectic product
        for p in range(n, 2 * n):
            anti = int(np.sum((self.x[p] & pz) ^ (self.z[p] & px)) % 2)
            if anti:
                return 0
        # P is ± a product of stabilizers; find which via destabilizers:
        # destabilizer i anticommutes only with stabilizer i
        xh = np.zeros(n, dtype=np.uint8)
        zh = np.zeros(n, dtype=np.uint8)
        rh = 0
        for i in range(n):
            anti = int(np.sum((self.x[i] & pz) ^ (self.z[i] & px)) % 2)
            if anti:
                xh, zh, rh = self._rowsum_into(xh, zh, rh, i + n)
        if not (np.array_equal(xh, px) and np.array_equal(zh, pz)):
            # product mismatch should not happen if P commutes with all
            return 0
        # account for the i^ny phase convention of Y = i X Z:
        # our accumulated rows carry signs in the X/Z convention already;
        # the CHP g-function handles Y phases, so rh is the sign of P
        return 1 if rh == 0 else -1

    # -------------------------------------------------------- diagnostics

    def stabilizers(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self.n
        return self.x[n:], self.z[n:], self.r[n:]

    def entanglement_entropy(self, region: Sequence[int]) -> float:
        """S_A = rank_GF2(stabilizers restricted to A) - |A| (in bits -> nats)."""
        n = self.n
        region = list(region)
        sub = np.concatenate(
            [self.x[n:, region], self.z[n:, region]], axis=1
        ).astype(np.uint8)
        rank = _gf2_rank(sub)
        return float((rank - len(region)) * np.log(2.0))


def _gf2_rank(m: np.ndarray) -> int:
    m = m.copy() % 2
    rows, cols = m.shape
    rank = 0
    for c in range(cols):
        pivot = None
        for r_ in range(rank, rows):
            if m[r_, c]:
                pivot = r_
                break
        if pivot is None:
            continue
        m[[rank, pivot]] = m[[pivot, rank]]
        for r_ in range(rows):
            if r_ != rank and m[r_, c]:
                m[r_] ^= m[rank]
        rank += 1
        if rank == rows:
            break
    return rank
