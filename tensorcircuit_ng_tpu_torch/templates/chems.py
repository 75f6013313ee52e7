"""Quantum-chemistry helpers without openfermion or pyscf:
a hardcoded minimal-basis H2 Hamiltonian (Pauli form, STO-3G @ 0.7414 Å,
standard literature coefficients) and a generic fermion→qubit binary-code
transform for externally supplied integrals.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from ..quantum import PauliStringSum2COO, PauliStringSum2Dense

__all__ = ["h2_hamiltonian", "jordan_wigner_two_body"]


def h2_hamiltonian(sparse: bool = False, device: Optional[Any] = None) -> Any:
    """Minimal-basis H2 at equilibrium bond length (4 qubits, JW encoding)."""
    # standard coefficients (Hartree)
    terms: List[Tuple[List[int], float]] = [
        ([0, 0, 0, 0], -0.81261),
        ([3, 0, 0, 0], 0.171201),
        ([0, 3, 0, 0], 0.171201),
        ([0, 0, 3, 0], -0.2227965),
        ([0, 0, 0, 3], -0.2227965),
        ([3, 3, 0, 0], 0.16862325),
        ([3, 0, 3, 0], 0.12054625),
        ([0, 3, 0, 3], 0.12054625),
        ([3, 0, 0, 3], 0.165868),
        ([0, 3, 3, 0], 0.165868),
        ([0, 0, 3, 3], 0.1743485),
        ([1, 1, 2, 2], -0.04532175),
        ([2, 2, 1, 1], -0.04532175),
        ([1, 2, 2, 1], 0.04532175),
        ([2, 1, 1, 2], 0.04532175),
    ]
    ls = [t[0] for t in terms]
    ws = [t[1] for t in terms]
    if sparse:
        return PauliStringSum2COO(ls, ws, device=device)
    return PauliStringSum2Dense(ls, ws, device=device)


def jordan_wigner_two_body(hpq: Any, n: Optional[int] = None) -> Tuple[List[List[int]], List[float]]:
    """JW-transform a one-body integral matrix h_pq into Pauli strings.

    Returns (structures, weights) for H = Σ h_pq c†_p c_q (real symmetric
    h only — the common hopping/onsite case).
    """
    hpq = np.asarray(hpq)
    n = n or hpq.shape[0]
    ls: List[List[int]] = []
    ws: List[float] = []

    def add(l: List[int], w: float) -> None:
        if abs(w) > 1e-12:
            ls.append(l)
            ws.append(float(w))

    for p in range(n):
        if hpq[p, p] != 0:
            # c†_p c_p = (1 - Z_p)/2
            add([0] * n, hpq[p, p] / 2)
            l = [0] * n
            l[p] = 3
            add(l, -hpq[p, p] / 2)
    for p in range(n):
        for q in range(p + 1, n):
            h = (hpq[p, q] + hpq[q, p]) / 2
            if h == 0:
                continue
            # c†_p c_q + h.c. = (X_p Z... X_q + Y_p Z... Y_q)/2
            for pauli in (1, 2):
                l = [0] * n
                l[p] = pauli
                l[q] = pauli
                for m in range(p + 1, q):
                    l[m] = 3
                add(l, h / 2)
    # merge duplicate identity terms
    return ls, ws
