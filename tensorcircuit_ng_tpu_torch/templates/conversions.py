"""Problem conversions: QUBO matrices to Ising Pauli sums and back, and an
openfermion-style ``QubitOperator`` to Pauli strings."""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np

__all__ = ["QUBO_to_Ising", "Ising_to_QUBO"]


def QUBO_to_Ising(Q: Any) -> Tuple[List[List[int]], List[float], float]:
    """QUBO matrix -> (pauli structures, weights, offset).

    x_i = (1 - z_i)/2 maps x^T Q x onto Z strings.  Returns Pauli structures (0/3 codes), weights,
    and the constant offset.
    """
    Q = np.asarray(Q, dtype=float)
    n = Q.shape[0]
    Qs = (Q + Q.T) / 2.0
    offset = 0.0
    hz = np.zeros(n)
    jzz = {}
    for i in range(n):
        offset += Qs[i, i] / 2.0
        hz[i] -= Qs[i, i] / 2.0
        for j in range(i + 1, n):
            q = Qs[i, j] * 2.0  # both (i,j) and (j,i)
            offset += q / 4.0
            hz[i] -= q / 4.0
            hz[j] -= q / 4.0
            jzz[(i, j)] = jzz.get((i, j), 0.0) + q / 4.0
    structures: List[List[int]] = []
    weights: List[float] = []
    for (i, j), w in jzz.items():
        if w != 0:
            l = [0] * n
            l[i] = 3
            l[j] = 3
            structures.append(l)
            weights.append(w)
    for i in range(n):
        if hz[i] != 0:
            l = [0] * n
            l[i] = 3
            structures.append(l)
            weights.append(hz[i])
    return structures, weights, offset


def Ising_to_QUBO(
    structures: Sequence[Sequence[int]], weights: Sequence[float], offset: float = 0.0
) -> Tuple[np.ndarray, float]:
    """Inverse of :func:`QUBO_to_Ising` (z_i = 1 - 2 x_i)."""
    n = len(structures[0])
    Q = np.zeros((n, n))
    const = offset
    for l, w in zip(structures, weights):
        sites = [i for i, v in enumerate(l) if v == 3]
        if len(sites) == 1:
            (i,) = sites
            # w z_i = w (1 - 2 x_i)
            const += w
            Q[i, i] += -2 * w
        elif len(sites) == 2:
            i, j = sites
            # w z_i z_j = w (1 - 2x_i)(1 - 2x_j)
            const += w
            Q[i, i] += -2 * w
            Q[j, j] += -2 * w
            Q[i, j] += 2 * w
            Q[j, i] += 2 * w
        elif len(sites) == 0:
            const += w
        else:
            raise ValueError("only 1- and 2-local Z strings map to QUBO")
    return Q, const


def get_ps(qo: Any, n: int) -> Tuple[Any, Any]:
    """Pauli-string array + weights from an openfermion ``QubitOperator``.

    Works with any object exposing
    a ``.terms`` dict of ``{((qubit, "X"|"Y"|"Z"), ...): weight}``.
    """
    import numpy as np

    value = {"X": 1, "Y": 2, "Z": 3}
    res, wts = [], []
    for key, w in qo.terms.items():
        bit = np.zeros(n, dtype=int)
        for q, pauli in key:
            bit[q] = value[pauli]
        res.append(tuple(bit))
        wts.append(w)
    return np.array(res), np.array(wts)
