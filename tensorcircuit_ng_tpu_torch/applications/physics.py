"""Physics baselines and finite-size-scaling tools.

Counterparts of reference ``applications/physics/baseline.py`` (exact 1D
TFIM / Heisenberg ground-state energies for VQE validation) and
``applications/physics/fss.py`` (critical-point data collapse).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TFIM1Denergy",
    "Heisenberg1Denergy",
    "data_collapse",
    "pc_linear_interpolation",
]


def TFIM1Denergy(L: int, Jzz: float = 1.0, Jx: float = 1.0, Pauli: bool = True) -> float:
    r"""Exact PBC ground energy of H = -Jzz Σ ZZ - Jx Σ X via free fermions.

    Jordan-Wigner + Bogoliubov: E = -Σ_q ε(q) with
    ε(q) = |Jx| sqrt(1 + g² - 2 g cos q)/..., here parameterized as in the
    spin-1/2 (Pauli=False) or Pauli-operator (Pauli=True) convention.
    Caveat (as in the reference): the AFM frustrated case (Jzz > Jx, odd L)
    is not handled.
    """
    jx = 2.0 * Jx if Pauli else Jx
    jzz = 4.0 * Jzz if Pauli else Jzz
    energy = 0.0
    # antiperiodic (even-parity) momenta for even L, shifted for odd L
    offset = (1 + (-1) ** L) / 2
    for m in range(L):
        q = np.pi * (2 * m - offset) / L
        energy -= 0.5 * abs(jx) * np.sqrt(
            1.0 + jzz**2 / (4.0 * jx**2) - (jzz / jx) * np.cos(q)
        )
    return float(energy)


def Heisenberg1Denergy(L: int, Pauli: bool = True, maxiters: int = 1000) -> float:
    r"""Exact PBC ground energy of the spin-1/2 Heisenberg chain (Bethe ansatz).

    Solves the coupled Bethe equations for the half-filled root configuration
    by fixed-point iteration on the phase matrix.
    """
    tol = 1e-15
    tiny = 1e-20
    m = L // 2
    phases = np.zeros((m, m))
    quantum_numbers = 2.0 * np.arange(m) + 1.0
    k = np.zeros(m)
    for _ in range(maxiters):
        k = (2.0 * np.pi * quantum_numbers + phases.sum(axis=-1) - np.diag(phases)) / L
        half_cot = 1.0 / (np.tan(k / 2.0) + tiny)
        new_phases = 2.0 * np.arctan(2.0 / (half_cot[:, None] - half_cot[None, :] + tiny))
        if np.allclose(phases, new_phases, rtol=tol):
            phases = new_phases
            break
        phases = new_phases
    else:
        raise ValueError(f"Bethe-ansatz iteration did not converge in {maxiters} steps")
    energy = -np.sum(1.0 - np.cos(k)) + L / 4.0
    return float(4.0 * energy if Pauli else energy)


def pc_linear_interpolation(p: Sequence[float], obs: Sequence[float], pc: float) -> float:
    """Linearly interpolate obs(p) at the critical point ``pc``."""
    p = list(p)
    if pc in p:
        return float(obs[p.index(pc)])
    right = next((i for i, v in enumerate(p) if v > pc), len(p) - 1)
    left = max(right - 1, 0)
    x0, x1 = p[left], p[right]
    y0, y1 = obs[left], obs[right]
    if x1 == x0:
        return float(y0)
    return float(y0 + (y1 - y0) * (pc - x0) / (x1 - x0))


def data_collapse(
    n: List[int],
    p: Any,
    obs: List[List[float]],
    pc: float,
    nu: float,
    beta: float = 0,
    obs_type: int = 1,
    fit_type: int = 0,
    dobs: Optional[List[List[float]]] = None,
) -> Tuple[List[float], List[List[float]], List[List[float]], float]:
    """Finite-size-scaling data collapse quality (reference ``fss.py``).

    Rescale x = (p - pc) L^{1/nu}, y = obs·L^beta (obs_type=1) or
    (obs - obs(pc))·L^beta (obs_type=0); the returned loss measures how well
    curves from different system sizes collapse (fit_type=0: mean-square
    spread against interpolated consensus; fit_type=1: uncertainty-weighted
    quality objective, needs ``dobs``).
    """
    if not isinstance(p[0], (list, tuple, np.ndarray)):
        p = [list(p) for _ in n]
    xs: List[List[float]] = []
    ys: List[List[float]] = []
    pc_vals: List[float] = []
    for i, L in enumerate(n):
        obs_at_pc = pc_linear_interpolation(p[i], obs[i], pc)
        pc_vals.append(obs_at_pc)
        xi = [(pv - pc) * L ** (1.0 / nu) for pv in p[i]]
        if obs_type == 0:
            yi = [(ov - obs_at_pc) * L**beta for ov in obs[i]]
        else:
            yi = [ov * L**beta for ov in obs[i]]
        xs.append(xi)
        ys.append(yi)

    if fit_type == 0:
        all_x = [x for xi in xs for x in xi]
        losses = []
        for x0 in all_x:
            samples = [
                pc_linear_interpolation(xs[i], ys[i], x0)
                for i in range(len(n))
                if xs[i][0] <= x0 <= xs[i][-1]
            ]
            if not samples:
                continue
            mean = float(np.mean(samples))
            losses.append(float(np.sum((np.asarray(samples) - mean) ** 2)))
        return pc_vals, xs, ys, float(np.sum(losses))

    if dobs is None:
        raise ValueError("fit_type=1 needs per-point uncertainties in `dobs`")
    triples = sorted(
        (
            (xs[i][j], ys[i][j], dobs[i][j])
            for i in range(len(n))
            for j in range(len(xs[i]))
        ),
        key=lambda t: t[0],
    )
    # uncertainty-weighted deviation from the line through neighbors
    # (PRB 101, 060301 supplement)
    ws = []
    for j in range(1, len(triples) - 1):
        x1, y1, d1 = triples[j - 1]
        x, y, d = triples[j]
        x2, y2, d2 = triples[j + 1]
        if abs(x - x1) < 1e-4 or abs(x - x2) < 1e-4:
            continue
        y_line = ((x2 - x) * y1 - (x1 - x) * y2) / (x2 - x1)
        var = (
            d**2
            + d1**2 * (x2 - x) ** 2 / (x2 - x1) ** 2
            + d2**2 * (x1 - x) ** 2 / (x2 - x1) ** 2
        )
        ws.append((y - y_line) ** 2 / var)
    return pc_vals, xs, ys, float(np.mean(ws))
