"""Exact sympy gate matrices of the port (``tct.symbolgates``).

Counterpart of ``tensorcircuit_ng_tpu/ops/symbolgates.py``: the standard
gate set as ``sympy.Matrix`` for algebra on circuits, and the rotations over
free symbols.  Everything here is host sympy; :class:`SymbolCircuit
<tensorcircuit_ng_tpu_torch.models.symbolcircuit.SymbolCircuit>` records
these matrices and binds them to numbers for the device.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = [
    "sym_i", "sym_x", "sym_y", "sym_z", "sym_h", "sym_s", "sym_sd",
    "sym_t", "sym_td", "sym_cnot", "sym_cz", "sym_swap",
    "sym_rx", "sym_ry", "sym_rz", "sym_phase", "sym_rzz", "sym_u",
    "sym_wroot", "sym_cy", "sym_ox", "sym_oy", "sym_oz", "sym_toffoli",
    "sym_fredkin", "sym_r", "sym_rxx", "sym_ryy", "sym_iswap", "sym_cphase",
    "sym_crx", "sym_cry", "sym_crz", "sym_cu", "sym_cr", "sym_orx",
    "sym_ory", "sym_orz", "sym_any",
]


def _sp() -> Any:
    import sympy

    return sympy


def sym_i() -> Any:
    return _sp().eye(2)


def sym_x() -> Any:
    return _sp().Matrix([[0, 1], [1, 0]])


def sym_y() -> Any:
    sp = _sp()
    return sp.Matrix([[0, -sp.I], [sp.I, 0]])


def sym_z() -> Any:
    return _sp().Matrix([[1, 0], [0, -1]])


def sym_h() -> Any:
    sp = _sp()
    return sp.Matrix([[1, 1], [1, -1]]) / sp.sqrt(2)


def sym_s() -> Any:
    sp = _sp()
    return sp.Matrix([[1, 0], [0, sp.I]])


def sym_sd() -> Any:
    return sym_s().conjugate().T


def sym_t() -> Any:
    sp = _sp()
    return sp.Matrix([[1, 0], [0, sp.exp(sp.I * sp.pi / 4)]])


def sym_td() -> Any:
    return sym_t().conjugate().T


def sym_cnot() -> Any:
    return _sp().Matrix([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])


def sym_cz() -> Any:
    return _sp().diag(1, 1, 1, -1)


def sym_swap() -> Any:
    return _sp().Matrix([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])


def sym_rx(theta: Any) -> Any:
    sp = _sp()
    c, s = sp.cos(theta / 2), sp.sin(theta / 2)
    return sp.Matrix([[c, -sp.I * s], [-sp.I * s, c]])


def sym_ry(theta: Any) -> Any:
    sp = _sp()
    c, s = sp.cos(theta / 2), sp.sin(theta / 2)
    return sp.Matrix([[c, -s], [s, c]])


def sym_rz(theta: Any) -> Any:
    sp = _sp()
    return sp.diag(sp.exp(-sp.I * theta / 2), sp.exp(sp.I * theta / 2))


def sym_phase(theta: Any) -> Any:
    sp = _sp()
    return sp.diag(1, sp.exp(sp.I * theta))


def sym_rzz(theta: Any) -> Any:
    sp = _sp()
    em, ep = sp.exp(-sp.I * theta / 2), sp.exp(sp.I * theta / 2)
    return sp.diag(em, ep, ep, em)


def sym_u(theta: Any, phi: Any, lbd: Any) -> Any:
    sp = _sp()
    c, s = sp.cos(theta / 2), sp.sin(theta / 2)
    return sp.Matrix(
        [
            [c, -sp.exp(sp.I * lbd) * s],
            [sp.exp(sp.I * phi) * s, sp.exp(sp.I * (phi + lbd)) * c],
        ]
    )


def sym_wroot() -> Any:
    """The square root of W = (X + Y)/sqrt(2)."""
    sp = _sp()
    v = 1 / sp.sqrt(2)
    return sp.Matrix([[v, -v * (1 + sp.I) / sp.sqrt(2)], [v * (1 - sp.I) / sp.sqrt(2), v]])


def sym_cy() -> Any:
    sp = _sp()
    return sp.Matrix([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, -sp.I], [0, 0, sp.I, 0]])


def _sym_ocontrolled(u: Any) -> Any:
    """[[U, 0], [0, I]]: ``u`` acts where the control is |0>."""
    m = _sp().zeros(4, 4)
    m[0:2, 0:2] = u
    m[2, 2] = 1
    m[3, 3] = 1
    return m


def _sym_controlled(u: Any) -> Any:
    """[[I, 0], [0, U]]: ``u`` acts where the control is |1>."""
    m = _sp().eye(4)
    m[2:4, 2:4] = u
    return m


def sym_ox() -> Any:
    return _sym_ocontrolled(sym_x())


def sym_oy() -> Any:
    return _sym_ocontrolled(sym_y())


def sym_oz() -> Any:
    return _sym_ocontrolled(sym_z())


def sym_orx(theta: Any = 0) -> Any:
    return _sym_ocontrolled(sym_rx(theta))


def sym_ory(theta: Any = 0) -> Any:
    return _sym_ocontrolled(sym_ry(theta))


def sym_orz(theta: Any = 0) -> Any:
    return _sym_ocontrolled(sym_rz(theta))


def _sym_swap_rows(size: int, a: int, b: int) -> Any:
    """The identity of ``size`` with the basis states ``a`` and ``b`` exchanged."""
    m = _sp().eye(size)
    m[a, a] = m[b, b] = 0
    m[a, b] = m[b, a] = 1
    return m


def sym_toffoli() -> Any:
    return _sym_swap_rows(8, 6, 7)


def sym_fredkin() -> Any:
    return _sym_swap_rows(8, 5, 6)


def sym_r(theta: Any = 0, alpha: Any = 0, phi: Any = 0) -> Any:
    """exp(-iθ n·σ) about the axis n of polar angle ``alpha`` and azimuth ``phi``."""
    sp = _sp()
    h = (
        sp.sin(alpha) * sp.cos(phi) * sym_x()
        + sp.sin(alpha) * sp.sin(phi) * sym_y()
        + sp.cos(alpha) * sym_z()
    )
    return sp.cos(theta) * sp.eye(2) - sp.I * sp.sin(theta) * h


def _sym_pauli_rotation(theta: Any, pp: np.ndarray) -> Any:
    """cos(θ/2) I - i sin(θ/2) P for a real two-qubit Pauli product ``pp``."""
    sp = _sp()
    return sp.cos(theta / 2) * sp.eye(4) - sp.I * sp.sin(theta / 2) * sp.Matrix(pp.astype(int).tolist())


def sym_rxx(theta: Any = 0) -> Any:
    x = np.array([[0, 1], [1, 0]])
    return _sym_pauli_rotation(theta, np.kron(x, x))


def sym_ryy(theta: Any = 0) -> Any:
    y = np.array([[0, -1j], [1j, 0]])
    return _sym_pauli_rotation(theta, np.real(np.kron(y, y)))


def sym_iswap(theta: Any = 1) -> Any:
    sp = _sp()
    c, s = sp.cos(sp.pi * theta / 2), sp.sin(sp.pi * theta / 2)
    return sp.Matrix([[1, 0, 0, 0], [0, c, sp.I * s, 0], [0, sp.I * s, c, 0], [0, 0, 0, 1]])


def sym_cphase(theta: Any = 0) -> Any:
    sp = _sp()
    return sp.diag(1, 1, 1, sp.exp(sp.I * theta))


def sym_crx(theta: Any = 0) -> Any:
    return _sym_controlled(sym_rx(theta))


def sym_cry(theta: Any = 0) -> Any:
    return _sym_controlled(sym_ry(theta))


def sym_crz(theta: Any = 0) -> Any:
    return _sym_controlled(sym_rz(theta))


def sym_cu(theta: Any = 0, phi: Any = 0, lbd: Any = 0) -> Any:
    return _sym_controlled(sym_u(theta, phi, lbd))


def sym_cr(theta: Any = 0, alpha: Any = 0, phi: Any = 0) -> Any:
    return _sym_controlled(sym_r(theta, alpha, phi))


def sym_any(unitary: Any) -> Any:
    """An arbitrary matrix (numpy, nested lists, a host copy of a tensor, or
    sympy) as a ``sympy.Matrix``."""
    if hasattr(unitary, "detach"):
        unitary = unitary.detach().cpu().numpy()
    if hasattr(unitary, "tolist"):
        unitary = unitary.tolist()
    return _sp().Matrix(unitary)
