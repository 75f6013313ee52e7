"""Qudit (d-level) gate matrices.

Counterpart of ``tensorcircuit_ng_tpu/ops/quditgates.py``: the shift X and
clock Z, the Fourier H, the phase S, the two-level rotations rx/ry/rz on a
(j, k) pair, phase, u8, the pair-subspace rzz/rxx, cphase, csum and swap,
each a (d, d) or (d^2, d^2) matrix in the configured dtype.  A matrix is
numpy unless an angle is a tensor; then it is a tensor on the angle's
device, built with torch so that autograd reaches the angle.  As in the JAX
package, an angle is cast to the complex dtype before its cosines and
exponentials are taken.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import config

__all__ = [
    "x_matrix_func",
    "z_matrix_func",
    "s_matrix_func",
    "rzz_matrix_func",
    "rxx_matrix_func",
    "h_matrix_func",
    "i_matrix_func",
    "rx_matrix_func",
    "ry_matrix_func",
    "rz_matrix_func",
    "phase_matrix_func",
    "u8_matrix_func",
    "cphase_matrix_func",
    "csum_matrix_func",
    "swap_matrix_func",
    "SINGLE_BUILDERS",
    "TWO_BUILDERS",
]


def _dt() -> np.dtype:
    return config.np_dtype()


def _angle(*thetas: Any) -> Tuple[Any, ...]:
    """The angles in the complex dtype: tensors (on the first tensor's
    device) when any of them is one, else numpy scalars."""
    ts = [t for t in thetas if isinstance(t, torch.Tensor)]
    if ts:
        cdt, dev = config.torch_dtype(), ts[0].device
        return tuple(torch.as_tensor(t, device=dev).to(cdt) if not isinstance(t, torch.Tensor) else t.to(cdt)
                     for t in thetas)
    return tuple(np.asarray(t).astype(_dt()) for t in thetas)


def _eye(dim: int, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        return torch.eye(dim, dtype=like.dtype, device=like.device)
    return np.eye(dim, dtype=_dt())


def _set(m: Any, entries: dict) -> Any:
    """``m`` with ``entries`` {(row, col): value} written (a copy)."""
    m = m.clone() if isinstance(m, torch.Tensor) else m.copy()
    for (a, b), v in entries.items():
        m[a, b] = v
    return m


def _xp(x: Any) -> Any:
    return torch if isinstance(x, torch.Tensor) else np


def i_matrix_func(d: int) -> np.ndarray:
    return np.eye(d, dtype=_dt())


def x_matrix_func(d: int) -> np.ndarray:
    """Shift: X|j> = |j+1 mod d>."""
    m = np.zeros((d, d))
    for j in range(d):
        m[(j + 1) % d, j] = 1.0
    return m.astype(_dt())


def z_matrix_func(d: int, omega: Optional[complex] = None) -> np.ndarray:
    """Clock: Z|j> = w^j |j>, w = ``omega`` or exp(2 pi i / d)."""
    w = np.exp(2j * np.pi / d) if omega is None else omega
    return np.diag(w ** np.arange(d)).astype(_dt())


def h_matrix_func(d: int, omega: Optional[complex] = None) -> np.ndarray:
    """The generalized Hadamard (quantum Fourier): H_{jk} = w^{jk}/sqrt(d)."""
    w = np.exp(2j * np.pi / d) if omega is None else omega
    j, k = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    return (w ** (j * k) / np.sqrt(d)).astype(_dt())


def s_matrix_func(d: int, omega: Optional[complex] = None) -> np.ndarray:
    """The qudit phase gate: S|j> = w^{j(j+p)/2}|j>, p = d mod 2."""
    w = np.exp(2j * np.pi / d) if omega is None else omega
    j = np.arange(d)
    return np.diag(w ** (j * (j + d % 2) / 2.0)).astype(_dt())


def _two_level(d: int, block: Tuple[Any, Any, Any, Any], j: int, k: int) -> Any:
    """The identity with the 2x2 ``block`` (row-major) on levels j, k."""
    m = _eye(d, block[0])
    return _set(m, {(j, j): block[0], (j, k): block[1], (k, j): block[2], (k, k): block[3]})


def _pair_index(d: int, j1: int, k1: int, j2: int, k2: int) -> Tuple[int, int]:
    """The two basis indices |j1 j2>, |k1 k2> of a two-qudit subspace."""
    for v in (j1, k1, j2, k2):
        if not 0 <= v < d:
            raise ValueError(f"level index {v} out of range for d={d}")
    a, b = j1 * d + j2, k1 * d + k2
    if a == b:
        raise ValueError("subspace states must be distinct")
    return a, b


def rzz_matrix_func(d: int, theta: Any = 0, j1: int = 0, k1: int = 1, j2: int = 0, k2: int = 1) -> Any:
    """diag(e^{-i theta/2}, e^{+i theta/2}) on the |j1 j2>, |k1 k2> pair,
    the identity elsewhere."""
    a, b = _pair_index(d, j1, k1, j2, k2)
    (theta,) = _angle(theta)
    xp = _xp(theta)
    return _set(_eye(d * d, theta), {(a, a): xp.exp(-1j * theta / 2.0), (b, b): xp.exp(1j * theta / 2.0)})


def rxx_matrix_func(d: int, theta: Any = 0, j1: int = 0, k1: int = 1, j2: int = 0, k2: int = 1) -> Any:
    """The rx rotation of the |j1 j2>, |k1 k2> pair."""
    a, b = _pair_index(d, j1, k1, j2, k2)
    (theta,) = _angle(theta)
    xp = _xp(theta)
    c, s = xp.cos(theta / 2.0), -1j * xp.sin(theta / 2.0)
    return _set(_eye(d * d, theta), {(a, a): c, (b, b): c, (a, b): s, (b, a): s})


def rx_matrix_func(d: int, theta: Any = 0, j: int = 0, k: int = 1) -> Any:
    """The rx rotation of levels (j, k)."""
    (theta,) = _angle(theta)
    xp = _xp(theta)
    c, s = xp.cos(theta / 2), -1j * xp.sin(theta / 2)
    return _two_level(d, (c, s, s, c), j, k)


def ry_matrix_func(d: int, theta: Any = 0, j: int = 0, k: int = 1) -> Any:
    """The ry rotation of levels (j, k)."""
    (theta,) = _angle(theta)
    xp = _xp(theta)
    c, s = xp.cos(theta / 2), xp.sin(theta / 2)
    return _two_level(d, (c, -s, s, c), j, k)


def rz_matrix_func(d: int, theta: Any = 0, j: int = 0, k: int = 1) -> Any:
    """diag phases e^{-i theta/2} at level j and e^{+i theta/2} at k."""
    (theta,) = _angle(theta)
    xp = _xp(theta)
    return _set(_eye(d, theta), {(j, j): xp.exp(-1j * theta / 2), (k, k): xp.exp(1j * theta / 2)})


def phase_matrix_func(d: int, theta: Any = 0, j: int = 1) -> Any:
    """The identity with e^{i theta} at level j."""
    (theta,) = _angle(theta)
    return _set(_eye(d, theta), {(j, j): _xp(theta).exp(1j * theta)})


def u8_matrix_func(d: int, gamma: Any = 0, z: Any = 0, eps: Any = 0, omega: Optional[complex] = None) -> Any:
    """The qutrit U8 phase gate diag(1, w^z e^{i gamma}, w^{2z} e^{i eps})."""
    if d != 3:
        raise ValueError("u8 gate is defined for qutrits (d=3)")
    w0 = np.exp(2j * np.pi / 3) if omega is None else omega
    gamma, z, eps, w = _angle(gamma, z, eps, w0)
    xp = _xp(gamma)
    one = xp.ones_like(gamma)
    diag = [one, w**z * xp.exp(1j * gamma), w ** (2 * z) * xp.exp(1j * eps)]
    return torch.diag(torch.stack(diag)) if xp is torch else np.diag(np.stack(diag))


def cphase_matrix_func(d: int, cv: Optional[int] = None, theta: Any = None, omega: Optional[complex] = None) -> Any:
    """The controlled phase: without ``theta`` the SUMZ diagonal
    |j,k> -> w^{jk}|j,k> (with ``cv``, the clock on the target only where
    the control reads ``cv``); with it, e^{i theta t} on |cv, t> (``cv``
    d-1 by default)."""
    if theta is None:
        w = np.exp(2j * np.pi / d) if omega is None else omega
        if cv is not None:
            if not 0 <= cv < d:
                raise ValueError(f"cv must be in [0, {d - 1}], got {cv}")
            m = np.eye(d * d, dtype=np.complex128)
            for t in range(d):
                m[cv * d + t, cv * d + t] = w**t
            return m.astype(_dt())
        j, k = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
        return np.diag((w ** (j * k)).reshape(-1)).astype(_dt())
    (theta,) = _angle(theta)
    xp = _xp(theta)
    cv = d - 1 if cv is None else cv
    return _set(_eye(d * d, theta), {(cv * d + t, cv * d + t): xp.exp(1j * theta * t) for t in range(d)})


def csum_matrix_func(d: int, cv: Optional[int] = None) -> np.ndarray:
    """The controlled sum: |j,k> -> |j, j+k mod d>, or with ``cv`` one
    shift of the target where the control reads ``cv``."""
    m = np.zeros((d * d, d * d))
    if cv is not None:
        if not 0 <= cv < d:
            raise ValueError(f"cv must be in [0, {d - 1}], got {cv}")
        for j in range(d):
            for k in range(d):
                m[j * d + (k + (1 if j == cv else 0)) % d, j * d + k] = 1.0
        return m.astype(_dt())
    for j in range(d):
        for k in range(d):
            m[j * d + (j + k) % d, j * d + k] = 1.0
    return m.astype(_dt())


def swap_matrix_func(d: int) -> np.ndarray:
    m = np.zeros((d * d, d * d))
    for j in range(d):
        for k in range(d):
            m[k * d + j, j * d + k] = 1.0
    return m.astype(_dt())


#: name -> (parameter names, builder(d, omega=None, **kw)), as the JAX
#: package registers them
SINGLE_BUILDERS = {
    "I": (("none",), lambda d, omega=None, **kw: i_matrix_func(d)),
    "X": (("none",), lambda d, omega=None, **kw: x_matrix_func(d)),
    "Z": (("none",), lambda d, omega=None, **kw: z_matrix_func(d, omega)),
    "H": (("none",), lambda d, omega=None, **kw: h_matrix_func(d, omega)),
    "S": (("none",), lambda d, omega=None, **kw: s_matrix_func(d, omega)),
    "RX": (("theta", "j", "k"), lambda d, omega=None, **kw: rx_matrix_func(
        d, kw.get("theta", 0), kw.get("j", 0), kw.get("k", 1))),
    "RY": (("theta", "j", "k"), lambda d, omega=None, **kw: ry_matrix_func(
        d, kw.get("theta", 0), kw.get("j", 0), kw.get("k", 1))),
    "RZ": (("theta", "j"), lambda d, omega=None, **kw: rz_matrix_func(d, kw.get("theta", 0), kw.get("j", 0))),
    "PHASE": (("theta", "j"), lambda d, omega=None, **kw: phase_matrix_func(d, kw.get("theta", 0), kw.get("j", 1))),
    "U8": (("gamma", "z", "eps"), lambda d, omega=None, **kw: u8_matrix_func(
        d, kw.get("gamma", 0), kw.get("z", 0), kw.get("eps", 0), omega)),
}

TWO_BUILDERS = {
    "RXX": (("theta", "j1", "k1", "j2", "k2"), lambda d, omega=None, **kw: rxx_matrix_func(
        d, kw.get("theta", 0), kw.get("j1", 0), kw.get("k1", 1), kw.get("j2", 0), kw.get("k2", 1))),
    "RZZ": (("theta",), lambda d, omega=None, **kw: rzz_matrix_func(d, kw.get("theta", 0))),
    "CPHASE": (("cv", "theta"), lambda d, omega=None, **kw: cphase_matrix_func(
        d, kw.get("cv"), kw.get("theta"), omega)),
    "CSUM": (("cv",), lambda d, omega=None, **kw: csum_matrix_func(d, kw.get("cv"))),
    "SWAP": (("none",), lambda d, omega=None, **kw: swap_matrix_func(d)),
}
