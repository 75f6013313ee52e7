"""Dispatch layer of the fused TFIM path (forward).

Counterpart of ``tensorcircuit_ng_tpu/core/kernels.py:203-504``.  The
shape conditions are the JAX package's, so every shape takes the
counterpart of the kernel JAX takes there; the JAX condition "on a TPU"
becomes "the state tensor is on CUDA".  On a CPU state the port takes the
JAX package's CPU branch: plain torch, differentiable by autograd.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from . import kernels_rowlayer, statevec
from . import kernels_stack as kst
from ..ops.gates import rx_matrix

__all__ = [
    "fused_single_qubit_layer",
    "fused_zzrx_layer",
    "fused_zzrx_multilayer",
    "fused_zzrx_multilayer_energy",
    "ising_readout_spec",
    "ising_energy_dense",
]

_LANE_QUBITS = 7


def fused_single_qubit_layer(state, gates, constant: bool = False):
    """One gate per qubit, fused: needs the row-layer kernels
    (``row_layer_const`` for constant gates), which are not ported yet."""
    raise NotImplementedError(
        "fused_single_qubit_layer needs the row_layer_const / row_layer "
        "kernels (counterparts of kernels_rowlayer._pallas_row_fwd and "
        "_pallas_row_bwd_const), which are not ported yet"
    )


def _check_width(state, n: int) -> None:
    if state.shape[0] != 2**n:
        raise ValueError(f"one rx angle per qubit required: {n} angles for a state of {state.shape[0]}")


def _pairs(pairs: Any) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(a), int(b)) for a, b in pairs)


def fused_zzrx_layer(state, pairs, zz_thetas, rx_thetas):
    """exp(-i/2 Σ θ_k Z_a Z_b) then rx(φ_q) on every qubit, one layer.

    The zz phase and the kernel-row rx share kernel K1 (without its lane
    matmul); outer row qubits and the 7 lane qubits are one kron matmul
    each.  complex128 keeps the plain dense formulation."""
    rx_thetas = torch.reshape(torch.as_tensor(rx_thetas, device=state.device), (-1,))
    zz_thetas = torch.reshape(torch.as_tensor(zz_thetas, device=state.device), (-1,))
    n = rx_thetas.shape[0]
    _check_width(state, n)
    pairs = _pairs(pairs)
    if state.dtype != torch.complex64:
        psi = statevec.apply_zz_product_phase(state, pairs, zz_thetas)
        for q in range(n):
            psi = statevec.apply_unitary(
                psi, rx_matrix(rx_thetas[q], dtype=str(state.dtype).replace("torch.", "")), [q]
            )
        return psi
    nlane = min(_LANE_QUBITS, n)
    nrow = n - nlane
    nkernel = min(nrow, kernels_rowlayer.MAX_KERNEL_QUBITS_ZZRX)
    nouter = nrow - nkernel
    psi = torch.reshape(state, (max(2**nrow, 1), 2**nlane))
    if nkernel > 0:
        psi = kernels_rowlayer.zzrx_row_layer(
            pairs, n, psi, zz_thetas, rx_thetas[nouter:nrow]
        )
    else:
        psi = kernels_rowlayer._zz_phase_dense(psi, pairs, n, zz_thetas)
    if nouter:
        mo = kst._rx_kron(rx_thetas[None, :nouter])[0]
        psi = torch.reshape(mo @ torch.reshape(psi, (2**nouter, -1)), (-1,))
    psi = torch.reshape(psi, (max(2**nrow, 1), 2**nlane))
    psi = psi @ kst._rx_kron(rx_thetas[None, nrow:])[0].T
    return torch.reshape(psi, (-1,))


def _stack_ok(n: int, dtype: torch.dtype) -> bool:
    # the stack computes in float32 planes: complex128 keeps the per-layer
    # path; nouter is capped at the lane width (outer matrix <= 128 x 128)
    nouter_s = max(0, (n - _LANE_QUBITS) - kernels_rowlayer.MAX_KERNEL_QUBITS_ZZRX)
    return n > _LANE_QUBITS and nouter_s <= _LANE_QUBITS and dtype == torch.complex64


def fused_zzrx_multilayer(state, pairs, zz_thetas, rx_thetas):
    """L stacked zzrx layers: ``zz_thetas`` (L, npairs), ``rx_thetas`` (L, n).

    Runs the stack path (:func:`kernels_stack.zzrx_stack_core`) where it
    applies, else one :func:`fused_zzrx_layer` per layer."""
    zz_thetas = torch.as_tensor(zz_thetas, device=state.device)
    rx_thetas = torch.as_tensor(rx_thetas, device=state.device)
    L, n = rx_thetas.shape
    _check_width(state, n)
    pairs = _pairs(pairs)
    if not _stack_ok(n, state.dtype):
        psi = state
        for l in range(L):
            psi = fused_zzrx_layer(psi, pairs, zz_thetas[l], rx_thetas[l])
        return psi
    nrow, nkernel, nouter, _ = kst._shapes(n)
    mout, mlane = kst._theta_kron_mats(n, rx_thetas)
    psi = torch.reshape(state, (2**nrow, 2**_LANE_QUBITS))
    psi = kst.zzrx_stack_core(
        pairs, n, psi, zz_thetas, rx_thetas[:, nouter:nrow], mout, mlane
    )
    return torch.reshape(psi, (-1,))


def ising_readout_spec(n: int, zz_terms: Any = None, z_terms: Any = None, x_terms: Any = None):
    """Normalize Ising-family readout terms to the hashable spec
    ``(diag_terms, x_terms)``: diag entries are ``((qubits...), w)``
    Z-strings, x entries ``(q, w)``; ``x_terms=True`` is a uniform field."""
    diag = []
    for t in zz_terms or ():
        t = tuple(t)
        w = float(t[2]) if len(t) > 2 else 1.0
        diag.append(((int(t[0]), int(t[1])), w))
    for t in z_terms or ():
        t = (t,) if np.isscalar(t) else tuple(t)
        w = float(t[1]) if len(t) > 1 else 1.0
        diag.append(((int(t[0]),), w))
    if x_terms is True:
        x_terms = range(n)
    xs = []
    for t in x_terms or ():
        t = (t,) if np.isscalar(t) else tuple(t)
        w = float(t[1]) if len(t) > 1 else 1.0
        xs.append((int(t[0]), w))
    return tuple(diag), tuple(xs)


def ising_energy_dense(state, n: int, spec) -> torch.Tensor:
    """⟨H⟩ for an Ising-family spec on a dense state of any n and dtype
    (block sandwiches at the state's precision)."""
    nrow = max(n - _LANE_QUBITS, 0)
    r, lanes = 2**nrow, 2 ** min(n, _LANE_QUBITS)
    psi = torch.reshape(state, (r, lanes))
    return kst._readout_energy(psi.real, psi.imag, n, spec)[0]


def fused_zzrx_multilayer_energy(state, pairs, zz_thetas, rx_thetas, spec=((), ())):
    """L stacked zzrx layers + an Ising-family energy readout.

    On a CUDA complex64 state with 1 <= nouter and nrow <=
    ``MAX_GRAND_ROW_QUBITS`` this is the angle-level boundary
    (:func:`kernels_stack.zzrx_stack_energy_theta`), else the matrix-level
    one, else layers + the dense readout."""
    zz_thetas = torch.as_tensor(zz_thetas, device=state.device)
    rx_thetas = torch.as_tensor(rx_thetas, device=state.device)
    L, n = rx_thetas.shape
    _check_width(state, n)
    pairs = _pairs(pairs)
    if not _stack_ok(n, state.dtype):
        psi = fused_zzrx_multilayer(state, pairs, zz_thetas, rx_thetas)
        return ising_energy_dense(psi, n, spec)
    nrow, nkernel, nouter, _ = kst._shapes(n)
    psi = torch.reshape(state, (2**nrow, 2**_LANE_QUBITS))
    if nouter >= 1 and nrow <= kst.MAX_GRAND_ROW_QUBITS and state.is_cuda:
        return kst.zzrx_stack_energy_theta(
            pairs, n, psi, zz_thetas, rx_thetas.to(torch.float32), spec
        )
    mout, mlane = kst._theta_kron_mats(n, rx_thetas)
    return kst.zzrx_stack_energy(
        pairs, n, psi, zz_thetas, rx_thetas[:, nouter:nrow], mout, mlane, spec
    )
