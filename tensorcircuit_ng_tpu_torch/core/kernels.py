"""Dispatch layer of the fused circuit layers.

Counterpart of ``tensorcircuit_ng_tpu/core/kernels.py``.  The shape
conditions are the JAX package's, so every shape takes the counterpart of
the kernel JAX takes there; the JAX condition "on a TPU" becomes "the
state tensor is on CUDA".  On a CPU state the port takes the JAX package's
CPU branch: the plain versions of the kernels.  Every entry point
differentiates end to end: the gradients go through the autograd
boundaries of ``kernels_stack``, ``kernels_rowlayer`` and
``kernels_multilayer``.  complex128 keeps the plain per-qubit (or
per-layer) formulation on any device: the kernels compute in float32
planes.  Two switches pick the off-default kernels, as in the JAX package:
``ML_MODE`` for the zzrx runs and ``USE_ROTX`` for ``rx_layer``.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import config
from . import kernels_multilayer as kml
from . import kernels_rowlayer, statevec
from . import kernels_stack as kst
from ..ops.gates import rx_matrix

__all__ = [
    "fused_single_qubit_layer",
    "fused_single_qubit_layer_pallas",
    "fused_rx_layer",
    "block_kron_layer",
    "fused_zzrx_layer",
    "fused_zzrx_multilayer",
    "fused_zzrx_multilayer_energy",
    "ising_readout_spec",
    "ising_energy_dense",
]

_LANE_QUBITS = 7


def _lane_matrix(gates: torch.Tensor, nlane: int) -> torch.Tensor:
    """kron of the last ``nlane`` gates: one matmul applies them all."""
    m = gates[-nlane]
    for j in range(1, nlane):
        m = torch.kron(m, gates[-nlane + j])
    return m


def _apply_layer_reference(state: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Unfused: one :func:`statevec.apply_unitary` a qubit."""
    for q in range(gates.shape[0]):
        state = statevec.apply_unitary(state, gates[q], [q])
    return state


def _gate_stack(gates: Any, state: torch.Tensor) -> torch.Tensor:
    """(n, 2, 2) gates as a tensor on the state's device and dtype (keeps
    autograd)."""
    if isinstance(gates, torch.Tensor):
        return gates.to(device=state.device, dtype=state.dtype)
    return config.device_constant(gates, state.device, state.dtype)


def fused_single_qubit_layer_pallas(
    state: torch.Tensor, gates: Any, fuse_lane: bool = False, constant: bool = False
) -> torch.Tensor:
    """gates[q] on qubit q for all q, fused (UNITARY gates).

    Qubits split three ways: the first large-stride qubits (beyond the
    kernels' ``MAX_KERNEL_QUBITS`` row block) apply as plain einsums; the
    middle row qubits go to the row kernels (K6 forward; K7 backward, or
    K8 for ``constant`` gates); the last 7 lane qubits collapse into one
    128x128 kron matmul, fused into K6/K7 with ``fuse_lane``.  A complex128
    state takes the per-qubit formulation."""
    gates = _gate_stack(gates, state)
    n = gates.shape[0]
    if state.shape[0] != 2**n:
        raise ValueError(f"one gate per qubit required: {n} gates for a state of {state.shape[0]}")
    if state.dtype != torch.complex64:
        return _apply_layer_reference(state, gates)
    nlane = min(_LANE_QUBITS, n)
    nrow = n - nlane
    nkernel = min(nrow, kernels_rowlayer.MAX_KERNEL_QUBITS)
    nouter = nrow - nkernel
    psi = state
    for q in range(nouter):  # large-stride qubits: plain einsum
        psi = statevec.apply_unitary(psi, gates[q], [q])
    psi = torch.reshape(psi, (max(2**nrow, 1), 2**nlane))
    mlane = _lane_matrix(gates, nlane)
    if nkernel > 0 and fuse_lane:
        psi = kernels_rowlayer.row_layer_lane(psi, gates[nouter:nrow], mlane.T)
    elif nkernel > 0 and constant:
        psi = kernels_rowlayer.row_layer_const(psi, gates[nouter:nrow]) @ mlane.T
    elif nkernel > 0:
        psi = kernels_rowlayer.row_layer(psi, gates[nouter:nrow]) @ mlane.T
    else:
        psi = psi @ mlane.T
    return torch.reshape(psi, (-1,))


#: route ``rx_layer`` through the theta-native rotx kernels (K11 forward,
#: K12 backward: dθ directly); off by default, as in the JAX package
USE_ROTX = False


def fused_rx_layer(state: torch.Tensor, thetas: Any) -> torch.Tensor:
    """rx(thetas[q]) on every qubit.

    By default the generic fused layer of rx gates.  With ``USE_ROTX`` a
    complex64 state splits as in the JAX package: the outer row qubits
    beyond ``MAX_KERNEL_QUBITS_ROTX`` as einsums, the kernel row qubits
    through :func:`kernels_rowlayer.rotx_row_layer`, the 7 lane qubits as
    one kron matmul.  A complex128 state keeps the per-qubit formulation
    (the JAX package sends it through float32 gates there)."""
    thetas = torch.reshape(statevec.real_tensor(thetas, state.device, state.dtype), (-1,))
    if not USE_ROTX or state.dtype != torch.complex64:
        return fused_single_qubit_layer(state, rx_matrix(thetas, dtype=str(state.dtype).replace("torch.", "")))
    n = thetas.shape[0]
    _check_width(state, n)
    nlane = min(_LANE_QUBITS, n)
    nrow = n - nlane
    nkernel = min(nrow, kernels_rowlayer.MAX_KERNEL_QUBITS_ROTX)
    nouter = nrow - nkernel
    psi = state
    for q in range(nouter):
        psi = statevec.apply_unitary(psi, rx_matrix(thetas[q], dtype="complex64"), [q])
    psi = torch.reshape(psi, (max(2**nrow, 1), 2**nlane))
    if nkernel > 0:
        psi = kernels_rowlayer.rotx_row_layer(psi, thetas[nouter:nrow])
    psi = psi @ kst._rx_kron(thetas[None, nrow:])[0].T
    return torch.reshape(psi, (-1,))


def fused_single_qubit_layer(state: torch.Tensor, gates: Any, constant: bool = False) -> torch.Tensor:
    """gates[q] on qubit q for all q, fused through the row kernels (UNITARY
    gates; :func:`block_kron_layer` takes any stack)."""
    return fused_single_qubit_layer_pallas(state, gates, constant=constant)


def block_kron_layer(state: torch.Tensor, gates: Any, block: int = _LANE_QUBITS) -> torch.Tensor:
    """gates[q] on every qubit via ~n/7 block-kron matmuls; no unitarity
    requirement, plain autograd."""
    gates = _gate_stack(gates, state)
    n = gates.shape[0]
    pos = 0
    psi = state
    while pos < n:
        b = min(block, n - pos)
        m = gates[pos]
        for j in range(1, b):
            m = torch.kron(m, gates[pos + j])
        v = torch.reshape(psi, (2**pos, 2**b, -1))
        psi = torch.reshape(torch.einsum("ab,xby->xay", m, v), (-1,))
        pos += b
    return psi


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
    rx_thetas = torch.reshape(statevec.real_tensor(rx_thetas, state.device, state.dtype), (-1,))
    zz_thetas = torch.reshape(statevec.real_tensor(zz_thetas, state.device, state.dtype), (-1,))
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


#: implementation of a run of zzrx layers, as in the JAX package: "stack"
#: (the per-layer kernels under one autograd boundary; the default),
#: "pallas" (the whole-block kernels K9/K10, ``kernels_multilayer``), "xla"
#: (plain matmuls, native autograd) or "perlayer" (one
#: :func:`fused_zzrx_layer` a layer)
ML_MODE = "stack"


def fused_zzrx_multilayer(state, pairs, zz_thetas, rx_thetas):
    """L stacked zzrx layers: ``zz_thetas`` (L, npairs), ``rx_thetas`` (L, n).

    ``ML_MODE`` picks the implementation under the JAX package's conditions:
    "stack" where the stack path applies (n > 7, at most 7 outer qubits,
    complex64); "xla" from n = 10 with at most 128 pairs; any other mode
    but "perlayer" the whole-block kernels, with nrow = min(n - 7, 12) row
    qubits and at most 10 lane qubits, at most 128 pairs and complex64.
    Every other case takes one :func:`fused_zzrx_layer` a layer."""
    zz_thetas = statevec.real_tensor(zz_thetas, state.device, state.dtype)
    rx_thetas = statevec.real_tensor(rx_thetas, state.device, state.dtype)
    L, n = rx_thetas.shape
    _check_width(state, n)
    pairs = _pairs(pairs)
    # the lanes take what the whole-block row budget cannot: n=20 gives 12
    # row qubits and 8 lane qubits (256 lanes)
    nrow = min(n - _LANE_QUBITS, kml.MAX_ML_ROW_QUBITS)
    nlane = n - nrow
    if ML_MODE == "perlayer" or (ML_MODE == "stack" and not _stack_ok(n, state.dtype)) or (
        ML_MODE == "xla" and (n < 10 or len(pairs) > kml.MAX_ML_PAIRS)
    ) or (
        ML_MODE not in ("stack", "xla")
        and (
            nrow < 1
            or nlane > 10
            or len(pairs) > kml.MAX_ML_PAIRS
            or state.dtype != torch.complex64
        )
    ):
        psi = state
        for l in range(L):
            psi = fused_zzrx_layer(psi, pairs, zz_thetas[l], rx_thetas[l])
        return psi
    if ML_MODE == "xla":
        gb = min(3, n - 14) if n > 14 else 0
        cb = min(7, n - gb - 1)
        return kml.zzrx_multilayer_xla(pairs, n, state, zz_thetas, rx_thetas, split=(gb, cb))
    if ML_MODE != "stack":
        mlane = kst._rx_kron(rx_thetas[:, nrow:]).transpose(-1, -2)
        psi = torch.reshape(state, (2**nrow, 2**nlane))
        psi = kml.zzrx_multilayer(pairs, n, psi, zz_thetas, rx_thetas[:, :nrow], mlane)
        return torch.reshape(psi, (-1,))
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

    Under ``ML_MODE = "stack"``, on a complex64 state in the fused
    topology (``FUSE_LANE`` on a CUDA state) with ``FUSE_GRAND_BWD``, no
    ``FUSE_ROWM``, 1 <= nouter and nrow <= ``MAX_GRAND_ROW_QUBITS`` this is
    the angle-level boundary (:func:`kernels_stack.zzrx_stack_energy_theta`,
    backward K4), else the matrix-level one; other modes and shapes take
    :func:`fused_zzrx_multilayer` + the dense readout."""
    zz_thetas = statevec.real_tensor(zz_thetas, state.device, state.dtype)
    rx_thetas = statevec.real_tensor(rx_thetas, state.device, state.dtype)
    L, n = rx_thetas.shape
    _check_width(state, n)
    pairs = _pairs(pairs)
    if not (ML_MODE == "stack" and _stack_ok(n, state.dtype)):
        psi = fused_zzrx_multilayer(state, pairs, zz_thetas, rx_thetas)
        return ising_energy_dense(psi, n, spec)
    nrow, nkernel, nouter, _ = kst._shapes(n)
    psi = torch.reshape(state, (2**nrow, 2**_LANE_QUBITS))
    fused, _ = kst._stack_mode(n, psi)
    if (
        kst.FUSE_GRAND_BWD and fused and not kst.FUSE_ROWM
        and nouter >= 1 and nrow <= kst.MAX_GRAND_ROW_QUBITS
    ):
        return kst.zzrx_stack_energy_theta(
            pairs, n, psi, zz_thetas, rx_thetas.to(torch.float32), spec
        )
    mout, mlane = kst._theta_kron_mats(n, rx_thetas)
    return kst.zzrx_stack_energy(
        pairs, n, psi, zz_thetas, rx_thetas[:, nouter:nrow], mout, mlane, spec
    )
