"""Dense statevector operations on a flat ``(d^n,)`` torch tensor.

Counterpart of ``tensorcircuit_ng_tpu/core/statevec.py`` (the subset the
circuit path needs).  Plain torch: the JAX package leaves these to XLA, so
the port has no hand kernel for them.  Qubit q is bit ``n-1-q`` of the flat
index; each gate reshapes the state to expose only its wires.
"""

from __future__ import annotations

import math
import string
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config

__all__ = [
    "init_state",
    "num_slots",
    "apply_unitary",
    "apply_diagonal",
    "apply_zz_product_phase",
    "expectation_zz_sum",
    "expectation_x_sum",
    "expectation_ps",
    "probabilities",
]

_LETTERS = string.ascii_lowercase + string.ascii_uppercase


def num_slots(state: torch.Tensor, d: int = 2) -> int:
    size = state.shape[-1]
    n = int(round(math.log(size) / math.log(d)))
    assert d**n == size, f"state size {size} is not a power of {d}"
    return n


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _as_tensor(t: Any, like: torch.Tensor) -> torch.Tensor:
    """Numpy or torch operand -> tensor on ``like``'s device and dtype."""
    if isinstance(t, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.array(t), device=like.device).to(like.dtype)


def init_state(
    n: int,
    d: int = 2,
    dtype: Optional[str] = None,
    inputs: Optional[Any] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """|0...0> of n qudits as a flat (d^n,) vector, or reshape ``inputs``."""
    cdt = config.torch_dtype(dtype)
    device = config.resolve_device(device)
    if inputs is not None:
        if isinstance(inputs, torch.Tensor):
            s = inputs.to(device=device, dtype=cdt)
        else:
            s = torch.as_tensor(np.asarray(inputs), device=device).to(cdt)
        return torch.reshape(s, (-1,))
    s = torch.zeros((d**n,), dtype=cdt, device=device)
    s[0] = 1.0
    return s


def _exposed_shape(n: int, wires: Sequence[int], d: int) -> Tuple[int, ...]:
    """Shape (A0, d, A1, d, ..., Ak) exposing sorted ``wires``."""
    shape = []
    prev = 0
    for w in wires:
        shape.append(d ** (w - prev))
        shape.append(d)
        prev = w + 1
    shape.append(d ** (n - prev))
    return tuple(shape)


def apply_unitary(
    state: torch.Tensor, gate: Any, wires: Sequence[int], d: int = 2
) -> torch.Tensor:
    """Apply a k-site gate (``(d,)*2k`` or ``(d^k, d^k)``) on ``wires``."""
    wires = [int(w) for w in wires]
    k = len(wires)
    n = num_slots(state, d)
    g = _as_tensor(gate, state)
    if g.ndim != 2 * k:
        g = g.reshape((d,) * (2 * k))
    order = list(np.argsort(wires))
    if order != list(range(k)):
        perm = order + [k + o for o in order]
        g = g.permute(perm)
    ws = sorted(wires)
    ps = torch.reshape(state, _exposed_shape(n, ws, d))
    g_out = _LETTERS[:k]
    g_in = _LETTERS[k : 2 * k]
    seg = _LETTERS[2 * k : 3 * k + 1]
    state_sub = "".join(seg[i] + g_in[i] for i in range(k)) + seg[k]
    out_sub = "".join(seg[i] + g_out[i] for i in range(k)) + seg[k]
    out = torch.einsum(f"{g_out}{g_in},{state_sub}->{out_sub}", g, ps)
    return torch.reshape(out, (-1,))


def apply_diagonal(
    state: torch.Tensor, diag: Any, wires: Sequence[int], d: int = 2
) -> torch.Tensor:
    """Apply a diagonal k-site gate given its diagonal of shape ``(d,)*k``."""
    wires = [int(w) for w in wires]
    k = len(wires)
    n = num_slots(state, d)
    dg = _as_tensor(diag, state)
    if dg.ndim != k:
        dg = dg.reshape((d,) * k)
    order = list(np.argsort(wires))
    if order != list(range(k)):
        dg = dg.permute(order)
    ws = sorted(wires)
    ps = torch.reshape(state, _exposed_shape(n, ws, d))
    bshape = tuple(d if i % 2 == 1 else 1 for i in range(2 * k)) + (1,)
    return torch.reshape(ps * torch.reshape(dg, bshape), (-1,))


def _zsign(idx: torch.Tensor, n: int, q: int) -> torch.Tensor:
    return 1 - 2 * ((idx >> (n - 1 - int(q))) & 1)


def apply_zz_product_phase(
    state: torch.Tensor, pairs: Sequence[Tuple[int, int]], thetas: torch.Tensor
) -> torch.Tensor:
    r"""exp(-i/2 Σ_k θ_k Z_a Z_b), all pair phases in one pass over the state.

    The exponent accumulates at the state's real precision."""
    n = num_slots(state, 2)
    idx = torch.arange(state.shape[0], device=state.device)
    rdt = _real_dtype(state.dtype)
    thetas = torch.reshape(torch.as_tensor(thetas, device=state.device), (-1,)).to(rdt)
    expo = torch.zeros(state.shape[0], dtype=rdt, device=state.device)
    for k, (a, b) in enumerate(pairs):
        expo = expo + thetas[k] * (_zsign(idx, n, a) * _zsign(idx, n, b)).to(rdt)
    return state * torch.polar(torch.ones_like(expo), -0.5 * expo).to(state.dtype)


def probabilities(state: torch.Tensor) -> torch.Tensor:
    return torch.real(torch.conj(state) * state)


def expectation_zz_sum(
    state: torch.Tensor,
    pairs: Sequence[Tuple[int, int]],
    weights: Optional[Any] = None,
) -> torch.Tensor:
    r"""Σ_k w_k ⟨Z_a Z_b⟩ in one pass over |psi|²."""
    n = num_slots(state, 2)
    idx = torch.arange(state.shape[0], device=state.device)
    p = probabilities(state)
    acc = torch.zeros_like(p)
    for k, (a, b) in enumerate(pairs):
        w = 1.0 if weights is None else weights[k]
        acc = acc + w * (_zsign(idx, n, a) * _zsign(idx, n, b)).to(p.dtype)
    return torch.sum(p * acc)


def expectation_x_sum(
    state: torch.Tensor, wires: Optional[Sequence[int]] = None, block: int = 7
) -> torch.Tensor:
    r"""Σ_q ⟨X_q⟩ by block sandwiches: qubits group into blocks of ≤ ``block``,
    each block's Σ X_q is one (2^b, 2^b) matrix applied by one matmul."""
    n = num_slots(state, 2)
    wire_set = set(int(q) for q in (range(n) if wires is None else wires))
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    e2 = np.eye(2)
    total = torch.zeros((), dtype=_real_dtype(state.dtype), device=state.device)
    pos = 0
    while pos < n:
        b = min(block, n - pos)
        qubits = [pos + j for j in range(b)]
        if wire_set.intersection(qubits):
            m = np.zeros((2**b, 2**b))
            for j, q in enumerate(qubits):
                if q in wire_set:
                    term = np.eye(1)
                    for jj in range(b):
                        term = np.kron(term, x if jj == j else e2)
                    m = m + term
            v = torch.reshape(state, (2**pos, 2**b, -1))
            mv = torch.einsum("ab,xby->xay", _as_tensor(m, state), v)
            total = total + torch.real(torch.vdot(v.reshape(-1), mv.reshape(-1)))
        pos += b
    return total


def _flip_slot(state: torch.Tensor, wire: int, d: int = 2) -> torch.Tensor:
    n = num_slots(state, d)
    v = torch.reshape(state, _exposed_shape(n, [wire], d))
    return torch.reshape(torch.flip(v, dims=(1,)), (-1,))


def expectation_ps(
    state: torch.Tensor,
    x: Optional[Sequence[int]] = None,
    y: Optional[Sequence[int]] = None,
    z: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """⟨psi| X_x Y_y Z_z |psi⟩: flips and sign masks, no matmuls."""
    phi = state
    for q in x or ():
        phi = _flip_slot(phi, q)
    for q in y or ():
        # Y = flip ∘ diag(i, -i)
        phi = apply_diagonal(phi, np.array([1j, -1j]), [q])
        phi = _flip_slot(phi, q)
    for q in z or ():
        phi = apply_diagonal(phi, np.array([1.0, -1.0]), [q])
    return torch.vdot(state, phi)
