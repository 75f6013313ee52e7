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
    "apply_zstring_phase",
    "apply_multicz",
    "expectation_zz_sum",
    "expectation_1q_sum",
    "expectation_x_sum",
    "flip_slot",
    "sign_slot",
    "expectation_local",
    "expectation_ps",
    "amplitude",
    "probabilities",
    "marginal_probability",
    "reduced_density_matrix",
    "project_slot",
    "block_sums",
    "sample_trajectories",
    "cumsum_fixed_order",
]

_LETTERS = string.ascii_lowercase + string.ascii_uppercase


def num_slots(state: torch.Tensor, d: int = 2) -> int:
    size = state.shape[-1]
    n = int(round(math.log(size) / math.log(d)))
    assert d**n == size, f"state size {size} is not a power of {d}"
    return n


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def real_tensor(x: Any, device: Any, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a real tensor on ``device``.  A tensor or a numpy array keeps
    its dtype (and its autograd graph); Python numbers, and lists of them,
    are built in the real dtype of the complex ``dtype``: float64 under
    complex128, as the JAX package's ``jnp.asarray`` gives after
    ``set_dtype``, not torch's default float32."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(x, device=device)
    return torch.as_tensor(x, dtype=_real_dtype(dtype), device=device)


def _as_tensor(t: Any, like: torch.Tensor) -> torch.Tensor:
    """Numpy or torch operand -> tensor on ``like``'s device and dtype."""
    if isinstance(t, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return config.device_constant(t, like.device, like.dtype)


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
    s[:1].fill_(1.0)  # no host-to-device copy: capturable in a CUDA graph
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
    thetas = torch.reshape(real_tensor(thetas, state.device, state.dtype), (-1,)).to(rdt)
    expo = torch.zeros(state.shape[0], dtype=rdt, device=state.device)
    for k, (a, b) in enumerate(pairs):
        expo = expo + thetas[k] * (_zsign(idx, n, a) * _zsign(idx, n, b)).to(rdt)
    return state * torch.polar(torch.ones_like(expo), -0.5 * expo).to(state.dtype)


def apply_zstring_phase(state: torch.Tensor, wires: Sequence[int], theta: Any) -> torch.Tensor:
    r"""exp(-i theta/2 Z_{w1} ... Z_{wk}) in one elementwise pass: the sign
    is the parity of the wires' index bits (no 2^k matrix)."""
    n = num_slots(state, 2)
    idx = torch.arange(state.shape[0], device=state.device)
    parity = torch.zeros_like(idx)
    for w in wires:
        parity = parity ^ ((idx >> (n - 1 - int(w))) & 1)
    rdt = _real_dtype(state.dtype)
    theta = real_tensor(theta, state.device, state.dtype).to(rdt)
    expo = theta * (1 - 2 * parity).to(rdt)
    return state * torch.polar(torch.ones_like(expo), -0.5 * expo).to(state.dtype)


def apply_multicz(state: torch.Tensor, wires: Sequence[int]) -> torch.Tensor:
    r"""k-controlled Z: flip the sign of the amplitudes where every wire is
    1, in one elementwise pass."""
    n = num_slots(state, 2)
    idx = torch.arange(state.shape[0], device=state.device)
    mask = 0
    for w in wires:
        mask |= 1 << (n - 1 - int(w))
    sign = 1.0 - 2.0 * ((idx & mask) == mask).to(_real_dtype(state.dtype))
    return state * sign.to(state.dtype)


def probabilities(state: torch.Tensor) -> torch.Tensor:
    return torch.real(torch.conj(state) * state)


def amplitude(state: torch.Tensor, bitstring: Sequence[int], d: int = 2) -> torch.Tensor:
    """⟨b|psi⟩ for a computational-basis string of ints."""
    n = num_slots(state, d)
    b = torch.as_tensor(np.asarray(bitstring), device=state.device).to(torch.int64)
    radix = torch.as_tensor([d ** (n - 1 - i) for i in range(n)], device=state.device)
    return state[torch.sum(b * radix)]


def marginal_probability(state: torch.Tensor, wires: Sequence[int], d: int = 2) -> torch.Tensor:
    """Marginal probability over ``wires`` (flat, length d^len(wires), in
    the order of ``wires``)."""
    wires = [int(w) for w in wires]
    k = len(wires)
    n = num_slots(state, d)
    ps = torch.reshape(probabilities(state), _exposed_shape(n, sorted(wires), d))
    m = torch.sum(ps, dim=tuple(2 * i for i in range(k + 1)))  # (d,)*k, sorted order
    order = list(np.argsort(wires))
    inv = [order.index(i) for i in range(k)]
    if inv != list(range(k)):
        m = m.permute(inv)
    return torch.reshape(m, (-1,))


def reduced_density_matrix(state: torch.Tensor, wires: Sequence[int], d: int = 2) -> torch.Tensor:
    """The (d^k, d^k) reduced density matrix Tr_rest |psi><psi| of the k
    ``wires`` (rows and columns in the order of ``wires``), unnormalized:
    one pass over the state."""
    wires = [int(w) for w in wires]
    k = len(wires)
    n = num_slots(state, d)
    ps = torch.reshape(state, _exposed_shape(n, sorted(wires), d))
    ket, bra, seg = _LETTERS[:k], _LETTERS[k : 2 * k], _LETTERS[2 * k : 3 * k + 1]
    sub_ket = "".join(seg[i] + ket[i] for i in range(k)) + seg[k]
    sub_bra = "".join(seg[i] + bra[i] for i in range(k)) + seg[k]
    rho = torch.einsum(f"{sub_ket},{sub_bra}->{ket}{bra}", ps, torch.conj(ps))
    order = list(np.argsort(wires))
    inv = [order.index(i) for i in range(k)]
    if inv != list(range(k)):
        rho = rho.permute(inv + [k + i for i in inv])
    return torch.reshape(rho, (d**k, d**k))


def project_slot(
    state: torch.Tensor, wire: int, outcome: Any, d: int = 2, renormalize: bool = True
) -> torch.Tensor:
    """Project ``wire`` onto basis state ``outcome`` (0..d-1, an int or a
    0-d tensor), renormalized unless the projection is zero."""
    outcome = torch.as_tensor(outcome, device=state.device).to(torch.int64)
    sel = torch.nn.functional.one_hot(outcome, d).to(state.dtype)
    proj = apply_diagonal(state, sel, [wire], d)
    if renormalize:
        nrm = torch.linalg.vector_norm(proj)
        proj = proj / torch.where(nrm == 0, torch.ones_like(nrm), nrm).to(proj.dtype)
    return proj


project_qubit = project_slot


#: the widest row :func:`cumsum_fixed_order` scans in one piece
_SCAN_ROW = 1024


def cumsum_fixed_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor whose float sums run in the same
    order on every call.  On the card ``torch.cumsum`` of one long row is
    CUB's decoupled look-back scan, whose partial sums depend on timing: at
    n=20 two calls moved 157 of 8,192 inverse-CDF indices.  Here rows of
    ``_SCAN_ROW`` entries are scanned each by one block (torch's scan along
    the innermost of several rows), then their totals the same way, and
    each row gets its predecessors' total."""
    size = x.shape[0]
    rows = -(-size // _SCAN_ROW)
    xs = torch.nn.functional.pad(x, (0, rows * _SCAN_ROW - size)).reshape(rows, _SCAN_ROW)
    if rows == 1:  # two rows: never the one-row (CUB) route
        return torch.cumsum(torch.cat([xs, torch.zeros_like(xs)]), dim=1)[0, :size]
    cs = torch.cumsum(xs, dim=1)
    offsets = cumsum_fixed_order(cs[:, -1])
    cs = torch.cat([cs[:1], cs[1:] + offsets[:-1, None]])
    return cs.reshape(-1)[:size]


def block_sums(p: torch.Tensor, d: int = 2) -> list:
    """The d-ary tree of block sums of ``p`` (d^n,): entry k is the (d^k,)
    vector of the sums over the blocks that fix the first k digits (qubits
    0..k-1), from k = 0 (the total) to k = n (``p`` itself); about
    d^(n+1)/(d-1) entries in all."""
    n = num_slots(p, d)
    levels = [p]
    for k in range(n - 1, -1, -1):
        levels.append(torch.sum(torch.reshape(levels[-1], (d**k, d)), dim=1))
    return levels[::-1]


#: tie-break added to each uniform, as in the JAX package's measurement
MEASURE_EPS = 0.31415926e-12


def sample_trajectories(
    p: torch.Tensor, status: torch.Tensor, d: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Measure every qudit of a state with probabilities ``p`` (d^n,),
    qudit 0 first, once a row of ``status`` [batch, n]: the outcomes
    [batch, n] (int32) and each shot's probability [batch].

    The outcomes of ``measure_jit`` on each row, without a state a shot: the
    measured prefix fixes one contiguous block of ``p``, so the conditional
    marginal of the next qudit is its block's d child sums in
    :func:`block_sums`, renormalized, cumulated and searched at
    ``status[:, k] + MEASURE_EPS`` (the first child whose cdf reaches it,
    held to d-1).  n vectorised steps over the batch on ``p``'s device."""
    n = num_slots(p, d)
    levels = block_sums(p, d)
    batch = status.shape[0]
    status = status.to(p.dtype)
    children = torch.arange(d, device=p.device)
    block = torch.zeros((batch,), dtype=torch.int64, device=p.device)
    prob = torch.ones((batch,), dtype=p.dtype, device=p.device)
    outcomes = []
    for k in range(n):
        sums = levels[k + 1][block[:, None] * d + children]  # (batch, d)
        marg = sums / torch.sum(sums, dim=1, keepdim=True)
        cdf = torch.cumsum(marg, dim=1)
        u = status[:, k] + MEASURE_EPS
        out = torch.clamp(torch.sum(cdf < u[:, None], dim=1), max=d - 1)
        prob = prob * torch.gather(marg, 1, out[:, None])[:, 0]
        block = block * d + out
        outcomes.append(out)
    return torch.stack(outcomes, dim=1).to(torch.int32), prob


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


def expectation_1q_sum(
    state: torch.Tensor, op: Any, wires: Optional[Sequence[int]] = None, block: int = 7
) -> torch.Tensor:
    r"""Σ_{q∈wires} ⟨O_q⟩ for one single-qubit operator O by block
    sandwiches: qubits group into blocks of ≤ ``block``, each block's Σ O_q
    is one (2^b, 2^b) matrix applied by one matmul.  Real part, at the
    state's real precision."""
    n = num_slots(state, 2)
    wire_set = set(int(q) for q in (range(n) if wires is None else wires))
    op = np.asarray(op)
    e2 = np.eye(2)
    total = torch.zeros((), dtype=_real_dtype(state.dtype), device=state.device)
    pos = 0
    while pos < n:
        b = min(block, n - pos)
        qubits = [pos + j for j in range(b)]
        if wire_set.intersection(qubits):
            m = np.zeros((2**b, 2**b), dtype=complex)
            for j, q in enumerate(qubits):
                if q in wire_set:
                    term = np.eye(1)
                    for jj in range(b):
                        term = np.kron(term, op if jj == j else e2)
                    m = m + term
            v = torch.reshape(state, (2**pos, 2**b, -1))
            mv = torch.einsum("ab,xby->xay", _as_tensor(m, state), v)
            total = total + torch.real(torch.vdot(v.reshape(-1), mv.reshape(-1)))
        pos += b
    return total


def expectation_x_sum(
    state: torch.Tensor, wires: Optional[Sequence[int]] = None, block: int = 7
) -> torch.Tensor:
    r"""Σ_q ⟨X_q⟩ by block sandwiches (:func:`expectation_1q_sum`)."""
    return expectation_1q_sum(state, np.array([[0.0, 1.0], [1.0, 0.0]]), wires, block)


def flip_slot(state: torch.Tensor, wire: int, d: int = 2) -> torch.Tensor:
    """X-like index reversal on one slot (an axis flip)."""
    n = num_slots(state, d)
    v = torch.reshape(state, _exposed_shape(n, [wire], d))
    return torch.reshape(torch.flip(v, dims=(1,)), (-1,))


def sign_slot(state: torch.Tensor, wire: int, d: int = 2) -> torch.Tensor:
    """Z on one slot (d=2): the sign mask diag(1, -1)."""
    return apply_diagonal(state, np.array([1.0, -1.0]), [wire], d)


def expectation_local(
    state: torch.Tensor, ops: Sequence[Tuple[Any, Sequence[int]]], d: int = 2
) -> torch.Tensor:
    """⟨psi| Π_i O_i |psi⟩ for local operators ``(O_i, wires_i)``."""
    phi = state
    for op, wires in ops:
        phi = apply_unitary(phi, op, wires, d)
    return torch.vdot(state, phi)


def expectation_ps(
    state: torch.Tensor,
    x: Optional[Sequence[int]] = None,
    y: Optional[Sequence[int]] = None,
    z: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """⟨psi| X_x Y_y Z_z |psi⟩: flips and sign masks, no matmuls."""
    phi = state
    for q in x or ():
        phi = flip_slot(phi, q)
    for q in y or ():
        # Y = flip ∘ diag(i, -i)
        phi = apply_diagonal(phi, np.array([1j, -1j]), [q])
        phi = flip_slot(phi, q)
    for q in z or ():
        phi = sign_slot(phi, q)
    return torch.vdot(state, phi)
