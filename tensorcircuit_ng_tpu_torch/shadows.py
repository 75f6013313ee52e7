"""Classical shadows: random Pauli-basis snapshots, the local and global
shadow states, Pauli-string estimates by median of means, the Rényi-2
and shadow entropies, and the sample-count bound.

Counterpart of ``tensorcircuit_ng_tpu/shadows.py``.  Snapshots run on the
state's device: the measurement bases of a chunk of settings are applied
to copies of the state as batched single-qubit rotations, and each
setting's shots are drawn by inverse CDF from its uniforms (``status``,
else the backend's generator of that device), the cumulative sums in a
fixed order.  The same status gives the JAX package's bits wherever a
uniform is not within rounding of a cdf boundary.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config
from .backend import backend as K
from .backend import device_tensor
from .core import statevec

Tensor = Any

__all__ = [
    "shadow_bound",
    "shadow_snapshots",
    "local_snapshot_states",
    "global_shadow_state",
    "global_shadow_state1",
    "global_shadow_state2",
    "expectation_ps_shadow",
    "entropy_shadow",
    "renyi_entropy_2",
    "slice_sub",
]


def shadow_bound(
    observables: Union[Tensor, Sequence[Sequence[int]]], epsilon: float, delta: float = 0.01
) -> Tuple[int, int]:
    """(N, k): the snapshots and the equal parts of median of means for
    ``observables`` (Pauli strings as codes 0-3) to accuracy ``epsilon``
    with probability 1 - ``delta`` (Huang, Kueng and Preskill's bound)."""
    obs = np.asarray(K.numpy(observables) if isinstance(observables, torch.Tensor) else observables)
    m = obs.shape[0]
    k = int(2 * np.log(2 * m / delta))
    max_locality = int(np.max(np.sum(obs != 0, axis=-1)))
    n_per = int(34 * 4**max_locality / (epsilon**2))
    return n_per * k, k


#: the rotations into the Z basis of measurement basis b (0 = X, 1 = Y, 2 = Z)
_ROT = np.stack(
    [
        np.array([[1, 1], [1, -1]]) / np.sqrt(2),  # H (X basis)
        np.array([[1, -1j], [1, 1j]]) / np.sqrt(2),  # H S† (Y basis)
        np.eye(2),  # Z basis
    ]
)
#: the settings whose rotated copies are held at once
_CHUNK = 32


def _cumsum_rows(p: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of each row of ``p`` (B, N) in a fixed order:
    blocks of 1024 scanned along the innermost axis, then their totals."""
    b, size = p.shape
    width = min(size, 1024)
    blocks = -(-size // width)
    cs = torch.cumsum(torch.nn.functional.pad(p, (0, blocks * width - size)).reshape(b, blocks, width), dim=-1)
    if blocks > 1:
        offsets = torch.cumsum(cs[:, :, -1], dim=-1)
        cs = torch.cat([cs[:, :1], cs[:, 1:] + offsets[:, :-1, None]], dim=1)
    return cs.reshape(b, -1)[:, :size]


def shadow_snapshots(
    psi: Any,
    pauli_strings: Any,
    status: Optional[Any] = None,
    measurement_only: bool = False,
) -> torch.Tensor:
    """Measure ``psi`` in random Pauli bases: ``pauli_strings`` [ns, nq]
    of 0/1/2 (X/Y/Z), ``status`` [ns, repeat] uniforms (default: one shot
    a setting from the backend's generator).  Returns the bits
    [ns, repeat, nq] (int32)."""
    psi = torch.reshape(psi if isinstance(psi, torch.Tensor) else torch.as_tensor(
        np.asarray(psi), device=config.resolve_device()), (-1,))
    dev = psi.device
    nq = statevec.num_slots(psi)
    strings = device_tensor(pauli_strings, dev, "pauli_strings").to(torch.int64)
    ns = strings.shape[0]
    if status is None:
        status = K.implicit_randu([ns, 1], device=dev)
    status = device_tensor(status, dev)
    rot = torch.as_tensor(_ROT, device=dev).to(psi.dtype)
    shifts = torch.arange(nq - 1, -1, -1, device=dev)
    out = []
    for lo in range(0, ns, _CHUNK):
        s = strings[lo: lo + _CHUNK]
        b = s.shape[0]
        phi = psi.expand(b, -1)
        for q in range(nq):
            phi = torch.einsum("bij,bajc->baic", rot[s[:, q]], phi.reshape(b, 2**q, 2, -1)).reshape(b, -1)
        p = statevec.probabilities(phi)
        cdf = _cumsum_rows(p / torch.sum(p, dim=1, keepdim=True))
        r = status[lo: lo + _CHUNK].to(cdf.dtype).contiguous()
        idx = torch.clamp(torch.searchsorted(cdf, r, right=True), 0, p.shape[1] - 1)
        out.append(((idx[..., None] >> shifts) & 1).to(torch.int32))
    return torch.cat(out)


def _bases(snapshots: torch.Tensor, pauli_strings: Any) -> torch.Tensor:
    """The basis of each snapshot bit, broadcast to the snapshots' shape."""
    ps = device_tensor(pauli_strings, snapshots.device, "pauli_strings").to(torch.int64)
    if ps.dim() == 2:
        ps = ps[:, None, :].expand(snapshots.shape)
    return ps


def local_snapshot_states(snapshots: Any, pauli_strings: Any, sub: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Each qubit's inverse-channel state 3 U†|b⟩⟨b|U - I: [ns, repeat,
    nq, 2, 2] in the configured dtype."""
    snapshots = device_tensor(snapshots, config.resolve_device() if not isinstance(snapshots, torch.Tensor)
                              else snapshots.device, "snapshots")
    dev = snapshots.device
    rot = torch.as_tensor(_ROT, device=dev).to(config.torch_dtype())
    # table[u, b] = 3 U_u† |b><b| U_u - I for the 3 bases and 2 outcomes
    kets = torch.conj(rot).transpose(-1, -2)  # U† |b> is column b of U†
    table = 3.0 * torch.einsum("uib,ujb->ubij", kets, torch.conj(kets)) - torch.eye(2, dtype=rot.dtype, device=dev)
    return table[_bases(snapshots, pauli_strings), snapshots.to(torch.int64)]


def _kron_mean(lss: torch.Tensor) -> torch.Tensor:
    """The mean over snapshots of the kron over qubits of [S, nq, 2, 2]."""
    out = lss[:, 0]
    for q in range(1, lss.shape[1]):
        s = out.shape[-1]
        out = torch.einsum("xab,xcd->xacbd", out, lss[:, q]).reshape(-1, 2 * s, 2 * s)
    return torch.mean(out, dim=0)


def global_shadow_state(snapshots: Any, pauli_strings: Optional[Any] = None,
                        sub: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The mean of the snapshots' global states (2^m x 2^m) over the qubits
    ``sub`` (all by default)."""
    snapshots = snapshots if isinstance(snapshots, torch.Tensor) else torch.as_tensor(
        np.asarray(snapshots), device=config.resolve_device())
    lss = snapshots if snapshots.dim() == 5 else local_snapshot_states(snapshots, pauli_strings)
    ns, repeat, nq = lss.shape[:3]
    if sub is not None:
        lss = lss[:, :, list(sub)]
        nq = len(sub)
    return _kron_mean(lss.reshape(ns * repeat, nq, 2, 2))


def expectation_ps_shadow(
    snapshots: Any,
    pauli_strings: Optional[Any] = None,
    x: Optional[Sequence[int]] = None,
    y: Optional[Sequence[int]] = None,
    z: Optional[Sequence[int]] = None,
    ps: Optional[Sequence[int]] = None,
    k: int = 1,
) -> list:
    """The k batch means of the single-snapshot estimates of a Pauli
    string (take their median); a snapshot contributes Π 3·(±1) over the
    string's qubits where every basis matches, else 0."""
    snapshots = snapshots if isinstance(snapshots, torch.Tensor) else torch.as_tensor(
        np.asarray(snapshots), device=config.resolve_device())
    ns, repeat, nq = snapshots.shape
    if ps is not None:
        obs = [int(v) for v in ps]
    else:
        obs = [0] * nq
        for code, qs in ((1, x), (2, y), (3, z)):
            for q in qs or ():
                obs[q] = code
    active = [q for q in range(nq) if obs[q]]
    bases = _bases(snapshots, pauli_strings)
    est = torch.ones((ns, repeat), dtype=torch.float32, device=snapshots.device)
    for q in active:
        sign = 1.0 - 2.0 * snapshots[:, :, q].to(torch.float32)
        est = est * torch.where(bases[:, :, q] == obs[q] - 1, 3.0 * sign, torch.zeros_like(sign))
    ests = torch.mean(est, dim=1)
    per_batch = ns // k
    return [torch.mean(ests[i * per_batch: (i + 1) * per_batch]) for i in range(k)]


def _keep(nq: int, sub: Optional[Sequence[int]], subsystem_to_keep: Optional[Sequence[int]],
          subsystems_to_trace_out: Optional[Sequence[int]]) -> list:
    if subsystem_to_keep is not None and subsystems_to_trace_out is not None:
        raise ValueError("give only one of subsystem_to_keep / subsystems_to_trace_out")
    if subsystems_to_trace_out is not None:
        return [q for q in range(nq) if q not in set(subsystems_to_trace_out)]
    if subsystem_to_keep is not None:
        return list(subsystem_to_keep)
    return list(range(nq)) if sub is None else list(sub)


def renyi_entropy_2(
    snapshots: Any,
    sub: Optional[Sequence[int]] = None,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
) -> float:
    """The second Rényi entropy of the kept qubits from randomized-
    measurement bits [ns, repeat, nq] (Brydges et al., Science 364, 260
    (2019)): tr ρ_A² = 2^nq Σ_{x,y} pp(x, y) (-2)^{-H(x, y)}, pp the pairs
    of distinct shots of one setting (an unbiased U-statistic).  Runs on
    the host; with too few snapshots the sum can be nonpositive, and the
    NaN or inf returned says the estimate failed."""
    snap = K.numpy(snapshots) if isinstance(snapshots, torch.Tensor) else np.asarray(snapshots)
    snap = snap.astype(np.int64)
    if snap.ndim == 2:
        snap = snap[:, None, :]
    snap = snap[:, :, _keep(snap.shape[2], sub, subsystem_to_keep, subsystems_to_trace_out)]
    ns, repeat, nq = snap.shape
    if repeat < 2:
        raise ValueError(
            "renyi_entropy_2 needs repeat >= 2 shots per measurement setting "
            "(cross-shot pairs within one random basis)"
        )
    codes = (snap << np.arange(nq - 1, -1, -1)[None, None, :]).sum(-1)
    uniq, inv = np.unique(codes.reshape(-1), return_inverse=True)
    counts = np.zeros((uniq.shape[0], ns), dtype=np.float64)
    inv2 = inv.reshape(ns, repeat)
    for i in range(ns):
        np.add.at(counts[:, i], inv2[i], 1.0)
    xh = uniq[:, None] ^ uniq[None, :]
    h = np.zeros_like(xh)
    for _ in range(nq):
        h += xh & 1
        xh >>= 1
    pair = counts @ counts.T
    np.fill_diagonal(pair, np.diag(pair) - counts.sum(axis=1))
    pp = pair / (ns * repeat * (repeat - 1))
    tr = float(np.sum(pp * (-2.0) ** (-h)))
    return float(-np.log(tr * 2**nq))


def entropy_shadow(
    snapshots: Any,
    pauli_strings: Optional[Any] = None,
    sub: Optional[Sequence[int]] = None,
    alpha: int = 2,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The Rényi-``alpha`` entropy (von Neumann at 1) of the shadow state
    of the kept qubits (one of ``sub``, ``subsystem_to_keep``,
    ``subsystems_to_trace_out``; a keyword wins over ``sub``)."""
    if alpha <= 0:
        raise ValueError("alpha must be a positive integer")
    shape = tuple(snapshots.shape) if hasattr(snapshots, "shape") else np.shape(snapshots)
    nq = shape[1] if len(shape) == 2 else shape[2]
    if subsystem_to_keep is not None and subsystems_to_trace_out is not None:
        raise ValueError("give only one of subsystem_to_keep / subsystems_to_trace_out")
    if sub is not None and (subsystem_to_keep is not None or subsystems_to_trace_out is not None):
        warnings.warn("both sub and a subsystem keyword given: the keyword wins and sub is ignored "
                      "(reference convention)", UserWarning)
    if subsystems_to_trace_out is not None:
        out = set(int(q) for q in subsystems_to_trace_out)
        if any(q >= nq or q < 0 for q in out):
            raise ValueError("subsystem index out of range")
        sub = [q for q in range(nq) if q not in out]
    elif subsystem_to_keep is not None:
        sub = [int(q) for q in subsystem_to_keep]
    if sub is not None and any(int(q) >= nq or int(q) < 0 for q in sub):
        raise ValueError("subsystem index out of range")
    rho = global_shadow_state(snapshots, pauli_strings, sub=sub)
    lam = torch.clamp(torch.real(torch.linalg.eigvalsh(rho)), min=1e-12)
    lam = lam / torch.sum(lam)
    if alpha == 1:
        return -torch.sum(lam * torch.log(lam))
    return torch.log(torch.sum(lam**alpha)) / (1 - alpha)


def slice_sub(entirety: Any, sub: Sequence[int]) -> torch.Tensor:
    """The qubit axis (axis 2) cut to ``sub``."""
    entirety = entirety if isinstance(entirety, torch.Tensor) else torch.as_tensor(
        np.asarray(entirety), device=config.resolve_device())
    if entirety.dim() < 3:
        entirety = entirety[:, None, :]
    return entirety[:, :, list(sub)]


def _lss_of(snapshots: Any, pauli_strings: Optional[Any], sub: Optional[Sequence[int]]) -> torch.Tensor:
    snapshots = snapshots if isinstance(snapshots, torch.Tensor) else torch.as_tensor(
        np.asarray(snapshots), device=config.resolve_device())
    if pauli_strings is not None:
        if snapshots.dim() != 3:
            raise ValueError(
                f"snapshots should be 3-d if pauli_strings is not None, got {snapshots.dim()}-d instead."
            )
        lss = local_snapshot_states(snapshots, pauli_strings)
        return slice_sub(lss, sub) if sub is not None else lss
    return slice_sub(snapshots, sub) if sub is not None else snapshots


def global_shadow_state1(snapshots: Any, pauli_strings: Optional[Any] = None,
                         sub: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The global shadow state by one einsum over the qubits."""
    lss = _lss_of(snapshots, pauli_strings, sub)
    ns, repeat, nq = lss.shape[:3]
    abc = "cdefghijklmnopqrstuvwxyz"
    terms = [f"ab{abc[2 * q]}{abc[2 * q + 1]}" for q in range(nq)]
    out = "ab" + abc[0: 2 * nq: 2] + abc[1: 2 * nq: 2]
    g = torch.einsum(",".join(terms) + "->" + out, *[lss[:, :, q] for q in range(nq)])
    return torch.mean(torch.reshape(g, (ns, repeat, 2**nq, 2**nq)), dim=(0, 1))


def global_shadow_state2(snapshots: Any, pauli_strings: Optional[Any] = None,
                         sub: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The global shadow state by kron chains."""
    lss = _lss_of(snapshots, pauli_strings, sub)
    ns, repeat, nq = lss.shape[:3]
    return _kron_mean(lss.reshape(ns * repeat, nq, 2, 2))
