"""Pauli-noise channel algebra on error bits, and the channel sampler.

Counterpart of ``tensorcircuit_ng_tpu/zx/noise_model.py`` (itself derived
from the public tsim package): probability distributions over bit patterns
of error insertions ("e-basis"), a GF(2) transform to the reduced "f-basis"
that actually influences outcomes, and algebraic simplification (null-bit
marginalization, XOR-convolution merging, subset absorption).  The algebra
is host numpy, the port's own copy.

- :func:`xor_convolve` uses the Walsh–Hadamard transform (the distribution
  over GF(2)^k convolves pointwise in WHT space).
- Bit conventions: outcome index ``o`` assigns bit ``(o >> i) & 1`` to
  position ``i`` of ``unique_col_ids`` (LSB-first).
- :meth:`ChannelSampler.sample_jax` (the JAX package's name) draws every
  channel's categorical at once on the device from a ``torch.Generator``
  (``torch.multinomial`` over the channels' padded distributions), then
  XOR-reduces the chosen f-bit patterns.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config

__all__ = [
    "Channel",
    "error_probs",
    "pauli_channel_1_probs",
    "pauli_channel_2_probs",
    "correlated_error_probs",
    "xor_convolve",
    "reduce_null_bits",
    "normalize_channels",
    "expand_channel",
    "merge_identical_channels",
    "absorb_subset_channels",
    "simplify_channels",
    "ChannelSampler",
]


@dataclass
class Channel:
    """Probability distribution over 2^k error-bit patterns.

    ``probs[o]`` is the probability that the pattern with bits
    ``(o >> i) & 1`` fires; ``unique_col_ids[i]`` names the f-signature
    column that bit ``i`` feeds.
    """

    probs: Any
    unique_col_ids: Tuple[int, ...]

    @property
    def num_bits(self) -> int:
        return int(np.log2(len(self.probs)))


def error_probs(p: float) -> np.ndarray:
    """One-bit error distribution [1-p, p] (reference parity)."""
    return np.array([1.0 - p, p], dtype=np.float64)


def pauli_channel_1_probs(px: float, py: float, pz: float) -> np.ndarray:
    """Single-qubit Pauli channel over bits (z, x): order [I, Z, X, Y]."""
    return np.array([1.0 - px - py - pz, pz, px, py], dtype=np.float64)


def pauli_channel_2_probs(*ps: float) -> np.ndarray:
    """Two-qubit Pauli channel over bits (z1, x1, z2, x2).

    Arguments follow the stim ``PAULI_CHANNEL_2`` order:
    (pix, piy, piz, pxi, pxx, pxy, pxz, pyi, pyx, pyy, pyz,
    pzi, pzx, pzy, pzz).
    """
    if len(ps) != 15:
        raise ValueError("pauli_channel_2_probs takes 15 probabilities")
    names = [
        "ix", "iy", "iz", "xi", "xx", "xy", "xz",
        "yi", "yx", "yy", "yz", "zi", "zx", "zy", "zz",
    ]
    table = dict(zip(names, ps))
    # per-qubit Pauli -> (z, x) bit pair: I=00, Z=10, X=01, Y=11
    bits = {"i": (0, 0), "z": (1, 0), "x": (0, 1), "y": (1, 1)}
    probs = np.zeros(16, dtype=np.float64)
    for name, p in table.items():
        z1, x1 = bits[name[0]]
        z2, x2 = bits[name[1]]
        probs[z1 | (x1 << 1) | (z2 << 2) | (x2 << 3)] = p
    probs[0] = 1.0 - sum(ps)
    return probs


def correlated_error_probs(probabilities: Sequence[float]) -> np.ndarray:
    """Joint distribution of a CORRELATED_ERROR / ELSE_CORRELATED_ERROR chain.

    Outcomes are mutually exclusive: P(bit i fires) = prod_{j<i}(1-p_j) p_i.
    """
    k = len(probabilities)
    probs = np.zeros(2**k, dtype=np.float64)
    survive = 1.0
    for i, p in enumerate(probabilities):
        probs[1 << i] = survive * p
        survive *= 1.0 - p
    probs[0] = survive
    return probs


def _wht(v: np.ndarray) -> np.ndarray:
    """In-place-free Walsh–Hadamard transform (unnormalized)."""
    v = np.array(v, dtype=np.float64)
    n = v.shape[0]
    h = 1
    while h < n:
        v = v.reshape(-1, 2, h)
        v = np.stack([v[:, 0] + v[:, 1], v[:, 0] - v[:, 1]], axis=1)
        v = v.reshape(n)
        h *= 2
    return v


def xor_convolve(probs_a: Any, probs_b: Any) -> np.ndarray:
    """Distribution of a XOR b for independent patterns a ~ A, b ~ B.

    Computed by pointwise multiplication in Walsh–Hadamard space.
    """
    a = np.asarray(probs_a, dtype=np.float64)
    b = np.asarray(probs_b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError("Both channels must have same number of outcomes")
    out = _wht(_wht(a) * _wht(b)) / a.shape[0]
    return np.clip(out, 0.0, None)


def _bits_of(outcomes: np.ndarray, k: int) -> np.ndarray:
    """LSB-first bit matrix of shape (len(outcomes), k)."""
    return ((outcomes[:, None] >> np.arange(k)) & 1).astype(np.uint8)


def _permute_bits(probs: np.ndarray, perm: Sequence[int]) -> np.ndarray:
    """Reindex a 2^k distribution so new bit j = old bit perm[j]."""
    k = int(np.log2(len(probs)))
    outcomes = np.arange(len(probs))
    bits = _bits_of(outcomes, k)
    new_idx = np.zeros(len(probs), dtype=np.int64)
    for j, old in enumerate(perm):
        new_idx |= bits[:, old].astype(np.int64) << j
    out = np.zeros_like(probs)
    out[new_idx] = probs
    return out


def reduce_null_bits(
    channels: List[Channel], null_col_id: Optional[int] = None
) -> List[Channel]:
    """Marginalize out bits feeding the all-zero signature column."""
    if null_col_id is None:
        return channels
    out: List[Channel] = []
    for ch in channels:
        k = ch.num_bits
        live = [i for i, cid in enumerate(ch.unique_col_ids) if cid != null_col_id]
        if not live:
            continue  # channel affects nothing
        if len(live) == k:
            out.append(ch)
            continue
        outcomes = np.arange(len(ch.probs))
        bits = _bits_of(outcomes, k)
        new_idx = np.zeros(len(ch.probs), dtype=np.int64)
        for j, i in enumerate(live):
            new_idx |= bits[:, i].astype(np.int64) << j
        new_probs = np.zeros(2 ** len(live), dtype=np.float64)
        np.add.at(new_probs, new_idx, np.asarray(ch.probs, dtype=np.float64))
        out.append(
            Channel(new_probs, tuple(ch.unique_col_ids[i] for i in live))
        )
    return out


def normalize_channels(channels: List[Channel]) -> List[Channel]:
    """Sort each channel's col ids ascending, permuting probs to match."""
    out: List[Channel] = []
    for ch in channels:
        ids = np.asarray(ch.unique_col_ids)
        perm = np.argsort(ids, kind="stable")
        out.append(
            Channel(
                _permute_bits(np.asarray(ch.probs, dtype=np.float64), perm),
                tuple(int(i) for i in ids[perm]),
            )
        )
    return out


def expand_channel(channel: Channel, target_col_ids: Tuple[int, ...]) -> Channel:
    """Embed a channel into a sorted superset signature (new bits = 0)."""
    src = channel.unique_col_ids
    if src != tuple(sorted(src)) or target_col_ids != tuple(sorted(target_col_ids)):
        raise ValueError("both signatures must be sorted")
    if not set(src) < set(target_col_ids):
        raise ValueError("source must be a strict subset of target")
    pos = {c: j for j, c in enumerate(target_col_ids)}
    k = channel.num_bits
    outcomes = np.arange(len(channel.probs))
    bits = _bits_of(outcomes, k)
    new_idx = np.zeros(len(channel.probs), dtype=np.int64)
    for i, c in enumerate(src):
        new_idx |= bits[:, i].astype(np.int64) << pos[c]
    new_probs = np.zeros(2 ** len(target_col_ids), dtype=np.float64)
    np.add.at(new_probs, new_idx, np.asarray(channel.probs, dtype=np.float64))
    return Channel(new_probs, target_col_ids)


def merge_identical_channels(channels: List[Channel]) -> List[Channel]:
    """XOR-convolve channels sharing an identical signature tuple."""
    groups: Dict[Tuple[int, ...], List[Channel]] = defaultdict(list)
    for ch in channels:
        groups[ch.unique_col_ids].append(ch)
    out: List[Channel] = []
    for ids, group in groups.items():
        probs = np.asarray(group[0].probs, dtype=np.float64)
        for ch in group[1:]:
            probs = xor_convolve(probs, ch.probs)
        out.append(Channel(probs, ids))
    return out


def absorb_subset_channels(channels: List[Channel], max_bits: int = 4) -> List[Channel]:
    """Fold channels whose signature is a strict subset of a larger one."""
    order = sorted(range(len(channels)), key=lambda i: -len(channels[i].unique_col_ids))
    absorbed: set = set()
    out: List[Channel] = []
    for rank, i in enumerate(order):
        if i in absorbed:
            continue
        host = channels[i]
        ids_set = set(host.unique_col_ids)
        probs = np.asarray(host.probs, dtype=np.float64)
        if len(ids_set) <= max_bits:
            for j in order[rank + 1 :]:
                if j in absorbed:
                    continue
                cand = channels[j]
                if set(cand.unique_col_ids) < ids_set:
                    probs = xor_convolve(
                        probs, expand_channel(cand, host.unique_col_ids).probs
                    )
                    absorbed.add(j)
        out.append(Channel(probs, host.unique_col_ids))
    return out


def simplify_channels(
    channels: List[Channel], max_bits: int = 4, null_col_id: Optional[int] = None
) -> List[Channel]:
    """reduce_null_bits → normalize → merge identical → absorb subsets."""
    channels = reduce_null_bits(channels, null_col_id)
    channels = normalize_channels(channels)
    channels = merge_identical_channels(channels)
    channels = absorb_subset_channels(channels, max_bits)
    return channels


class ChannelSampler:
    """Sample error channels and project onto the reduced f-basis.

    ``f = error_transform @ e (mod 2)``; columns of the transform that
    coincide are merged, all-zero columns marginalized, so the per-shot work
    scales with the number of *distinct* error effects rather than the number
    of noise instructions (reference ``zx/noise_model.py`` / tsim design).
    """

    def __init__(
        self,
        channel_probs: List[Any],
        error_transform: Any,
        seed: Optional[int] = None,
        device: Any = None,
    ):
        transform = np.asarray(error_transform, dtype=np.uint8)
        unique_cols, inverse = np.unique(transform, axis=1, return_inverse=True)
        self.signature_matrix = unique_cols.T.astype(np.uint8)  # (nsig, num_f)
        zero = np.flatnonzero(~unique_cols.any(axis=0))
        null_col_id = int(zero[0]) if len(zero) else None
        channels: List[Channel] = []
        e_off = 0
        for probs in channel_probs:
            k = int(np.log2(len(probs)))
            ids = tuple(int(inverse[e_off + i]) for i in range(k))
            channels.append(Channel(np.asarray(probs, dtype=np.float64), ids))
            e_off += k
        self.channels = simplify_channels(channels, null_col_id=null_col_id)
        self._rng = np.random.default_rng(seed)
        self.device = config.resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        else:
            self._gen.seed()
        self._host_tables = self._build_host_tables()
        self._device_tables = self._build_device_tables()

    @property
    def num_f_params(self) -> int:
        return int(self.signature_matrix.shape[1])

    def _xor_patterns(self, ch: Channel, outcomes: np.ndarray) -> np.ndarray:
        """f-bit pattern of each outcome: bits @ signatures (mod 2)."""
        bits = _bits_of(outcomes, ch.num_bits)
        ids = np.asarray(ch.unique_col_ids)
        return (bits @ self.signature_matrix[ids]) % 2

    def _build_host_tables(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        tables = []
        for ch in self.channels:
            p_fire = 1.0 - float(ch.probs[0])
            if p_fire <= 1e-15 or len(ch.probs) <= 1:
                continue
            cond = np.cumsum(np.asarray(ch.probs[1:]) / p_fire)
            cond /= cond[-1]
            pats = self._xor_patterns(ch, np.arange(1, len(ch.probs)))
            tables.append((p_fire, cond, pats.astype(np.uint8)))
        return tables

    def sample(self, num_samples: int = 1) -> np.ndarray:
        """Host-side geometric-skip sampling (fast in the low-noise regime)."""
        out = np.zeros((num_samples, self.num_f_params), dtype=np.uint8)
        for p_fire, cond, pats in self._host_tables:
            # expected firing count with generous headroom
            mean = num_samples * p_fire
            budget = int(mean + 7.0 * np.sqrt(mean * (1 - p_fire))) + 100
            hits = np.cumsum(self._rng.geometric(p_fire, size=budget)) - 1
            hits = hits[hits < num_samples]
            if hits.size == 0:
                continue
            which = np.searchsorted(cond, self._rng.uniform(size=hits.size))
            out[hits] ^= pats[which]
        return out

    def _build_device_tables(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(probabilities [channels, width], float64, zero-padded; f-bit
        patterns [channels, width, num_f], uint8) of the channels that can
        fire, on the device."""
        active = []
        for ch in self.channels:
            if 1.0 - float(ch.probs[0]) <= 1e-15 or len(ch.probs) <= 1:
                continue
            pats = self._xor_patterns(ch, np.arange(len(ch.probs)))
            active.append((np.asarray(ch.probs, dtype=np.float64), pats.astype(np.uint8)))
        if not active:
            return None
        width = max(p.shape[0] for p, _ in active)
        probs = np.stack([np.pad(p, (0, width - p.shape[0])) for p, _ in active])
        pats = np.stack([np.pad(x, ((0, width - x.shape[0]), (0, 0))) for _, x in active])
        return (torch.as_tensor(np.clip(probs, 0.0, None), device=self.device),
                torch.as_tensor(pats, device=self.device))

    def sample_jax(self, num_samples: int, key: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Any]:
        """f-bit patterns [num_samples, num_f] (uint8, on the device) and
        the generator drawn from (``key``, a ``torch.Generator`` on the
        device, else the sampler's own, seeded by ``seed``): one categorical
        draw a channel and shot, all channels in one ``torch.multinomial``,
        the chosen patterns XOR-reduced."""
        gen = self._gen if key is None else key
        if self._device_tables is None:
            return torch.zeros((num_samples, self.num_f_params), dtype=torch.uint8, device=self.device), gen
        probs, pats = self._device_tables
        nch, width, num_f = pats.shape
        idx = torch.multinomial(probs, num_samples, replacement=True, generator=gen)  # (nch, ns)
        # XOR of the chosen rows: a one-hot count a pattern entry, mod 2,
        # in groups of channels that bound the (group, ns, num_f) gather
        out = torch.zeros((num_samples, num_f), dtype=torch.uint8, device=self.device)
        group = max(1, (1 << 26) // max(1, num_samples * num_f))
        rows = torch.arange(nch, device=self.device)[:, None]
        for lo in range(0, nch, group):
            chosen = pats[rows[lo:lo + group], idx[lo:lo + group]]  # (g, ns, num_f)
            out ^= (chosen.sum(dim=0, dtype=torch.int32) & 1).to(torch.uint8)
        return out, gen
