"""Counts-dict toolbox (reference ``results/counts.py:15-239``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

ct = Dict[str, int]

__all__ = [
    "normalized_count",
    "marginal_count",
    "merge_count",
    "count2vec",
    "vec2count",
    "kl_divergence",
    "expectation",
    "sort_count",
    "plot_histogram",
]


def normalized_count(count: ct) -> Dict[str, float]:
    total = sum(count.values())
    return {k: v / total for k, v in count.items()}


def sort_count(count: ct) -> ct:
    return dict(sorted(count.items(), key=lambda kv: -kv[1]))


def marginal_count(count: ct, keep_list: Sequence[int]) -> ct:
    """Marginalize onto the listed (ordered) bit positions (reference ``:40``)."""
    out: ct = {}
    for bstr, v in count.items():
        key = "".join(bstr[i] for i in keep_list)
        out[key] = out.get(key, 0) + v
    return out


def merge_count(*counts: ct) -> ct:
    out: ct = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def count2vec(count: ct, normalization: bool = True) -> np.ndarray:
    n = len(next(iter(count)))
    v = np.zeros(2**n)
    for k, c in count.items():
        v[int(k, 2)] = c
    if normalization and v.sum() > 0:
        v = v / v.sum()
    return v


def vec2count(vec: Any, prune: bool = False, atol: float = 1e-9) -> ct:
    vec = np.asarray(vec)
    n = int(round(np.log2(vec.size)))
    out: ct = {}
    for i, v in enumerate(vec):
        if prune and abs(v) < atol:
            continue
        out[format(i, f"0{n}b")] = v if isinstance(v, (int, np.integer)) else float(v)
    return out


def kl_divergence(c1: ct, c2: ct, eps: float = 1e-9) -> float:
    p = normalized_count(c1)
    q = normalized_count(c2)
    keys = set(p) | set(q)
    # a zero-probability key contributes 0 in the limit (0*log 0 = 0),
    # NOT nan via 0*(-inf); only q is clamped by eps
    return float(
        sum(
            pk * (np.log(pk) - np.log(q.get(k, eps) or eps))
            for k in keys
            for pk in (p.get(k, 0.0),)
            if pk > 0
        )
    )


def expectation(
    count: ct, z: Optional[Sequence[int]] = None, diagonal_op: Optional[Any] = None
) -> float:
    """Diagonal-observable expectation from counts (reference ``:120``).

    ``z``: qubit list for a Z-string; ``diagonal_op``: per-qubit diagonal
    [n, 2] (e.g. [[1, -1], ...]) or a full 2^n diagonal vector.
    """
    total = sum(count.values())
    acc = 0.0
    for bstr, c in count.items():
        term = 1.0
        if z is not None:
            for q in z:
                term *= -1.0 if bstr[q] == "1" else 1.0
        elif diagonal_op is not None:
            dop = np.asarray(diagonal_op)
            if dop.ndim == 2:
                for q, row in enumerate(dop):
                    term *= row[int(bstr[q])]
            else:
                term = float(dop[int(bstr, 2)])
        acc += term * c
    return acc / total


def plot_histogram(count: ct, ax: Any = None, **kws: Any) -> Any:  # pragma: no cover
    """Bar plot of counts (matplotlib optional)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    items = sorted(count.items())
    ax.bar([k for k, _ in items], [v for _, v in items], **kws)
    ax.set_xlabel("bitstring")
    ax.set_ylabel("count")
    return ax


def reverse_count(count: ct) -> ct:
    """Reverse the bit-string keys (endianness flip), reference ``counts.py:15``."""
    return {k[::-1]: v for k, v in count.items()}
