"""Measurement post-processing of the port: samples, counts and their formats.

Counterpart of the measurement section of ``tensorcircuit_ng_tpu/quantum.py``
(the rest of that module is Queue 1 item 14 of ``ROADMAP.md``).  A sample is
a basis index (int) or its base-d digits, qubit 0 first; counts are a dense
count vector of length d^n, an ``(indices, counts)`` tuple or a dict keyed
by the index or its digit string.  Tensors keep their device; numpy input
goes to the configured device.  Integer results are int32 as the JAX package
gives them, int64 where an index needs more than 31 bits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from .backend import backend as K

__all__ = [
    "sample_int2bin",
    "sample_bin2int",
    "sample2count",
    "count_vector2dict",
    "count_dict2vector",
    "count_tuple2dict",
    "count_s2d",
    "count_d2s",
    "counts_v2t",
    "count_t2v",
    "counts_t2v",
    "sample2all",
    "measurement_counts",
    "measurement_results",
    "spin_by_basis",
    "correlation_from_samples",
    "correlation_from_counts",
    "expectation_from_counts",
]

def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=config.resolve_device())


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _index_dtype(size: int) -> torch.dtype:
    return torch.int64 if size > 2**31 else torch.int32


def _radix(n: int, d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor([d ** (n - 1 - i) for i in range(n)], dtype=dtype, device=device)


def sample_int2bin(sample: Any, n: int, d: int = 2) -> torch.Tensor:
    """[batch] int basis indices -> [batch, n] digits (the sample's dtype)."""
    sample = _tensor(sample)
    rad = _radix(n, d, _index_dtype(d ** max(n - 1, 0) + 1), sample.device)
    return ((sample.to(rad.dtype)[..., None] // rad) % d).to(sample.dtype)


def sample_bin2int(sample: Any, n: int, d: int = 2) -> torch.Tensor:
    """[batch, n] digits -> [batch] ints (int64 above 2^31 states)."""
    sample = _tensor(sample)
    rad = _radix(n, d, _index_dtype(d**n), sample.device)
    return torch.sum(sample.to(rad.dtype) * rad, dim=-1, dtype=rad.dtype)


def sample2count(sample: Any, n: int, d: int = 2, jittable: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """int samples -> (basis indices, counts): the dense count vector over
    every index when ``jittable``, else the indices seen and their counts."""
    sample = _tensor(sample).reshape(-1)
    if jittable:
        ones = torch.ones(sample.shape, dtype=torch.int32, device=sample.device)
        cv = torch.zeros((d**n,), dtype=torch.int32, device=sample.device).index_add_(0, sample.to(torch.int64), ones)
        return torch.arange(d**n, dtype=_index_dtype(d**n), device=sample.device), cv
    vals, counts = torch.unique(sample, return_counts=True)
    return vals, counts.to(torch.int32)


def _int2basestr(i: int, n: int, d: int = 2) -> str:
    """The n base-d digits of ``i`` (0-9A-Z), the first qubit first."""
    return (format(i, "b") if d == 2 else np.base_repr(i, d)).zfill(n)


def count_vector2dict(count: Any, n: int, key: str = "bin", d: int = 2) -> Dict[Any, int]:
    """count vector [d^n] -> dict of the nonzero entries, keyed by the int
    (``key="int"``) or its base-d string."""
    count_np = _host(count)
    result = {}
    for i in np.nonzero(count_np)[0]:
        k = int(i) if key == "int" else _int2basestr(int(i), n, d)
        result[k] = int(count_np[i])
    return result


def count_dict2vector(count: Dict[Any, int], n: int, d: int = 2) -> torch.Tensor:
    """dict with int or base-d string keys -> count vector [d^n]."""
    cv = np.zeros((d**n,), dtype=np.int64)
    for k, v in count.items():
        if isinstance(k, str):
            k = int(k, d) if d <= 10 else int(k, 36)
        cv[int(k)] += v
    return torch.as_tensor(cv, device=config.resolve_device()).to(torch.int32)


def count_tuple2dict(count: Tuple[Any, Any], n: int, key: str = "bin", d: int = 2) -> Dict[Any, int]:
    """(indices, counts) -> dict of the positive counts."""
    out = {}
    for v, c in zip(_host(count[0]), _host(count[1])):
        if c <= 0:
            continue
        k = int(v) if key == "int" else _int2basestr(int(v), n, d)
        out[k] = int(c)
    return out


def count_s2d(srepr: Tuple[Any, Any], n: int, dim: Optional[int] = None) -> torch.Tensor:
    """Sparse (indices, values) -> dense count vector [dim^n] (dim 2 by
    default), repeated indices summed."""
    d = 2 if dim is None else dim
    vals = _tensor(srepr[1])
    idx = torch.reshape(_tensor(srepr[0]), (-1,)).to(device=vals.device, dtype=torch.int64)
    return torch.zeros((d**n,), dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


def count_d2s(drepr: Any, eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense count vector -> (indices, values) of the entries with |v| >
    eps (the output's length depends on the data)."""
    arr = _tensor(drepr)
    idx = torch.nonzero(torch.abs(arr) > eps).reshape(-1)
    return idx.to(_index_dtype(arr.shape[0])), arr[idx]


counts_v2t = count_s2d
count_t2v = count_d2s
counts_t2v = count_s2d


def sample2all(sample: Any, n: int, format: str = "count_vector", jittable: bool = True, d: int = 2) -> Any:
    """int samples [batch] in one of six formats: ``sample_int``,
    ``sample_bin``, ``count_vector``, ``count_tuple``, ``count_dict_bin``,
    ``count_dict_int``.  Above 32 qubits no dense count vector is made: the
    count formats go through the sparse tuple, and ``count_vector`` raises."""
    sample = _tensor(sample)
    if format == "sample_int":
        return sample
    if format == "sample_bin":
        return sample_int2bin(sample, n, d)
    if n * math.log2(d) > 32:
        if format == "count_vector":
            raise ValueError(
                f"count_vector needs a dense {d}**{n} array; use count_tuple/"
                "count_dict_* formats above 32 qubits"
            )
        if format == "count_tuple":
            return sample2count(sample, n, d, jittable=False)
        if format in ("count_dict_bin", "count_dict_int"):
            key = "bin" if format.endswith("bin") else "int"
            return count_tuple2dict(sample2count(sample, n, d, jittable=False), n, key=key, d=d)
    if format == "count_vector":
        return sample2count(sample, n, d, jittable=True)[1]
    if format == "count_tuple":
        return sample2count(sample, n, d, jittable=False)
    if format in ("count_dict_bin", "count_dict_int"):
        key = "bin" if format.endswith("bin") else "int"
        return count_vector2dict(sample2count(sample, n, d, jittable=True)[1], n, key=key, d=d)
    raise ValueError(f"unknown sample format {format!r}")


def measurement_counts(
    state: Any,
    counts: Optional[int] = 8192,
    format: str = "count_vector",
    is_prob: bool = False,
    random_generator: Optional[torch.Generator] = None,
    status: Optional[Any] = None,
    jittable: bool = False,
    d: int = 2,
) -> Any:
    """Sample ``counts`` outcomes of a state, a density matrix (a square
    2-D input: its diagonal) or, with ``is_prob``, a probability vector;
    ``counts`` None or ≤ 0 returns the normalized probabilities."""
    state = _tensor(state)
    if is_prob:
        p = torch.real(state)
    elif state.ndim == 2 and state.shape[0] == state.shape[1] and state.shape[0] > 1:
        p = torch.real(torch.diagonal(state))
    else:
        flat = torch.reshape(state, (-1,))
        p = torch.real(torch.conj(flat) * flat)
    p = p / torch.sum(p)
    n = int(round(math.log2(p.shape[0]) / math.log2(d)))
    if counts is None or (isinstance(counts, int) and counts <= 0):
        return p
    idx = K.probability_sample(counts, p, status=status, g=random_generator)
    return sample2all(idx, n, format=format, jittable=jittable, d=d)


measurement_results = measurement_counts


def spin_by_basis(
    n: int, m: int, elements: Tuple[int, int] = (1, -1), device: Optional[Any] = None
) -> torch.Tensor:
    """``elements[bit]`` of qubit m over all 2^n basis states, on ``device``
    (the configured device by default)."""
    s = torch.arange(2**n, device=config.resolve_device(device))
    bit = (s // (2 ** (n - 1 - m))) % 2
    e = torch.as_tensor(elements, device=s.device)
    return e[bit].to(torch.int32) if not e.is_floating_point() else e[bit]


def correlation_from_samples(index: Sequence[int], results: Any, n: int) -> torch.Tensor:
    """⟨Z_i Z_j ...⟩ from [shots, n] digit samples or [shots] int samples."""
    results = _tensor(results)
    if results.ndim == 1:
        results = sample_int2bin(results, n)
    spins = 1 - 2 * results
    prod = torch.ones((results.shape[0],), dtype=spins.dtype, device=spins.device)
    for i in index:
        prod = prod * spins[:, i]
    return torch.mean(prod.to(getattr(torch, config.rdtypestr())))


def correlation_from_counts(index: Sequence[int], results: Any) -> torch.Tensor:
    """⟨Z_i Z_j ...⟩ from a count vector."""
    if isinstance(results, tuple):
        raise NotImplementedError("pass a count_vector for correlation_from_counts")
    cv = _tensor(results).to(getattr(torch, config.rdtypestr()))
    n = int(round(math.log2(cv.shape[0])))
    corr = cv / torch.sum(cv)
    for i in index:
        corr = corr * spin_by_basis(n, i, device=cv.device).to(corr.dtype)
    return torch.sum(corr)


def expectation_from_counts(
    count: Dict[str, int], z: Optional[Sequence[int]] = None, diagonal_op: Optional[Any] = None
) -> float:
    """A diagonal observable's mean from a dict of bit-string counts: the
    Z string on ``z``, or the diagonal ``diagonal_op`` indexed by the bits."""
    total = sum(count.values())
    diag = None if diagonal_op is None else _host(diagonal_op)
    acc = 0.0
    for bstr, c in count.items():
        if z is not None:
            parity = 1
            for q in z:
                if bstr[q] == "1":
                    parity = -parity
            acc += parity * c
        elif diag is not None:
            acc += float(diag[int(bstr, 2)]) * c
    return acc / total
