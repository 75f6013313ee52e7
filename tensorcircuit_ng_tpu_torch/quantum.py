"""The port's quantum toolbox: the QuOperator family and measurement
post-processing.

Counterpart of two sections of ``tensorcircuit_ng_tpu/quantum.py``:

- :class:`QuOperator`, :class:`QuVector`, :class:`QuAdjointVector` and
  :class:`QuScalar`: a dense tensor with its output and input leg
  dimensions, on a device (a tensor keeps its own, anything else goes to
  the configured device), with ``@``, scalar ``*`` and ``/``, ``+``, ``-``,
  the tensor product ``|``, ``adjoint``, ``partial_trace``, ``trace``,
  ``norm`` (squared, as the JAX package gives it) and ``projector``;
  ``tn2qop`` of MPO site tensors (l, out, in, r) and the node-graph names
  (``get_all_nodes``, ``reachable``, ``check_spaces``,
  ``eliminate_identities``) over the one dense tensor.
- samples, counts and their formats.  A sample is
a basis index (int) or its base-d digits, qubit 0 first; counts are a dense
count vector of length d^n, an ``(indices, counts)`` tuple or a dict keyed
by the index or its digit string.  Tensors keep their device; numpy input
goes to the configured device.  Integer results are int32 as the JAX package
gives them, int64 where an index needs more than 31 bits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from .backend import backend as K

__all__ = [
    "QuOperator",
    "QuVector",
    "QuAdjointVector",
    "QuScalar",
    "quantum_constructor",
    "identity",
    "tn2qop",
    "generate_local_hamiltonian",
    "extract_tensors_from_qop",
    "get_all_nodes",
    "reachable",
    "check_spaces",
    "eliminate_identities",
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


def _numel(dims: Sequence[int]) -> int:
    return int(np.prod(dims, dtype=np.int64))


def _promote(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ======================================================================
# QuOperator: operators, kets, bras and scalars on one dense tensor
# ======================================================================


class QuOperator:
    """An operator with ``out_dims`` x ``in_dims`` legs, held as one dense
    tensor.  A vector has no input legs, an adjoint vector no output legs, a
    scalar neither; products, sums and the tensor product give the class
    their legs call for."""

    #: numpy defers ``np.float64(0.5) * op`` to :meth:`__rmul__`
    __array_ufunc__ = None

    def __init__(self, tensor: Any, out_dims: Sequence[int], in_dims: Sequence[int]):
        self._t = _tensor(tensor).resolve_conj()
        self.out_dims = tuple(int(d) for d in out_dims)
        self.in_dims = tuple(int(d) for d in in_dims)
        assert _numel(self.out_dims + self.in_dims) == self._t.numel()

    # constructors ------------------------------------------------------

    @classmethod
    def from_tensor(
        cls,
        tensor: Any,
        out_axes: Optional[Sequence[int]] = None,
        in_axes: Optional[Sequence[int]] = None,
    ) -> "QuOperator":
        """The operator of ``tensor`` with ``out_axes`` as its output legs and
        ``in_axes`` as its input legs (each defaults to the axes the other
        leaves, both to the first and second half)."""
        t = _tensor(tensor)
        nd = t.ndim
        if out_axes is None and in_axes is None:
            out_axes = list(range(nd // 2))
            in_axes = list(range(nd // 2, nd))
        elif out_axes is None:
            out_axes = [i for i in range(nd) if i not in set(in_axes)]
        elif in_axes is None:
            in_axes = [i for i in range(nd) if i not in set(out_axes)]
        t = torch.permute(t, list(out_axes) + list(in_axes))
        return cls(t, tuple(t.shape[: len(out_axes)]), tuple(t.shape[len(out_axes) :]))

    @classmethod
    def from_local_tensor(cls, tensor: Any, space: Sequence[int], loc: Sequence[int]) -> "QuOperator":
        """A local operator on the sites ``loc`` of the product space
        ``space``, the identity elsewhere."""
        t = _tensor(tensor)
        n = len(space)
        rest = [i for i in range(n) if i not in set(loc)]
        mat = torch.reshape(t, (_numel([space[q] for q in loc]),) * 2)
        big = torch.kron(mat, torch.eye(_numel([space[i] for i in rest]), dtype=mat.dtype, device=mat.device))
        order = list(loc) + rest
        big = torch.reshape(big, [space[i] for i in order] * 2)
        inv = [order.index(i) for i in range(n)]
        big = torch.permute(big, inv + [n + i for i in inv])
        return cls(big, tuple(space), tuple(space))

    @property
    def shape(self) -> Tuple[int, int]:
        return (_numel(self.out_dims) if self.out_dims else 1, _numel(self.in_dims) if self.in_dims else 1)

    @property
    def is_scalar(self) -> bool:
        return not self.out_dims and not self.in_dims

    @property
    def is_vector(self) -> bool:
        return bool(self.out_dims) and not self.in_dims

    @property
    def is_adjoint_vector(self) -> bool:
        return not self.out_dims and bool(self.in_dims)

    # evaluation --------------------------------------------------------

    def eval(self) -> torch.Tensor:
        """The tensor with its output legs first, then its input legs."""
        return torch.reshape(self._t, self.out_dims + self.in_dims)

    def eval_matrix(self) -> torch.Tensor:
        """The (prod out_dims, prod in_dims) matrix."""
        return torch.reshape(self._t, self.shape)

    def copy(self) -> "QuOperator":
        return QuOperator(self._t, self.out_dims, self.in_dims)

    # algebra -----------------------------------------------------------

    def adjoint(self) -> "QuOperator":
        m = self.eval_matrix()
        return QuOperator(torch.reshape(m.mH, self.in_dims + self.out_dims), self.in_dims, self.out_dims)

    def __matmul__(self, other: Any) -> "QuOperator":
        if isinstance(other, QuOperator):
            assert self.in_dims == other.out_dims or self.shape[1] == other.shape[0]
            a, b = _promote(self.eval_matrix(), other.eval_matrix())
            return _qu_like(a @ b, self.out_dims, other.in_dims)
        other_t = _tensor(other)
        a, b = _promote(self.eval_matrix(), torch.reshape(other_t, (self.shape[1], -1)).to(self._t.device))
        return _qu_like(a @ b, self.out_dims, tuple(other_t.shape[1:]) if other_t.ndim > 1 else ())

    def __mul__(self, scalar: Any) -> "QuOperator":
        if isinstance(scalar, QuOperator):
            if not scalar.is_scalar and not self.is_scalar:
                raise ValueError("only scalar multiplication is supported; use @ for operator products")
            other_t = scalar.eval() if scalar.is_scalar else scalar._t
            if self.is_scalar and not scalar.is_scalar:
                return type(scalar)._build(self.eval() * other_t, scalar)
            return self._build(self._t * other_t, self)
        ndim = scalar.ndim if isinstance(scalar, torch.Tensor) else np.ndim(scalar)
        if ndim != 0:
            raise ValueError("only scalar multiplication is supported; got a non-scalar operand")
        return self._build(self._t * scalar, self)

    __rmul__ = __mul__

    @staticmethod
    def _build(t: torch.Tensor, like: "QuOperator") -> "QuOperator":
        return _qu_like(torch.reshape(t, (-1,)), like.out_dims, like.in_dims)

    def __truediv__(self, scalar: Any) -> "QuOperator":
        if isinstance(scalar, QuOperator) and scalar.is_scalar:
            scalar = scalar.eval()
        return self._build(self._t / scalar, self)

    def __add__(self, other: "QuOperator") -> "QuOperator":
        assert self.out_dims == other.out_dims and self.in_dims == other.in_dims
        return QuOperator(self._t + other._t, self.out_dims, self.in_dims)

    def __sub__(self, other: "QuOperator") -> "QuOperator":
        return self + (other * (-1.0))

    def __neg__(self) -> "QuOperator":
        return self * (-1.0)

    def tensor_product(self, other: "QuOperator") -> "QuOperator":
        a, b = _promote(self.eval_matrix(), other.eval_matrix().to(self._t.device))
        return _qu_like(torch.kron(a, b), self.out_dims + other.out_dims, self.in_dims + other.in_dims)

    __or__ = tensor_product

    def partial_trace(self, subsystems_to_trace_out: Sequence[int]) -> "QuOperator":
        """The square operator with the listed subsystems traced out."""
        assert self.out_dims == self.in_dims, "partial trace needs a square operator"
        t = self.eval()
        for s in sorted(subsystems_to_trace_out, reverse=True):
            t = torch.diagonal(t, dim1=s, dim2=t.ndim // 2 + s).sum(-1)
        dims = tuple(d for i, d in enumerate(self.out_dims) if i not in set(subsystems_to_trace_out))
        return QuOperator(t, dims, dims)

    def trace(self) -> "QuOperator":
        """tr(O) as a QuScalar (``.eval()`` gives the value)."""
        return QuScalar(torch.trace(self.eval_matrix()))

    def norm(self) -> "QuOperator":
        """The SQUARED Hilbert-Schmidt norm tr(A†A) as a QuScalar, as the
        JAX package gives it."""
        m = self.eval_matrix()
        return QuScalar(torch.real(torch.sum(torch.conj(m) * m)))

    def projector(self) -> "QuOperator":
        assert self.is_vector
        v = torch.reshape(self._t, (-1, 1))
        return QuOperator(v @ v.mH, self.out_dims, self.out_dims)

    # the node-graph API over the one dense tensor ------------------------

    @property
    def in_space(self) -> Tuple[int, ...]:
        return tuple(self.in_dims)

    @property
    def out_space(self) -> Tuple[int, ...]:
        return tuple(self.out_dims)

    @property
    def nodes(self) -> List[Any]:
        """The constituent tensors: the one dense tensor."""
        return [self._t]

    def check_network(self) -> None:
        assert self._t.numel() == (_numel(self.out_dims + self.in_dims) or 1)

    def contract(self, final_edge_order: Optional[Sequence[int]] = None) -> "QuOperator":
        """Already contracted: returns self."""
        return self


def _qu_like(m: torch.Tensor, out_dims: Tuple[int, ...], in_dims: Tuple[int, ...]) -> QuOperator:
    """The QuOperator, QuVector, QuAdjointVector or QuScalar of ``m`` with
    these legs."""
    if out_dims and in_dims:
        return QuOperator(torch.reshape(m, out_dims + in_dims), out_dims, in_dims)
    if out_dims:
        return QuVector(torch.reshape(m, out_dims), out_dims)
    if in_dims:
        return QuAdjointVector(torch.reshape(m, in_dims), in_dims)
    return QuScalar(torch.reshape(m, ()))


class QuVector(QuOperator):
    """A ket |psi⟩."""

    def __init__(self, tensor: Any, subsystem_dims: Optional[Sequence[int]] = None):
        t = _tensor(tensor)
        super().__init__(t, tuple(t.shape) if subsystem_dims is None else tuple(subsystem_dims), ())

    @classmethod
    def from_tensor(cls, tensor: Any, subsystem_axes: Optional[Sequence[int]] = None) -> "QuVector":  # type: ignore[override]
        t = _tensor(tensor)
        if subsystem_axes is not None:
            t = torch.permute(t, list(subsystem_axes))
        return cls(t, tuple(t.shape))

    def reduced_density_matrix(self, cut: Sequence[int]) -> QuOperator:
        return self.projector().partial_trace(cut)

    @property
    def space(self) -> Tuple[int, ...]:
        return tuple(self.out_dims)

    @property
    def subsystem_edges(self) -> List[int]:
        """The subsystems' dimensions (the legs of the dense tensor)."""
        return list(self.out_dims)

    def reduced_density(self, subsystems_to_trace_out: Sequence[int]) -> QuOperator:
        return self.projector().partial_trace(list(subsystems_to_trace_out))


class QuAdjointVector(QuOperator):
    """A bra ⟨psi|."""

    def __init__(self, tensor: Any, subsystem_dims: Optional[Sequence[int]] = None):
        t = _tensor(tensor)
        super().__init__(t, (), tuple(t.shape) if subsystem_dims is None else tuple(subsystem_dims))

    @classmethod
    def from_tensor(cls, tensor: Any, subsystem_axes: Optional[Sequence[int]] = None) -> "QuAdjointVector":  # type: ignore[override]
        t = _tensor(tensor)
        if subsystem_axes is not None:
            t = torch.permute(t, list(subsystem_axes))
        return cls(t, tuple(t.shape))

    @property
    def space(self) -> Tuple[int, ...]:
        return tuple(self.in_dims)

    @property
    def subsystem_edges(self) -> List[int]:
        return list(self.in_dims)

    def reduced_density(self, subsystems_to_trace_out: Sequence[int]) -> QuOperator:
        ket = QuVector(torch.conj(self._t), self.in_dims)
        return ket.projector().partial_trace(list(subsystems_to_trace_out))


class QuScalar(QuOperator):
    def __init__(self, tensor: Any):
        super().__init__(torch.reshape(_tensor(tensor), ()), (), ())

    @classmethod
    def from_tensor(cls, tensor: Any, *args: Any) -> "QuScalar":  # type: ignore[override]
        return cls(tensor)


def quantum_constructor(out_dims: Sequence[int], in_dims: Sequence[int], tensor: Any) -> QuOperator:
    return _qu_like(_tensor(tensor), tuple(out_dims), tuple(in_dims))


def identity(dims: Sequence[int], dtype: Optional[str] = None, device: Optional[Any] = None) -> QuOperator:
    """The identity on ``dims``, in ``dtype`` (the configured one by
    default) on ``device`` (the configured one by default)."""
    d = _numel(dims)
    eye = torch.eye(d, dtype=config.torch_dtype(dtype), device=config.resolve_device(device))
    return QuOperator(torch.reshape(eye, tuple(dims) * 2), tuple(dims), tuple(dims))


def tn2qop(tensors: Sequence[Any]) -> QuOperator:
    """MPO site tensors [(l, out, in, r)] -> the dense QuOperator, on the
    first tensor's device."""
    acc = None
    for t in tensors:
        t = _tensor(t)
        if acc is None:
            acc = t
            continue
        acc, t = _promote(acc, t.to(acc.device))
        acc = torch.einsum("aijb,bklc->aikjlc", acc, t)
        s = acc.shape
        acc = torch.reshape(acc, (s[0], s[1] * s[2], s[3] * s[4], s[5]))
    assert acc.shape[0] == 1 and acc.shape[-1] == 1
    m = torch.reshape(acc, (acc.shape[1], acc.shape[2]))
    nsites = len(tensors)
    d = int(round(m.shape[0] ** (1.0 / nsites)))
    dims = (d,) * nsites
    return QuOperator(torch.reshape(m, dims + dims), dims, dims)


def generate_local_hamiltonian(*hlist: Any, matrix_form: bool = True) -> Any:
    """The tensor product of the local terms, the first on the first sites:
    the dense matrix (``matrix_form``) or the QuOperator."""
    ops = [QuOperator.from_tensor(h) for h in hlist]
    hop = ops[0]
    for op in ops[1:]:
        hop = hop.tensor_product(op)
    return hop.eval_matrix() if matrix_form else hop


def extract_tensors_from_qop(qop: QuOperator) -> torch.Tensor:
    """The dense matrix of a QuOperator."""
    return qop.eval_matrix()


def get_all_nodes(qops: Sequence[QuOperator]) -> List[Any]:
    """The constituent tensors of several QuOperators."""
    out: List[Any] = []
    for q in qops:
        out.extend(q.nodes)
    return out


def reachable(qop: QuOperator) -> List[Any]:
    """The tensors reachable from an operator: its own."""
    return list(qop.nodes)


def check_spaces(qops: Sequence[QuOperator]) -> None:
    """ValueError unless each operator's input legs match the next one's
    output legs."""
    for a, b in zip(qops[:-1], qops[1:]):
        if tuple(a.in_dims) != tuple(b.out_dims):
            raise ValueError(f"incompatible spaces: {a.in_dims} (in) vs {b.out_dims} (out)")


def eliminate_identities(qop: QuOperator) -> QuOperator:
    """The operator with its size-1 legs dropped."""
    out_dims = tuple(d for d in qop.out_dims if d != 1)
    in_dims = tuple(d for d in qop.in_dims if d != 1)
    return _qu_like(qop._t, out_dims, in_dims)


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
