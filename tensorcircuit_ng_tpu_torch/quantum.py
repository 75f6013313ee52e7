"""The port's quantum toolbox: the QuOperator family, Pauli-sum
Hamiltonians, the quantum-information toolbox and measurement
post-processing.

Counterpart of ``tensorcircuit_ng_tpu/quantum.py``:

- :class:`QuOperator`, :class:`QuVector`, :class:`QuAdjointVector` and
  :class:`QuScalar`: a dense tensor with its output and input leg
  dimensions, on a device (a tensor keeps its own, anything else goes to
  the configured device), with ``@``, scalar ``*`` and ``/``, ``+``, ``-``,
  the tensor product ``|``, ``adjoint``, ``partial_trace``, ``trace``,
  ``norm`` (squared, as the JAX package gives it) and ``projector``;
  ``tn2qop`` of MPO site tensors (l, out, in, r) and the node-graph names
  (``get_all_nodes``, ``reachable``, ``check_spaces``,
  ``eliminate_identities``) over the one dense tensor.
- Pauli-sum Hamiltonians (0: I, 1: X, 2: Y, 3: Z a site; qubit q is bit
  n-1-q of the flat index): ``PauliStringSum2COO`` builds a coalesced
  ``torch.sparse_coo_tensor`` on the device (``numpy=True``: scipy on the
  host), ``PauliStringSum2Dense`` its dense form, ``PauliStringSum2MVP`` a
  matrix-free product; ``heisenberg_hamiltonian``, ``LinearOperator``.  A
  builder that makes a tensor from no tensor runs on the configured device
  or on ``device=``.
- the QI toolbox: reduced density matrices, partial transposes and
  purifications; the von Neumann and Rényi entropies (``eigvalsh``),
  mutual information, negativities; fidelity (both roots by
  ``core.linalg.sqrtmh``: a finite gradient at a pure state, where the JAX
  package's is NaN, Queue 3 F10), Gibbs, thermofield and purified states
  (``eigh``: a NaN gradient at a degenerate spectrum, as the JAX
  package's); trace distance, free energies, the
  stabilizer Rényi entropy; the U(1) sector helpers and the MPO
  converters (quimb, TeNPy and tensornetwork imported only when called).
  Each computes in its input's dtype, with the JAX package's clips and
  eps values, on its input's device.
- samples, counts and their formats.  A sample is
a basis index (int) or its base-d digits, qubit 0 first; counts are a dense
count vector of length d^n, an ``(indices, counts)`` tuple or a dict keyed
by the index or its digit string.  Tensors keep their device; numpy input
goes to the configured device.  Integer results are int32 as the JAX package
gives them, int64 where an index needs more than 31 bits.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config
from .backend import backend as K
from .core import linalg
from .core.linalg import plain_eigh as _eigh

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
    "PauliString2Dense",
    "PauliString2COO",
    "PauliStringSum2COO",
    "PauliStringSum2COO_numpy",
    "PauliStringSum2COO_tf",
    "PauliStringSum2Dense",
    "PauliStringSum2MVP",
    "heisenberg_hamiltonian",
    "xyz_hamiltonian",
    "LinearOperator",
    "aslinearoperator",
    "ps2xyz",
    "xyz2ps",
    "ps2coo_core",
    "reduced_density_matrix",
    "entropy",
    "renyi_entropy",
    "entanglement_entropy",
    "renyi_entanglement_entropy",
    "partial_transpose",
    "entanglement_negativity",
    "log_negativity",
    "fidelity",
    "trace_distance",
    "mutual_information",
    "gibbs_state",
    "double_state",
    "free_energy",
    "renyi_free_energy",
    "truncated_free_energy",
    "purified_state",
    "stabilizer_renyi_entropy",
    "taylorlnm",
    "op2tensor",
    "onehot_d_tensor",
    "trace_product",
    "anti_flatness",
    "entanglement_anti_flatness",
    "reduced_wavefunction",
    "u1_inds",
    "u1_mask",
    "u1_project",
    "u1_enlarge",
    "quimb2qop",
    "tenpy2qop",
    "qop2tn",
    "qop2quimb",
    "qop2tenpy",
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


# ======================================================================
# Pauli-string Hamiltonians: dense, sparse COO and matrix-free
# ======================================================================

_PAULI_NP = [
    np.eye(2, dtype=np.complex128),
    np.array([[0, 1], [1, 0]], dtype=np.complex128),
    np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    np.array([[1, 0], [0, -1]], dtype=np.complex128),
]


def _pauli_masks(l: Sequence[int]) -> Tuple[int, int, int]:
    """(x mask, z mask, number of Ys) of a Pauli string, qubit q on bit
    n-1-q of the flat index: X sets the x bit, Z the z bit, Y both."""
    n = len(l)
    x_mask = z_mask = ny = 0
    for q, p in enumerate(l):
        bit = 1 << (n - 1 - q)
        p = int(p)
        if p in (1, 2):
            x_mask |= bit
        if p in (2, 3):
            z_mask |= bit
        ny += p == 2
    return x_mask, z_mask, ny


def PauliString2Dense(l: Sequence[int], weight: Optional[Any] = None, device: Optional[Any] = None) -> torch.Tensor:
    """The dense (2^n, 2^n) matrix of one Pauli string (0: I, 1: X, 2: Y,
    3: Z) in the configured dtype on ``device`` (the configured one by
    default), times ``weight`` if given."""
    m = _PAULI_NP[int(l[0])]
    for p in l[1:]:
        m = np.kron(m, _PAULI_NP[int(p)])
    m = torch.as_tensor(m.astype(config.np_dtype()), device=config.resolve_device(device))
    return m if weight is None else m * weight


def _pauli_string_coo_numpy(l: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(columns, values) of one Pauli string over rows 0..2^n-1 (complex128):
    row r holds one entry, in column r XOR x_mask, of value
    i^(#Y) (-1)^popcount(column & z_mask)."""
    x_mask, z_mask, ny = _pauli_masks(l)
    cols = np.arange(1 << len(l), dtype=np.int64) ^ x_mask
    zc = cols & z_mask
    cnt = np.zeros_like(zc)
    while zc.any():
        cnt += zc & 1
        zc >>= 1
    signs = np.where(cnt % 2 == 1, -1.0, 1.0).astype(np.complex128)
    return cols, signs * (1j) ** ny


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) mod 2 of non-negative int64 entries below 2^63."""
    for s in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def _pauli_sum_coo_planes(
    ls: Sequence[Sequence[int]], weight: Optional[Sequence[Any]], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, columns, complex128 values) of Σ_i w_i P_i, merged and in
    row-major order, built on ``device`` with bit arithmetic.  Strings
    with one x mask share their entries (column = row XOR x_mask), so each
    distinct mask is one plane of 2^n values summed over its strings in
    the order given (as scipy's ``sum_duplicates`` sums them); each row's
    columns are then sorted, so the planes need no global sort and the
    entries come out as ``coalesce`` orders them, equal on every device.
    Explicit zeros of a merged entry are kept, as scipy keeps them."""
    n = len(ls[0])
    size = 1 << n
    if weight is None:
        weight = [1.0] * len(ls)
    groups: Dict[int, List[Tuple[int, complex]]] = {}
    for l, w in zip(ls, weight):
        x_mask, z_mask, ny = _pauli_masks(l)
        groups.setdefault(x_mask, []).append((z_mask, (1j) ** ny * complex(w)))
    rows = torch.arange(size, dtype=torch.int64, device=device)
    masks = sorted(groups)
    cols = torch.stack([rows ^ x for x in masks], dim=1)
    planes = []
    for x, c in zip(masks, cols.unbind(1)):
        acc = None
        for z_mask, coef in groups[x]:
            sign = 1.0 - 2.0 * _parity(c & z_mask).to(torch.float64)
            term = sign * torch.tensor(coef, dtype=torch.complex128, device=device)
            acc = term if acc is None else acc + term
        planes.append(acc)
    vals = torch.stack(planes, dim=1)
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, order)
    rows = rows[:, None].expand(size, len(masks))
    return rows.reshape(-1), cols.reshape(-1), vals.reshape(-1)


def PauliString2COO(l: Sequence[int], weight: Optional[Any] = None, device: Optional[Any] = None) -> torch.Tensor:
    """One Pauli string as a coalesced ``torch.sparse_coo_tensor`` (2^n
    entries) in the configured dtype on ``device``, times ``weight``."""
    cols, vals = _pauli_string_coo_numpy(l)
    if weight is not None:
        vals = vals * complex(weight) if np.isscalar(weight) else vals * np.asarray(weight)
    size = 1 << len(l)
    dev = config.resolve_device(device)
    idx = np.stack([np.arange(size, dtype=np.int64), cols])
    return torch.sparse_coo_tensor(
        torch.as_tensor(idx, device=dev), torch.as_tensor(vals.astype(config.np_dtype()), device=dev),
        (size, size), is_coalesced=True, check_invariants=False,
    )


def PauliStringSum2COO(
    ls: Sequence[Sequence[int]],
    weight: Optional[Sequence[Any]] = None,
    numpy: bool = False,
    device: Optional[Any] = None,
) -> Any:
    """Σ_i w_i P_i as a coalesced ``torch.sparse_coo_tensor`` in the
    configured dtype on ``device`` (the configured one by default), built
    there (:func:`_pauli_sum_coo_planes`: int64 index planes, values summed
    in complex128 and rounded once); with ``numpy`` a scipy ``coo_matrix``
    (complex128) built on the host, as the JAX package builds both."""
    if numpy:
        import scipy.sparse as sp

        n = len(ls[0])
        size = 1 << n
        if weight is None:
            weight = [1.0] * len(ls)
        rows = np.arange(size, dtype=np.int64)
        r, c, v = [], [], []
        for l, w in zip(ls, weight):
            cols, vals = _pauli_string_coo_numpy([int(x) for x in l])
            r.append(rows)
            c.append(cols)
            v.append(vals * complex(w))
        m = sp.coo_matrix((np.concatenate(v), (np.concatenate(r), np.concatenate(c))), shape=(size, size))
        m.sum_duplicates()
        return m
    dev = config.resolve_device(device)
    rows, cols, vals = _pauli_sum_coo_planes(ls, weight, dev)
    size = 1 << len(ls[0])
    return torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals.to(config.torch_dtype()), (size, size), is_coalesced=True,
        check_invariants=False,
    )


def PauliStringSum2Dense(
    ls: Sequence[Sequence[int]],
    weight: Optional[Sequence[Any]] = None,
    numpy: bool = False,
    device: Optional[Any] = None,
) -> Any:
    """Σ_i w_i P_i as a dense (2^n, 2^n) tensor in the configured dtype on
    ``device``: the dense form of :func:`PauliStringSum2COO`'s matrix; with
    ``numpy`` the complex128 numpy array of its scipy route."""
    if numpy:
        return np.asarray(PauliStringSum2COO(ls, weight, numpy=True).todense())
    return PauliStringSum2COO(ls, weight, device=device).to_dense()


def PauliStringSum2MVP(
    ls: Sequence[Sequence[int]], weight: Optional[Sequence[Any]] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The matrix-free product v -> (Σ_i w_i P_i) v of a state of any shape
    of 2^n entries, on v's device and differentiable in v: each string is
    sign masks on its Z and Y slots, then index flips on its X and Y slots
    (``statevec.sign_slot`` / ``flip_slot``), times w_i·i^(#Y)."""
    from .core import statevec as _sv

    ls = [[int(x) for x in l] for l in ls]
    if weight is None:
        weight = [1.0] * len(ls)
    specs = []
    for l, w in zip(ls, weight):
        x_slots = tuple(q for q, p in enumerate(l) if p in (1, 2))
        zy_slots = tuple(q for q, p in enumerate(l) if p in (2, 3))
        specs.append((x_slots, zy_slots, complex(w) * (1j) ** sum(1 for p in l if p == 2)))

    def mvp(v: torch.Tensor) -> torch.Tensor:
        psi = torch.reshape(v, (-1,))
        acc = torch.zeros_like(psi)
        for x_slots, zy_slots, coef in specs:
            term = psi
            for q in zy_slots:
                term = _sv.sign_slot(term, q)
            for q in x_slots:
                term = _sv.flip_slot(term, q)
            acc = acc + torch.tensor(coef, dtype=psi.dtype, device=psi.device) * term
        return torch.reshape(acc, v.shape)

    return mvp


def heisenberg_hamiltonian(
    g: Any,
    hzz: float = 1.0,
    hxx: float = 1.0,
    hyy: float = 1.0,
    hz: float = 0.0,
    hx: float = 0.0,
    hy: float = 0.0,
    sparse: bool = True,
    numpy: bool = False,
    device: Optional[Any] = None,
) -> Any:
    """The Heisenberg (XYZ) Hamiltonian of a graph (a networkx graph or a
    list of edges; nodes in their order): Σ_edges hxx XX + hyy YY + hzz ZZ
    + Σ_nodes hx X + hy Y + hz Z, as COO (``sparse``) or dense."""
    try:
        nodes = list(g.nodes)
        edges = list(g.edges)
    except AttributeError:
        edges = list(g)
        nodes = sorted({i for e in edges for i in e})
    n = len(nodes)
    idx = {v: i for i, v in enumerate(nodes)}
    ls: List[List[int]] = []
    weights: List[float] = []
    for e in edges:
        i, j = idx[e[0]], idx[e[1]]
        for p, h in [(1, hxx), (2, hyy), (3, hzz)]:
            if h != 0:
                l = [0] * n
                l[i] = l[j] = p
                ls.append(l)
                weights.append(h)
    for i in range(n):
        for p, h in [(1, hx), (2, hy), (3, hz)]:
            if h != 0:
                l = [0] * n
                l[i] = p
                ls.append(l)
                weights.append(h)
    if sparse:
        return PauliStringSum2COO(ls, weights, numpy=numpy, device=device)
    return PauliStringSum2Dense(ls, weights, numpy=numpy, device=device)


xyz_hamiltonian = heisenberg_hamiltonian


class LinearOperator:
    """A dense matrix, a sparse matrix or a matrix-free product as one
    operator: ``op(v)``, ``op.matvec(v)`` and ``op @ v``."""

    def __init__(self, h: Any, shape: Optional[Tuple[int, int]] = None):
        if isinstance(h, LinearOperator):
            self._mvp = h._mvp
            self.shape = h.shape
        elif callable(h) and not hasattr(h, "shape"):
            self._mvp = h
            self.shape = shape
        elif K.is_sparse(h):
            self._mvp = lambda v: K.sparse_dense_matmul(h, v)
            self.shape = tuple(h.shape)
        else:
            hm = _tensor(h)
            self._mvp = lambda v: hm @ v
            self.shape = tuple(hm.shape)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self._mvp(v)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self._mvp(v)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self._mvp(v)


def aslinearoperator(h: Any) -> LinearOperator:
    """``h`` (dense, sparse or a callable) as a :class:`LinearOperator`."""
    return LinearOperator(h)


def ps2xyz(ps: Sequence[int]) -> Dict[str, List[int]]:
    """A Pauli string as its X, Y and Z sites: ``ps2xyz([1, 2, 2, 0]) ==
    {"x": [0], "y": [1, 2], "z": []}``."""
    xyz: Dict[str, List[int]] = {"x": [], "y": [], "z": []}
    for i, j in enumerate(ps):
        if j in (1, 2, 3):
            xyz["xyz"[j - 1]].append(i)
    return xyz


def xyz2ps(xyz: Dict[str, List[int]], n: Optional[int] = None) -> List[int]:
    """The Pauli string of X, Y and Z sites, of length ``n`` (the last
    site + 1 by default)."""
    if n is None:
        n = max(xyz.get("x", []) + xyz.get("y", []) + xyz.get("z", [])) + 1
    ps = [0] * n
    for code, key in ((1, "x"), (2, "y"), (3, "z")):
        for i in xyz.get(key, []):
            ps[i] = code
    return ps


def ps2coo_core(l: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [2^n, 2] int64, complex128 values) of one Pauli string, on
    the host."""
    cols, vals = _pauli_string_coo_numpy(list(l))
    return np.stack([np.arange(cols.shape[0], dtype=np.int64), cols], axis=1), vals


#: the single-string COO builder by backend name, as the JAX package keys it
PauliString2COO_jit = {"numpy": PauliString2COO, "pytorch": PauliString2COO}


def PauliStringSum2COO_tf(*args: Any, **kws: Any) -> Any:
    """:func:`PauliStringSum2COO` under the reference's TensorFlow name."""
    return PauliStringSum2COO(*args, **kws)


def PauliStringSum2COO_numpy(ls: Any, weight: Optional[Any] = None) -> Any:
    """:func:`PauliStringSum2COO` on the host (a scipy ``coo_matrix``)."""
    return PauliStringSum2COO(ls, weight, numpy=True)


# ======================================================================
# quantum-information toolbox
# ======================================================================


def _to_rho(state: Any) -> torch.Tensor:
    """A square 2-D input as it is; anything else as the pure |s⟩⟨s| of
    its flattened entries."""
    s = _tensor(state)
    if s.ndim == 2 and s.shape[0] == s.shape[1]:
        return s
    s = torch.reshape(s, (-1,))
    return torch.outer(s, torch.conj(s))


def _resolve_cut(n: int, cut: Any, subsystem_to_keep: Any, subsystems_to_trace_out: Any) -> List[int]:
    """The sites to trace out: ``subsystems_to_trace_out``, else the
    complement of ``subsystem_to_keep``, else ``cut`` (an int c means the
    first c sites)."""
    if subsystems_to_trace_out is not None:
        return [int(q) for q in subsystems_to_trace_out]
    if subsystem_to_keep is not None:
        keep = set(int(q) for q in subsystem_to_keep)
        return [q for q in range(n) if q not in keep]
    if cut is None:
        raise ValueError("give one of cut / subsystem_to_keep / subsystems_to_trace_out")
    if isinstance(cut, int):
        return list(range(cut))
    return [int(q) for q in cut]


def _is_dm(s: torch.Tensor) -> bool:
    return s.ndim == 2 and s.shape[0] == s.shape[1] and s.numel() == s.shape[0] ** 2


def reduced_density_matrix(
    state: Any,
    cut: Union[int, Sequence[int], None] = None,
    p: Optional[Any] = None,
    normalize: bool = True,
    dim: Optional[int] = None,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The density matrix of the sites left after tracing out ``cut`` (or
    keeping ``subsystem_to_keep``, or tracing ``subsystems_to_trace_out``:
    give one of the three) of a ket (any shape of d^n entries), a density
    matrix or a QuOperator, with local dimension ``dim`` (2).  A ket's
    entries may be weighted by the probabilities ``p``.  Normalized to
    trace 1 unless ``normalize`` is False; on the state's device."""
    if isinstance(state, QuOperator):
        state = state.eval_matrix() if (state.in_dims and state.out_dims) else torch.reshape(state.eval(), (-1,))
    d = int(dim or 2)
    s = _tensor(state)
    size = s.numel()
    n = int(round(math.log(s.shape[0] if _is_dm(s) else size, d)))
    cut = _resolve_cut(n, cut, subsystem_to_keep, subsystems_to_trace_out)
    if _is_dm(s):
        # one site traced at a time, the highest first
        flat = torch.reshape(s, (-1,))
        m = n
        for q in sorted(cut, reverse=True):
            t = torch.reshape(flat, (d**q, d, d ** (m - 1), d, d ** (m - 1 - q)))
            flat = torch.reshape(torch.einsum("aibic->abc", t), (-1,))
            m -= 1
        rho = torch.reshape(flat, (d**m, d**m))
    else:
        psi = torch.reshape(s, (-1,))
        if p is not None:
            psi = psi * torch.sqrt(torch.reshape(_tensor(p), (-1,))).to(psi.dtype)
        # each traced site moved to the minor end, the highest first
        for q in sorted(cut, reverse=True):
            psi = torch.reshape(torch.transpose(torch.reshape(psi, (d**q, d, d ** (n - 1 - q))), 1, 2), (-1,))
        psi_m = torch.reshape(psi, (d ** (n - len(cut)), d ** len(cut)))
        rho = psi_m @ psi_m.mH
    if normalize:
        rho = rho / torch.trace(rho)
    return rho


def entropy(rho: Any, eps: float = 1e-12) -> torch.Tensor:
    """The von Neumann entropy -tr(ρ ln ρ), from ``eigvalsh`` with the
    eigenvalues clipped to [eps, 1]."""
    if isinstance(rho, QuOperator):
        rho = rho.eval_matrix()
    lam = torch.clamp(torch.linalg.eigvalsh(_to_rho(rho)), eps, 1.0)
    return -torch.sum(lam * torch.log(lam))


def renyi_entropy(rho: Any, k: int = 2, eps: float = 1e-12) -> torch.Tensor:
    """The order-k Rényi entropy ln tr(ρ^k) / (1 - k) (k=1: :func:`entropy`)."""
    if isinstance(rho, QuOperator):
        rho = rho.eval_matrix()
    rho = _to_rho(rho)
    if k == 1:
        return entropy(rho, eps)
    lam = torch.clamp(torch.linalg.eigvalsh(rho), eps, 1.0)
    return torch.log(torch.sum(lam**k)) / (1 - k)


def entanglement_entropy(
    state: Any,
    cut: Union[int, Sequence[int], None] = None,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """The von Neumann entropy of :func:`reduced_density_matrix`."""
    rho = reduced_density_matrix(
        state, cut, dim=dim, subsystem_to_keep=subsystem_to_keep, subsystems_to_trace_out=subsystems_to_trace_out
    )
    return entropy(rho)


def renyi_entanglement_entropy(
    state: Any,
    cut: Union[int, Sequence[int], None] = None,
    k: int = 2,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """The order-k Rényi entropy of :func:`reduced_density_matrix`."""
    rho = reduced_density_matrix(
        state, cut, dim=dim, subsystem_to_keep=subsystem_to_keep, subsystems_to_trace_out=subsystems_to_trace_out
    )
    return renyi_entropy(rho, k)


def partial_transpose(rho: Any, transposed_sites: Sequence[int]) -> torch.Tensor:
    """ρ^{T_A}: the row and column indices of each listed qubit swapped."""
    rho = _to_rho(rho)
    n = int(round(math.log2(rho.shape[0])))
    flat = torch.reshape(rho, (-1,))
    for q in transposed_sites:
        t = torch.reshape(flat, (2**q, 2, 2 ** (n - 1), 2, 2 ** (n - q - 1)))
        flat = torch.reshape(torch.permute(t, (0, 3, 2, 1, 4)), (-1,))
    return torch.reshape(flat, rho.shape)


def _trace_norm_pt(rho: Any, transposed_sites: Sequence[int]) -> torch.Tensor:
    rho_pt = partial_transpose(rho, transposed_sites)
    lam = torch.linalg.eigvalsh(rho_pt @ rho_pt.mH)
    return torch.sum(torch.sqrt(torch.clamp(lam, min=0.0)))


def entanglement_negativity(rho: Any, transposed_sites: Sequence[int]) -> torch.Tensor:
    """(‖ρ^{T_A}‖_1 - 1) / 2, the trace norm from ``eigvalsh`` of
    ρ^{T_A} ρ^{T_A}†."""
    return (_trace_norm_pt(rho, transposed_sites) - 1.0) / 2.0


def log_negativity(rho: Any, transposed_sites: Sequence[int], base: str = "e") -> torch.Tensor:
    """ln ‖ρ^{T_A}‖_1 (base 2 with ``base="2"``)."""
    ln = torch.log(_trace_norm_pt(rho, transposed_sites))
    if base in (2, "2"):
        ln = ln / math.log(2.0)
    return ln


def _matrix_sqrt(a: torch.Tensor) -> torch.Tensor:
    """√a of a Hermitian PSD matrix (negative eigenvalues clipped to 0) by
    :func:`core.linalg.sqrtmh`, whose gradient stays finite where a is
    singular (the JAX package's is NaN there: Queue 3 F10 of
    ``ROADMAP.md``)."""
    return linalg.sqrtmh(a, psd=True)


def fidelity(rho: Any, rho0: Any) -> torch.Tensor:
    """The Uhlmann fidelity (tr √(√ρ ρ0 √ρ))², both roots by
    :func:`_matrix_sqrt`: finite gradients at a pure ρ too."""
    sq = _matrix_sqrt(_to_rho(rho))
    root = _matrix_sqrt(sq @ _to_rho(rho0) @ sq)
    return torch.real(torch.diagonal(root, dim1=-2, dim2=-1).sum(-1)) ** 2


def trace_distance(rho: Any, rho0: Any, eps: float = 1e-12) -> torch.Tensor:
    """½‖ρ - ρ0‖_1, from ``eigvalsh`` of (ρ-ρ0)(ρ-ρ0)†, each eigenvalue
    + eps under the root."""
    d = _to_rho(rho) - _to_rho(rho0)
    lam = torch.clamp(torch.linalg.eigvalsh(d @ d.mH), min=0.0)
    return 0.5 * torch.sum(torch.sqrt(lam + eps))


def mutual_information(
    s: Any,
    cut: Union[int, Sequence[int], None] = None,
    dim: Optional[int] = None,
    *,
    subsystem_to_keep: Optional[Sequence[int]] = None,
    subsystems_to_trace_out: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """I(A:B) = S(A) + S(B) - S(AB), A the sites of ``cut`` (or the
    keyword forms' traced sites), B the rest; S(AB) = 0 for a ket."""
    d = int(dim or 2)
    s = _tensor(s)
    mixed = s.ndim == 2 and s.shape[0] == s.shape[1]
    n = int(round(math.log(s.shape[0] if mixed else s.numel(), d)))
    cut = _resolve_cut(n, cut, subsystem_to_keep, subsystems_to_trace_out)
    other = [i for i in range(n) if i not in set(cut)]
    rho_a = reduced_density_matrix(s, other, dim=d)
    rho_b = reduced_density_matrix(s, list(cut), dim=d)
    hab = entropy(s) if mixed else 0.0
    return entropy(rho_a) + entropy(rho_b) - hab


def gibbs_state(h: Any, beta: float = 1.0) -> torch.Tensor:
    """e^{-βH} / Z by ``eigh`` of H."""
    e, v = _eigh(_tensor(h))
    rho = (v * torch.exp(-beta * e).to(v.dtype)[None, :]) @ v.mH
    return rho / torch.trace(rho)


def double_state(h: Any, beta: float = 1.0) -> torch.Tensor:
    """The thermofield double Σ_n e^{-βE_n/2} |v_n⟩|v_n*⟩ / √Z, flattened."""
    e, v = _eigh(_tensor(h))
    w = torch.exp(-beta * e / 2.0)
    psi = torch.reshape(torch.einsum("in,jn,n->ij", v, torch.conj(v), w.to(v.dtype)), (-1,))
    return psi / torch.linalg.vector_norm(psi)


def free_energy(rho: Any, h: Any, beta: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """tr(ρH) - S(ρ)/β (H dense or a QuOperator)."""
    rho = _to_rho(rho)
    if isinstance(h, QuOperator):
        h = h.eval_matrix()
    energy = torch.real(torch.trace(rho @ _tensor(h).to(rho.dtype)))
    return energy - entropy(rho, eps) / beta


def renyi_free_energy(rho: Any, h: Any, beta: float = 1.0, k: int = 2) -> torch.Tensor:
    """tr(ρH) - S_k(ρ)/β, S_k the order-k Rényi entropy."""
    rho = _to_rho(rho)
    if isinstance(h, QuOperator):
        h = h.eval_matrix()
    energy = torch.real(torch.trace(rho @ _tensor(h).to(rho.dtype)))
    return energy - renyi_entropy(rho, k) / beta


truncated_free_energy = renyi_free_energy


def purified_state(rho: Any) -> torch.Tensor:
    """A purification Σ_n √λ_n |v_n⟩|n⟩ of ρ by ``eigh``, flattened."""
    e, v = _eigh(_to_rho(rho))
    return torch.reshape(v * torch.sqrt(torch.clamp(e, min=0.0)).to(v.dtype)[None, :], (-1,))


def _fwht(v: torch.Tensor) -> torch.Tensor:
    """The unnormalized Walsh-Hadamard transform along the last axis: one
    butterfly a bit, the lowest first."""
    m = v.shape[-1]
    lead = v.shape[:-1]
    for q in range(int(round(math.log2(m)))):
        a = 2**q
        vr = torch.reshape(v, lead + (m // (2 * a), 2, a))
        lo, hi = vr[..., 0, :], vr[..., 1, :]
        v = torch.reshape(torch.stack([lo + hi, lo - hi], dim=-2), lead + (m,))
    return v


def stabilizer_renyi_entropy(state: Any, alpha: int = 2) -> torch.Tensor:
    """The stabilizer Rényi entropy M_alpha of a pure state: the Pauli
    spectrum p(x, z) = |⟨ψ|X^x Z^z|ψ⟩|² / 2^n over all 4^n strings,
    ⟨ψ|X^x Z^z|ψ⟩ = FWHT_s(conj(ψ[s ^ x]) ψ[s])[z], as one gather of the
    [2^n, 2^n] table and a batched Walsh-Hadamard transform;
    M = ln Σ p^alpha / (1 - alpha) - n ln 2 (alpha=1: the Shannon form)."""
    psi = torch.reshape(_tensor(state), (-1,))
    n = int(round(math.log2(psi.shape[0])))
    s = torch.arange(2**n, device=psi.device)
    chi = _fwht(torch.conj(psi[s[:, None] ^ s[None, :]]) * psi[None, :])
    p = torch.abs(chi) ** 2 / (2**n)
    p = torch.clamp(p / torch.sum(p), 1e-30, 1.0)
    if alpha == 1:
        ent = -torch.sum(p * torch.log(p))
    else:
        ent = torch.log(torch.sum(p**alpha)) / (1 - alpha)
    return ent - n * math.log(2.0)


def taylorlnm(x: Any, k: int) -> torch.Tensor:
    """ln(I + x) to order k of its Taylor series."""
    x = _tensor(x)
    acc = torch.zeros_like(x)
    term = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(1, k + 1):
        term = term @ x
        acc = acc + ((-1.0) ** (i + 1) / i) * term
    return acc


def op2tensor(fn: Callable[..., Any], op_argnums: Union[int, Sequence[int]] = 0) -> Callable[..., Any]:
    """``fn`` with its QuOperator arguments at ``op_argnums`` given as their
    dense matrices."""
    if isinstance(op_argnums, int):
        op_argnums = (op_argnums,)

    def wrapper(*args: Any, **kws: Any) -> Any:
        nargs = list(args)
        for i in op_argnums:
            if i < len(nargs) and isinstance(nargs[i], QuOperator):
                nargs[i] = nargs[i].eval_matrix()
        return fn(*nargs, **kws)

    wrapper.__name__ = getattr(fn, "__name__", "wrapped")
    wrapper.__doc__ = fn.__doc__
    return wrapper


def onehot_d_tensor(i: Any, d: int = 2, device: Optional[Any] = None) -> torch.Tensor:
    """The one-hot vector(s) of ``i`` of length d, in the configured dtype,
    on i's device (a tensor) or ``device`` (the configured one by
    default)."""
    dev = i.device if isinstance(i, torch.Tensor) else config.resolve_device(device)
    idx = torch.as_tensor(i, device=dev).to(torch.int64)
    return torch.nn.functional.one_hot(idx, d).to(config.torch_dtype())


def trace_product(*o: Any) -> torch.Tensor:
    """tr(Π_i O_i) of tensors and QuOperators."""
    mats = [x.eval_matrix() if isinstance(x, QuOperator) else _tensor(x) for x in o]
    prod = mats[0]
    for m in mats[1:]:
        prod, m = _promote(prod, m.to(prod.device))
        prod = prod @ m
    return torch.trace(prod)


def anti_flatness(rho: Any) -> torch.Tensor:
    """tr(ρ³) - tr(ρ²)², zero for a flat spectrum."""
    if isinstance(rho, QuOperator):
        rho = rho.eval_matrix()
    rho = _tensor(rho)
    rho2 = rho @ rho
    purity = torch.real(torch.trace(rho2))
    return torch.real(torch.sum(rho2 * rho.T)) - purity * purity


def entanglement_anti_flatness(state: Any, cut: Union[int, Sequence[int]]) -> torch.Tensor:
    """:func:`anti_flatness` of the state with ``cut`` traced out."""
    return anti_flatness(reduced_density_matrix(state, cut))


def reduced_wavefunction(
    state: Any, cut: Sequence[int], measure: Optional[Sequence[int]] = None, d: int = 2
) -> torch.Tensor:
    """The unnormalized wavefunction of the other sites after projecting
    the sites ``cut`` onto the outcomes ``measure`` (0s by default)."""
    s = torch.reshape(_tensor(state), (-1,))
    n = int(round(math.log(s.shape[0], d)))
    if measure is None:
        measure = [0 for _ in cut]
    nn = n
    for q, m in sorted(zip(list(cut), list(measure)), key=lambda x: -x[0]):
        s = torch.reshape(torch.reshape(s, (d**q, d, d ** (nn - 1 - q)))[:, int(m), :], (-1,))
        nn -= 1
    return s


# ======================================================================
# U(1) sectors
# ======================================================================


def u1_inds(n: int, m: int) -> np.ndarray:
    """The n-bit integers with exactly m set bits, ascending (Gosper's
    hack), on the host (int64)."""
    num = math.comb(n, m)
    inds = np.zeros([num], dtype=np.int64)
    if m == 0:
        return inds
    comb = (1 << m) - 1
    for i in range(num):
        inds[i] = comb
        u = comb & -comb
        v = u + comb
        comb = v + (((v ^ comb) // u) >> 2)
    return inds


def u1_mask(n: int, m: int, device: Optional[Any] = None) -> torch.Tensor:
    """The 0/1 mask of length 2^n of the sector with m set bits, in the
    configured real dtype on ``device`` (the configured one by default)."""
    mask = torch.zeros([2**n], dtype=getattr(torch, config.rdtypestr()), device=config.resolve_device(device))
    mask[torch.as_tensor(u1_inds(n, m), device=mask.device)] = 1.0
    return mask


def u1_project(s: Any, n: int, m: int) -> torch.Tensor:
    """The C(n, m) entries of a 2^n state in the sector with m set bits."""
    s = torch.reshape(_tensor(s), (-1,))
    return s[torch.as_tensor(u1_inds(n, m), device=s.device)]


def u1_enlarge(s: Any, n: int, m: int) -> torch.Tensor:
    """A sector state of C(n, m) entries embedded in the 2^n space."""
    s = torch.reshape(_tensor(s), (-1,))
    out = torch.zeros([2**n], dtype=s.dtype, device=s.device)
    return out.index_put((torch.as_tensor(u1_inds(n, m), device=s.device),), s)


# ======================================================================
# converters from and to MPO packages (each imported only when called)
# ======================================================================


def quimb2qop(mpo: Any) -> QuOperator:
    """A quimb MPO (its ``.arrays``, (l, r, out, in), the boundary tensors
    without their outer bond) as the dense QuOperator."""
    fixed = []
    for k, a in enumerate(_host(t) for t in mpo.arrays):
        if a.ndim == 3:
            a = a[None, ...] if k == 0 else a[:, None, ...]
        fixed.append(np.transpose(a, (0, 2, 3, 1)))
    return tn2qop(fixed)


def tenpy2qop(mpo: Any) -> QuOperator:
    """A TeNPy MPO (``get_W(i).to_ndarray()``, (wL, wR, p, p*)) as the dense
    QuOperator."""
    return tn2qop([np.transpose(_host(mpo.get_W(i).to_ndarray()), (0, 2, 3, 1)) for i in range(mpo.L)])


def _optional(name: str, what: str) -> Any:
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"{what} needs the {name} package, which is not installed") from e


def qop2tn(qop: QuOperator) -> Any:
    """A QuOperator as a list of tensornetwork Nodes (one, its matrix)."""
    tn = _optional("tensornetwork", "qop2tn")
    return [tn.Node(_host(qop.eval_matrix()))]


def qop2quimb(qop: QuOperator) -> Any:
    """A QuOperator as a quimb dense operator."""
    quimb = _optional("quimb", "qop2quimb")
    return quimb.qu(_host(qop.eval_matrix()), qtype="dop", sparse=False)


def qop2tenpy(qop: QuOperator) -> Any:
    """A QuOperator on n qubits as a TeNPy MPO of spin-1/2 sites, split site
    by site by SVDs of its matrix (singular values above 1e-12 kept)."""
    _optional("tenpy", "qop2tenpy")
    from tenpy.networks.mpo import MPO
    from tenpy.networks.site import SpinHalfSite

    m = _host(qop.eval_matrix())
    n = int(round(np.log2(m.shape[0])))
    perm = [i for pair in zip(range(n), range(n, 2 * n)) for i in pair]
    t = np.transpose(m.reshape((2,) * (2 * n)), perm).reshape(1, *(4,) * n, 1)
    ws = []
    rest = t.reshape(4, -1)
    left = 1
    for _ in range(n - 1):
        u, s, vh = np.linalg.svd(rest, full_matrices=False)
        keep = int(np.sum(s > 1e-12))
        u, s, vh = u[:, :keep], s[:keep], vh[:keep]
        ws.append(u.reshape(left, 4, keep))
        left = keep
        rest = (np.diag(s) @ vh).reshape(keep * 4, -1)
    ws.append(rest.reshape(left, 4, 1))
    site = SpinHalfSite(conserve=None)
    return MPO([site] * n, [np.transpose(w.reshape(w.shape[0], 2, 2, w.shape[-1]), (0, 3, 1, 2)) for w in ws])
