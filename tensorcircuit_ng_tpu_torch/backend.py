"""``TorchBackend``: the port's backend, the counterpart of
``tensorcircuit_ng_tpu/backend.py``'s ``JaxBackend`` under the same method
names, so that code written against ``K = tc.backend`` ports directly.

- **The array surface**: creation, shapes, elementwise math, reductions,
  linear algebra (``svd``/``qr``/``rq`` with the degenerate-safe adjoints of
  ``core/linalg.py``, ``expm`` by ``torch.linalg.matrix_exp``, ``sqrtmh``
  with a gradient finite at rank deficiency, ``eigsh_lobpcg`` and
  ``lobpcg_standard`` by a block LOBPCG, ``schur`` by scipy on the host),
  the bit operations and ``popc``.  A tensor keeps its device; a tensor
  made from nothing or from numpy is made on the configured device.
- **The transforms, on ``torch.func``**: ``grad``, ``value_and_grad``,
  ``jvp``, ``vjp``, ``jacfwd``, ``jacrev``, ``hessian``, ``vmap`` (over
  ``vectorized_argnums``) and ``vectorized_value_and_grad`` (``vvag``: the
  gradients of shared arguments summed over the batch), with the JAX
  package's ``argnums``/``has_aux`` forms.  A complex leaf's gradient is the
  JAX package's (``dL = Re<g, dx>``: the conjugate of torch's ``.grad``).
  Forward mode (``jvp``, ``jacfwd``, ``hessian``) through a kernel raises,
  as through the JAX package's ``custom_vjp`` kernels.
- **``jit``**: a call whose tensors all lie on the card is captured as a
  CUDA graph (:class:`Jitted`); on the CPU, or with ``jit_compile=False``,
  it runs eagerly.
- **Control flow and pytrees**: ``scan``, ``cond``, ``switch``,
  ``while_loop``, ``fori_loop`` as Python loops and branches,
  ``stop_gradient`` as ``detach``; ``tree_map``/``tree_flatten``/
  ``tree_unflatten`` on ``torch.utils._pytree``.
- **``optimizer``**: a ``torch.optim`` optimizer behind ``update(grads,
  params)`` (:class:`TorchOptimizer`).
- **Randomness**: every draw comes from a ``torch.Generator`` on the device
  it is drawn on: ``implicit_rand*`` from the backend's own generator, one
  per device, seeded from ``set_random_state(seed)`` (on a first use
  without a seed, the seed comes from ``np.random.randint(0, 2**31 - 1)``,
  so ``np.random.seed`` followed by ``set_random_state()`` repeats a run,
  as in the JAX package); ``stateful_rand*`` from a generator the caller
  passes, on that generator's device.  torch's generators give other bits
  than JAX's threefry keys: a run matches the JAX package only through an
  explicit ``status`` of uniforms.
- **Sparse matrices**: ``coo_sparse_matrix`` (a coalesced
  ``torch.sparse_coo_tensor`` on the values' device), its scipy import,
  ``sparse_dense_matmul``, ``is_sparse`` and ``to_dense``.
"""

from __future__ import annotations

import functools
import gc
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import config
from .core import linalg
from .core.statevec import cumsum_fixed_order

__all__ = ["TorchBackend", "Jitted", "TorchOptimizer", "backend", "get_backend", "check_generator",
           "device_tensor"]

Shape = Union[None, int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _device_key(device: Union[None, str, torch.device]) -> torch.device:
    """The device, with the current card's index on a bare ``"cuda"``."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_generator(g: torch.Generator, device: Union[str, torch.device]) -> None:
    """ValueError unless ``g`` draws on ``device``: a draw is never moved."""
    want, have = _device_key(device), torch.device(g.device)
    if have.type == "cuda" and have.index is None:
        have = torch.device("cuda", torch.cuda.current_device())
    if have != want:
        raise ValueError(
            f"the random generator is on {have} but the draw is for {want}: pass a "
            f"torch.Generator(device={str(want)!r})"
        )


def device_tensor(x: Any, device: Union[str, torch.device], what: str = "status") -> torch.Tensor:
    """``x`` as a tensor on ``device``: numpy arrays and Python numbers are
    copied there, a tensor on another device is refused (ValueError)."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor):
        if x.device.type != dev.type or (dev.index is not None and x.device.index != dev.index):
            raise ValueError(f"{what} is on {x.device} but the circuit is on {dev}: move it explicitly")
        return x
    return torch.as_tensor(np.asarray(x), device=dev)


class TorchBackend:
    """The backend of the port (one concrete backend, ``"pytorch"``)."""

    name = "pytorch"

    def __init__(self) -> None:
        self._seed: Optional[int] = None
        self._generators: Dict[torch.device, torch.Generator] = {}

    # ---------------- generators ----------------

    def set_random_state(self, seed: Optional[int] = None) -> None:
        """Seed the implicit generators of every device (with a seed drawn
        from ``np.random`` when ``seed`` is None)."""
        if seed is None:
            seed = np.random.randint(0, 2**31 - 1)
        self._seed = int(seed)
        self._generators = {}

    def get_random_state(
        self, seed: Optional[int] = None, device: Union[None, str, torch.device] = None
    ) -> torch.Generator:
        """A new generator seeded with ``seed`` on ``device`` (the configured
        device by default); without a seed, the implicit generator."""
        if seed is None:
            return self._implicit(device)
        g = torch.Generator(device=_device_key(device))
        g.manual_seed(int(seed))
        return g

    def _implicit(self, device: Union[None, str, torch.device]) -> torch.Generator:
        dev = _device_key(device)
        if dev not in self._generators:
            if self._seed is None:
                self.set_random_state()
            g = torch.Generator(device=dev)
            g.manual_seed(self._seed)
            self._generators[dev] = g
        return self._generators[dev]

    # ---------------- draws ----------------

    def implicit_randn(
        self, shape: Shape = None, mean: float = 0.0, stddev: float = 1.0,
        device: Union[None, str, torch.device] = None,
    ) -> torch.Tensor:
        """Normal numbers in the configured real dtype on ``device``."""
        return self.stateful_randn(self._implicit(device), shape, mean, stddev)

    def implicit_randu(
        self, shape: Shape = None, low: float = 0.0, high: float = 1.0,
        device: Union[None, str, torch.device] = None,
    ) -> torch.Tensor:
        """Uniforms in [low, high) in the configured real dtype on ``device``."""
        return self.stateful_randu(self._implicit(device), shape, low, high)

    def implicit_randc(
        self, a: Any, shape: Shape = None, p: Optional[Any] = None,
        device: Union[None, str, torch.device] = None,
    ) -> torch.Tensor:
        """Choices from ``a`` (an int n means ``range(n)``), with replacement,
        weighted by ``p`` when given."""
        return self.stateful_randc(self._implicit(device), a, shape, p)

    def stateful_randn(
        self, g: torch.Generator, shape: Shape = None, mean: float = 0.0,
        stddev: float = 1.0, dtype: Optional[str] = None,
    ) -> torch.Tensor:
        dt = getattr(torch, dtype or config.rdtypestr())
        return torch.randn(_shape(shape), generator=g, device=g.device, dtype=dt) * stddev + mean

    def stateful_randu(
        self, g: torch.Generator, shape: Shape = None, low: float = 0.0,
        high: float = 1.0, dtype: Optional[str] = None,
    ) -> torch.Tensor:
        dt = getattr(torch, dtype or config.rdtypestr())
        u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=dt)
        return u * (high - low) + low if (low, high) != (0.0, 1.0) else u

    def stateful_randc(
        self, g: torch.Generator, a: Any, shape: Shape = None, p: Optional[Any] = None
    ) -> torch.Tensor:
        a = torch.arange(a, device=g.device) if isinstance(a, int) else torch.as_tensor(a, device=g.device)
        shape = _shape(shape)
        num = int(np.prod(shape)) if shape else 1
        if p is None:
            idx = torch.randint(a.shape[0], (num,), generator=g, device=g.device)
        else:
            w = torch.as_tensor(p, device=g.device, dtype=torch.float64)
            idx = torch.multinomial(w, num, replacement=True, generator=g)
        return torch.reshape(a[idx], shape)

    # ---------------- sampling ----------------

    def probability_sample(
        self, shots: int, p: torch.Tensor, status: Optional[Any] = None,
        g: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Inverse-CDF sampling of ``shots`` indices of the probabilities
        ``p`` (renormalized) from one uniform a shot: ``status`` if given
        (its length sets the count), else drawn from ``g`` or the implicit
        generator of ``p``'s device.  The cumulative sum runs on ``p``'s
        device in a fixed order (:func:`statevec.cumsum_fixed_order`), so
        the same status gives the same indices on every call; an index is
        the count of cdf entries ≤ its uniform (int32), held to
        ``len(p) - 1`` where rounding leaves cdf[-1] below it."""
        p = p / torch.sum(p)
        rdt = p.dtype if p.is_floating_point() else torch.float32
        if status is None:
            if g is None:
                g = self._implicit(p.device)
            check_generator(g, p.device)
            status = torch.rand((shots,), generator=g, device=p.device, dtype=rdt)
        else:
            status = device_tensor(status, p.device)
        cdf = cumsum_fixed_order(p)
        idx = torch.searchsorted(cdf, status.to(cdf.dtype).contiguous(), right=True)
        return torch.clamp(idx, max=p.shape[0] - 1).to(torch.int32)

    # ---------------- sparse matrices ----------------

    def coo_sparse_matrix(self, indices: Any, values: Any, shape: Sequence[int]) -> torch.Tensor:
        """The COO matrix of ``indices`` [nnz, 2] and ``values`` [nnz],
        coalesced (entries in row-major order, duplicates summed), on the
        values' device (numpy values: the configured device)."""
        values = values if isinstance(values, torch.Tensor) else torch.as_tensor(
            np.asarray(values), device=config.resolve_device())
        idx = torch.as_tensor(np.asarray(indices) if not isinstance(indices, torch.Tensor) else indices,
                              device=values.device).to(torch.int64)
        return torch.sparse_coo_tensor(idx.T, values, tuple(int(s) for s in shape), check_invariants=True).coalesce()

    def coo_sparse_matrix_from_numpy(self, a: Any) -> torch.Tensor:
        """A scipy sparse matrix (or a dense numpy one) as
        :meth:`coo_sparse_matrix` gives it."""
        import scipy.sparse as sp

        acoo = sp.coo_matrix(a)
        return self.coo_sparse_matrix(np.stack([acoo.row, acoo.col], axis=1), acoo.data, acoo.shape)

    def sparse_dense_matmul(self, sp_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``sp_a @ b`` for a vector or a matrix ``b``."""
        return sp_a @ b

    def is_sparse(self, a: Any) -> bool:
        """Whether ``a`` is a torch sparse tensor (COO or compressed)."""
        return isinstance(a, torch.Tensor) and a.layout != torch.strided

    def to_dense(self, sp_a: torch.Tensor) -> torch.Tensor:
        return sp_a.to_dense()


    # ---------------- creation ----------------

    def _new(self, a: Any, dtype: Optional[str] = None) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            t = a
        else:
            t = torch.as_tensor(np.asarray(a), device=config.resolve_device())
        return t if dtype is None else t.to(_dt(dtype))

    def convert_to_tensor(self, a: Any, dtype: Optional[str] = None) -> torch.Tensor:
        """``a`` as a tensor (a tensor keeps its device; numpy and Python
        values go to the configured device)."""
        return self._new(a, dtype)

    def cast(self, a: Any, dtype: str) -> torch.Tensor:
        t = self._new(a)
        if t.is_complex() and not _dt(dtype).is_complex:
            t = t.real
        return t.to(_dt(dtype))

    def eye(self, N: int, dtype: Optional[str] = None, M: Optional[int] = None) -> torch.Tensor:
        return torch.eye(N, M if M is not None else N, dtype=_dt(dtype or config.dtypestr()),
                         device=config.resolve_device())

    def ones(self, shape: Sequence[int], dtype: Optional[str] = None) -> torch.Tensor:
        return torch.ones(_shape(shape), dtype=_dt(dtype or config.dtypestr()), device=config.resolve_device())

    def zeros(self, shape: Sequence[int], dtype: Optional[str] = None) -> torch.Tensor:
        return torch.zeros(_shape(shape), dtype=_dt(dtype or config.dtypestr()), device=config.resolve_device())

    def copy(self, a: Any) -> torch.Tensor:
        return self._new(a).clone()

    def arange(self, start: int, stop: Optional[int] = None, step: int = 1) -> torch.Tensor:
        if stop is None:
            start, stop = 0, start
        return torch.arange(start, stop, step, device=config.resolve_device())

    def ones_like(self, a: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(a)

    def zeros_like(self, a: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(a)

    def i(self, dtype: Optional[str] = None) -> torch.Tensor:
        return torch.tensor(1j, dtype=_dt(dtype or config.dtypestr()), device=config.resolve_device())

    def random_split(self, key: torch.Generator, num: int = 2) -> List[torch.Generator]:
        """``num`` new generators on ``key``'s device, seeded by draws from
        ``key`` (the counterpart of splitting a JAX key)."""
        seeds = torch.randint(0, 2**62, (num,), generator=key, device=key.device).tolist()
        out = []
        for sd in seeds:
            g = torch.Generator(device=key.device)
            g.manual_seed(int(sd))
            out.append(g)
        return out

    # ---------------- shapes / structure ----------------

    def shape_tuple(self, a: torch.Tensor) -> Tuple[int, ...]:
        return tuple(a.shape)

    def shape_concat(self, values: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
        return torch.cat(list(values), dim=axis)

    def shape_prod(self, values: Any) -> torch.Tensor:
        return torch.prod(self._new(values))

    def sizen(self, a: torch.Tensor) -> int:
        return int(np.prod(a.shape)) if a.shape else 1

    def size(self, a: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.sizen(a), device=a.device)

    def reshape(self, a: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        return torch.reshape(a, _shape(shape))

    def reshape2(self, a: torch.Tensor) -> torch.Tensor:
        """Reshape to (2, 2, ..., 2)."""
        return torch.reshape(a, [2] * int(np.log2(self.sizen(a))))

    def reshapem(self, a: torch.Tensor) -> torch.Tensor:
        """Reshape to a square matrix."""
        l = int(np.sqrt(self.sizen(a)))
        return torch.reshape(a, (l, l))

    def reshaped(self, a: torch.Tensor, d: int) -> torch.Tensor:
        """Reshape to (d, d, ..., d); an empty input to the empty (0,)."""
        if not isinstance(d, int) or d <= 0:
            raise ValueError("d must be a positive integer.")
        size = self.sizen(a)
        if size == 0:
            return torch.reshape(a, (0,))
        nleg = int(round(math.log(size, d))) if size > 1 else 0
        if d**nleg != size:
            raise ValueError(f"tensor size {size} is not a power of {d}")
        return torch.reshape(a, [d] * nleg)

    def transpose(self, a: torch.Tensor, perm: Optional[Sequence[int]] = None) -> torch.Tensor:
        return a.permute(*(range(a.dim() - 1, -1, -1) if perm is None else perm))

    def tile(self, a: torch.Tensor, rep: Any) -> torch.Tensor:
        return torch.tile(a, _shape(rep))

    def stack(self, a: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
        return torch.stack(list(a), dim=axis)

    def concat(self, a: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
        return torch.cat(list(a), dim=axis)

    def slice(self, a: torch.Tensor, starts: Sequence[int], sizes: Sequence[int]) -> torch.Tensor:
        """``lax.dynamic_slice``: each start clamped so the slice fits."""
        out = a
        for ax, (st, sz) in enumerate(zip(starts, sizes)):
            st = min(max(int(st), 0), a.shape[ax] - int(sz))
            out = out.narrow(ax, st, int(sz))
        return out

    def gather1d(self, a: torch.Tensor, indices: Any) -> torch.Tensor:
        """``jnp.take`` without an axis: indices into the flattened ``a``."""
        return torch.reshape(a, (-1,))[self._new(indices).to(device=a.device, dtype=torch.int64)]

    def scatter(self, a: torch.Tensor, indices: Any, updates: torch.Tensor) -> torch.Tensor:
        """A copy of ``a`` with a[indices] = updates; indices [n, rank]."""
        idx = self._new(indices).to(device=a.device, dtype=torch.int64)
        if idx.dim() == 1:
            idx = idx[:, None]
        return a.index_put(tuple(idx[:, i] for i in range(idx.shape[1])), updates.to(a.dtype))

    def expand_dims(self, a: torch.Tensor, axis: int) -> torch.Tensor:
        return torch.unsqueeze(a, axis)

    def repeat(self, a: torch.Tensor, repeats: Any, axis: Optional[int] = None) -> torch.Tensor:
        return torch.repeat_interleave(a.reshape(-1) if axis is None else a, repeats, dim=0 if axis is None else axis)

    def meshgrid(self, *args: torch.Tensor, **kws: Any) -> Tuple[torch.Tensor, ...]:
        return torch.meshgrid(*args, indexing=kws.get("indexing", "xy"))

    def reverse(self, a: torch.Tensor) -> torch.Tensor:
        return torch.flip(a, (0,))

    def moveaxis(self, a: torch.Tensor, source: Any, destination: Any) -> torch.Tensor:
        return torch.movedim(a, source, destination)

    def diagflat(self, a: torch.Tensor) -> torch.Tensor:
        return torch.diagflat(a)

    def diag(self, a: torch.Tensor, k: int = 0) -> torch.Tensor:
        return torch.diag(a, k)

    def onehot(self, a: torch.Tensor, num: int) -> torch.Tensor:
        return torch.nn.functional.one_hot(self._new(a).to(torch.int64), num).to(torch.float32)

    one_hot = onehot

    # ---------------- elementwise / math ----------------

    def real(self, a: torch.Tensor) -> torch.Tensor:
        return torch.real(a) if a.is_complex() else a

    def imag(self, a: torch.Tensor) -> torch.Tensor:
        return torch.imag(a) if a.is_complex() else torch.zeros_like(a)

    def conj(self, a: torch.Tensor) -> torch.Tensor:
        return torch.conj(a).resolve_conj() if a.is_complex() else a

    def adjoint(self, a: torch.Tensor) -> torch.Tensor:
        return self.conj(torch.swapaxes(a, -1, -2))

    def abs(self, a: torch.Tensor) -> torch.Tensor:
        return torch.abs(a)

    def sign(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sgn(a)

    def exp(self, a: torch.Tensor) -> torch.Tensor:
        return torch.exp(a)

    def log(self, a: torch.Tensor) -> torch.Tensor:
        return torch.log(a)

    def sqrt(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(a)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return torch.square(a)

    def sigmoid(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(a)

    def relu(self, a: torch.Tensor) -> torch.Tensor:
        return torch.relu(a)

    def softmax(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.softmax(a, dim=-1 if axis is None else axis)

    def power(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return torch.pow(a, b)

    def mod(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        """The floor modulus (the divisor's sign), as ``jnp.mod``."""
        return torch.remainder(x, y)

    def floor_divide(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.floor_divide(x, y)

    def clip(self, a: torch.Tensor, a_min: Any, a_max: Any) -> torch.Tensor:
        return torch.clamp(a, a_min, a_max)

    def maximum(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))

    def minimum(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))

    def atan2(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.atan2(y, x)

    def bitwise_and(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.bitwise_and(x, y)

    def bitwise_or(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.bitwise_or(x, y)

    def bitwise_xor(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.bitwise_xor(x, y)

    def left_shift(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.bitwise_left_shift(x, y)

    def right_shift(self, x: torch.Tensor, y: Any) -> torch.Tensor:
        return torch.bitwise_right_shift(x, y)

    def popc(self, a: torch.Tensor) -> torch.Tensor:
        """The number of set bits of each entry (``lax.population_count``)
        of an integer tensor, in its dtype (a negative entry counts its
        two's complement bits)."""
        width = torch.iinfo(a.dtype).bits
        x = a.to(torch.int64) & ((1 << width) - 1 if width < 64 else -1)
        count = torch.zeros_like(x)
        for b in range(width):
            count = count + ((x >> b) & 1)
        return count.to(a.dtype)

    # ---------------- reductions / comparisons ----------------

    def sum(self, a: torch.Tensor, axis: Any = None, keepdims: bool = False) -> torch.Tensor:
        return torch.sum(a) if axis is None and not keepdims else torch.sum(a, dim=_axes(axis, a), keepdim=keepdims)

    def mean(self, a: torch.Tensor, axis: Any = None, keepdims: bool = False) -> torch.Tensor:
        return torch.mean(a) if axis is None and not keepdims else torch.mean(a, dim=_axes(axis, a), keepdim=keepdims)

    def std(self, a: torch.Tensor, axis: Any = None, keepdims: bool = False) -> torch.Tensor:
        """The population standard deviation (``ddof=0``, as ``jnp.std``)."""
        return torch.std(a, dim=_axes(axis, a), correction=0, keepdim=keepdims)

    def max(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.amax(a) if axis is None else torch.amax(a, dim=axis)

    def min(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.amin(a) if axis is None else torch.amin(a, dim=axis)

    def argmax(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return torch.argmax(a, dim=axis)

    def argmin(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return torch.argmin(a, dim=axis)

    def cumsum(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.cumsum(a.reshape(-1) if axis is None else a, dim=0 if axis is None else axis)

    def prod(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.prod(a) if axis is None else torch.prod(a, dim=axis)

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        """The 2-norm of a vector, the Frobenius norm of a matrix."""
        return torch.linalg.vector_norm(a)

    def all(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.all(a) if axis is None else torch.all(a, dim=axis)

    def any(self, a: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        return torch.any(a) if axis is None else torch.any(a, dim=axis)

    def argsort(self, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
        return torch.argsort(a, dim=axis, stable=True)

    def sort(self, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
        return torch.sort(a, dim=axis, stable=True).values

    def lexsort(self, keys: Any, axis: int = -1) -> torch.Tensor:
        """Indices sorting by the last key first (``jnp.lexsort``)."""
        keys = [self._new(k) for k in keys]
        idx = torch.argsort(keys[0], dim=axis, stable=True)
        for k in keys[1:]:
            idx = torch.gather(idx, axis, torch.argsort(torch.gather(k, axis, idx), dim=axis, stable=True))
        return idx

    def top_k(self, a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        v, i = torch.topk(a, k, dim=-1)
        return v, i

    def unique_with_counts(self, a: torch.Tensor, **kws: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.unique(a, sorted=True, return_counts=True)

    def relative_entropy(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return torch.sum(p * (torch.log(p) - torch.log(q)))

    def equal(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a == b

    def not_equal(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a != b

    def greater(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a > b

    def less(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a < b

    def greater_equal(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a >= b

    def less_equal(self, a: torch.Tensor, b: Any) -> torch.Tensor:
        return a <= b

    def where(self, cond: torch.Tensor, x: Any, y: Any) -> torch.Tensor:
        return torch.where(cond, x, y)

    def searchsorted(self, a: torch.Tensor, v: Any, side: str = "left") -> torch.Tensor:
        v = self._new(v).to(device=a.device, dtype=a.dtype)
        return torch.searchsorted(a, v.contiguous(), right=side == "right")

    # ---------------- linear algebra ----------------

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    def matvec(self, A: Any, x: torch.Tensor) -> torch.Tensor:
        if hasattr(A, "matvec"):  # a LinearOperator
            return A.matvec(x)
        if self.is_sparse(A):
            return A @ x
        return torch.tensordot(A, x, dims=([1], [0]))

    def tensordot(self, a: torch.Tensor, b: torch.Tensor, axes: Any) -> torch.Tensor:
        return torch.tensordot(a, b, dims=axes)

    def einsum(self, expr: str, *tensors: torch.Tensor, **kws: Any) -> torch.Tensor:
        return torch.einsum(expr, *tensors)

    def outer_product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(a, b, dims=0)

    def kron(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.kron(a, b)

    def trace(self, a: torch.Tensor) -> torch.Tensor:
        """The trace over the first two axes (``jnp.trace``)."""
        return torch.diagonal(a, 0, 0, 1).sum(-1)

    def det(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.det(a)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.inv(a)

    def solve(self, a: torch.Tensor, b: torch.Tensor, **kws: Any) -> torch.Tensor:
        return torch.linalg.solve(a, b)

    def svd(self, a: torch.Tensor, full_matrices: bool = False):
        return linalg.adaware_svd(a)

    def qr(self, a: torch.Tensor):
        return linalg.adaware_qr(a)

    def rq(self, a: torch.Tensor):
        return linalg.adaware_rq(a)

    def eigh(self, a: torch.Tensor):
        """``jnp.linalg.eigh``'s adjoint (exact spacings)."""
        return linalg.plain_eigh(a)

    def eig(self, a: torch.Tensor):
        return torch.linalg.eig(a)

    def eigvalsh(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.eigvalsh(a)

    def expm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.matrix_exp(a)

    def sqrtmh(self, a: torch.Tensor, psd: bool = False) -> torch.Tensor:
        """√a of a Hermitian matrix (:func:`core.linalg.sqrtmh`: a finite
        gradient at rank deficiency)."""
        return linalg.sqrtmh(a, psd=psd)

    def schur(self, a: torch.Tensor, output: str = "real"):
        """The Schur form ``(t, z)`` with ``a = z t z^H``, by scipy on the
        host (the JAX package leaves it to ``jax.scipy``), back on ``a``'s
        device."""
        import scipy.linalg as sl

        t, z = sl.schur(a.detach().cpu().resolve_conj().numpy(), output=output)
        return torch.as_tensor(t, device=a.device), torch.as_tensor(z, device=a.device)

    def lobpcg(self, a: Any, x: torch.Tensor, m: Any = None, largest: bool = False, tol: float = 0.0,
               max_iter: int = 100):
        """``(eigenvalues, vectors)`` of the k = x.shape[1] smallest (or
        ``largest``) eigenpairs of a symmetric or Hermitian operator from
        the start block ``x`` (the JAX backend's ``lobpcg``; complex blocks
        run natively, no real embedding)."""
        op = _operator(self, a)
        if largest:
            theta, u, _ = _lobpcg(op, x, max_iter, tol or None)
            return theta, u
        theta, u, _ = _lobpcg(lambda v: -op(v), x, max_iter, tol or None)
        return -theta, u

    def lobpcg_standard(self, a: Any, x0: torch.Tensor, m: int = 100, tol: Optional[float] = None):
        """The k = x0.shape[1] LARGEST eigenpairs of a symmetric operator
        (a matrix, a sparse matrix, a LinearOperator or a callable) by block
        LOBPCG from the start block ``x0``: ``(theta, u, iterations)``, as
        ``jax.experimental.sparse.linalg.lobpcg_standard``."""
        return _lobpcg(_operator(self, a), x0, m, tol)

    def eigsh_lobpcg(self, a: Any, k: int = 1, which: str = "SA", x0: Optional[torch.Tensor] = None,
                     maxiter: int = 100, tol: float = 0.0, **kws: Any):
        """The k smallest eigenpairs (``which="SA"``; ``"LA"`` the largest)
        of a symmetric operator by :meth:`lobpcg_standard`; without ``x0``
        the start block is Gaussian from a fixed seed."""
        op = _operator(self, a)
        if x0 is None:
            n = a.shape[-1]
            dtype = a.dtype if isinstance(a, torch.Tensor) else _dt(config.rdtypestr())
            dev = a.device if isinstance(a, torch.Tensor) else config.resolve_device()
            gen = torch.Generator(device=dev).manual_seed(0)
            x0 = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
        if which == "LA":
            theta, u, _ = _lobpcg(op, x0, maxiter, tol or None)
            return theta, u
        theta, u, _ = _lobpcg(lambda v: -op(v), x0, maxiter, tol or None)
        return -theta, u

    # ---------------- dtype / device / numpy ----------------

    def dtype(self, a: torch.Tensor) -> str:
        return str(a.dtype).replace("torch.", "")

    def numpy(self, a: Any) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().resolve_conj().numpy()
        return np.asarray(a)

    def item(self, a: Any) -> Any:
        return a.item() if isinstance(a, torch.Tensor) else np.asarray(a).item()

    def is_tensor(self, a: Any) -> bool:
        return isinstance(a, torch.Tensor)

    def device(self, a: torch.Tensor) -> torch.device:
        return a.device

    def device_move(self, a: torch.Tensor, dev: Any) -> torch.Tensor:
        return a.to(dev)

    def to_dlpack(self, a: torch.Tensor) -> Any:
        return torch.utils.dlpack.to_dlpack(a)

    def from_dlpack(self, a: Any) -> torch.Tensor:
        return torch.utils.dlpack.from_dlpack(a)

    # ---------------- control flow ----------------

    def cond(self, pred: Any, true_fn: Callable, false_fn: Callable, *operands: Any) -> Any:
        """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``
        (a Python branch: ``pred`` is read on the host)."""
        return true_fn(*operands) if bool(pred) else false_fn(*operands)

    def switch(self, index: Any, branches: Sequence[Callable], *operands: Any) -> Any:
        """``branches[index](*operands)``, the index clamped into range as
        ``lax.switch`` clamps it."""
        return branches[min(max(int(index), 0), len(branches) - 1)](*operands)

    def scan(self, f: Callable, init: Any, xs: Any = None, length: Optional[int] = None):
        """``(carry, ys)``: ``carry, y = f(carry, x)`` for each leading
        slice ``x`` of the pytree ``xs`` (``length`` times with ``x=None``
        when there is none), the ``y`` stacked on a new front axis."""
        leaves, spec = pytree.tree_flatten(xs) if xs is not None else ([], None)
        steps = length if not leaves else leaves[0].shape[0]
        carry, ys = init, []
        for t in range(steps):
            x = None if not leaves else pytree.tree_unflatten([l[t] for l in leaves], spec)
            carry, y = f(carry, x)
            ys.append(y)
        if not ys or ys[0] is None:
            return carry, None
        return carry, pytree.tree_map(lambda *a: torch.stack(a), *ys)

    def jaxy_scan(self, f: Callable, init: Any, xs: Any):
        if xs is None:
            raise ValueError("Either xs or length must be provided.")
        return self.scan(f, init, xs)

    def while_loop(self, cond_fn: Callable, body_fn: Callable, init: Any) -> Any:
        val = init
        while bool(cond_fn(val)):
            val = body_fn(val)
        return val

    def fori_loop(self, lower: int, upper: int, body_fn: Callable, init: Any) -> Any:
        val = init
        for i in range(int(lower), int(upper)):
            val = body_fn(i, val)
        return val

    def stop_gradient(self, a: torch.Tensor) -> torch.Tensor:
        return a.detach()

    # ---------------- AD / JIT / vmap ----------------

    def grad(self, f: Callable, argnums: Any = 0, has_aux: bool = False) -> Callable:
        """The gradient of the real scalar ``f`` in ``argnums``; a complex
        leaf's gradient in the JAX convention."""
        g = torch.func.grad(f, argnums=argnums, has_aux=has_aux)

        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            out = g(*args, **kws)
            return (_jax_grads(out[0]), out[1]) if has_aux else _jax_grads(out)

        return wrapper

    def value_and_grad(self, f: Callable, argnums: Any = 0, has_aux: bool = False) -> Callable:
        """``(value, grad)``, or ``((value, aux), grad)`` with ``has_aux``."""
        gv = torch.func.grad_and_value(f, argnums=argnums, has_aux=has_aux)

        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            grads, value = gv(*args, **kws)
            return value, _jax_grads(grads)

        return wrapper

    def jvp(self, f: Callable, inputs: Any, v: Any):
        one_input = not isinstance(inputs, (list, tuple))
        if one_input:
            inputs, v = (inputs,), (v,)
        return torch.func.jvp(f, tuple(inputs), tuple(v))

    def vjp(self, f: Callable, inputs: Any, v: Any):
        """``(f(*inputs), v^T J)`` as ``jax.vjp`` gives it (no conjugation:
        torch's is taken on the conjugate cotangent and conjugated back)."""
        one_input = not isinstance(inputs, (list, tuple))
        if one_input:
            inputs = (inputs,)
        out, vjp_fn = torch.func.vjp(f, *inputs)
        grads = _jax_grads(vjp_fn(_jax_grads(v)))
        return out, (grads[0] if one_input else grads)

    def jacfwd(self, f: Callable, argnums: Any = 0) -> Callable:
        return torch.func.jacfwd(f, argnums=argnums)

    def jacrev(self, f: Callable, argnums: Any = 0) -> Callable:
        jf = torch.func.jacrev(f, argnums=argnums)

        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            return _jax_grads(jf(*args, **kws))

        return wrapper

    def hessian(self, f: Callable, argnums: Any = 0) -> Callable:
        return torch.func.hessian(f, argnums=argnums)

    def jit(self, f: Callable, static_argnums: Any = None, jit_compile: Optional[bool] = None,
            **kws: Any) -> Callable:
        """``f`` as a :class:`Jitted`: a call whose tensors all lie on the card
        replays a CUDA graph captured for its signature; with
        ``jit_compile=False``, or on CPU tensors, ``f`` runs eagerly."""
        return Jitted(f, static_argnums, capture=jit_compile is not False)

    def vmap(self, f: Callable, vectorized_argnums: Union[int, Sequence[int]] = 0) -> Callable:
        """``f`` mapped over the leading axis of the positional arguments
        ``vectorized_argnums``, the others shared."""
        vargs = _argnums(vectorized_argnums)

        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            in_dims = tuple(0 if i in vargs else None for i in range(len(args)))
            return torch.func.vmap(functools.partial(f, **kws) if kws else f, in_dims=in_dims)(*args)

        return wrapper

    def vectorized_value_and_grad(
        self, f: Callable, argnums: Union[int, Sequence[int]] = 0,
        vectorized_argnums: Union[int, Sequence[int]] = 0, has_aux: bool = False,
    ) -> Callable:
        """``vmap`` of ``value_and_grad`` over ``vectorized_argnums``: the
        gradients of shared (not vectorized) arguments summed over the
        batch."""
        argnums_t, vargs = _argnums(argnums), _argnums(vectorized_argnums)
        vg = self.value_and_grad(f, argnums=argnums_t, has_aux=has_aux)

        @functools.wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            in_dims = tuple(0 if i in vargs else None for i in range(len(args)))
            values, grads = torch.func.vmap(functools.partial(vg, **kws) if kws else vg, in_dims=in_dims)(*args)
            grads = tuple(g if an in vargs else pytree.tree_map(lambda x: torch.sum(x, dim=0), g)
                          for an, g in zip(argnums_t, grads))
            return values, (grads[0] if isinstance(argnums, int) else grads)

        return wrapper

    vvag = vectorized_value_and_grad

    # ---------------- pytrees ----------------

    def tree_map(self, f: Callable, *pytrees: Any) -> Any:
        return pytree.tree_map(f, *pytrees)

    def tree_flatten(self, tree: Any):
        """``(leaves, treedef)``."""
        return pytree.tree_flatten(tree)

    def tree_unflatten(self, treedef: Any, leaves: Any) -> Any:
        return pytree.tree_unflatten(list(leaves), treedef)

    # ---------------- optimizers ----------------

    def optimizer(self, optimizer: Any, **kws: Any) -> "TorchOptimizer":
        """A stateful optimizer with ``update(grads, params)``
        (:class:`TorchOptimizer`)."""
        return TorchOptimizer(optimizer, **kws)

    optax_optimizer = optimizer

    # ---------------- special functions ----------------

    def special_jv(self, v: int, z: Any, M: int) -> torch.Tensor:
        """[J_0(z), ..., J_{v-1}(z)] by Miller's downward recurrence."""
        from .timeevol import _bessel_jn_miller

        return _bessel_jn_miller(v - 1, self._new(z))[:v]

    def sparse_csr_from_coo(self, coo: torch.Tensor, strict: bool = False) -> torch.Tensor:
        return coo.to_sparse_csr()


def _dt(dtype: Any) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype).replace("torch.", ""))


def _axes(axis: Any, a: torch.Tensor) -> Any:
    if axis is None:
        return tuple(range(a.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _argnums(argnums: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (argnums,) if isinstance(argnums, int) else tuple(argnums)


def _jax_grads(tree: Any) -> Any:
    """torch's gradients in the JAX convention: a complex leaf conjugated."""
    return pytree.tree_map(lambda x: torch.conj(x).resolve_conj()
                           if isinstance(x, torch.Tensor) and x.is_complex() else x, tree)


def _operator(K: "TorchBackend", a: Any) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(a) and not isinstance(a, torch.Tensor):
        return a
    return lambda v: K.matvec(a, v)


def _lobpcg(op: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, m: int, tol: Optional[float]):
    """Block LOBPCG for the largest eigenpairs of the symmetric ``op``:
    Rayleigh-Ritz on [X, R, P] each step, the basis orthonormalized by a
    QR with its rounding-level directions dropped; stops when every
    residual column is below ``tol`` (default: 10 · eps · |θ|max · n)."""
    k = x0.shape[1]
    x, _ = torch.linalg.qr(x0)
    ax = op(x)
    theta, c = torch.linalg.eigh(_H(x) @ ax)
    theta, c = theta.flip(-1), c.flip(-1)
    x, ax = x @ c, ax @ c
    p = ap = None
    eps = torch.finfo(theta.dtype).eps
    it = 0
    for it in range(1, m + 1):
        r = ax - x * theta.to(x.dtype)
        rn = torch.linalg.vector_norm(r, dim=0)
        limit = tol if tol is not None else 10 * eps * x.shape[0] * float(theta.abs().max())
        if float(rn.max()) <= limit:
            break
        basis = [x, r] if p is None else [x, r, p]
        s, rr = torch.linalg.qr(torch.cat(basis, dim=1))
        keep = torch.diagonal(rr).abs() > 1e3 * eps * torch.diagonal(rr).abs().max()
        s = s[:, keep]
        as_ = op(s)
        g = _H(s) @ as_
        w, cw = torch.linalg.eigh(0.5 * (g + _H(g)))
        cw = cw.flip(-1)[:, :k]
        xn, axn = s @ cw, as_ @ cw
        # the new search direction: the step's part outside the old block
        p = xn - x @ (_H(x) @ xn)
        ap = axn - ax @ (_H(x) @ xn)
        x, ax, theta = xn, axn, w.flip(-1)[:k]
    return theta, x, it


def _H(a: torch.Tensor) -> torch.Tensor:
    return a.mH if a.is_complex() else a.transpose(-1, -2)


class Jitted:
    """``backend.jit(f)``: on CUDA tensors a captured CUDA graph a signature.

    The signature of a call is its pytree structure, each tensor's shape,
    dtype, device and ``requires_grad``, and the value of every other
    argument (the ``static_argnums`` and any Python value, which a graph
    bakes in).  Where every tensor argument lies on the card, the first
    call of a signature runs ``f`` eagerly (which builds the kernels and
    warms the allocator), then captures ``f`` on static copies of the
    inputs with ``torch.cuda.graph`` into a memory pool of its own; every
    later call copies its inputs into the static buffers, replays the graph
    and returns clones of the outputs, so a result never aliases the next
    call's, as with JAX's jit.  On CPU tensors, or with ``capture=False``,
    ``f`` runs eagerly.  A function that cannot be captured (a host read
    such as ``.item()``, ``.tolist()`` or ``.cpu()``, a draw from a
    generator) raises with the capture's error, as JAX's jit raises on a
    concrete read of a tracer: nothing falls back to eager.  A replay has
    no autograd node, so a card call with a tensor that requires grad (under
    grad mode) raises: differentiate inside, ``jit(value_and_grad(f))``."""

    def __init__(self, f: Callable, static_argnums: Any = None, capture: bool = True) -> None:
        functools.update_wrapper(self, f)
        self.f = f
        self.static = set(_argnums(static_argnums)) if static_argnums is not None else set()
        self.capture = capture
        self.graphs: Dict[Any, Any] = {}
        #: the signatures captured (each captured once) and the replays
        self.captures = 0
        self.replays = 0

    def _signature(self, args: tuple, kws: dict):
        dyn = tuple(None if i in self.static else a for i, a in enumerate(args))
        leaves, spec = pytree.tree_flatten((dyn, kws))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = [spec, tuple(args[i] if _hashable(args[i]) else id(args[i]) for i in sorted(self.static)
                           if i < len(args))]
        for x in leaves:
            if isinstance(x, torch.Tensor):
                key.append((tuple(x.shape), x.dtype, x.device, x.requires_grad))
            else:
                key.append(x if _hashable(x) else id(x))
        return tuple(key), leaves, spec, tensors

    def __call__(self, *args: Any, **kws: Any) -> Any:
        if not self.capture:
            return self.f(*args, **kws)
        sig, leaves, spec, tensors = self._signature(args, kws)
        if not tensors or any(t.device.type != "cuda" for t in tensors):
            return self.f(*args, **kws)
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise ValueError("jit: a CUDA graph replay has no autograd node, and an argument requires grad: "
                             "differentiate inside the jitted function (jit(value_and_grad(f)))")
        entry = self.graphs.get(sig)
        if entry is None:
            out = self.f(*args, **kws)
            self.graphs[sig] = self._capture(args, leaves, spec)
            return out
        graph, static_in, static_out = entry
        for buf, t in zip(static_in, tensors):
            buf.copy_(t)
        graph.replay()
        self.replays += 1
        return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, static_out)

    def _capture(self, args: tuple, leaves: list, spec: Any):
        static_in = [x.detach().clone() for x in leaves if isinstance(x, torch.Tensor)]
        it = iter(static_in)
        dyn_args, kws = pytree.tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        call_args = tuple(args[i] if i in self.static else a for i, a in enumerate(dyn_args))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected CUDA graph
        # or event frees itself by a CUDA call the capture forbids, which
        # invalidates it (``torch.cuda.graph`` collects once on entry)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
                static_out = self.f(*call_args, **kws)
        except RuntimeError as err:
            raise RuntimeError(
                f"jit: {getattr(self.f, '__name__', self.f)!r} cannot be captured as a CUDA graph (a host "
                f"read such as .item(), .tolist() or .cpu(), or a draw from a generator, inside it?): {err}"
            ) from err
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return graph, static_in, static_out


def _hashable(x: Any) -> bool:
    try:
        hash(x)
    except TypeError:
        return False
    return True


class TorchOptimizer:
    """A ``torch.optim`` optimizer behind the JAX package's stateful
    ``update(grads, params)`` (``_OptaxOptimizer``): it returns the new
    parameters and keeps the state.  ``optimizer`` is an optimizer class,
    built on the parameters with ``kws`` (``torch.optim.Adam, lr=0.05``,
    optax's ``adam(0.05)``: the same b1, b2 and eps), or a factory of the
    parameter list.  The gradients are the backend's (the JAX convention
    for a complex leaf: conjugated back to torch's here)."""

    def __init__(self, optimizer: Any, **kws: Any) -> None:
        self.factory = (lambda ps: optimizer(ps, **kws)) if isinstance(optimizer, type) else optimizer
        self.optimizer: Any = None
        self.params: List[torch.Tensor] = []

    def update(self, grads: Any, params: Any) -> Any:
        leaves, spec = pytree.tree_flatten(params)
        gleaves = pytree.tree_leaves(grads)
        if self.optimizer is None:
            self.params = [p.detach().clone() for p in leaves]
            self.optimizer = self.factory(self.params)
        with torch.no_grad():
            for own, p, g in zip(self.params, leaves, gleaves):
                own.copy_(p)
                own.grad = (torch.conj(g) if g.is_complex() else g).detach().clone()
        self.optimizer.step()
        return pytree.tree_unflatten([p.detach().clone() for p in self.params], spec)


def _elementwise(name: str, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    def method(self: TorchBackend, a: torch.Tensor) -> torch.Tensor:
        return fn(a)

    method.__name__ = name
    setattr(TorchBackend, name, method)


for _name, _fn in {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "tanh": torch.tanh, "acos": torch.acos,
    "asin": torch.asin, "atan": torch.atan, "acosh": torch.acosh, "asinh": torch.asinh, "atanh": torch.atanh,
    "cosh": torch.cosh, "sinh": torch.sinh, "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
}.items():
    _elementwise(_name, _fn)


backend = TorchBackend()


def get_backend(name: str = "pytorch") -> TorchBackend:
    """The one backend of the port; ``name`` must name it."""
    config.normalize_backend(name)
    return backend
