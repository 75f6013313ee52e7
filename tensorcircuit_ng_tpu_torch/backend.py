"""``TorchBackend``: the subset of the backend that the circuit models call.

Counterpart of ``tensorcircuit_ng_tpu/backend.py``'s randomness and its
inverse-CDF sampler.  Every draw comes from a ``torch.Generator`` on the
device it is drawn on:

- ``implicit_rand*`` draw from the backend's own generator, one per device,
  seeded from ``set_random_state(seed)``; on a first use without a seed, the
  seed comes from ``np.random.randint(0, 2**31 - 1)``, so ``np.random.seed``
  followed by ``set_random_state()`` repeats a run, as in the JAX package;
- ``stateful_rand*`` draw from a generator the caller passes, on that
  generator's device.

The sparse surface: ``coo_sparse_matrix`` (a coalesced
``torch.sparse_coo_tensor`` on the values' device), its scipy import,
``sparse_dense_matmul``, ``is_sparse`` and ``to_dense``.

torch's generators give other bits than JAX's threefry keys: a run matches
the JAX package only through an explicit ``status`` of uniforms.  ``jit``,
``vmap``, ``grad`` and the optimizers are not part of this subset.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import config
from .core.statevec import cumsum_fixed_order

__all__ = ["TorchBackend", "backend", "get_backend", "check_generator", "device_tensor"]

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


backend = TorchBackend()


def get_backend(name: str = "pytorch") -> TorchBackend:
    """The one backend of the port; ``name`` must name it."""
    config.normalize_backend(name)
    return backend
