"""Device meshes of the port's parallel engines, their collectives, and the
term-sharded Hamiltonian expectation.

Counterpart of ``tensorcircuit_ng_tpu/parallel/mesh.py`` and of the JAX
package's use of ``jax.sharding.Mesh``.  A mesh is a 1-D axis of shards with
three collectives, each differentiable:

- ``ppermute(xs, pairs)``: shard ``dst`` receives shard ``src``'s tensor for
  each ``(src, dst)``; the engines' pairs are ``(d, d ^ mask)``, an
  involution, so the adjoint of an exchange is the same exchange;
- ``psum(xs)``: the sum of the shards' values, the same on every shard; its
  adjoint hands each shard the upstream gradient;
- ``all_gather(xs)``: the shards' values stacked on a new leading axis.

:class:`Mesh` holds every shard in this process, shard ``d`` on
``devices[d]``; a device may repeat, so one card can hold 2, 4 or 8 shards
(as the JAX tests hold 8 shards on one CPU) and a mesh over ``cuda:0..3``
holds one a card.  :class:`ProcessGroupMesh` holds one shard a rank of the
``torch.distributed`` world (NCCL where the ranks hold cards, gloo on the
CPU), the counterpart of a global mesh under ``jax.distributed``.  The
engines write each step once, as a loop over ``mesh.shard_ids`` with the
collectives between: ``xs`` lists the tensors of this process's shards.

A value that every shard reads whole (an angle, a gate, the state of a
term-sharded energy) enters a shard's work through ``mesh.replicate``: on a
process group its gradient is summed over the ranks (each rank computes the
part of it that its own shard's work gives), in this process autograd joins
the shards' graphs by itself.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..core import statevec

Tensor = Any

__all__ = [
    "Mesh",
    "ProcessGroupMesh",
    "default_mesh",
    "term_sharded_expectation",
    "pauli_term_expectation",
]


def _normal_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` checked by :func:`config.resolve_device` (a CUDA device
    needs a card), a bare ``"cuda"`` given the current card's index."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D mesh of shards held by this process: shard ``d`` lives on
    ``devices[d]`` (devices may repeat).  ``mesh.shape[axis]`` is the shard
    count, as on a ``jax.sharding.Mesh``.  Readouts land on the first
    shard's device, :attr:`device`."""

    def __init__(self, devices: Any, axis_names: Union[str, Sequence[str]] = ("devices",)) -> None:
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        devs = np.array(list(devices) if not isinstance(devices, np.ndarray) else devices, dtype=object)
        if len(names) != 1 or devs.ndim != 1 or devs.size == 0:
            raise ValueError(f"a mesh is one non-empty axis of devices: got shape {devs.shape} for axes {names}")
        self.devices = np.array([_normal_device(d) for d in devs], dtype=object)
        self.axis_names = names
        self.size = int(self.devices.size)
        self.shape = {names[0]: self.size}
        self.shard_ids: List[int] = list(range(self.size))
        self.shard_devices: List[torch.device] = list(self.devices)
        self.device: torch.device = self.shard_devices[0]
        #: the process that runs host-side searches (every process here)
        self.is_root = True

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"

    def ppermute(self, xs: Sequence[Tensor], pairs: Sequence[Tuple[int, int]]) -> List[Tensor]:
        out: List[Optional[Tensor]] = [None] * self.size
        for src, dst in pairs:
            out[dst] = xs[src].to(self.devices[dst])
        return [torch.zeros_like(xs[d]) if o is None else o for d, o in enumerate(out)]

    def psum(self, xs: Sequence[Tensor]) -> Tensor:
        return functools.reduce(torch.add, [x.to(self.device) for x in xs])

    def all_gather(self, xs: Sequence[Tensor]) -> Tensor:
        return torch.stack([x.to(self.device) for x in xs])

    def broadcast(self, x: Tensor, root: int = 0) -> Tensor:
        return x

    def replicate(self, x: Any) -> Any:
        return x


# ----------------------------------------------------------------------
# one shard a rank: torch.distributed
# ----------------------------------------------------------------------


def _wire(x: Tensor) -> Tensor:
    """A contiguous real view of ``x`` for the wire (gloo and NCCL move
    complex tensors as their float pairs)."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _sendrecv(x: Tensor, dst: Optional[int], src: Optional[int]) -> Tensor:
    """Send ``x`` to rank ``dst`` and receive the same shape from ``src``."""
    rank = dist.get_rank()
    if dst == rank and src == rank:
        return x.clone()
    x = x.contiguous()
    buf = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, _wire(x), dst))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, _wire(buf), src))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, src):
        ctx.dst, ctx.src = dst, src
        return _sendrecv(x, dst, src)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, ctx.src, ctx.dst), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone().contiguous()
        dist.all_reduce(_wire(y))
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        bufs = [torch.zeros_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather([_wire(b) for b in bufs], _wire(x))
        return torch.stack(bufs)

    @staticmethod
    def backward(ctx, g):
        return g[dist.get_rank()]


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone().contiguous()
        dist.all_reduce(_wire(g))
        return g


class ProcessGroupMesh:
    """One shard a rank of the initialized ``torch.distributed`` world
    (:func:`parallel.initialize_distributed`): rank r holds shard r on its
    device, ``cuda:<current card>`` under NCCL, the CPU under gloo."""

    def __init__(self, axis_name: str = "devices", device: Union[None, str, torch.device] = None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialized process group: call "
                               "parallel.initialize_distributed first")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if device is None:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device = _normal_device(device)
        self.axis_names = (axis_name,)
        self.shape = {axis_name: self.size}
        self.shard_ids = [self.rank]
        self.shard_devices = [self.device]
        self.is_root = self.rank == 0

    def __repr__(self) -> str:
        return f"ProcessGroupMesh(rank {self.rank} of {self.size} on {self.device}, {self.axis_names})"

    def ppermute(self, xs: Sequence[Tensor], pairs: Sequence[Tuple[int, int]]) -> List[Tensor]:
        dst = next((b for a, b in pairs if a == self.rank), None)
        src = next((a for a, b in pairs if b == self.rank), None)
        out = _Exchange.apply(xs[0], dst, src)
        return [out]

    def psum(self, xs: Sequence[Tensor]) -> Tensor:
        return _AllReduce.apply(xs[0])

    def all_gather(self, xs: Sequence[Tensor]) -> Tensor:
        return _AllGather.apply(xs[0])

    def broadcast(self, x: Tensor, root: int = 0) -> Tensor:
        y = x.detach().clone().contiguous()
        dist.broadcast(_wire(y), src=root)
        return y

    def replicate(self, x: Any) -> Any:
        if isinstance(x, torch.Tensor) and x.requires_grad:
            return _Replicate.apply(x)
        return x


AnyMesh = Union[Mesh, ProcessGroupMesh]


def default_mesh(axis_name: str = "devices", devices: Optional[Sequence[Any]] = None) -> AnyMesh:
    """The mesh over ``devices``; without them, one shard a rank of an
    initialized process group, else every visible CUDA card.  The CPU is
    taken only when the caller names it; without a card and without
    devices this raises."""
    if devices is not None:
        return Mesh(list(devices), (axis_name,))
    if dist.is_initialized():
        return ProcessGroupMesh(axis_name)
    if not torch.cuda.is_available():
        raise RuntimeError("default_mesh: no CUDA device is available; pass devices=['cpu'] * k "
                           "to build a mesh on the CPU")
    return Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())], (axis_name,))


def _pauli_lists(code: Sequence[int]) -> Tuple[List[int], List[int], List[int]]:
    """(x, y, z) wire lists of a Pauli code string (0..3 for I, X, Y, Z)."""
    code = [int(c) for c in code]
    return tuple([q for q, c in enumerate(code) if c == p] for p in (1, 2, 3))  # type: ignore[return-value]


def pauli_term_expectation(psi: Tensor, code: Any) -> Tensor:
    """⟨psi|P(code)|psi⟩ for per-qubit Pauli codes [n] (0..3), by slot flips
    and sign masks (``statevec.expectation_ps``)."""
    if isinstance(code, torch.Tensor):
        code = code.tolist()
    x, y, z = _pauli_lists(np.reshape(np.asarray(code), (-1,)))
    return torch.real(statevec.expectation_ps(psi, x, y, z))


def term_sharded_expectation(
    state_fn: Callable[..., Tensor],
    structures: Any,
    weights: Any,
    mesh: Optional[AnyMesh] = None,
    axis_name: str = "devices",
) -> Callable[..., Tensor]:
    """Build ``energy(*params) = Σ_i w_i ⟨psi(params)|P_i|psi(params)⟩``
    with the terms split over the mesh's axis.

    The terms are padded with identity strings of weight 0 to a multiple of
    the axis and split into one block a shard; each shard evaluates its
    block on its replica of the state (``state_fn``'s output moved to the
    shard's device) and the blocks are summed by one ``psum`` (over a
    process group, each rank evaluates its block and the ranks
    ``all_reduce``)."""
    if mesh is None:
        mesh = default_mesh(axis_name)
    ndev = mesh.shape[axis_name]
    if isinstance(structures, torch.Tensor):
        structures = structures.detach().cpu().numpy()
    codes = np.asarray(structures, dtype=np.int64)
    w = weights if isinstance(weights, torch.Tensor) else torch.as_tensor(np.asarray(weights))
    w = torch.reshape(w, (-1,))
    nterms = codes.shape[0]
    per = -(-nterms // ndev)
    pad = per * ndev - nterms
    codes = np.concatenate([codes, np.zeros((pad, codes.shape[1]), np.int64)])
    w = torch.cat([w, torch.zeros((pad,), dtype=w.dtype, device=w.device)])
    blocks = [[_pauli_lists(codes[d * per + j]) for j in range(per)] for d in range(ndev)]

    def energy(*params: Any) -> Tensor:
        psi = mesh.replicate(state_fn(*params))
        wr = mesh.replicate(w)
        parts = []
        for d, dev in zip(mesh.shard_ids, mesh.shard_devices):
            rep = psi.to(dev)
            evs = torch.stack([torch.real(statevec.expectation_ps(rep, x, y, z)) for x, y, z in blocks[d]])
            parts.append(torch.sum(evs * wr[d * per:(d + 1) * per].to(device=dev, dtype=evs.dtype)))
        return mesh.psum(parts)

    return energy
