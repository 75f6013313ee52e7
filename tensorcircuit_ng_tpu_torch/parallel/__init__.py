"""Distribution: device meshes, the sharded statevector, sliced contraction
and the process-group helpers.

Counterpart of ``tensorcircuit_ng_tpu/parallel/``: one exact state split
over a mesh (:class:`ShardedStatevec`, behind ``Circuit(mesh=...)``), slice
parallelism (:class:`DistributedContractor`) and term sharding
(:func:`term_sharded_expectation`), each over an in-process :class:`Mesh`
(shards on devices of this process, a card may hold several) or a
:class:`ProcessGroupMesh` (one shard a rank of ``torch.distributed``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from .distributed import DistributedContractor
from .mesh import Mesh, ProcessGroupMesh, default_mesh, pauli_term_expectation, term_sharded_expectation
from .sharded_state import ShardedState, ShardedStatevec


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = 300.0,
    **kws: Any,
) -> str:
    """``torch.distributed.init_process_group`` for a multi-process run,
    the counterpart of ``jax.distributed.initialize``.

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  The backend is NCCL where the ranks hold
    cards (each rank takes card ``LOCAL_RANK``, default its rank modulo the
    card count) and gloo on the CPU; ``timeout`` (seconds) bounds every
    collective.  Returns the backend's name."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        **kws,
    )
    return backend


__all__ = [
    "DistributedContractor",
    "Mesh",
    "ProcessGroupMesh",
    "ShardedState",
    "ShardedStatevec",
    "default_mesh",
    "initialize_distributed",
    "pauli_term_expectation",
    "term_sharded_expectation",
]
