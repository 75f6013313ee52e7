"""``DistributedContractor``: a sliced tensor contraction over a mesh.

Counterpart of ``tensorcircuit_ng_tpu/parallel/distributed.py``.  The slice
set is found on the first process (``contractor.choose_slices``) and
broadcast (``experimental.broadcast_py_object``); the slice ids are padded
to ``ndev × ceil(nslices / ndev)`` with a weight mask that zeroes the
padding; each shard (a device of an in-process :class:`~parallel.mesh.Mesh`,
or a rank of a :class:`~parallel.mesh.ProcessGroupMesh`) contracts its row
of ids (``contractor.sliced_contract_ir``), and the parts meet in one
``psum``.  ``value_and_grad`` applies ``op`` to the total, so the gradient
flows through the sum of the parts.  ``find_path``/``from_path`` keep the
slice data as the JAX package pickles it, so a path file written by either
package serves the other.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import contractor as _ctr
from ..core.einsum_ir import EinsumIR
from .mesh import AnyMesh, default_mesh

Tensor = Any

__all__ = ["DistributedContractor"]


def _on_device(ir: EinsumIR, device: torch.device) -> EinsumIR:
    """``ir`` with its operands on ``device`` (the same IR when they are)."""
    if all(not isinstance(t, torch.Tensor) or t.device == device for t in ir.tensors):
        return ir
    tensors = [t.to(device) if isinstance(t, torch.Tensor) else t for t in ir.tensors]
    return EinsumIR(ir.inputs, ir.output, ir.size_dict, tensors)


class DistributedContractor:
    """Distribute a sliced einsum contraction over a mesh.

    ``ir_fn(params) -> EinsumIR`` builds the network (``params`` any pytree
    of tensors).  ``options``: ``target_size`` (the largest intermediate of
    a slice, default 2**28 entries) and ``optimizer`` (the path optimizer,
    default ``"greedy"``).  Without ``mesh``, :func:`default_mesh` over
    ``devices``."""

    def __init__(
        self,
        ir_fn: Callable[..., EinsumIR],
        params: Any,
        options: Optional[Dict[str, Any]] = None,
        devices: Optional[Sequence[Any]] = None,
        mesh: Optional[AnyMesh] = None,
        tree_data: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._ir_fn = ir_fn
        options = options or {}
        self._optimizer = options.get("optimizer", "greedy")
        target_size = options.get("target_size", 2**28)
        self._mesh = mesh if mesh is not None else default_mesh("devices", devices)
        self._ndev = self._mesh.size
        if tree_data is None:
            tree_data = self._search(params, target_size)
        self._tree_data = tree_data
        self._sliced: List[int] = [int(i) for i in tree_data["sliced_indices"]]
        self._nslices = int(tree_data["num_slices"])
        per_dev = -(-self._nslices // self._ndev)
        total = per_dev * self._ndev
        self._slice_ids = (np.arange(total) % self._nslices).reshape(self._ndev, per_dev)
        self._slice_mask = (np.arange(total) < self._nslices).astype(np.float32).reshape(self._ndev, per_dev)

    def _search(self, params: Any, target_size: int) -> Dict[str, Any]:
        """The slice search on the first process, broadcast to the rest."""
        from ..experimental import broadcast_py_object

        data = None
        if self._mesh.is_root:
            ir = self._ir_fn(params)
            sliced = _ctr.choose_slices(ir, target_size=target_size, optimizer=self._optimizer)
            num = int(np.prod([ir.size_dict[i] for i in sliced])) if sliced else 1
            data = {
                "sliced_indices": sliced,
                "num_slices": num,
                "inputs": ir.inputs,
                "output": ir.output,
                "size_dict": ir.size_dict,
            }
        return broadcast_py_object(data)

    def _total(self, params: Any) -> Tensor:
        ir = self._ir_fn(params)
        parts = []
        for d, dev in zip(self._mesh.shard_ids, self._mesh.shard_devices):
            parts.append(_ctr.sliced_contract_ir(
                _on_device(ir, dev), self._sliced, self._slice_ids[d], optimizer=self._optimizer,
                slice_weights=self._slice_mask[d]))
        return self._mesh.psum(parts)

    def value(self, params: Any, op: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
        """The contraction (``op`` of it) with ``params``, on the mesh's
        first device, the same on every rank."""
        v = self._total(params)
        return op(v) if op is not None else v

    def value_and_grad(self, params: Any, op: Optional[Callable[[Tensor], Tensor]] = None
                       ) -> Tuple[Tensor, Any]:
        """(Re(op(total)) or Re(Σ total), its gradient in ``params``'s
        structure): ``op`` is applied to the sum of the shards' parts, and
        the gradient flows through that sum."""
        leaves, spec = pytree.tree_flatten(params)
        xs = [torch.as_tensor(leaf).detach().requires_grad_(True) for leaf in leaves]
        total = self._total(pytree.tree_unflatten([self._mesh.replicate(x) for x in xs], spec))
        loss = torch.real(op(total)) if op is not None else torch.real(torch.sum(total))
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    def grad(self, params: Any, op: Optional[Callable[[Tensor], Tensor]] = None) -> Any:
        return self.value_and_grad(params, op)[1]

    # -- the path file -----------------------------------------------------

    def find_path(self, filepath: str) -> None:
        """Pickle the slice data, so that a later run skips the search."""
        with open(filepath, "wb") as f:
            pickle.dump(self._tree_data, f)

    @classmethod
    def from_path(cls, filepath: str, ir_fn: Callable[..., EinsumIR], params: Any = None,
                  **kws: Any) -> "DistributedContractor":
        """A contractor from a path file of :meth:`find_path` (this
        package's or the JAX package's)."""
        with open(filepath, "rb") as f:
            tree_data = pickle.load(f)
        return cls(ir_fn, params, tree_data=tree_data, **kws)

    def report(self) -> Dict[str, Any]:
        """The slices and their split over the shards."""
        return {
            "num_slices": self._nslices,
            "sliced_indices": self._sliced,
            "devices": self._ndev,
            "slices_per_device": int(self._slice_ids.shape[1]),
        }
