"""ZX graph: spiders + (Hadamard-)edges, tensor lowering, spider fusion.

Counterpart of ``tensorcircuit_ng_tpu/zx/graph.py``: the graph lowers to
the port's einsum IR (:mod:`tensorcircuit_ng_tpu_torch.core.einsum_ir`),
its tensors in the configured dtype on the device, so evaluation rides the
same planned contraction engine as circuits (``core.contractor``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config

Tensor = Any

__all__ = ["Spider", "ZXGraph"]


class Spider:
    """Z or X spider with a phase (radians)."""

    __slots__ = ("kind", "phase", "id")

    def __init__(self, kind: str, phase: float = 0.0, id_: int = -1):
        assert kind in ("Z", "X", "B")  # B: boundary
        self.kind = kind
        self.phase = phase
        self.id = id_

    def __repr__(self) -> str:
        return f"Spider({self.kind}, {self.phase:.3f}, id={self.id})"


class ZXGraph:
    """Open ZX diagram with ordered input/output boundary spiders."""

    def __init__(self) -> None:
        self.spiders: Dict[int, Spider] = {}
        self.edges: List[Tuple[int, int, bool]] = []  # (a, b, hadamard?)
        self.inputs: List[int] = []
        self.outputs: List[int] = []
        self._next = 0
        self.scalar_power2: int = 0  # global scalar (sqrt(2))^p bookkeeping

    def add_spider(self, kind: str, phase: float = 0.0) -> int:
        s = Spider(kind, phase, self._next)
        self.spiders[self._next] = s
        self._next += 1
        return s.id

    def add_edge(self, a: int, b: int, hadamard: bool = False) -> None:
        self.edges.append((a, b, hadamard))

    def degree(self, sid: int) -> int:
        return sum(1 for a, b, _ in self.edges if a == sid or b == sid)

    def num_spiders(self) -> int:
        return len(self.spiders)

    # ------------------------------------------------------------------
    # simplification: spider fusion (same-color spiders joined by a plain
    # edge fuse, phases add) — the core rewrite of the ZX calculus
    # ------------------------------------------------------------------

    def fuse_spiders(self) -> int:
        """Apply same-color fusion to a fixpoint; returns number of fusions."""
        count = 0
        changed = True
        while changed:
            changed = False
            for a, b, had in list(self.edges):
                if had or a == b:
                    continue
                sa, sb = self.spiders.get(a), self.spiders.get(b)
                if sa is None or sb is None:
                    continue
                if sa.kind == sb.kind and sa.kind in ("Z", "X"):
                    # merge b into a
                    sa.phase = (sa.phase + sb.phase) % (2 * math.pi)
                    new_edges = []
                    for x, y, h in self.edges:
                        if (x, y) == (a, b) or (x, y) == (b, a):
                            if h:
                                new_edges.append((a, a, True))
                            continue  # drop the fusing edge
                        x2 = a if x == b else x
                        y2 = a if y == b else y
                        new_edges.append((x2, y2, h))
                    self.edges = new_edges
                    del self.spiders[b]
                    self.inputs = [a if i == b else i for i in self.inputs]
                    self.outputs = [a if i == b else i for i in self.outputs]
                    count += 1
                    changed = True
                    break
        return count

    # ------------------------------------------------------------------
    # tensor lowering
    # ------------------------------------------------------------------

    def to_einsum_ir(self, device: Any = None) -> Any:
        """Lower the diagram to an EinsumIR (open legs = inputs then
        outputs), its tensors in the configured dtype on ``device`` (the
        configured one by default)."""
        from ..core.einsum_ir import EinsumIR

        dt = np.dtype(config.dtypestr())
        dev = config.resolve_device(device)
        tdt = config.torch_dtype()
        next_idx = 0
        size: Dict[int, int] = {}

        def new_index() -> int:
            nonlocal next_idx
            i = next_idx
            next_idx += 1
            size[i] = 2
            return i

        # per-spider leg lists
        legs: Dict[int, List[int]] = {sid: [] for sid in self.spiders}
        inputs_ir: List[Tuple[int, ...]] = []
        tensors: List[Tensor] = []

        h_mat = (np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2.0)).astype(dt)
        eye2 = np.eye(2, dtype=dt)
        for a, b, had in self.edges:
            both_boundary = (
                self.spiders[a].kind == "B" and self.spiders[b].kind == "B"
            )
            if had or both_boundary:
                # explicit 2x2 tensor on the edge (H, or identity for a bare
                # boundary-boundary wire which must not alias open legs)
                ia = new_index()
                ib = new_index()
                legs[a].append(ia)
                legs[b].append(ib)
                inputs_ir.append((ia, ib))
                tensors.append(h_mat if had else eye2)
            else:
                i = new_index()
                legs[a].append(i)
                legs[b].append(i)

        open_legs: List[int] = []
        for sid, s in self.spiders.items():
            k = len(legs[sid])
            if s.kind == "B":
                # boundary spider: identity wire — expose its single leg
                assert k == 1, "boundary spiders must have degree 1"
                open_legs.append(legs[sid][0])
                continue
            t = _spider_tensor(s.kind, s.phase, k, dt)
            inputs_ir.append(tuple(legs[sid]))
            tensors.append(t)

        ordered_open = []
        for sid in self.inputs + self.outputs:
            ordered_open.append(legs[sid][0])
        return EinsumIR(inputs_ir, tuple(ordered_open), size,
                        [config.device_constant(t, dev, tdt) for t in tensors])

    def to_tensor(self, device: Any = None) -> torch.Tensor:
        """Dense tensor of the diagram (inputs legs first, then outputs),
        contracted by the port's contractor on ``device``."""
        from ..core import contractor as _ctr

        t = _ctr.contract_ir(self.to_einsum_ir(device))
        return t * (math.sqrt(2.0)) ** self.scalar_power2

    def to_matrix(self, device: Any = None) -> torch.Tensor:
        t = self.to_tensor(device)
        nin = len(self.inputs)
        nout = len(self.outputs)
        return torch.reshape(t, (2**nin if nin else 1, 2**nout if nout else 1)).T

    def scalar(self, device: Any = None) -> torch.Tensor:
        """Evaluate a closed diagram to its complex scalar."""
        assert not self.inputs and not self.outputs
        return torch.reshape(self.to_tensor(device), ())


def _spider_tensor(kind: str, phase: float, k: int, dt: Any) -> Tensor:
    """Z spider: δ-tensor with e^{iφ} on the all-1 entry; X = H-conjugated Z.

    A numpy array, copied to the device with the IR.
    """
    if k == 0:
        return np.asarray(1.0 + np.exp(1j * phase)).astype(dt)
    t = np.zeros((2,) * k, dtype=complex)
    t[(0,) * k] = 1.0
    t[(1,) * k] = np.exp(1j * phase)
    if kind == "X":
        h = np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2.0)
        for ax in range(k):
            t = np.tensordot(h, t, axes=[[1], [ax]])
            t = np.moveaxis(t, 0, ax)
    return t.astype(dt)
