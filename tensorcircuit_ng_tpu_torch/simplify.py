"""Network and QIR simplification passes.

Counterpart of ``tensorcircuit_ng_tpu/simplify.py``: single-qubit chains
fused into the next multi-qubit gate before the einsum IR is built, the SVD
split of a two-qubit gate, the light-cone pass, and the shape-level helpers.

Gate tensors come as numpy (fixed gates, Python-float angles) or torch
(tensor angles, the fused layers).  A product of numpy gates stays numpy,
as in the JAX package; one with a tensor in it is a tensor on that tensor's
device, with its autograd.  An accumulated single-qubit product that equals
the identity within 1e-12 (``np.allclose``'s rule) is dropped when it is
numpy or a tensor that needs no grad.  The JAX package drops numpy ones
only, so the two give the same operand list where every gate is numpy or
needs a grad, and differ where an identity product holds a tensor that
needs none (an angle 0 passed as a tensor): the port drops it there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import linalg as _linalg

__all__ = [
    "fuse_single_qubit_qir",
    "split_two_qubit_gate",
    "gate_schmidt_rank",
    "light_cone_qir",
    "light_cone_cancel",
    "infer_new_shape",
    "pseudo_contract_between",
]


def _as_tensors(*ts: Any) -> List[Any]:
    """All numpy when every one is numpy; else every one a tensor on the
    device of the first tensor among them, in the complex dtype that all
    of them promote to."""
    like = next((t for t in ts if isinstance(t, torch.Tensor)), None)
    if like is None:
        return [np.asarray(t) for t in ts]
    ts = [t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t)).to(like.device) for t in ts]
    dtype = torch.complex64
    for t in ts:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def _tensordot(a: Any, b: Any, axes: Any) -> Any:
    a, b = _as_tensors(a, b)
    if isinstance(a, torch.Tensor):
        return torch.tensordot(a, b, dims=axes)
    return np.tensordot(a, b, axes=axes)


def _moveaxis(t: Any, src: int, dst: int) -> Any:
    return torch.movedim(t, src, dst) if isinstance(t, torch.Tensor) else np.moveaxis(t, src, dst)


def _is_identity(g: Any, d: int) -> bool:
    if isinstance(g, torch.Tensor):
        return not g.requires_grad and bool(torch.allclose(g, torch.eye(d, dtype=g.dtype, device=g.device), atol=1e-12))
    return bool(np.allclose(g, np.eye(d), atol=1e-12))


def fuse_single_qubit_qir(
    qir: Sequence[Dict[str, Any]], d: int = 2, drop_identity: bool = True
) -> List[Dict[str, Any]]:
    """Merge single-qubit gate chains and absorb them into the next
    multi-qubit gate on the wire (or, at the end of a wire, into the output
    leg of the last one).

    Plain unitary items only: channels, mpo and split items are barriers.
    A deep circuit then lowers to about one tensor an entangling gate.  An
    accumulated product equal to the identity is dropped with
    ``drop_identity`` (see the module's docstring for which)."""
    from .ops.gates import Gate

    pending: Dict[int, Any] = {}  # wire -> accumulated (d, d) matrix
    out: List[Dict[str, Any]] = []
    # wire -> (position in ``out``, output-leg slot) of the last multi-qubit
    # gate whose output on that wire is still on the frontier
    last_gate: Dict[int, Tuple[int, int]] = {}

    def flush(wire: int) -> None:
        g = pending.pop(wire, None)
        if g is None or (drop_identity and _is_identity(g, d)):
            return
        if wire in last_gate:
            # absorb into the previous multi-qubit gate's output leg
            pos, slot = last_gate[wire]
            item = dict(out[pos])
            t = item["gate"].tensor
            k = len(item["index"])
            tt = t.reshape((d,) * (2 * k)) if t.ndim != 2 * k else t
            tt = _moveaxis(_tensordot(g, tt, [[1], [slot]]), 0, slot)
            item["gate"] = Gate(tt, name=(item.get("name") or "gate") + "*")
            item["diagonal"] = False
            item["gatef"] = None
            item.pop("parameters", None)
            out[pos] = item
            return
        out.append({"gatef": None, "gate": Gate(g, name="merged1q"), "index": (wire,), "name": "merged1q",
                    "split": None, "mpo": False, "diagonal": False})

    for item in qir:
        idx = tuple(int(w) for w in item.get("index", ()))
        barrier = (item.get("is_channel") or item.get("mpo") or item.get("split")
                   or "gate" not in item or item.get("gate") is None)
        if barrier:
            for w in idx:
                flush(w)
                last_gate.pop(w, None)
            out.append(item)
            continue
        t = item["gate"].tensor
        k = len(idx)
        if k == 1:
            g = t.reshape(d, d)
            prev = pending.get(idx[0])
            if prev is None:
                pending[idx[0]] = g
            else:
                g, prev = _as_tensors(g, prev)
                pending[idx[0]] = g @ prev
            continue
        # absorb pending single-qubit gates into this gate's input legs
        absorbed = [pending.pop(w, None) for w in idx]
        if any(a is not None for a in absorbed):
            tt = t.reshape((d,) * (2 * k)) if t.ndim != 2 * k else t
            for j, a in enumerate(absorbed):
                if a is not None:
                    tt = _moveaxis(_tensordot(tt, a, [[k + j], [0]]), -1, k + j)
            item = dict(item)
            item["gate"] = Gate(tt, name=(item.get("name") or "gate") + "*")
            item["diagonal"] = False
            item["gatef"] = None
            item.pop("parameters", None)
        pos = len(out)
        out.append(item)
        for j, w in enumerate(idx):
            last_gate[w] = (pos, j)
    for w in sorted(pending):
        flush(w)
    return out


def split_two_qubit_gate(
    gate: Any,
    max_singular_values: Optional[int] = None,
    max_truncation_err: float = 0.0,
    relative: bool = False,
    d: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD split of a two-site gate across the bond, G = Σ_k A_k ⊗ B_k.

    Returns ``(a, s, b)`` with ``a: (d, d, k)``, ``s: (k,)``, ``b: (k, d, d)``
    and G[(o1 o2), (i1 i2)] = Σ_k a[o1, i1, k] s[k] b[k, o2, i2]."""
    g = gate if isinstance(gate, torch.Tensor) else torch.as_tensor(np.asarray(gate))
    g = torch.reshape(g, (d, d, d, d)).permute(0, 2, 1, 3)  # (o1, i1, o2, i2)
    m = torch.reshape(g, (d * d, d * d))
    k = max_singular_values or d * d
    u, s, vh, _ = _linalg.truncated_svd(m, max_singular_values=k, max_truncation_err=max_truncation_err,
                                        relative=relative)
    kdim = u.shape[1]
    return torch.reshape(u, (d, d, kdim)), s, torch.reshape(vh, (kdim, d, d))


def gate_schmidt_rank(gate: Any, tol: float = 1e-6, d: int = 2) -> int:
    """Operator-Schmidt rank of a two-site gate (1 a product, 2 CNOT-like)."""
    _, s, _ = split_two_qubit_gate(gate, d=d)
    return int(torch.sum(s > tol).item())


def light_cone_qir(qir: Sequence[Dict[str, Any]], obs_wires: Sequence[int]) -> List[Dict[str, Any]]:
    """The items in the observables' backward causal cone, in order (the
    U†U pairs outside it cancel in ⟨ψ|O|ψ⟩)."""
    cone = set(int(w) for w in obs_wires)
    keep: List[Dict[str, Any]] = []
    for item in reversed(list(qir)):
        if cone.intersection(item["index"]):
            keep.append(item)
            cone.update(item["index"])
    keep.reverse()
    return keep


light_cone_cancel = light_cone_qir


def infer_new_shape(shape_a: Sequence[int], shape_b: Sequence[int], shared: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """Output shape of contracting two tensors over the ``(axis_in_a,
    axis_in_b)`` pairs ``shared``."""
    a_axes = {a for a, _ in shared}
    b_axes = {b for _, b in shared}
    return tuple([x for i, x in enumerate(shape_a) if i not in a_axes]
                 + [x for i, x in enumerate(shape_b) if i not in b_axes])


def pseudo_contract_between(
    inputs_a: Sequence[int], inputs_b: Sequence[int], size_dict: Dict[int, int]
) -> Tuple[Tuple[int, ...], int]:
    """A dry run of contracting two IR operands: (output indices, size)."""
    shared = set(inputs_a) & set(inputs_b)
    out = tuple(i for i in inputs_a if i not in shared) + tuple(i for i in inputs_b if i not in shared)
    size = 1
    for i in out:
        size *= size_dict[i]
    return out, size
