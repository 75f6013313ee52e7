"""Einsum IR: explicit, hashable contraction networks.

Counterpart of ``tensorcircuit_ng_tpu/core/einsum_ir.py``.  A circuit's QIR
lowers to ``(inputs, output, size_dict)`` and the operand tensors; the
contractor plans a path for the structure (cached by ``signature()``) and
contracts the operands pairwise.

Every operand is a torch tensor on one device, in one complex dtype, made
when the IR is built: the numpy operands (fixed gates, Python-float angles,
boundary vectors) of one IR go to the device in one copy, and a tensor
operand keeps its autograd.  So no contraction step moves host data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config

__all__ = [
    "EinsumIR",
    "circuit_state_ir",
    "amplitude_ir",
    "expectation_ir",
    "superop_expectation_ir",
    "superop_boundary_ir",
]

Device = Union[None, str, torch.device]


@dataclasses.dataclass
class EinsumIR:
    """(inputs, output, size_dict) topology and the operand tensors.

    Index ids are ints; ``signature()`` is hashable and independent of the
    tensors' values, so the path caches key on structure only."""

    inputs: List[Tuple[int, ...]]
    output: Tuple[int, ...]
    size_dict: Dict[int, int]
    tensors: List[Any]

    def signature(self) -> Tuple:
        return (tuple(self.inputs), tuple(self.output), tuple(sorted(self.size_dict.items())))

    def shapes(self) -> List[Tuple[int, ...]]:
        return [tuple(self.size_dict[i] for i in inp) for inp in self.inputs]

    def to_subscripts(self) -> str:
        """opt_einsum-style subscripts on its unicode symbols (ids in
        increasing order)."""
        import opt_einsum as oe

        ids = sorted({i for inp in self.inputs for i in inp} | set(self.output))
        sym = {i: oe.get_symbol(k) for k, i in enumerate(ids)}
        lhs = ",".join("".join(sym[i] for i in inp) for inp in self.inputs)
        return f"{lhs}->{''.join(sym[i] for i in self.output)}"


class _IRBuilder:
    """Track each wire's frontier index while gate tensors are appended."""

    def __init__(self, n: int, d: int = 2):
        self.n = n
        self.d = d
        self.counter = 0
        self.inputs: List[Tuple[int, ...]] = []
        self.tensors: List[Any] = []
        self.size: Dict[int, int] = {}
        self.front: List[int] = [self.new_index() for _ in range(n)]

    def new_index(self) -> int:
        i = self.counter
        self.counter += 1
        self.size[i] = self.d
        return i

    def add_tensor(self, t: Any, idx: Sequence[int]) -> None:
        self.inputs.append(tuple(idx))
        self.tensors.append(t)

    def add_initial(self, init_vec: Any) -> None:
        """The product-state vector on every wire's frontier."""
        for w in range(self.n):
            self.add_tensor(init_vec, (self.front[w],))

    def add_diagonal(self, diag: Any, wires: Sequence[int]) -> None:
        """A k-local diagonal as a (d,)*k hyperedge tensor on the wires'
        frontier indices, which do not advance: 2^k entries, never (2^k)^2,
        so matrix-free items (rzm, multicz) lower at any k."""
        k = len(wires)
        t = _nd(diag)
        if t.ndim != k:
            t = t.reshape((self.d,) * k)
        self.add_tensor(t, tuple(self.front[w] for w in wires))

    def add_gate(self, tensor: Any, wires: Sequence[int]) -> None:
        """A gate tensor, legs (out..., in...), on ``wires``."""
        k = len(wires)
        t = _nd(tensor)
        if t.ndim != 2 * k:
            t = t.reshape((self.d,) * (2 * k))
        new = [self.new_index() for _ in range(k)]
        self.add_tensor(t, tuple(new) + tuple(self.front[w] for w in wires))
        for j, w in enumerate(wires):
            self.front[w] = new[j]

    def finish(self, output: Sequence[int], device: Device, dtype: Any) -> EinsumIR:
        from .contractor import _maybe_capture

        ir = EinsumIR(self.inputs, tuple(output), self.size, _on_device(self.tensors, device, dtype))
        _maybe_capture(ir)
        return ir


def _nd(t: Any) -> Any:
    return t if isinstance(t, (torch.Tensor, np.ndarray)) else np.asarray(t)


def _on_device(tensors: List[Any], device: Device, dtype: Any) -> List[torch.Tensor]:
    """The operands as tensors of ``dtype`` on ``device`` (by default the
    device of the first tensor operand, else the configured one); the numpy
    ones travel in one copy, as views of one buffer."""
    cdt = config.torch_dtype(dtype)
    npdt = config.np_dtype(dtype)
    if device is None:
        device = next((t.device for t in tensors if isinstance(t, torch.Tensor)), None)
    device = config.resolve_device(device)
    host = [k for k, t in enumerate(tensors) if not isinstance(t, torch.Tensor)]
    out: List[Any] = list(tensors)
    if host:
        arrs = [np.asarray(tensors[k]) for k in host]
        buf = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs]).astype(npdt)).to(device)
        pos = 0
        for k, a in zip(host, arrs):
            out[k] = buf[pos:pos + a.size].reshape(a.shape)
            pos += a.size
    for k, t in enumerate(out):
        if isinstance(t, torch.Tensor) and (t.device != device or t.dtype != cdt):
            out[k] = t.to(device=device, dtype=cdt)
    return out


def _conj(t: Any) -> Any:
    return torch.conj(t) if isinstance(t, torch.Tensor) else np.conj(t)


def _transpose(t: Any, perm: Sequence[int]) -> Any:
    return t.permute(*perm) if isinstance(t, torch.Tensor) else np.transpose(t, perm)


def _basis_vec(val: int, d: int) -> np.ndarray:
    v = np.zeros((d,), dtype=np.complex128)
    v[val] = 1.0
    return v


def _multicz_diag(d: int, k: int) -> np.ndarray:
    diag = np.ones(d**k, dtype=np.complex128)
    diag[-1] = -1.0
    return diag


def _matrix_free_diag(item: Dict[str, Any], d: int, dtype: Any) -> Optional[Any]:
    """The diagonal of a matrix-free item (multicz, rzm), else None."""
    k = len(item["index"])
    if item.get("multicz"):
        return _multicz_diag(d, k)
    if item.get("zstring_rot"):
        from ..ops.gates import rzm_diagonal

        return rzm_diagonal(item["theta"], k, dtype)
    return None


def _gate_tensor(item: Dict[str, Any], d: int) -> Any:
    t = _nd(item["gate"].tensor)
    k = len(item["index"])
    return t.reshape((d,) * (2 * k)) if t.ndim != 2 * k else t


def _dtype_str(dtype: Any) -> str:
    return str(dtype or config.dtypestr()).replace("torch.", "")


def _build_forward(qir: List[Dict[str, Any]], n: int, d: int, dtype: str, simplify: bool = True) -> _IRBuilder:
    if simplify:
        from ..simplify import fuse_single_qubit_qir

        qir = fuse_single_qubit_qir(qir, d=d)
    b = _IRBuilder(n, d)
    b.add_initial(_basis_vec(0, d))
    for item in qir:
        diag = _matrix_free_diag(item, d, dtype)
        if diag is not None:
            b.add_diagonal(diag, item["index"])
        else:
            b.add_gate(item["gate"].tensor, item["index"])
    return b


def circuit_state_ir(
    qir: List[Dict[str, Any]], n: int, d: int = 2, dtype: Any = None, device: Device = None
) -> EinsumIR:
    """The IR whose contraction is the whole output state (open legs)."""
    dtype = _dtype_str(dtype)
    b = _build_forward(qir, n, d, dtype)
    return b.finish(b.front, device, dtype)


def amplitude_ir(
    qir: List[Dict[str, Any]], n: int, bits: Sequence[int], d: int = 2, dtype: Any = None, device: Device = None
) -> EinsumIR:
    """The IR of ⟨bits|C|0...0⟩, a closed (scalar) network."""
    dtype = _dtype_str(dtype)
    b = _build_forward(qir, n, d, dtype)
    for w in range(n):
        b.add_tensor(_basis_vec(int(bits[w]), d), (b.front[w],))
    return b.finish((), device, dtype)


def _restrict(qir: List[Dict[str, Any]], ops: Sequence[Tuple[Any, Sequence[int]]], extra: Sequence[int] = ()):
    """The QIR and operators on the wires that something touches, renumbered
    0..m-1 in order (every other wire closes to a factor 1), and the map."""
    support = sorted({int(w) for item in qir for w in item["index"]}
                     | {int(w) for _, wires in ops for w in wires} | set(extra))
    wmap = {w: i for i, w in enumerate(support)}
    qir = [dict(item, index=tuple(wmap[int(w)] for w in item["index"])) for item in qir]
    ops = [(op, tuple(wmap[int(w)] for w in wires)) for op, wires in ops]
    return qir, ops, wmap, max(len(support), 1)


def expectation_ir(
    qir: List[Dict[str, Any]],
    n: int,
    ops: Sequence[Tuple[Any, Sequence[int]]],
    d: int = 2,
    dtype: Any = None,
    lightcone: bool = True,
    device: Device = None,
) -> EinsumIR:
    """The IR of ⟨0|C† O C|0⟩ (the doubled network).  With ``lightcone`` the
    items outside the observables' causal cone are dropped first; the
    network holds only the wires that an item or an operator touches."""
    from ..simplify import fuse_single_qubit_qir, light_cone_qir

    dtype = _dtype_str(dtype)
    if lightcone:
        qir = light_cone_qir(qir, [int(w) for _, wires in ops for w in wires])
    qir, ops, _, n = _restrict(qir, ops)
    qir = fuse_single_qubit_qir(qir, d=d)
    b = _build_forward(qir, n, d, dtype, simplify=False)
    # the operators bridge the ket frontier to the bra frontier
    bra_front = list(b.front)
    for op, wires in ops:
        k = len(wires)
        t = _nd(op)
        if t.ndim != 2 * k:
            t = t.reshape((d,) * (2 * k))
        new = [b.new_index() for _ in range(k)]
        b.add_tensor(t, tuple(new) + tuple(bra_front[w] for w in wires))
        for j, w in enumerate(wires):
            bra_front[w] = new[j]
    # the bra side: the circuit in reverse, each gate's dagger
    for item in reversed(qir):
        k = len(item["index"])
        diag = _matrix_free_diag(item, d, dtype)
        if diag is not None:
            b.add_tensor(_conj(_nd(diag)).reshape((d,) * k), tuple(bra_front[w] for w in item["index"]))
            continue
        t = _gate_tensor(item, d)
        tdg = _conj(_transpose(t, tuple(range(k, 2 * k)) + tuple(range(k))))
        new = [b.new_index() for _ in range(k)]
        b.add_tensor(tdg, tuple(new) + tuple(bra_front[w] for w in item["index"]))
        for j, w in enumerate(item["index"]):
            bra_front[w] = new[j]
    for w in range(n):
        b.add_tensor(_basis_vec(0, d), (bra_front[w],))
    return b.finish((), device, dtype)


def superop_expectation_ir(
    qir: List[Dict[str, Any]],
    n: int,
    ops: Sequence[Tuple[Any, Sequence[int]]],
    d: int = 2,
    dtype: Any = None,
    lightcone: bool = True,
    device: Device = None,
) -> EinsumIR:
    """The IR of tr(O_k ... O_1 ρ) over the doubled (superoperator)
    network: :func:`superop_boundary_ir` with every wire traced."""
    return superop_boundary_ir(qir, n, ops=ops, d=d, dtype=dtype, lightcone=lightcone, device=device)


def _channel_superop(mats: Sequence[Any], k: int, d: int) -> Any:
    """S[ok.., ob.., ik.., ib..] = Σ_i K_i[ok, ik] conj(K_i)[ob, ib]."""
    from ..simplify import _as_tensors

    dim = d**k
    mats = [m.reshape(dim, dim) for m in _as_tensors(*mats)]
    if isinstance(mats[0], torch.Tensor):
        s = sum(torch.einsum("oi,pj->opij", m, torch.conj(m)) for m in mats)
    else:
        s = sum(np.einsum("oi,pj->opij", m, np.conj(m)) for m in mats)
    return s.reshape((d,) * (4 * k))


def superop_boundary_ir(
    qir: List[Dict[str, Any]],
    n: int,
    ops: Sequence[Tuple[Any, Sequence[int]]] = (),
    fixed: Optional[Dict[int, Any]] = None,
    diag_wires: Sequence[int] = (),
    d: int = 2,
    dtype: Any = None,
    lightcone: bool = True,
    device: Device = None,
) -> EinsumIR:
    """The doubled (superoperator) network with a boundary on each wire.

    Wires [0, m) are the ket legs and [m, 2m) the bra legs of the m wires
    that something touches.  A unitary contributes (U, conj U) on the pair,
    a channel one superoperator tensor bridging both sides, a diagonal item
    its diagonal and the conjugate.  The boundary of a wire:

    - ``ops``: the observables applied on the ket side before closing,
      tr(O_k .. O_1 ρ);
    - ``fixed[w] = v``: the wire closes against |v><v|, ``v`` on the ket
      frontier and ``conj(v)`` on the bra one (``v`` may be a one-hot
      tensor: conditioning);
    - ``diag_wires``: the ket/bra pair meets in a 3-leg delta whose third
      leg is an output index: the contraction is the joint diagonal
      marginal of these wires, shape (d,)*len;
    - any other wire is traced (a 2-leg delta).

    Trace preservation cancels the items outside the cone of the ops, fixed
    and diagonal wires, so the light-cone pass seeds from all three."""
    from ..simplify import fuse_single_qubit_qir, light_cone_qir

    dtype = _dtype_str(dtype)
    fixed = {int(w): v for w, v in (fixed or {}).items()}
    diag_wires = [int(w) for w in diag_wires]
    boundary = set(fixed) | set(diag_wires)
    if lightcone:
        qir = light_cone_qir(qir, list(boundary) + [int(w) for _, wires in ops for w in wires])
    qir, ops, wmap, m = _restrict(qir, ops, boundary)
    fixed = {wmap[w]: v for w, v in fixed.items()}
    diag_wires = [wmap[w] for w in diag_wires]
    qir = fuse_single_qubit_qir(qir, d=d)
    b = _IRBuilder(2 * m, d)
    b.add_initial(_basis_vec(0, d))
    for item in qir:
        wires = list(item["index"])
        k = len(wires)
        diag = _matrix_free_diag(item, d, dtype)
        if diag is not None:
            b.add_diagonal(diag, wires)
            b.add_diagonal(_conj(_nd(diag)), [w + m for w in wires])
        elif item.get("is_channel"):
            b.add_gate(_channel_superop(item["channel_kraus"], k, d), wires + [w + m for w in wires])
        else:
            t = _gate_tensor(item, d)
            b.add_gate(t, wires)
            b.add_gate(_conj(t), [w + m for w in wires])
    for op, wires in ops:
        b.add_gate(op, list(wires))
    # per wire: fixed -> |v><v|; diagonal -> an open 3-leg delta; else the trace
    eye = np.eye(d)
    delta3 = np.zeros((d, d, d))
    for i in range(d):
        delta3[i, i, i] = 1.0
    out_by_wire: Dict[int, int] = {}
    for w in range(m):
        if w in fixed:
            v = _nd(fixed[w])
            b.add_tensor(v, (b.front[w],))
            b.add_tensor(_conj(v), (b.front[w + m],))
        elif w in diag_wires:
            o = b.new_index()
            out_by_wire[w] = o
            b.add_tensor(delta3, (b.front[w], b.front[w + m], o))
        else:
            b.add_tensor(eye, (b.front[w], b.front[w + m]))
    return b.finish(tuple(out_by_wire[w] for w in diag_wires), device, dtype)
