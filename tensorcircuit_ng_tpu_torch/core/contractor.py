"""Contraction engine: path finding, execution, slicing, cost introspection.

Counterpart of ``tensorcircuit_ng_tpu/core/contractor.py``.  Paths come from
opt_einsum (the optimizer ``set_contractor`` names) and are cached by the
IR's signature; under "auto" or "greedy" a plan above 10^10 FLOPs is
planned again by the native TreeSA annealer and the cheaper plan is kept.
A plan runs as a chain of pairwise ``torch.einsum`` calls on the operands'
device (cuBLAS complex GEMMs and permute copies on the card), and autograd
flows through it.  Slicing fixes the values of chosen indices so that each
slice's largest intermediate fits, and sums the slices in a loop.

``torch.einsum`` takes at most 52 distinct labels a call, and the networks
of wide circuits hold hundreds of indices: each pairwise step is relabelled
on its own letters once, when its plan's steps are cached.
"""

from __future__ import annotations

import functools
import math
import string
from typing import Any, Dict, List, Optional, Sequence, Tuple

import opt_einsum as oe
import torch

from .. import config
from .einsum_ir import EinsumIR

__all__ = [
    "find_path",
    "contract_ir",
    "contraction_info",
    "get_tn_info",
    "choose_slices",
    "sliced_contract_ir",
    "get_symbol",
    "sorted_edges",
    "set_tensornetwork_backend",
    "NodesReturn",
    "plain_contractor",
    "experimental_contractor",
    "custom",
    "custom_stateful",
    "OMEOptimizer",
    "contraction_info_decorator",
    "function_nodes_capture",
    "runtime_nodes_capture",
    "split_rules",
]

#: above this many FLOPs a greedy-class plan is planned again by TreeSA
ESCALATE_FLOPS = 1e10
#: the most distinct labels ``torch.einsum`` takes in one call
MAX_STEP_LABELS = len(string.ascii_letters)

_PATH_CACHE: Dict[Tuple, Any] = {}
_STEPS_CACHE: Dict[Tuple, List[Tuple[Tuple[int, ...], str]]] = {}
_INFO_PRINTED: set = set()


def _optimizer_from_config() -> Any:
    method = config.get_contractor()
    options = config.contractor_options()
    # read by contract_ir, not by the path optimizers
    options.pop("contraction_info", None)
    options.pop("debug_level", None)
    if method in ("auto", "plain"):
        return "auto" if method == "auto" else None
    if method == "custom":
        return options.get("optimizer")
    if method in ("treesa", "sa"):
        from .native import TreeSAOptimizer

        return TreeSAOptimizer(**options)
    return method  # "greedy", "optimal", "branch-2", "dp", ...


def find_path(ir: EinsumIR, optimizer: Any = None) -> Tuple[List[Tuple[int, ...]], Any]:
    """A pairwise contraction path for the IR and opt_einsum's PathInfo,
    cached by the IR's signature and the optimizer."""
    if optimizer is None:
        optimizer = _optimizer_from_config()
    key = (ir.signature(), str(optimizer))
    if key in _PATH_CACHE:
        return _PATH_CACHE[key]
    subscripts = ir.to_subscripts()
    shapes = ir.shapes()
    if optimizer is None:  # "plain": left to right
        path, info = [(0, 1)] * (len(shapes) - 1), None
    else:
        path, info = oe.contract_path(subscripts, *shapes, shapes=True, optimize=optimizer)
        if isinstance(optimizer, str) and optimizer in ("auto", "greedy") and float(info.opt_cost) > ESCALATE_FLOPS:
            # greedy-class plans of hard networks can be orders of magnitude
            # off: anneal from them and keep the cheaper plan
            from .native import TreeSAOptimizer

            path2, info2 = oe.contract_path(
                subscripts, *shapes, shapes=True,
                optimize=TreeSAOptimizer(n_iters=400000, restarts=2, size_weight=0.5),
            )
            if float(info2.opt_cost) < float(info.opt_cost):
                path, info = path2, info2
    _PATH_CACHE[key] = (path, info)
    return path, info


def contraction_info(ir: EinsumIR, optimizer: Any = None) -> Dict[str, Any]:
    """The plan's FLOPs, largest intermediate and path ({} for "plain")."""
    _, info = find_path(ir, optimizer)
    if info is None:
        return {}
    return {
        "flops": float(info.opt_cost),
        "log10[FLOPs]": math.log10(max(info.opt_cost, 1)),
        "log2[SIZE]": math.log2(max(info.largest_intermediate, 1)),
        "largest_intermediate": float(info.largest_intermediate),
        "path": info.path,
    }


def get_tn_info(obj: Any, output_order: Any = None) -> Tuple[List[Tuple[int, ...]], Tuple[int, ...], Dict[int, int]]:
    """The ``(inputs, output, size_dict)`` topology of an ``EinsumIR``, or of
    a circuit's state network.  ``output_order`` is accepted for the JAX
    package's signature and ignored (the output is in wire order)."""
    if isinstance(obj, EinsumIR):
        ir = obj
    elif hasattr(obj, "_expanded_qir"):
        from . import einsum_ir

        ir = einsum_ir.circuit_state_ir(obj._expanded_qir(), obj._nqubits, d=getattr(obj, "_d", 2),
                                        device=getattr(obj, "_device", None))
    else:
        raise TypeError(f"get_tn_info expects an EinsumIR or a circuit, got {type(obj)}")
    return list(ir.inputs), tuple(ir.output), dict(ir.size_dict)


def _relabel(es: str) -> str:
    """An einsum string on letters a, b, ... in the order the symbols first
    appear, for ``torch.einsum``."""
    lhs, rhs = es.split("->")
    table: Dict[str, str] = {}
    for ch in lhs.replace(",", "") + rhs:
        if ch not in table:
            if len(table) == MAX_STEP_LABELS:
                raise ValueError(
                    f"a contraction step holds more than {MAX_STEP_LABELS} distinct indices, "
                    f"the most torch.einsum takes in one call: {es!r}"
                )
            table[ch] = string.ascii_letters[len(table)]
    return ",".join("".join(table[ch] for ch in term) for term in lhs.split(",")) + "->" + "".join(
        table[ch] for ch in rhs)


def _steps_for(ir: EinsumIR, optimizer: Any) -> List[Tuple[Tuple[int, ...], str]]:
    """The pairwise steps of the IR's plan, (operand positions, local
    einsum string), cached by signature and optimizer as the plan is.  The
    positions come in opt_einsum's pop order, which the einsum string's
    operands follow."""
    if optimizer is None:
        optimizer = _optimizer_from_config()
    key = (ir.signature(), str(optimizer))
    if key not in _STEPS_CACHE:
        path, _ = find_path(ir, optimizer)
        _, info = oe.contract_path(ir.to_subscripts(), *ir.shapes(), shapes=True, optimize=path)
        _STEPS_CACHE[key] = [(tuple(c[0]), _relabel(c[2])) for c in info.contraction_list]
    return _STEPS_CACHE[key]


def _execute_steps(steps: Sequence[Tuple[Tuple[int, ...], str]], operands: Sequence[Any]) -> torch.Tensor:
    ops = list(operands)
    for positions, es in steps:
        arrs = [ops.pop(i) for i in positions]
        ops.append(torch.einsum(es, *arrs))
    if len(ops) != 1:
        raise ValueError(f"the plan left {len(ops)} operands, not one")
    return ops[0]


def contract_ir(ir: EinsumIR, optimizer: Any = None, dry_run: bool = False, strip_exponent: bool = False) -> Any:
    """Contract the IR into its output tensor (autograd flows through).

    ``dry_run`` (also the contractor option ``debug_level >= 2``) returns
    zeros of the output shape without contracting; ``strip_exponent``
    rescales each operand by its largest magnitude and returns ``(value,
    log_factor)``, the true result value * exp(log_factor), for networks of
    huge or tiny magnitude.  The option ``contraction_info=True`` prints a
    network's cost the first time it is contracted."""
    meta = config.contractor_options()
    if int(meta.get("debug_level", 0)) >= 2:
        dry_run = True
    out_shape = tuple(ir.size_dict[i] for i in ir.output)
    if dry_run:
        t0 = ir.tensors[0]
        return torch.zeros(out_shape, dtype=t0.dtype, device=t0.device)
    if meta.get("contraction_info"):
        sig = ir.signature()
        if sig not in _INFO_PRINTED:
            _INFO_PRINTED.add(sig)
            info = contraction_info(ir, optimizer)
            if info:
                print("------ contraction cost summary ------\n"
                      f"log10[FLOPs]: {info['log10[FLOPs]']:.3f}  log2[SIZE]: {info['log2[SIZE]']:.3f}  "
                      f"ops: {len(ir.inputs)}")
    steps = _steps_for(ir, optimizer)
    if not strip_exponent:
        return _execute_steps(steps, ir.tensors)
    scaled = []
    log_factor = torch.zeros((), dtype=torch.float32, device=ir.tensors[0].device)
    for t in ir.tensors:
        s = torch.max(torch.abs(t))
        s = torch.where(s == 0, torch.ones_like(s), s)
        scaled.append(t / s.to(t.dtype))
        log_factor = log_factor + torch.log(s).to(torch.float32)
    return _execute_steps(steps, scaled), log_factor


# ------------------------------------------------------------------
# slicing
# ------------------------------------------------------------------


def _without(ir: EinsumIR, sliced: Sequence[int]) -> EinsumIR:
    drop = set(sliced)
    return EinsumIR([tuple(i for i in inp if i not in drop) for inp in ir.inputs],
                    tuple(i for i in ir.output if i not in drop), ir.size_dict, ir.tensors)


def choose_slices(ir: EinsumIR, target_size: int = 2**28, max_slices: int = 4096, optimizer: Any = None) -> List[int]:
    """Greedy choice of indices to slice until the largest intermediate of
    the (greedy, or ``optimizer``) plan fits in ``target_size`` entries.

    Repeatedly: plan the sliced network, find its largest intermediate, and
    slice the index of it that most operands hold (never an output index:
    the slices are summed)."""
    sliced: List[int] = []
    for _ in range(int(math.log2(max_slices)) + 1):
        sub_ir = _without(ir, sliced)
        _, info = oe.contract_path(sub_ir.to_subscripts(), *sub_ir.shapes(), shapes=True,
                                   optimize=optimizer if optimizer is not None else "greedy")
        big_inds: List[str] = []
        big_size = 0
        for contraction in info.contraction_list:
            out_part = contraction[2].split("->")[1]
            size = 1
            for ch in out_part:
                size *= info.size_dict[ch]
            if size > big_size:
                big_size, big_inds = size, list(out_part)
        if big_size <= target_size or not big_inds:
            break
        ids = sorted({i for inp in sub_ir.inputs for i in inp} | set(sub_ir.output))
        sym2id = {oe.get_symbol(k): i for k, i in enumerate(ids)}
        out_set = set(ir.output)
        freq: Dict[int, int] = {}
        for ch in big_inds:
            iid = sym2id.get(ch)
            if iid is None or iid in out_set:
                continue
            freq[iid] = sum(1 for inp in ir.inputs if iid in inp)
        if not freq:
            break
        sliced.append(max(freq, key=lambda k: (freq[k], k)))
    return sliced


def sliced_contract_ir(
    ir: EinsumIR,
    sliced_indices: Sequence[int],
    slice_ids: Optional[Any] = None,
    optimizer: Any = None,
    slice_weights: Optional[Any] = None,
) -> torch.Tensor:
    """Contract with ``sliced_indices`` fixed slice by slice, the slices
    summed (weighted by ``slice_weights``).

    ``slice_ids`` (flat ids, the last index fastest) restricts the sum to a
    subset of the slices: the hook by which a distributed contraction gives
    each process its own share."""
    bad = [i for i in sliced_indices if i in set(ir.output)]
    if bad:
        raise ValueError(f"cannot slice open output indices {bad}: the slice sum would marginalize an output leg")
    d_sizes = [ir.size_dict[i] for i in sliced_indices]
    nslices = math.prod(d_sizes)
    ids = list(range(nslices)) if slice_ids is None else torch.as_tensor(slice_ids).reshape(-1).tolist()
    sub_ir = _without(ir, sliced_indices)
    steps = _steps_for(sub_ir, optimizer)
    dtype = ir.tensors[0].dtype
    device = ir.tensors[0].device
    if slice_weights is None:
        weights = torch.ones((len(ids),), dtype=torch.float32, device=device)
    else:
        weights = torch.as_tensor(slice_weights, device=device)

    def one_slice(flat_id: int) -> torch.Tensor:
        vals = []
        rem = flat_id
        for sz in reversed(d_sizes):
            vals.append(rem % sz)
            rem //= sz
        vals.reverse()
        operands = []
        for inp, t in zip(ir.inputs, ir.tensors):
            axes = list(inp)
            for sid, sval in zip(sliced_indices, vals):
                if sid in axes:
                    ax = axes.index(sid)
                    t = torch.select(t, ax, sval)
                    axes.pop(ax)
            operands.append(t)
        return _execute_steps(steps, operands)

    acc = torch.zeros(tuple(ir.size_dict[i] for i in sub_ir.output), dtype=dtype, device=device)
    for k, sid in enumerate(ids):
        acc = acc + weights[k].to(dtype) * one_slice(sid)
    return acc


# ======================================================================
# the JAX package's parity API (its reference: tensorcircuit's cons.py)
# ======================================================================

_SYMBOLS = string.ascii_letters


def get_symbol(i: int) -> str:
    """A deterministic einsum symbol for index ``i``."""
    if i < len(_SYMBOLS):
        return _SYMBOLS[i]
    return chr(192 + i - len(_SYMBOLS))


def sorted_edges(ir: EinsumIR) -> List[int]:
    """The IR's indices in the order the operands first hold them."""
    seen: List[int] = []
    for inds in ir.inputs:
        for ix in inds:
            if ix not in seen:
                seen.append(ix)
    return seen


def set_tensornetwork_backend(backend: Optional[str] = None, set_global: bool = True) -> str:
    """The engine contracts with torch only: ``None``, "pytorch" or "torch"."""
    if backend not in (None, "pytorch", "torch"):
        raise ValueError("the port contracts networks with torch only: use 'pytorch' (alias 'torch')")
    return "pytorch"


class NodesReturn(Exception):
    """Raised by :func:`function_nodes_capture` to hand back the network
    built inside, uncontracted; carries the IR."""

    def __init__(self, nodes: Any):
        self.nodes = nodes
        super().__init__("uncontracted network captured")


def plain_contractor(ir: EinsumIR, output: Optional[Sequence[int]] = None) -> Any:
    """:func:`contract_ir` with the configured optimizer (the JAX package's
    entry point of this name does the same)."""
    return contract_ir(ir, optimizer=None)


def experimental_contractor(ir: EinsumIR, output: Optional[Sequence[int]] = None, local_steps: int = 2) -> Any:
    """The greedy plan (the IR lowering already fuses single-qubit chains)."""
    return contract_ir(ir, optimizer="greedy")


def custom(ir: EinsumIR, optimizer: Any = None, output: Optional[Sequence[int]] = None, **kws: Any) -> Any:
    """Contract with an opt_einsum path optimizer given by the caller."""
    return contract_ir(ir, optimizer=optimizer)


def custom_stateful(ir: EinsumIR, optimizer_class: Any = None, output: Optional[Sequence[int]] = None,
                    **opt_kws: Any) -> Any:
    """Contract with a stateful optimizer class instantiated for the call."""
    return contract_ir(ir, optimizer=optimizer_class(**opt_kws) if optimizer_class is not None else None)


class OMEOptimizer(oe.paths.PathOptimizer):
    """The annealing tree optimizer slot of the JAX package's API: the
    native TreeSA, with the option names ``niters``/``steps``/``n_iters``,
    ``size_weight`` and ``seed``."""

    def __init__(self, **options: Any):
        from .native import TreeSAOptimizer

        n_iters = int(options.pop("niters", options.pop("steps", options.pop("n_iters", 2000))))
        self._opt = TreeSAOptimizer(n_iters=n_iters, size_weight=float(options.pop("size_weight", 0.6)),
                                    seed=int(options.pop("seed", 42)))

    def __call__(self, inputs: Any, output: Any, size_dict: Any, *args: Any, **kws: Any) -> Any:
        return self._opt(inputs, output, size_dict, *args, **kws)


def contraction_info_decorator(f: Any) -> Any:
    """Wrap a function that returns an IR (or takes one first) to print the
    network's cost at each call."""

    @functools.wraps(f)
    def wrapper(*args: Any, **kws: Any) -> Any:
        out = f(*args, **kws)
        ir = out if isinstance(out, EinsumIR) else (args[0] if args and isinstance(args[0], EinsumIR) else None)
        if ir is not None:
            info = contraction_info(ir)
            print("------ contraction cost summary ------\n"
                  f"log10[FLOPs]: {info.get('log10[FLOPs]', 0):.3f}  log2[SIZE]: {info.get('log2[SIZE]', 0):.1f}  "
                  f"ops: {len(info.get('path', []))}")
        return out

    return wrapper


_CAPTURE: Dict[str, Any] = {"store": None}


def function_nodes_capture(f: Any) -> Any:
    """Decorator: a call that builds an IR raises :class:`NodesReturn` with
    the last one built, after ``f`` returns."""

    @functools.wraps(f)
    def wrapper(*args: Any, **kws: Any) -> Any:
        with runtime_nodes_capture() as store:
            out = f(*args, **kws)
        if store["ir"] is not None:
            raise NodesReturn(store["ir"])
        return out

    return wrapper


class runtime_nodes_capture:
    """Context manager: its value's ``"ir"`` is the last IR built inside."""

    def __enter__(self) -> Dict[str, Any]:
        self._prev = _CAPTURE["store"]
        self._store: Dict[str, Any] = {"ir": None}
        _CAPTURE["store"] = self._store
        return self._store

    def __exit__(self, *exc: Any) -> None:
        _CAPTURE["store"] = self._prev


def _maybe_capture(ir: EinsumIR) -> None:
    if _CAPTURE["store"] is not None:
        _CAPTURE["store"]["ir"] = ir


def split_rules(max_singular_values: Optional[int] = None, max_truncation_err: Optional[float] = None,
                relative: bool = False) -> Dict[str, Any]:
    """The split-rule dict of an SVD gate split."""
    return {"max_singular_values": max_singular_values, "max_truncation_err": max_truncation_err,
            "relative": relative}
