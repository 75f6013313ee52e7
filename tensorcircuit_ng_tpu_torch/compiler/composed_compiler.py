"""Compile pipelines and the qiskit transpiler's mapping bookkeeping.

Counterpart of ``tensorcircuit_ng_tpu/compiler/composed_compiler.py``:
``Compiler`` chains stages ``(circuit, info) -> (circuit, info)``,
``DefaultCompiler`` is ``simple_compile`` (and a qiskit transpile where
qiskit is installed), and ``qiskit_compile`` threads the qubit mappings of
a transpile through ``info`` (``compose_mapping_info``); its transpiler
may be injected, so the bookkeeping runs without qiskit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Compiler", "DefaultCompiler", "default_compile", "qiskit_compile", "compose_mapping_info"]


class Compiler:
    """Chain of compile stages, each ``(circuit, info) -> (circuit, info)``."""

    def __init__(self, compile_funcs: Sequence[Callable[..., Any]], compiled_options: Optional[Sequence[Dict[str, Any]]] = None):
        self.compile_funcs = list(compile_funcs)
        self.compiled_options = list(compiled_options or [{}] * len(self.compile_funcs))

    def add_options(self, compiled_options: Optional[Any] = None) -> None:
        """Reset the stages' options: none, one dict for every stage, or a
        list of one a stage."""
        if compiled_options is None:
            self.compiled_options = [{} for _ in self.compile_funcs]
        elif isinstance(compiled_options, dict):
            self.compiled_options = [dict(compiled_options) for _ in self.compile_funcs]
        else:
            assert len(compiled_options) == len(self.compile_funcs), (
                "`compiled_options` must have the same list length as `compile_funcs`"
            )
            self.compiled_options = [dict(c or {}) for c in compiled_options]

    def __call__(self, circuit: Any, info: Optional[Dict[str, Any]] = None) -> Tuple[Any, Dict[str, Any]]:
        info = dict(info or {})
        for f, opts in zip(self.compile_funcs, self.compiled_options):
            result = f(circuit, info, **opts) if opts else f(circuit, info)
            if isinstance(result, tuple):
                circuit, info = result
            else:
                circuit = result
        # default identity mapping info for downstream wrappers
        info.setdefault(
            "logical_physical_mapping", {i: i for i in range(circuit.nqubits)}
        )
        info.setdefault(
            "positional_logical_mapping", {i: i for i in range(circuit.nqubits)}
        )
        return circuit, info


class DefaultCompiler(Compiler):
    """simple_compile pipeline; qiskit transpilation slots in when available."""

    def __init__(self, qiskit_compiled_options: Optional[Dict[str, Any]] = None):
        from .simple_compiler import simple_compile

        funcs: List[Callable[..., Any]] = [simple_compile]
        try:  # optional qiskit transpile stage
            import qiskit  # type: ignore # noqa

            funcs.append(_qiskit_stage(qiskit_compiled_options or {}))
        except ImportError:
            pass
        super().__init__(funcs)


def _qiskit_stage(options: Dict[str, Any]) -> Any:
    def stage(circuit: Any, info: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
        from qiskit import transpile  # type: ignore

        from ..translation import qir2qiskit, qiskit2tc

        qc = qir2qiskit(circuit.to_qir(), circuit.nqubits)
        tqc = transpile(qc, **options)
        return qiskit2tc(tqc, type(circuit)), info

    return stage


def default_compile(
    circuit: Any,
    info: Optional[Dict[str, Any]] = None,
    compiled_options: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """:class:`DefaultCompiler` on ``circuit``: (the circuit, ``info``)."""
    return DefaultCompiler(compiled_options)(circuit, info)


def compose_mapping_info(
    info: Optional[Dict[str, Any]],
    new_lpm: Dict[int, int],
    positional_logical: Optional[Dict[int, int]] = None,
) -> Dict[str, Any]:
    """Thread qubit-mapping bookkeeping through one transpile stage.

    A pure function (no qiskit needed):

    - an incoming ``logical_physical_mapping`` COMPOSES with the stage's new
      mapping: ``logical -> old physical -> new physical``;
    - ``positional_logical_mapping`` passes through unchanged when present
      (the logical circuit's measure order is upstream of this stage),
      otherwise the caller-provided one (derived from the pre-transpile
      circuit) is used, defaulting to identity.
    """
    out: Dict[str, Any] = {}
    if info is not None and "logical_physical_mapping" in info:
        out["logical_physical_mapping"] = {
            k: new_lpm[v] for k, v in info["logical_physical_mapping"].items()
        }
    else:
        out["logical_physical_mapping"] = dict(new_lpm)
    if info is not None and "positional_logical_mapping" in info:
        out["positional_logical_mapping"] = dict(info["positional_logical_mapping"])
    elif positional_logical is not None:
        out["positional_logical_mapping"] = dict(positional_logical)
    else:
        out["positional_logical_mapping"] = {k: k for k in new_lpm}
    return out


def positional_logical_mapping_of(circuit: Any) -> Optional[Dict[int, int]]:
    """Measure-order -> logical-qubit map of the PRE-transpile circuit:
    position ``i`` is the i-th measure instruction in program order, its
    value the measured qubit.  Works on tc circuits (recorded ``measure_instruction`` entries
    in ``_extra_qir``) and on qiskit circuits (``find_bit`` over measure
    data).  Returns None when no measure instructions are recorded (the
    identity convention applies then).
    """
    out: Dict[int, int] = {}
    i = 0
    if hasattr(circuit, "_extra_qir"):
        for inst in circuit._extra_qir:
            if inst.get("name") == "measure":
                for q in inst["index"]:
                    out[i] = int(q)
                    i += 1
        return out or None
    if hasattr(circuit, "data") and hasattr(circuit, "find_bit"):
        for inst in circuit.data:
            if inst[0].name == "measure":
                out[i] = circuit.find_bit(inst[1][0]).index
                i += 1
        return out or None
    return None


def qiskit_compile(
    circuit: Any,
    info: Optional[Dict[str, Any]] = None,
    output: str = "tc",
    compiled_options: Optional[Dict[str, Any]] = None,
    _transpile_fn: Optional[Callable[..., Any]] = None,
    **kws: Any,
) -> Any:
    """Compilation by ``qiskit.transpile``, with the qubit mappings in ``info``.

    ``kws`` (e.g. ``device=``) build the output circuit of ``output="tc"``.
    Requires qiskit unless ``_transpile_fn`` injects a transpiler (the
    offline-test seam: mapping bookkeeping is pure python via
    :func:`compose_mapping_info` and testable without qiskit).
    """
    if _transpile_fn is None:
        from qiskit.compiler import transpile as _transpile_fn  # type: ignore

    from ..translation import get_qiskit_qasm

    if hasattr(circuit, "to_qiskit"):
        try:
            qc = circuit.to_qiskit()
        except ImportError:
            if _transpile_fn.__module__.startswith("qiskit"):
                raise
            qc = circuit  # injected transpiler: hand it the tc circuit as-is
    else:
        qc = circuit
    options = compiled_options or {"optimization_level": 2}
    compiled = _transpile_fn(qc, **options)
    new_lpm: Dict[int, int] = {}
    try:
        layout = compiled.layout.final_index_layout()
        new_lpm = {i: p for i, p in enumerate(layout)}
    except Exception:
        nq = getattr(compiled, "num_qubits", getattr(circuit, "nqubits", 0))
        new_lpm = {i: i for i in range(int(nq))}
    info = compose_mapping_info(
        info, new_lpm, positional_logical=positional_logical_mapping_of(circuit)
    )
    if output == "qiskit":
        return compiled, info
    if output == "qasm":
        return get_qiskit_qasm(compiled), info
    from ..models.circuit import Circuit

    return Circuit.from_openqasm(get_qiskit_qasm(compiled), **kws), info


