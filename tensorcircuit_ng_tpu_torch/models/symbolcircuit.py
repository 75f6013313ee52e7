"""``SymbolCircuit``: circuits whose parameters may be sympy expressions.

Counterpart of ``tensorcircuit_ng_tpu/models/symbolcircuit.py``.  The gate
methods record a sympy matrix per gate; ``wavefunction``, ``amplitude``,
``matrix``, ``probability`` and ``expectation_ps`` (simplified) are exact
expressions, computed on the host.  ``subs``/``bind`` substitute symbols
and return a ``SymbolCircuit``; ``to_circuit(bindings, device=)`` binds
every symbol and returns the port's :class:`Circuit` on the device, from the
circuit's own ``inputs`` (the JAX package's ``to_circuit`` starts from
|0...0> whatever the inputs).  The readouts that need numbers (``sample``,
``measure``, ``sample_expectation_ps``, ``cond_measurement``,
``projected_subsystem``, ``measure_reference``) go through ``to_circuit``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..ops import gates as gates_mod
from .abstractcircuit import AbstractCircuit

__all__ = ["SymbolCircuit"]


def _host(a: Any) -> np.ndarray:
    """A host numpy copy of a tensor, a Gate's tensor or an array."""
    if hasattr(a, "tensor"):
        a = a.tensor
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def _sym_gate_matrix(name: str, params: Dict[str, Any]) -> Any:
    """The exact matrix of gate ``name``: the rotations and phases over
    their (possibly symbolic) ``theta``, any other gate from the numeric
    registry at its default parameters, made exact by ``nsimplify``."""
    import sympy as sp

    name = name.lower()
    th = params.get("theta", 0)
    c, s = sp.cos(th / 2), sp.sin(th / 2)
    if name == "rx":
        return sp.Matrix([[c, -sp.I * s], [-sp.I * s, c]])
    if name == "ry":
        return sp.Matrix([[c, -s], [s, c]])
    if name == "rz":
        return sp.Matrix([[c - sp.I * s, 0], [0, c + sp.I * s]])
    if name in ("rzz", "rxx", "ryy"):
        g = {
            "rzz": sp.diag(1, -1, -1, 1),
            "rxx": sp.Matrix([[0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0], [1, 0, 0, 0]]),
            "ryy": sp.Matrix([[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]),
        }[name]
        return c * sp.eye(4) - sp.I * s * g
    if name == "phase":
        return sp.Matrix([[1, 0], [0, sp.exp(sp.I * th)]])
    if name == "cphase":
        m = sp.eye(4)
        m[3, 3] = sp.exp(sp.I * th)
        return m
    if name == "crz":
        m = sp.eye(4)
        m[2, 2] = c - sp.I * s
        m[3, 3] = c + sp.I * s
        return m
    m = gates_mod.matrix_for_gate(gates_mod.get_gate(name)())
    return sp.Matrix(sp.nsimplify(sp.Matrix(m), rational=False))


def _need_binding(name: str) -> Any:
    """A method that runs ``Circuit.<name>`` on :meth:`SymbolCircuit.to_circuit`."""

    def meth(self: "SymbolCircuit", *args: Any, bindings: Optional[Dict[Any, Any]] = None, **kws: Any) -> Any:
        if bindings is None and self.free_symbols():
            raise ValueError(f"SymbolCircuit.{name} requires numeric values: pass bindings={{symbol: value}}")
        return getattr(self.to_circuit(bindings), name)(*args, **kws)

    meth.__name__ = name
    meth.__doc__ = f"``Circuit.{name}`` on the circuit with every symbol bound (``bindings``)."
    return meth


def _qubit_permutation_matrix(order: Sequence[int], n: int) -> Any:
    """The permutation P with (P ψ) in the qubit order ``order`` (its first
    entry the most significant qubit) for ψ in the natural order."""
    import sympy as sp

    dim = 2**n
    p = sp.zeros(dim, dim)
    for src in range(dim):
        dst = 0
        for q in order:
            dst = dst * 2 + ((src >> (n - 1 - q)) & 1)
        p[dst, src] = 1
    return p


class SymbolCircuit(AbstractCircuit):
    """Circuit whose gate parameters may be sympy expressions.  ``device``
    (default: the configured device, which needs a card when it is CUDA) is
    where :meth:`to_circuit` puts the bound circuit."""

    def __init__(
        self,
        nqubits: int,
        inputs: Optional[Any] = None,
        dim: int = 2,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        import sympy as sp

        super().__init__()
        self._nqubits = nqubits
        self._d = 2
        self._device = config.resolve_device(device)
        self._inputs = inputs
        if inputs is not None:
            self._psi0 = sp.Matrix(list(_host(inputs).reshape(-1)))
        else:
            self._psi0 = sp.Matrix([1] + [0] * (2**nqubits - 1))

    @property
    def device(self) -> torch.device:
        return self._device

    def _apply_gate_instance(self, gatef: Any, *index: Any, name: str, split: Any = None, **params: Any) -> None:
        """Record the gate's sympy matrix; index sequences broadcast."""
        if index and hasattr(index[0], "__iter__"):
            seqs = [list(i) for i in index]
            for pos in range(len(seqs[0])):
                self._apply_gate_instance(gatef, *(s[pos] for s in seqs), name=name, split=split, **params)
            return
        self._qir.append(
            {
                "gatef": gatef,
                "gate": None,
                "sym_matrix": _sym_gate_matrix(name, params),
                "index": tuple(int(i) for i in index),
                "name": name,
                "parameters": dict(params),
                "split": None,
                "mpo": False,
            }
        )

    def any(self, *index: int, unitary: Any, name: str = "any", **kws: Any) -> None:
        """A dense gate: a sympy matrix as it is, else a host copy of the
        numbers (numpy or a tensor)."""
        import sympy as sp

        if getattr(unitary, "is_Matrix", False):
            m = unitary
        else:
            m = sp.Matrix(_host(unitary).reshape(2 ** len(index), 2 ** len(index)))
        self._qir.append(
            {
                "gatef": None,
                "gate": None,
                "sym_matrix": m,
                "index": tuple(int(i) for i in index),
                "name": name,
                "parameters": {},
                "split": None,
                "mpo": False,
            }
        )

    unitary = any

    # ------------------------------------------------------------------
    # symbolic evaluation
    # ------------------------------------------------------------------

    def _embed(self, m: Any, index: Tuple[int, ...]) -> Any:
        """``m`` on the qubits ``index`` as a 2^n x 2^n sympy matrix."""
        import sympy as sp

        n, k = self._nqubits, len(index)
        order = list(index) + [q for q in range(n) if q not in set(index)]
        big = sp.Matrix(sp.kronecker_product(m, sp.eye(2 ** (n - k))))
        perm = _qubit_permutation_matrix(order, n)
        return perm.T * big * perm

    def matrix(self) -> Any:
        import sympy as sp

        u = sp.eye(2**self._nqubits)
        for item in self._qir:
            u = self._embed(item["sym_matrix"], item["index"]) * u
        return u

    def wavefunction(self) -> Any:
        psi = self._psi0
        for item in self._qir:
            psi = self._embed(item["sym_matrix"], item["index"]) * psi
        return psi

    state = wavefunction

    def amplitude(self, l: Union[str, Sequence[int]]) -> Any:
        if isinstance(l, str):
            l = [int(ch, 36) for ch in l]
        idx = 0
        for v in l:
            idx = idx * 2 + int(v)
        return self.wavefunction()[idx]

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        **kws: Any,
    ) -> Any:
        """<ψ|P|ψ> of the Pauli string, simplified."""
        import sympy as sp

        psi = self.wavefunction()
        op = sp.eye(2**self._nqubits)
        mats = {
            "x": sp.Matrix([[0, 1], [1, 0]]),
            "y": sp.Matrix([[0, -sp.I], [sp.I, 0]]),
            "z": sp.Matrix([[1, 0], [0, -1]]),
        }
        for key, qubits in (("x", x), ("y", y), ("z", z)):
            for q in qubits or ():
                op = self._embed(mats[key], (int(q),)) * op
        return sp.simplify((psi.H * op * psi)[0, 0])

    def probability(self) -> Any:
        """|ψ_s|² for every basis state s."""
        import sympy as sp

        return sp.Matrix([sp.Abs(x) ** 2 for x in self.wavefunction()])

    def expectation_before(self, *ops: Any, **kws: Any) -> Any:
        """The product over ``(op, wires)`` of <ψ|op|ψ>, unsimplified."""
        import sympy as sp

        psi = self.wavefunction()
        acc = None
        for op, wires in ops:
            m = sp.Matrix(_host(op.matrix() if hasattr(op, "matrix") else op))
            term = (psi.conjugate().T * self._embed(m, tuple(wires)) * psi)[0]
            acc = term if acc is None else acc * term
        return acc

    def get_quoperator(self) -> Any:
        """The circuit's symbolic matrix (the JAX package's name)."""
        return self.matrix()

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------

    def free_symbols(self) -> set:
        syms: set = set()
        for item in self._qir:
            for v in item.get("parameters", {}).values():
                if hasattr(v, "free_symbols"):
                    syms |= v.free_symbols
        return syms

    def subs(self, bindings: Dict[Any, Any]) -> "SymbolCircuit":
        """A new ``SymbolCircuit`` with ``bindings`` substituted, on the same
        inputs and device."""
        c = SymbolCircuit(self._nqubits, inputs=self._inputs, device=self._device)
        for item in self._qir:
            new_item = dict(item)
            new_item["sym_matrix"] = item["sym_matrix"].subs(bindings)
            new_item["parameters"] = {
                k: (v.subs(bindings) if hasattr(v, "subs") else v) for k, v in item.get("parameters", {}).items()
            }
            c._qir.append(new_item)
        return c

    bind = subs

    def to_circuit(
        self, bindings: Optional[Dict[Any, Any]] = None, device: Union[None, str, torch.device] = None
    ) -> Any:
        """The port's ``Circuit`` with every symbol bound by ``bindings``, from
        this circuit's inputs, on ``device`` (default: this circuit's)."""
        from .circuit import Circuit

        c = Circuit(self._nqubits, inputs=self._inputs, device=self._device if device is None else device)
        for item in self._qir:
            params = {}
            for key, v in item.get("parameters", {}).items():
                if hasattr(v, "subs"):
                    v = v.subs(bindings or {})
                    if not v.is_number:
                        raise ValueError("unbound symbols remain; provide bindings")
                    v = complex(v)
                    v = v.real if abs(v.imag) < 1e-12 else v
                params[key] = v
            if item["gatef"] is not None:
                c._apply_gate_instance(item["gatef"], *item["index"], name=item["name"], **params)
            else:
                m = item["sym_matrix"].subs(bindings) if bindings else item["sym_matrix"]
                c.any(*item["index"], unitary=np.asarray(m, dtype=complex), name=item["name"])
        return c

    measure = _need_binding("measure")
    measure_reference = _need_binding("measure_reference")
    sample = _need_binding("sample")
    sample_expectation_ps = _need_binding("sample_expectation_ps")
    cond_measurement = _need_binding("cond_measurement")
    projected_subsystem = _need_binding("projected_subsystem")
