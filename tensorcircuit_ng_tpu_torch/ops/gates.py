"""Gate registry: fixed and parameterized quantum gates.

Counterpart of ``tensorcircuit_ng_tpu/ops/gates.py``: a :class:`Gate` holds
a dense tensor of shape ``(2,)*2k``; gate matrices are functions of
(parameters, dtype).  Concrete parameters (numbers, numpy arrays) give numpy
matrices, which are moved to the state's device where they are applied; a
torch tensor parameter gives a torch matrix on its device that keeps
autograd.  ``GATES`` maps every gate name (and alias) to its factory:
``GATES["cnot"]()`` or ``GATES["rx"](theta=0.3)`` -> :class:`Gate`; the
module attributes ``gates.h``, ``gates.rx_gate`` name the same factories.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch

from .. import config

__all__ = [
    "Gate",
    "GateF",
    "GateVF",
    "num_to_tensor",
    "array_to_tensor",
    "GATES",
    "GATE_ALIASES",
    "VARIABLE_ALIASES",
    "FIXED_GATE_NAMES",
    "VARIABLE_GATE_NAMES",
    "rgate_matrix",
    "rx_matrix",
    "ry_matrix",
    "rz_matrix",
    "phase_matrix",
    "u_matrix",
    "cu_matrix",
    "rxx_matrix",
    "ryy_matrix",
    "rzz_matrix",
    "crx_matrix",
    "cry_matrix",
    "crz_matrix",
    "cphase_matrix",
    "iswap_matrix",
    "exponential_matrix",
    "exp1_matrix",
    "rzm_matrix",
    "rzm_diagonal",
    "su4_matrix",
    "multicontrol_matrix",
]


def num_to_tensor(*nums: Any, dtype: Optional[str] = None, device: Any = None) -> Any:
    """Numbers or arrays as tensors of the complex ``dtype`` (default: the
    configured one).  A tensor keeps its device (and autograd) unless
    ``device`` is given; anything else goes to ``device``, else the
    configured device."""
    cdt = config.torch_dtype(dtype)
    out = []
    for x in nums:
        if isinstance(x, torch.Tensor):
            out.append(x.to(device=x.device if device is None else device, dtype=cdt))
        else:
            out.append(torch.as_tensor(np.asarray(x), device=config.resolve_device(device)).to(cdt))
    return out[0] if len(out) == 1 else out


array_to_tensor = num_to_tensor

PAULI_CHAR_TO_INDEX = {"I": 0, "X": 1, "Y": 2, "Z": 3}

# single-qubit basis states, numpy constants
zero_state = np.array([1.0, 0.0], dtype=np.complex64)
one_state = np.array([0.0, 1.0], dtype=np.complex64)
plus_state = (zero_state + one_state) / np.sqrt(2.0)
minus_state = (zero_state - one_state) / np.sqrt(2.0)


class Gate:
    """A dense gate tensor with a name; shape ``(d,)*2k`` or matrix form."""

    def __init__(self, tensor: Any, name: str = "any") -> None:
        if not hasattr(tensor, "ndim"):
            tensor = np.asarray(tensor)
        self.tensor = tensor
        self.name = name

    def copy(self) -> "Gate":
        return Gate(self.tensor, self.name)

    def __repr__(self) -> str:
        return f"Gate(name={self.name!r}, shape={tuple(self.tensor.shape)})"

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    def matrix(self) -> Any:
        t = self.tensor
        dim = int(math.isqrt(int(np.prod(t.shape))))
        return t.reshape(dim, dim)


# ------------------------------------------------------------------
# fixed matrices (numpy, cast per dtype on demand)
# ------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)

_i_matrix = np.eye(2)
_x_matrix = np.array([[0, 1], [1, 0]])
_y_matrix = np.array([[0, -1j], [1j, 0]])
_z_matrix = np.array([[1, 0], [0, -1]])
_h_matrix = np.array([[1, 1], [1, -1]]) / _SQRT2
_s_matrix = np.array([[1, 0], [0, 1j]])
_t_matrix = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]])
_wroot_matrix = np.array([[1, -np.sqrt(1j)], [np.sqrt(-1j), 1]]) / _SQRT2
_sx_matrix = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])
_swap_matrix = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])


def _controlled(m: np.ndarray, num_ctrl: int = 1) -> np.ndarray:
    dim = m.shape[0]
    full = np.eye(dim * 2**num_ctrl, dtype=complex)
    full[-dim:, -dim:] = m
    return full


def _zero_controlled(m: np.ndarray) -> np.ndarray:
    full = np.eye(m.shape[0] * 2, dtype=complex)
    full[: m.shape[0], : m.shape[0]] = m
    return full


_FIXED_GATES: Dict[str, np.ndarray] = {
    "i": _i_matrix,
    "x": _x_matrix,
    "y": _y_matrix,
    "z": _z_matrix,
    "h": _h_matrix,
    "s": _s_matrix,
    "sd": _s_matrix.conj().T,
    "t": _t_matrix,
    "td": _t_matrix.conj().T,
    "wroot": _wroot_matrix,
    "sx": _sx_matrix,
    "cnot": _controlled(_x_matrix),
    "cy": _controlled(_y_matrix),
    "cz": _controlled(_z_matrix),
    "ch": _controlled(_h_matrix),
    "swap": _swap_matrix,
    "toffoli": _controlled(_x_matrix, 2),
    "fredkin": _controlled(_swap_matrix, 1),
    "ox": _zero_controlled(_x_matrix),
    "oy": _zero_controlled(_y_matrix),
    "oz": _zero_controlled(_z_matrix),
}

GATE_ALIASES: Dict[str, str] = {
    "cx": "cnot",
    "ccnot": "toffoli",
    "ccx": "toffoli",
    "cswap": "fredkin",
}


def _fixed_tensor(name: str, dtype: str) -> np.ndarray:
    m = _FIXED_GATES[name]
    nq = int(round(math.log2(m.shape[0])))
    return m.astype(np.dtype(dtype)).reshape((2,) * (2 * nq))


# ------------------------------------------------------------------
# parameterized matrices: numpy when concrete, torch for tensors
# ------------------------------------------------------------------


class _Ops:
    """The array operations of one matrix build: numpy when every parameter
    is concrete, torch (on the first tensor parameter's device) otherwise."""

    def __init__(self, dtype: Optional[str], *vals: Any) -> None:
        self.dtype = config.dtypestr() if dtype is None else str(np.dtype(str(dtype).replace("torch.", "")))
        ref = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        self.torch = ref is not None
        self.device = ref.device if ref is not None else None

    def c(self, v: Any) -> Any:
        """``v`` as a complex array (or tensor) at the build's dtype."""
        if self.torch:
            if isinstance(v, torch.Tensor):
                return v.to(device=self.device, dtype=getattr(torch, self.dtype))
            return config.device_constant(v, self.device, getattr(torch, self.dtype))
        return np.asarray(v).astype(np.dtype(self.dtype))

    def fn(self, name: str) -> Callable[..., Any]:
        return getattr(torch if self.torch else np, name)

    def stack(self, xs: Sequence[Any], axis: int = 0) -> Any:
        return torch.stack(list(xs), dim=axis) if self.torch else np.stack(xs, axis=axis)

    def eye(self, n: int) -> Any:
        return self.c(np.eye(n))

    def kron(self, a: Any, b: Any) -> Any:
        return self.fn("kron")(a, b)

    def diag(self, v: Any) -> Any:
        return self.fn("diag")(v)

    def set_block(self, m: Any, rows: Any, cols: Any, val: Any) -> Any:
        m = m.clone() if self.torch else m.copy()
        m[rows, cols] = val
        return m

    def paulis(self) -> Tuple[Any, Any, Any, Any]:
        return tuple(self.c(p) for p in (_i_matrix, _x_matrix, _y_matrix, _z_matrix))


def _e(t: Any) -> Any:
    """A parameter (any batch shape) broadcast against a matrix."""
    return t[..., None, None]


def _rot(theta: Any, which: int, dtype: Optional[str]) -> Any:
    """``exp(-i theta/2 P)`` for the Pauli P = paulis[which]; a batch of
    angles gives ``theta.shape + (2, 2)``."""
    o = _Ops(dtype, theta)
    p = o.paulis()
    theta = o.c(theta)
    return o.fn("cos")(_e(theta / 2)) * p[0] - 1j * o.fn("sin")(_e(theta / 2)) * p[which]


def _rot2(theta: Any, which: int, dtype: Optional[str]) -> Any:
    """``exp(-i theta/2 P⊗P)``."""
    o = _Ops(dtype, theta)
    p = o.paulis()[which]
    theta = o.c(theta)
    return o.fn("cos")(_e(theta / 2)) * o.eye(4) - 1j * o.fn("sin")(_e(theta / 2)) * o.kron(p, p)


def rgate_matrix(theta: Any = 0, alpha: Any = 0, phi: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta n(alpha, phi) . sigma)`` with
    ``n = (sin(alpha) cos(phi), sin(alpha) sin(phi), cos(alpha))``."""
    o = _Ops(dtype, theta, alpha, phi)
    i, x, y, z = o.paulis()
    theta, alpha, phi = o.c(theta), o.c(alpha), o.c(phi)
    sin, cos = o.fn("sin"), o.fn("cos")
    axis = sin(alpha) * cos(phi) * x + sin(alpha) * sin(phi) * y + cos(alpha) * z
    return cos(theta) * i - 1j * sin(theta) * axis


def rx_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 X)``; a batch of angles gives ``theta.shape + (2, 2)``."""
    return _rot(theta, 1, dtype)


def ry_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 Y)``; batches as :func:`rx_matrix`."""
    return _rot(theta, 2, dtype)


def rz_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 Z)``; batches as :func:`rx_matrix`."""
    return _rot(theta, 3, dtype)


def phase_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    """diag(1, exp(i theta))."""
    o = _Ops(dtype, theta)
    theta = o.c(theta)
    return o.diag(o.stack([o.c(1.0), o.fn("exp")(1j * theta)]))


def u_matrix(theta: Any = 0, phi: Any = 0, lbd: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""OpenQASM U(theta, phi, lambda)."""
    o = _Ops(dtype, theta, phi, lbd)
    theta, phi, lbd = o.c(theta), o.c(phi), o.c(lbd)
    c, s, exp = o.fn("cos")(theta / 2), o.fn("sin")(theta / 2), o.fn("exp")
    return o.stack([
        o.stack([c, -exp(1j * lbd) * s]),
        o.stack([exp(1j * phi) * s, exp(1j * (phi + lbd)) * c]),
    ])


def cu_matrix(theta: Any = 0, phi: Any = 0, lbd: Any = 0, dtype: Optional[str] = None) -> Any:
    o = _Ops(dtype, theta, phi, lbd)
    return o.set_block(o.eye(4), slice(2, None), slice(2, None), u_matrix(theta, phi, lbd, dtype=o.dtype))


def rxx_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 X⊗X)``."""
    return _rot2(theta, 1, dtype)


def ryy_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 Y⊗Y)``."""
    return _rot2(theta, 2, dtype)


def rzz_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta/2 Z⊗Z)``."""
    return _rot2(theta, 3, dtype)


def _controlled_rot(theta: Any, fn: Callable[..., Any], dtype: Optional[str]) -> Any:
    o = _Ops(dtype, theta)
    return o.set_block(o.eye(4), slice(2, None), slice(2, None), fn(theta, dtype=o.dtype))


def crx_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    return _controlled_rot(theta, rx_matrix, dtype)


def cry_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    return _controlled_rot(theta, ry_matrix, dtype)


def crz_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    return _controlled_rot(theta, rz_matrix, dtype)


def cphase_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    o = _Ops(dtype, theta)
    return o.set_block(o.eye(4), 3, 3, o.fn("exp")(1j * o.c(theta)))


def iswap_matrix(theta: Any = 1.0, dtype: Optional[str] = None) -> Any:
    r"""``exp(i theta pi/2 (X⊗X + Y⊗Y)/2)``; ``theta=1`` is the iSWAP."""
    o = _Ops(dtype, theta)
    _, x, y, _ = o.paulis()
    gen = (o.kron(x, x) + o.kron(y, y)) / 2.0
    # gen has eigenvalues {0, ±1}: exp(i a gen) = I + (cos a - 1) gen^2 + i sin a gen
    a = o.c(theta) * (np.pi / 2)
    return o.eye(4) + (o.fn("cos")(a) - 1.0) * (gen @ gen) + 1j * o.fn("sin")(a) * gen


def _square(o: _Ops, unitary: Any) -> Any:
    g = o.c(unitary)
    dim = int(math.isqrt(int(np.prod(tuple(g.shape)))))
    return g.reshape(dim, dim), dim


def exponential_matrix(unitary: Any, theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta G)`` by the matrix exponential."""
    o = _Ops(dtype, unitary, theta)
    g, _ = _square(o, unitary)
    a = -1j * o.c(theta) * g
    return torch.linalg.matrix_exp(a) if o.torch else scipy.linalg.expm(a)


def exp1_matrix(unitary: Any, theta: Any = 0, dtype: Optional[str] = None) -> Any:
    r"""``exp(-i theta G)`` for ``G^2 = I``: cos(theta) I - i sin(theta) G."""
    o = _Ops(dtype, unitary, theta)
    g, dim = _square(o, unitary)
    theta = o.c(theta)
    return o.fn("cos")(theta) * o.eye(dim) - 1j * o.fn("sin")(theta) * g


def rzm_matrix(theta: Any = 0, dtype: Optional[str] = None) -> Any:
    """The diagonal of rz."""
    o = _Ops(dtype, theta)
    theta = o.c(theta)
    exp = o.fn("exp")
    return o.stack([exp(-1j * theta / 2), exp(1j * theta / 2)])


def rzm_diagonal(theta: Any, k: int, dtype: Any) -> Any:
    """Diagonal of ``exp(-i theta/2 Z^{⊗k})`` as a length-2^k vector: numpy
    at full precision for a concrete theta, torch at ``dtype`` for a
    tensor."""
    zs = np.array([(-1) ** bin(i).count("1") for i in range(2**k)])
    if isinstance(theta, torch.Tensor):
        o = _Ops(dtype, theta)
        return torch.exp(-0.5j * o.c(theta) * o.c(zs))
    return np.exp(-0.5j * float(np.asarray(theta)) * zs).astype(np.dtype(str(dtype).replace("torch.", "")))


def su4_matrix(theta: Any, dtype: Optional[str] = None) -> Any:
    """A two-qubit gate from 15 parameters: u gates on each side of an
    XX, YY, ZZ interaction core."""
    o = _Ops(dtype, theta)
    th = theta if o.torch else np.asarray(theta)
    d = o.dtype
    pre0 = u_matrix(th[0], th[1], th[2], dtype=d)
    pre1 = u_matrix(th[3], th[4], th[5], dtype=d)
    post0 = u_matrix(th[9], th[10], th[11], dtype=d)
    post1 = u_matrix(th[12], th[13], th[14], dtype=d)
    core = rxx_matrix(th[6], dtype=d) @ ryy_matrix(th[7], dtype=d) @ rzz_matrix(th[8], dtype=d)
    return o.kron(post0, post1) @ core @ o.kron(pre0, pre1)


def multicontrol_matrix(unitary: Any, ctrl: Sequence[int], dtype: Optional[str] = None) -> Any:
    """Multi-controlled gate, dense; ``ctrl[i]`` in {0, 1} selects the
    control polarity."""
    o = _Ops(dtype, unitary)
    u, dim_u = _square(o, unitary)
    idx = 0
    for c in ctrl:
        idx = idx * 2 + int(c)
    start = idx * dim_u
    block = slice(start, start + dim_u)
    return o.set_block(o.eye(dim_u * 2 ** len(ctrl)), block, block, u)


# ------------------------------------------------------------------
# gate factories
# ------------------------------------------------------------------


def _as_gate(m: Any, name: str) -> Gate:
    dim = int(math.isqrt(int(np.prod(tuple(m.shape)))))
    nq = int(round(math.log2(dim)))
    return Gate(m.reshape((2,) * (2 * nq)), name=name)


class GateF:
    """Factory of a fixed gate: ``GateF("h")() -> Gate``."""

    def __init__(
        self,
        name: str,
        matrix_fn: Optional[Callable[..., Any]] = None,
        n: int = 1,
        ctrl: Optional[List[int]] = None,
    ) -> None:
        self.n = name
        self.name = name
        self._matrix_fn = matrix_fn
        self.nqubits = n
        self.ctrl: List[int] = list(ctrl) if ctrl is not None else []

    def __call__(self, *args: Any, **kws: Any) -> Gate:
        dtype = kws.pop("dtype", None) or config.dtypestr()
        if self._matrix_fn is not None:
            return _as_gate(self._matrix_fn(*args, dtype=dtype, **kws), self.name)
        return Gate(_fixed_tensor(self.name, dtype), name=self.name)

    def matrix(self, *args: Any, **kws: Any) -> Any:
        return self(*args, **kws).matrix()

    def adjoint(self) -> "GateF":
        """The factory of the conjugate transpose, named ``name + "d"``."""
        base = self

        def adj_fn(*args: Any, dtype: Optional[str] = None, **kws: Any) -> Any:
            return base(*args, dtype=dtype, **kws).matrix().T.conj()

        return GateF(self.name + "d", adj_fn, self.nqubits)

    def ided(self, before: bool = True) -> "GateF":
        """An identity wire tensored before (or after) the gate."""
        base = self

        def ided_fn(*args: Any, dtype: Optional[str] = None, **kws: Any) -> Any:
            m = base(*args, dtype=dtype, **kws).matrix()
            o = _Ops(dtype, m)
            return o.kron(o.eye(2), m) if before else o.kron(m, o.eye(2))

        return GateF(("ip" if before else "ia") + self.name, ided_fn, self.nqubits + 1)

    def _with_control(self, prefix: str, on: int) -> "GateF":
        base = self

        def ctrl_fn(*args: Any, dtype: Optional[str] = None, **kws: Any) -> Any:
            m = base(*args, dtype=dtype, **kws).matrix()
            o = _Ops(dtype, m)
            dim = m.shape[0]
            block = slice(dim, None) if on else slice(None, dim)
            return o.set_block(o.eye(2 * dim), block, block, m)

        return GateF(prefix + self.name, ctrl_fn, self.nqubits + 1, ctrl=[on] + self.ctrl)

    def controlled(self) -> "GateF":
        """The gate controlled by one more qubit (active on 1)."""
        return self._with_control("c", 1)

    def ocontrolled(self) -> "GateF":
        """The gate controlled by one more qubit (active on 0)."""
        return self._with_control("o", 0)

    def __repr__(self) -> str:
        return f"GateF({self.name!r})"


class GateVF(GateF):
    """Factory of a parameterized gate: ``GateVF(rx_matrix, "rx")(theta=0.3)``."""

    def __init__(
        self,
        matrix_fn: Callable[..., Any],
        name: str,
        n: int = 1,
        default_params: Optional[dict] = None,
    ) -> None:
        super().__init__(name, matrix_fn, n)
        self.default_params = default_params or {}

    def __call__(self, *args: Any, **kws: Any) -> Gate:
        dtype = kws.pop("dtype", None) or config.dtypestr()
        params = dict(self.default_params)
        params.update(kws)
        return _as_gate(self._matrix_fn(*args, dtype=dtype, **params), self.name)


_VARIABLE_FNS: Dict[str, Tuple[Callable[..., Any], int]] = {
    "r": (rgate_matrix, 1),
    "rx": (rx_matrix, 1),
    "ry": (ry_matrix, 1),
    "rz": (rz_matrix, 1),
    "phase": (phase_matrix, 1),
    "u": (u_matrix, 1),
    "cu": (cu_matrix, 2),
    "rxx": (rxx_matrix, 2),
    "ryy": (ryy_matrix, 2),
    "rzz": (rzz_matrix, 2),
    "crx": (crx_matrix, 2),
    "cry": (cry_matrix, 2),
    "crz": (crz_matrix, 2),
    "cphase": (cphase_matrix, 2),
    "iswap": (iswap_matrix, 2),
    "exp": (exponential_matrix, 0),  # qubits from the generator
    "exp1": (exp1_matrix, 0),
    "exponential": (exponential_matrix, 0),
    "su4": (su4_matrix, 2),
    "multicontrol": (multicontrol_matrix, 0),
}

VARIABLE_ALIASES: Dict[str, str] = {
    "cr": "cphase",
    "cp": "cphase",
    "crr": "cphase",
}


def _build_registry() -> Dict[str, GateF]:
    reg: Dict[str, GateF] = {}
    for name, m in _FIXED_GATES.items():
        reg[name] = GateF(name, None, int(round(math.log2(m.shape[0]))))
    for alias, target in GATE_ALIASES.items():
        reg[alias] = GateF(target, None, reg[target].nqubits)
    for name, (fn, nq) in _VARIABLE_FNS.items():
        reg[name] = GateVF(fn, name, nq)
    for alias, target in VARIABLE_ALIASES.items():
        fn, nq = _VARIABLE_FNS[target]
        reg[alias] = GateVF(fn, target, nq)
    return reg


#: every gate name and alias -> its factory
GATES: Dict[str, GateF] = _build_registry()

#: names of the gates that take no parameters
FIXED_GATE_NAMES = list(_FIXED_GATES) + list(GATE_ALIASES)
#: names of the parameterized gates
VARIABLE_GATE_NAMES = list(_VARIABLE_FNS) + list(VARIABLE_ALIASES)


def get_gate(name: str) -> GateF:
    """The factory registered under ``name`` (any case)."""
    name = name.lower()
    if name not in GATES:
        raise KeyError(f"unknown gate {name!r}")
    return GATES[name]


def __getattr__(attr: str) -> Any:
    """``gates.h``, ``gates.rx`` and ``gates.rx_gate`` name the factories."""
    key = attr[: -len("_gate")] if attr.endswith("_gate") else attr
    if key in GATES:
        return GATES[key]
    raise AttributeError(f"module 'gates' has no attribute {attr!r}")


def _numpy(a: Any) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def matrix_for_gate(gate: Gate) -> np.ndarray:
    """The dense numpy matrix of a Gate."""
    return _numpy(gate.matrix())


def batched_unitary(thetas: Any, nqubits: int = 1) -> Any:
    """Unitaries exp(i H(theta)) from parameter rows: each row, cast to the
    complex dtype and repeated to fill d x d, gives the hermitian H.  A row
    gives one (d, d) matrix, a (B, k) batch (B, d, d); numpy in, numpy out,
    a tensor keeps its device and autograd."""
    o = _Ops(None, thetas)
    th = o.c(thetas)
    dim = 2**nqubits
    need = dim * dim
    tile = (1,) * (th.ndim - 1) + (-(-need // th.shape[-1]),)
    th = th.repeat(*tile) if o.torch else np.tile(th, tile)
    m = th[..., :need].reshape(tuple(th.shape[:-1]) + (dim, dim))

    def dag(a: Any) -> Any:
        return a.transpose(-1, -2).conj() if o.torch else np.swapaxes(a, -1, -2).conj()

    h = (m + dag(m)) / 2.0 + 1j * (m - dag(m)) / 2.0
    h = (h + dag(h)) / 2.0
    e, v = o.fn("linalg").eigh(h)
    return (v * o.fn("exp")(1j * e)[..., None, :]) @ dag(v)


def pauli_gates(dtype: Optional[str] = None) -> list:
    """[I, X, Y, Z] as numpy matrices of the complex dtype."""
    return list(_Ops(dtype).paulis())


def meta_gate() -> None:
    """No-op: the gate matrices are built at each call with the live dtype."""


def meta_vgate() -> None:
    """No-op, as :func:`meta_gate`."""


def bmatrix(a: Any) -> str:
    r"""LaTeX bmatrix text of a 2D array."""
    a = _numpy(a)
    if a.ndim > 2:
        raise ValueError("bmatrix can at most display two dimensions")
    lines = np.array2string(a, max_line_width=10**8).replace("[", "").replace("]", "").splitlines()
    body = "\\\\\n".join("    " + " & ".join(ln.split()) for ln in lines if ln.strip())
    return "\\begin{bmatrix}\n" + body + "\n\\end{bmatrix}"


def get_u_parameter(m: Any) -> Tuple[float, float, float]:
    """(theta, phi, lbd) of the u gate from a single-qubit unitary."""
    m = _numpy(m).reshape(2, 2)
    u = np.linalg.det(m) ** (-0.5) * m  # SU(2)
    theta = 2 * np.arctan2(abs(u[1, 0]), abs(u[0, 0]))
    phi_plus_lam = 2 * np.angle(u[1, 1])
    phi_minus_lam = 2 * np.angle(u[1, 0])
    return float(theta), float((phi_plus_lam + phi_minus_lam) / 2.0), float((phi_plus_lam - phi_minus_lam) / 2.0)


def rgate_theoretical(theta: float = 0, alpha: float = 0, phi: float = 0) -> Gate:
    r"""The r gate by an explicit matrix exponential (complex128 numpy)."""
    x, y, z = (p.astype(complex) for p in (_x_matrix, _y_matrix, _z_matrix))
    h = np.sin(alpha) * np.cos(phi) * x + np.sin(alpha) * np.sin(phi) * y + np.cos(alpha) * z
    return Gate(scipy.linalg.expm(-1j * theta * h), name="r")


def random_single_qubit_gate(generator: Optional[torch.Generator] = None) -> Gate:
    """An r gate of three angles uniform in [0, 2 pi) (from ``generator``
    if given)."""
    theta, alpha, phi = (torch.rand(3, dtype=torch.float64, generator=generator) * 2 * np.pi).tolist()
    return Gate(rgate_matrix(theta, alpha, phi), name="R1Q")


def random_two_qubit_gate(generator: Optional[torch.Generator] = None) -> Gate:
    """A Haar-random two-qubit gate (complex64): the QR of a complex
    Gaussian matrix with the phases of R's diagonal divided out."""
    z = torch.randn(4, 4, dtype=torch.complex128, generator=generator).numpy()
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    u = (q * (d / np.abs(d))).astype(np.complex64)
    return Gate(u.reshape(2, 2, 2, 2), name="R2Q")


def any_gate(unitary: Any, name: str = "any") -> Gate:
    """A dense unitary as a Gate."""
    return Gate(unitary, name=name)


def exponential_gate_unity(unitary: Any, theta: Any, half: bool = False, name: str = "none") -> Gate:
    r"""exp(-i theta U) for U^2 = I, as cos(theta) I - i sin(theta) U
    (theta/2 with ``half``)."""
    return Gate(exp1_matrix(unitary, theta / 2.0 if half else theta), name=name)


def exponential_gate(unitary: Any, theta: Any, name: str = "none") -> Gate:
    r"""exp(-i theta G) by the matrix exponential."""
    return Gate(exponential_matrix(unitary, theta), name=name)


def diagonal_gate(diag: Any, name: str = "diagonal") -> Gate:
    """The gate of a diagonal vector."""
    return Gate(torch.diag(diag) if isinstance(diag, torch.Tensor) else np.diag(np.asarray(diag)), name=name)


def rzm_gate(theta: Any = 0) -> Gate:
    """The gate of :func:`rzm_matrix`: the diagonal of rz, a 2-vector."""
    return Gate(rzm_matrix(theta), name="rzm")


def cmz_gate(theta: Any = 0) -> Gate:
    """The phase exp(-i theta) on |11>, as a (2, 2, 2, 2) complex128 numpy
    tensor (the angle's real part, as a number)."""
    diag = np.exp(-1j * float(np.real(_numpy(theta))) * np.array([0.0, 0.0, 0.0, 1.0]))
    return Gate(np.diag(diag).reshape(2, 2, 2, 2), name="cmz")


def mpo_gate(mpo: Any, name: str = "mpo") -> Any:
    """The MPO itself (a pass-through constructor)."""
    return mpo
