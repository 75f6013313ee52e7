"""Quantum channels: Kraus sets and representation transforms.

Counterpart of ``tensorcircuit_ng_tpu/ops/channels.py``.  A channel is a
:class:`KrausList` of :class:`Gate` whose tensors are dense matrices; the
Monte-Carlo engine (``Circuit.unitary_kraus`` / ``general_kraus``) and the
exact one (``DMCircuit``) both take them.  As in ``ops/gates.py``, float
parameters give numpy Kraus operators, and a tensor parameter gives tensors
on its device that keep its autograd, so a noise strength can be
differentiated.  ``choi_to_kraus`` is a host numpy ``eigh``.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import config
from .gates import Gate

Tensor = Any

__all__ = [
    "KrausList",
    "depolarizingchannel",
    "generaldepolarizingchannel",
    "isotropicdepolarizingchannel",
    "amplitudedampingchannel",
    "phasedampingchannel",
    "resetchannel",
    "thermalrelaxationchannel",
    "kraus_to_super",
    "kraus_to_super_gate",
    "super_to_choi",
    "choi_to_super",
    "kraus_to_choi",
    "choi_to_kraus",
    "super_to_kraus",
    "kraus_identity_check",
    "is_unitary_kraus",
    "composedkraus",
    "reshuffle",
    "is_hermitian_matrix",
    "krausgate_to_krausmatrix",
    "krausmatrix_to_krausgate",
    "evol_kraus",
    "evol_superop",
    "check_rep_transformation",
    "CHANNEL_NAMES",
]

_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Y = np.array([[0.0, -1.0j], [1.0j, 0.0]])
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])
_P0 = np.array([[1.0, 0.0], [0.0, 0.0]])
_P1 = np.array([[0.0, 0.0], [0.0, 1.0]])
_S01 = np.array([[0.0, 1.0], [0.0, 0.0]])
_S10 = np.array([[0.0, 0.0], [1.0, 0.0]])


class KrausList(list):
    """List of Kraus ``Gate``s with channel metadata."""

    def __init__(self, iterable: Sequence[Gate], name: str = "channel", is_unitary: bool = False):
        super().__init__(iterable)
        self.name = name
        self.is_unitary = is_unitary


def _ref(*vals: Any) -> Optional[torch.Tensor]:
    """The first tensor among ``vals`` (None when all are concrete)."""
    return next((v for v in vals if isinstance(v, torch.Tensor)), None)


class _Coef:
    """Real coefficients times constant matrices: numpy when every parameter
    is concrete, torch on the first tensor parameter's device otherwise."""

    def __init__(self, *vals: Any) -> None:
        self.ref = _ref(*vals)
        self.rdt = config.rdtypestr()

    def real(self, v: Any) -> Any:
        if self.ref is None:
            return np.asarray(v).astype(np.dtype(self.rdt))
        rdt = getattr(torch, self.rdt)
        if isinstance(v, torch.Tensor):
            return v.to(device=self.ref.device, dtype=rdt)
        return torch.as_tensor(v, dtype=rdt, device=self.ref.device)

    def sqrt(self, v: Any) -> Any:
        return torch.sqrt(v) if isinstance(v, torch.Tensor) else np.sqrt(v)

    def mat(self, m: np.ndarray) -> Any:
        if self.ref is None:
            return m
        return config.device_constant(m, self.ref.device, config.torch_dtype())


def _g(m: Any, name: str) -> Gate:
    """A Gate of the configured complex dtype: numpy stays numpy, a tensor
    keeps its device and autograd."""
    if isinstance(m, torch.Tensor):
        return Gate(m.to(config.torch_dtype()), name=name)
    return Gate(np.asarray(m).astype(np.dtype(config.dtypestr())), name=name)


def depolarizingchannel(px: Any, py: Any, pz: Any) -> KrausList:
    r"""Single-qubit Pauli channel: K = {√(1-p)I, √px X, √py Y, √pz Z}."""
    o = _Coef(px, py, pz)
    i = o.sqrt(o.real(1.0 - px - py - pz)) * o.mat(np.eye(2))
    x = o.sqrt(o.real(px)) * o.mat(_X)
    y = o.sqrt(o.real(py)) * o.mat(_Y)
    z = o.sqrt(o.real(pz)) * o.mat(_Z)
    return KrausList(
        [_g(i, "dep_i"), _g(x, "dep_x"), _g(y, "dep_y"), _g(z, "dep_z")],
        name="depolarizing",
        is_unitary=True,
    )


def generaldepolarizingchannel(p: Any, num_qubits: int = 1) -> KrausList:
    r"""n-qubit depolarizing channel over all 4^n Pauli strings: ``p`` is a
    scalar (each non-identity string's probability) or the 4^n - 1
    probabilities in order."""
    strings: List[np.ndarray] = [np.eye(1)]
    for _ in range(num_qubits):
        strings = [np.kron(s, pm) for s in strings for pm in (np.eye(2), _X, _Y, _Z)]
    m = len(strings)
    o = _Coef(p)
    if isinstance(p, torch.Tensor) and p.ndim == 0 or np.isscalar(p):
        pv = o.real(p)
        probs = [1.0 - (m - 1) * pv] + [pv] * (m - 1)
    elif o.ref is not None:
        pv = o.real(p)
        probs = [1.0 - torch.sum(pv)] + list(pv)
    else:
        probs = [1.0 - float(np.sum(p))] + list(p)
    ops = [o.sqrt(pr if o.ref is None else o.real(pr)) * o.mat(s) for pr, s in zip(probs, strings)]
    return KrausList(
        [_g(op, f"gdep_{k}") for k, op in enumerate(ops)],
        name="generaldepolarizing",
        is_unitary=True,
    )


def isotropicdepolarizingchannel(p: Any, num_qubits: int = 1) -> KrausList:
    """Uniform depolarizing with total error probability ``p``."""
    m = 4**num_qubits
    return generaldepolarizingchannel(p / (m - 1), num_qubits)


def amplitudedampingchannel(gamma: Any, p: Any = 1.0) -> KrausList:
    r"""Generalized amplitude damping: damping ``gamma``, a fraction ``p``
    towards |0> and 1 - p towards |1>."""
    o = _Coef(gamma, p)
    g, pp = o.real(gamma), o.real(p)
    k0 = o.sqrt(pp) * o.mat(_P0) + o.sqrt(pp) * o.mat(_P1) * o.sqrt(1 - g)
    k1 = o.sqrt(pp) * o.sqrt(g) * o.mat(_S01)
    k2 = o.sqrt(1 - pp) * (o.sqrt(1 - g) * o.mat(_P0) + o.mat(_P1))
    k3 = o.sqrt(1 - pp) * o.sqrt(g) * o.mat(_S10)
    return KrausList(
        [_g(k0, "ad_0"), _g(k1, "ad_1"), _g(k2, "ad_2"), _g(k3, "ad_3")],
        name="amplitudedamping",
    )


def phasedampingchannel(gamma: Any) -> KrausList:
    o = _Coef(gamma)
    g = o.real(gamma)
    k0 = o.mat(_P0) + o.sqrt(1 - g) * o.mat(_P1)
    k1 = o.sqrt(g) * o.mat(_P1)
    return KrausList([_g(k0, "pd_0"), _g(k1, "pd_1")], name="phasedamping")


def resetchannel() -> KrausList:
    return KrausList([_g(_P0, "reset_0"), _g(_S01, "reset_1")], name="reset")


def thermalrelaxationchannel(
    t1: float,
    t2: float,
    time: float,
    method: str = "general",
    excitedstatepopulation: float = 0.0,
) -> KrausList:
    r"""T1/T2 thermal relaxation (host floats): a closed-form Kraus set for
    t2 <= t1 (``method`` "general", "auto", "bychoi" or "bykraus"), else
    the Choi construction, valid up to t2 <= 2 t1."""
    t1, t2, time = float(t1), float(t2), float(time)
    if t2 > 2 * t1:
        raise ValueError("t2 cannot exceed 2*t1")
    p_reset = 1.0 - math.exp(-time / t1)
    exp_t2 = math.exp(-time / t2)
    p1 = excitedstatepopulation
    if method.lower() in ("general", "auto", "bychoi", "bykraus") and t2 <= t1:
        pz = max(0.0, (1 - p_reset) * (1 - exp_t2 / max(1e-300, math.exp(-time / t1))) / 2)
        pid = 1 - pz - p_reset
        ks = [
            math.sqrt(max(0.0, pid)) * np.eye(2),
            math.sqrt(max(0.0, pz)) * _Z,
            math.sqrt(max(0.0, p_reset * (1 - p1))) * _P0,
            math.sqrt(max(0.0, p_reset * (1 - p1))) * _S01,
            math.sqrt(max(0.0, p_reset * p1)) * _S10,
            math.sqrt(max(0.0, p_reset * p1)) * _P1,
        ]
        ks = [k for k in ks if np.abs(k).max() > 0]
        return KrausList([_g(k, f"tr_{i}") for i, k in enumerate(ks)], name="thermalrelaxation")
    # C = Σ_ij |i><j| ⊗ E(|i><j|)
    c = np.zeros((4, 4), dtype=complex)
    c[0:2, 0:2] = np.diag([1 - p1 * p_reset, p1 * p_reset])
    c[2:4, 2:4] = np.diag([(1 - p1) * p_reset, 1 - (1 - p1) * p_reset])
    c[0, 3] = exp_t2
    c[3, 0] = exp_t2
    return choi_to_kraus(c.astype(np.dtype(config.dtypestr())), name="thermalrelaxation")


# ------------------------------------------------------------------
# representation transforms
# ------------------------------------------------------------------


def _mats(kraus: Sequence[Any]) -> List[Tensor]:
    """Each operator as a (dim, dim) matrix of the configured dtype (numpy
    stays numpy, a tensor keeps its device and autograd)."""
    out = []
    for k in kraus:
        m = k.matrix() if isinstance(k, Gate) else k
        if not hasattr(m, "ndim"):
            m = np.asarray(m)
        if m.ndim != 2:
            dim = int(math.isqrt(int(np.prod(tuple(m.shape)))))
            m = m.reshape(dim, dim)
        out.append(m.to(config.torch_dtype()) if isinstance(m, torch.Tensor) else m.astype(config.np_dtype()))
    return out


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(ms: Sequence[Any]) -> List[Tensor]:
    """All numpy, or all tensors on the first tensor's device."""
    ref = _ref(*ms)
    if ref is None:
        return list(ms)
    return [m if isinstance(m, torch.Tensor) else config.device_constant(m, ref.device, ref.dtype) for m in ms]


def _kron(a: Tensor, b: Tensor) -> Tensor:
    return torch.kron(a, b) if isinstance(a, torch.Tensor) else np.kron(a, b)


def _permute(t: Tensor, order: Sequence[int]) -> Tensor:
    return t.permute(*order) if isinstance(t, torch.Tensor) else t.transpose(*order)


def kraus_to_super(kraus: Sequence[Any]) -> Tensor:
    r"""The superoperator S = Σ_k K_k ⊗ conj(K_k), acting on vec(ρ) row-major
    (ρ_ij at i·d + j): vec(ρ') = S vec(ρ)."""
    s = None
    for m in _like(_mats(kraus)):
        term = _kron(m, m.conj())
        s = term if s is None else s + term
    return s


def kraus_to_super_gate(kraus: Sequence[Any]) -> Tensor:
    """Same as :func:`kraus_to_super`."""
    return kraus_to_super(kraus)


def super_to_choi(s: Tensor) -> Tensor:
    r"""Reshuffle a superoperator to the Choi matrix
    C_{(i a),(j b)} = S_{(a b),(i j)}, C = Σ_ij |i><j| ⊗ E(|i><j|)."""
    d2 = s.shape[0]
    d = math.isqrt(int(d2))
    return _permute(s.reshape(d, d, d, d), (2, 0, 3, 1)).reshape(d2, d2)


def choi_to_super(c: Tensor) -> Tensor:
    d2 = c.shape[0]
    d = math.isqrt(int(d2))
    return _permute(c.reshape(d, d, d, d), (1, 3, 0, 2)).reshape(d2, d2)


def kraus_to_choi(kraus: Sequence[Any]) -> Tensor:
    c = None
    for m in _like(_mats(kraus)):
        v = m.T.reshape(-1, 1)  # v_{(i,a)} = K_{a i}
        term = v @ v.T.conj()
        c = term if c is None else c + term
    return c


def choi_to_kraus(c: Tensor, truncation_rules: Optional[dict] = None, name: str = "channel") -> KrausList:
    """Kraus operators from the eigendecomposition of the Choi matrix, on
    the host (numpy ``eigh``; eigenvalues above ``max_singular_values_eps``,
    1e-10 by default, largest first)."""
    c = _host(c)
    d2 = c.shape[0]
    d = math.isqrt(int(d2))
    e, v = np.linalg.eigh(c)
    eps = 1e-10 if truncation_rules is None else truncation_rules.get("max_singular_values_eps", 1e-10)
    ks = []
    for i in range(d2 - 1, -1, -1):
        if e[i] > eps:
            ks.append(_g(math.sqrt(float(e[i])) * v[:, i].reshape(d, d).T, f"{name}_{len(ks)}"))
    if not ks:
        ks = [_g(np.zeros((d, d)), f"{name}_0")]
    return KrausList(ks, name=name)


def super_to_kraus(s: Tensor) -> KrausList:
    return choi_to_kraus(super_to_choi(s))


def kraus_identity_check(kraus: Sequence[Any], atol: float = 1e-5) -> None:
    """Assert Σ K†K = I (the channel preserves the trace)."""
    ms = [_host(m) for m in _mats(kraus)]
    acc = sum(m.T.conj() @ m for m in ms)
    np.testing.assert_allclose(acc, np.eye(ms[0].shape[0]), atol=atol)


single_qubit_kraus_identity_check = kraus_identity_check


def is_unitary_kraus(kraus: Sequence[Any], atol: float = 1e-8) -> bool:
    """True if every Kraus operator is proportional to a unitary."""
    for m in _mats(kraus):
        mm = _host(m.T.conj() @ m)
        lam = np.trace(mm) / mm.shape[0]
        if not np.allclose(mm, lam * np.eye(mm.shape[0]), atol=atol):
            return False
    return True


def composedkraus(kraus1: KrausList, kraus2: KrausList) -> KrausList:
    """Channel composition: every product a_i b_j (kraus1's after kraus2's)."""
    out = []
    for a in kraus1:
        for b in kraus2:
            ma, mb = _like([a.matrix(), b.matrix()])
            out.append(_g(ma @ mb, f"{a.name}@{b.name}"))
    return KrausList(
        out,
        name=f"{getattr(kraus1, 'name', 'k1')}∘{getattr(kraus2, 'name', 'k2')}",
        is_unitary=getattr(kraus1, "is_unitary", False) and getattr(kraus2, "is_unitary", False),
    )


def reshuffle(op: Tensor, order: Sequence[int]) -> Tensor:
    """Reorder the (out, out, in, in) legs of a d0^2 x d1^2 matrix."""
    d0 = math.isqrt(int(op.shape[0]))
    d1 = math.isqrt(int(op.shape[1]))
    shape = (d0, d0, d1, d1)
    t = _permute(op.reshape(shape), tuple(order))
    return t.reshape(shape[order[0]] * shape[order[1]], shape[order[2]] * shape[order[3]])


def is_hermitian_matrix(mat: Tensor, rtol: float = 1e-8, atol: float = 1e-5) -> bool:
    """True if ``mat`` is a square Hermitian matrix."""
    mat = _host(mat)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        return False
    return bool(np.allclose(mat, mat.conj().T, rtol=rtol, atol=atol))


def krausgate_to_krausmatrix(kraus_list: Sequence[Any]) -> List[Tensor]:
    """Kraus operators as Gates -> dense matrices."""
    return _mats(kraus_list)


def krausmatrix_to_krausgate(kraus_list: Sequence[Tensor]) -> List[Gate]:
    """Kraus operators as matrices -> Gates."""
    if not kraus_list or isinstance(kraus_list[0], Gate):
        return list(kraus_list)
    return [_g(k if isinstance(k, torch.Tensor) else np.asarray(k), f"kraus_{i}") for i, k in enumerate(kraus_list)]


def evol_kraus(density_matrix: Tensor, kraus_list: Sequence[Any]) -> Tensor:
    r"""ρ' = Σ_k K_k ρ K_k†: a tensor on ρ's device (keeping autograd) when
    ρ or an operator is a tensor, numpy otherwise."""
    ms = _like([density_matrix] + _mats(kraus_list))
    rho, ms = ms[0], ms[1:]
    if isinstance(rho, torch.Tensor) and not rho.is_complex():
        rho = rho.to(config.torch_dtype())
    out = None
    for k in ms:
        if isinstance(k, torch.Tensor):
            k = k.to(rho.dtype)
        term = k @ rho @ k.conj().T
        out = term if out is None else out + term
    return out


def evol_superop(density_matrix: Tensor, superop: Tensor) -> Tensor:
    """ρ' from ``superop`` in :func:`kraus_to_super`'s convention:
    vec(ρ') = S vec(ρ), vec row-major."""
    rho, s = _like([density_matrix, superop])
    d = rho.shape[0]
    return (s @ rho.reshape(-1, 1)).reshape(d, d)


def check_rep_transformation(kraus: Sequence[Any], density_matrix: Tensor, verbose: bool = False) -> None:
    """Assert that the Kraus, Choi and superoperator forms agree (on ρ too)."""
    choi = kraus_to_choi(kraus)
    kraus2 = choi_to_kraus(choi)
    choi2 = kraus_to_choi(kraus2)
    if verbose:  # pragma: no cover
        print("kraus:", kraus)
        print("kraus_new:", kraus2)
    superop = kraus_to_super(kraus)
    np.testing.assert_allclose(_host(superop), _host(choi_to_super(choi)), atol=1e-5)
    kraus_identity_check(kraus2)
    np.testing.assert_allclose(_host(choi), _host(choi2), atol=1e-5)
    dm1 = _host(evol_kraus(density_matrix, kraus))
    np.testing.assert_allclose(dm1, _host(evol_kraus(density_matrix, kraus2)), atol=1e-5)
    np.testing.assert_allclose(dm1, _host(evol_superop(density_matrix, superop)), atol=1e-5)


#: channel factories by name, for the circuits' channel methods
CHANNEL_NAMES = {
    "depolarizing": depolarizingchannel,
    "generaldepolarizing": generaldepolarizingchannel,
    "isotropicdepolarizing": isotropicdepolarizingchannel,
    "amplitudedamping": amplitudedampingchannel,
    "phasedamping": phasedampingchannel,
    "reset": resetchannel,
    "thermalrelaxation": thermalrelaxationchannel,
}
