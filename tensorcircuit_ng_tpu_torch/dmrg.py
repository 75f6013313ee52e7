"""Two-site DMRG ground states on MPS/MPO tensors, in torch.

Counterpart of ``tensorcircuit_ng_tpu/dmrg.py``: nearest-neighbour plus
on-site MPOs built on the host (numpy, as the JAX package builds them),
left and right environments, the dense two-site effective Hamiltonian
((l d d r)^2) and its ``eigh``, and the SVD back to the bond budget.  The
sweeps run in complex128 on ``device`` (the configured device by default,
so the card); the random initial state takes the same
``np.random.default_rng(seed)`` draws as the JAX package's, so both start
from the same MPS.  The site tensors (l, d, r) it returns feed
``MPSCircuit(tensors=...)``, ``FiniteMPS`` and ``Circuit(mps_inputs=...)``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config

__all__ = ["nn_mpo", "xxz_mpo", "dmrg", "mps_energy", "mps_overlap"]

_CDT = torch.complex128


def nn_mpo(
    n: int,
    bond_terms: Sequence[Tuple[np.ndarray, np.ndarray, float]],
    site_terms: Optional[Sequence[Tuple[np.ndarray, Any]]] = None,
    d: int = 2,
) -> List[np.ndarray]:
    """MPO of H = Σ_i Σ_t w_t A_t^i B_t^{i+1} + Σ_i Σ_s c_s(i) O_s^i, site
    tensors (l, out, in, r); a ``site_terms`` coefficient may be a callable
    of the site index."""
    site_terms = site_terms or []
    D = len(bond_terms) + 2
    eye = np.eye(d)

    def w_at(i: int) -> np.ndarray:
        w = np.zeros((D, d, d, D), dtype=complex)
        w[0, :, :, 0] = eye
        w[D - 1, :, :, D - 1] = eye
        for t, (a, b, wt) in enumerate(bond_terms):
            w[0, :, :, 1 + t] = wt * a
            w[1 + t, :, :, D - 1] = b
        for op, coef in site_terms:
            w[0, :, :, D - 1] += (coef(i) if callable(coef) else coef) * op
        return w

    ws = [w_at(i) for i in range(n)]
    ws[0] = ws[0][:1]
    ws[-1] = ws[-1][:, :, :, -1:]
    return ws


def xxz_mpo(n: int, delta: float = 1.0, stag: float = 0.0) -> List[np.ndarray]:
    """H = Σ (XX + YY + Δ ZZ) + stag Σ (-1)^i Z."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    z = np.diag([1.0, -1.0]).astype(complex)
    return nn_mpo(n, [(x, x, 1.0), (y, y, 1.0), (z, z, delta)], [(z, lambda i: stag * (-1.0) ** i)])


def _on(ts: Sequence[Any], device: torch.device) -> List[torch.Tensor]:
    return [(t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))).to(device=device, dtype=_CDT)
            for t in ts]


def _ones(device: torch.device) -> torch.Tensor:
    return torch.ones((1, 1, 1), dtype=_CDT, device=device)


def _left_env(envs: List[Any], a: List[torch.Tensor], w: List[torch.Tensor], i: int) -> torch.Tensor:
    """L_i from L_{i-1}: site i-1 contracted (a: (l, d, r))."""
    L = envs[i - 1] if i > 0 else _ones(a[0].device)
    t = a[i - 1]
    tmp = torch.einsum("abc,apr->bcpr", L, t)
    tmp = torch.einsum("bcpr,bqpw->cqrw", tmp, w[i - 1])
    return torch.einsum("cqrw,cqs->rws", tmp, t.conj())


def _right_env(envs: List[Any], a: List[torch.Tensor], w: List[torch.Tensor], i: int, n: int) -> torch.Tensor:
    R = envs[i + 1] if i < n - 1 else _ones(a[0].device)
    t = a[i + 1]
    tmp = torch.einsum("abc,lpa->lpbc", R, t)
    tmp = torch.einsum("lpbc,wqpb->lwqc", tmp, w[i + 1])
    return torch.einsum("lwqc,mqc->lwm", tmp, t.conj())


def dmrg(
    mpo: List[Any],
    chi: int = 16,
    sweeps: int = 4,
    init: Optional[List[Any]] = None,
    tol: float = 1e-9,
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
) -> Tuple[float, List[torch.Tensor]]:
    """Two-site DMRG: (energy, MPS site tensors (l, d, r), complex128 on
    ``device``)."""
    device = config.resolve_device(device)
    n = len(mpo)
    d = mpo[0].shape[1]
    rng = np.random.default_rng(seed)
    if init is None:
        host = []
        bl = 1
        for i in range(n):
            br = min(chi, d ** min(i + 1, n - i - 1), bl * d)
            host.append(rng.normal(size=(bl, d, br)) + 0j)
            bl = br
        a = _on(host, device)
    else:
        a = _on(init, device)
    w = _on(mpo, device)
    # right-canonicalize
    for i in range(n - 1, 0, -1):
        l, p, r = a[i].shape
        q, rr = torch.linalg.qr(a[i].reshape(l, p * r).mH)
        a[i] = q.mH.reshape(-1, p, r)
        a[i - 1] = torch.einsum("lpr,rm->lpm", a[i - 1], rr.mH)

    Ls: List[Any] = [None] * n
    Rs: List[Any] = [None] * n
    Ls[0] = _ones(device)
    Rs[n - 1] = _ones(device)
    for i in range(n - 2, -1, -1):
        Rs[i] = _right_env(Rs, a, w, i, n)

    energy = 0.0
    for _ in range(sweeps):
        for i in range(n - 1):
            energy, a = _two_site_update(a, w, Ls, Rs, i, chi, to_right=True)
            Ls[i + 1] = _left_env(Ls, a, w, i + 1)
        for i in range(n - 2, -1, -1):
            energy, a = _two_site_update(a, w, Ls, Rs, i, chi, to_right=False)
            Rs[i] = _right_env(Rs, a, w, i, n)
    return float(energy), a


def _two_site_update(a, mpo, Ls, Rs, i, chi, to_right):
    L, R = Ls[i], Rs[i + 1]
    w1, w2 = mpo[i], mpo[i + 1]
    l, d, r = a[i].shape[0], a[i].shape[1], a[i + 1].shape[2]
    # the effective two-site H as a dense (l d d r)^2 matrix; heff's axes:
    # (a=ket-l, b=bra-l, p=out1, q=in1, s=out2, t=in2, c=ket-r, f=bra-r);
    # rows = bra (b, p, s, f), columns = ket (a, q, t, c)
    heff = torch.einsum("awb,wpqx->abpqx", L, w1)
    heff = torch.einsum("abpqx,xsty->abpqsty", heff, w2)
    heff = torch.einsum("abpqsty,cyf->abpqstcf", heff, R)
    h = heff.permute(1, 2, 4, 7, 0, 3, 5, 6).reshape(l * d * d * r, l * d * d * r)
    h = (h + h.mH) / 2.0
    vals, vecs = torch.linalg.eigh(h)
    e0 = float(vals[0].real)
    m = vecs[:, 0].reshape(l * d, d * r)
    u, s, vh = torch.linalg.svd(m, full_matrices=False)
    keep = min(chi, int(torch.sum(s > 1e-12)) or 1)
    u, s, vh = u[:, :keep], s[:keep], vh[:keep]
    s = (s / torch.linalg.vector_norm(s)).to(_CDT)
    if to_right:
        a[i] = u.reshape(l, d, keep)
        a[i + 1] = (s[:, None] * vh).reshape(keep, d, r)
    else:
        a[i] = (u * s[None, :]).reshape(l, d, keep)
        a[i + 1] = vh.reshape(keep, d, r)
    return e0, a


def mps_energy(a: List[Any], mpo: List[Any], device: Union[None, str, torch.device] = None) -> float:
    """⟨psi|H|psi⟩ of a normalized MPS, on ``device``."""
    device = config.resolve_device(device)
    a, w = _on(a, device), _on(mpo, device)
    L = _ones(device)
    for t, wi in zip(a, w):
        tmp = torch.einsum("abc,apr->bcpr", L, t)
        tmp = torch.einsum("bcpr,bqpw->cqrw", tmp, wi)
        L = torch.einsum("cqrw,cqs->rws", tmp, t.conj())
    return float(L.reshape(-1)[0].real)


def mps_overlap(a: List[Any], b: List[Any], device: Union[None, str, torch.device] = None) -> complex:
    """⟨a|b⟩ of two (l, d, r) MPS by transfer contraction, on ``device``."""
    device = config.resolve_device(device)
    a, b = _on(a, device), _on(b, device)
    E = torch.ones((1, 1), dtype=_CDT, device=device)
    for ta, tb in zip(a, b):
        E = torch.einsum("xy,xpa,ypb->ab", E, ta.conj(), tb)
    return complex(E.reshape(-1)[0])
