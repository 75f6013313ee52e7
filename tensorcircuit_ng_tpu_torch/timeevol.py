"""Time evolution: Krylov/Lanczos, ``expm_multiply``, exact
diagonalization, ODE integration and the Chebyshev expansion.

Counterpart of ``tensorcircuit_ng_tpu/timeevol.py``.  Every engine takes
the Hamiltonian as a dense matrix, a sparse COO tensor
(:func:`quantum.PauliStringSum2COO`, on the state's device) or a
matrix-vector product (a callable, a :class:`quantum.LinearOperator`), and
computes on the state's device in its dtype.  The JAX package's
``lax.scan``/``fori_loop`` bodies are Python loops here, in the same order
of operations.  The ODE engine is the Dormand-Prince 5(4) step and step
controller of ``jax.experimental.ode.odeint`` (the JAX package's default;
``rtol = atol = 1.4e-7`` on the real and imaginary planes), written in
torch: its gradient is backpropagation through the steps it took, where the
JAX package's is the continuous adjoint, and the two agree to the
tolerance.  ``ode_backend="diffrax"`` is no route here (diffrax is JAX).
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config
from .backend import backend as K
from .core import linalg, statevec
from .quantum import aslinearoperator

Tensor = Any

__all__ = [
    "lanczos_iteration_scan",
    "lanczos_iteration",
    "krylov_evol",
    "hamiltonian_evol",
    "hamiltonian_evol_real",
    "ed_evol",
    "expm_multiply",
    "expm_multiply_evol",
    "estimate_expm_multiply_parameters",
    "ode_evol_local",
    "ode_evol_global",
    "evol_local",
    "evol_global",
    "chebyshev_evol",
    "estimate_k",
    "estimate_M",
    "estimate_spectral_bounds",
]


def _mvp_of(h: Any) -> Callable[[torch.Tensor], torch.Tensor]:
    """``h`` as a product; a COO matrix is converted once to CSR, whose
    row-wise product is the faster on both devices (an engine takes tens
    of products)."""
    if K.is_sparse(h) and h.layout == torch.sparse_coo:
        with warnings.catch_warnings():  # torch calls its CSR support "beta"
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
            h = h.to_sparse_csr()
    return aslinearoperator(h)


def _state(psi0: Any) -> torch.Tensor:
    return psi0 if isinstance(psi0, torch.Tensor) else torch.as_tensor(np.asarray(psi0), device=config.resolve_device())


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype if dtype.is_complex else dtype


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(dtype, dtype)


def _times(tlist: Any, like: torch.Tensor) -> torch.Tensor:
    if isinstance(tlist, torch.Tensor):
        return tlist.to(like.device)
    return torch.as_tensor(np.asarray(tlist), device=like.device)


def _each_time(one: Callable[[torch.Tensor], Any], tlist: torch.Tensor) -> Any:
    """``one`` at each time of a 1-d ``tlist`` stacked, or at a 0-d one."""
    if tlist.dim() == 0:
        return one(tlist)
    outs = [one(t) for t in tlist]
    return torch.stack(outs)


# ------------------------------------------------------------------
# Lanczos / Krylov
# ------------------------------------------------------------------


def lanczos_iteration_scan(
    hmvp: Callable[[torch.Tensor], torch.Tensor], psi0: torch.Tensor, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """m Lanczos steps: ``(T [m, m] real tridiagonal, V [m, dim])``; no
    early stop (a breakdown continues with zero vectors)."""
    dtype = psi0.dtype
    v0 = psi0 / torch.linalg.vector_norm(psi0)
    v_prev, v_cur = torch.zeros_like(v0), v0
    beta_prev = torch.zeros((), dtype=_real_dtype(dtype), device=psi0.device)
    alphas, betas, vs = [], [], []
    for _ in range(m):
        w = hmvp(v_cur)
        alpha = torch.real(torch.vdot(v_cur, w))
        w = w - alpha.to(dtype) * v_cur - beta_prev.to(dtype) * v_prev
        beta = torch.linalg.vector_norm(w)
        v_next = w / torch.where(beta == 0, torch.ones_like(beta), beta).to(dtype)
        alphas.append(alpha)
        betas.append(beta)
        vs.append(v_cur)
        v_prev, v_cur, beta_prev = v_cur, v_next, beta
    alphas, betas = torch.stack(alphas), torch.stack(betas)
    t = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    return t, torch.stack(vs)


def lanczos_iteration(hamiltonian: Any, initial_vector: Any, subspace_dimension: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lanczos_iteration_scan` on any form of the Hamiltonian."""
    return lanczos_iteration_scan(_mvp_of(hamiltonian), _state(initial_vector), subspace_dimension)


def krylov_evol(
    hamiltonian: Any,
    psi0: Any,
    tlist: Any,
    subspace_dimension: int = 20,
    callback: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    scan_impl: bool = True,
) -> torch.Tensor:
    r"""exp(-i H t)|psi0⟩ for each t of ``tlist`` by projection onto the
    ``subspace_dimension``-step Krylov space of psi0."""
    hmvp = _mvp_of(hamiltonian)
    psi0 = _state(psi0)
    nrm = torch.linalg.vector_norm(psi0)
    t_mat, vs = lanczos_iteration_scan(hmvp, psi0, subspace_dimension)
    e, u = linalg.plain_eigh(t_mat)
    cdt = _complex_dtype(e.dtype) if psi0.dtype != torch.complex64 else torch.complex64

    def one_time(t: torch.Tensor) -> torch.Tensor:
        phases = torch.exp(-1j * e.to(cdt) * t.to(e.dtype))
        coeff = u.to(cdt) @ (phases * torch.conj(u[0, :]).to(cdt))
        psi_t = torch.tensordot(coeff.to(psi0.dtype), vs, dims=([0], [0])) * nrm.to(psi0.dtype)
        return callback(psi_t) if callback is not None else psi_t

    return _each_time(one_time, _times(tlist, psi0))


def hamiltonian_evol(
    h: Any,
    psi0: Any,
    tlist: Any,
    callback: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    r"""Imaginary-time evolution exp(-t H)|psi0⟩ of a dense ``h``,
    renormalized at each time (also ``ed_evol``); real time:
    :func:`hamiltonian_evol_real`."""
    psi0 = _state(psi0)
    h = _state(h).to(psi0.device)
    e, v = linalg.plain_eigh(h)
    dt = torch.promote_types(v.dtype, psi0.dtype)
    v = v.to(dt)
    proj = v.mH @ psi0.to(dt)

    def one(t: torch.Tensor) -> torch.Tensor:
        weights = torch.exp(-e * torch.real(t).to(e.dtype))
        psi_t = v @ (weights.to(dt) * proj)
        psi_t = psi_t / torch.linalg.vector_norm(psi_t)
        return callback(psi_t) if callback is not None else psi_t

    return _each_time(one, _times(tlist, psi0))


ed_evol = hamiltonian_evol


def hamiltonian_evol_real(
    tlist: Any,
    h: Any,
    psi0: Any,
    callback: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    r"""Exact real-time evolution exp(-i H t)|psi0⟩ of a dense ``h`` by
    its eigendecomposition (not renormalized)."""
    psi0 = _state(psi0)
    h = _state(h).to(psi0.device)
    e, v = linalg.plain_eigh(h)
    dt = torch.promote_types(torch.promote_types(v.dtype, psi0.dtype), torch.complex64)
    v = v.to(dt)
    proj = v.mH @ psi0.to(dt)

    def one(t: torch.Tensor) -> torch.Tensor:
        phases = torch.exp(-1j * e * t.to(e.dtype))
        psi_t = v @ (phases.to(dt) * proj)
        return callback(psi_t) if callback is not None else psi_t

    return _each_time(one, _times(tlist, psi0))


def expm_multiply(
    h: Any,
    psi0: Any,
    t: Union[float, torch.Tensor] = 1.0,
    prefactor: complex = -1.0j,
    m: int = 30,
    s: Optional[int] = None,
) -> torch.Tensor:
    r"""exp(prefactor · t · H) psi0 by s segments of an m-term Taylor
    series; without ``s``, s = ceil(|t| ‖H v‖ / m) from the normalized
    state v."""
    hmvp = _mvp_of(h)
    psi0 = _state(psi0)
    if not psi0.is_complex() and np.iscomplexobj(prefactor):
        psi0 = psi0.to(config.torch_dtype())
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t, dtype=_real_dtype(psi0.dtype), device=psi0.device)
    coef = torch.as_tensor(prefactor, dtype=psi0.dtype, device=psi0.device) * t.to(psi0.dtype)
    if s is None:
        v = psi0 / torch.linalg.vector_norm(psi0)
        nrm = float(torch.linalg.vector_norm(hmvp(v)))
        s = max(1, int(math.ceil(abs(float(t)) * nrm / m)))
    frac = coef / s
    psi = psi0
    for _ in range(int(s)):
        term = acc = psi
        for k in range(1, m + 1):
            term = frac * hmvp(term) / k
            acc = acc + term
        psi = acc
    return psi


#: Al-Mohy–Higham θ_m (double precision truncation targets)
_EXPM_MULTIPLY_THETA = {
    5: 2.4e-1, 10: 1.1, 15: 2.2, 20: 3.6, 25: 4.9, 30: 6.3,
    35: 7.7, 40: 9.1, 45: 10.6, 50: 12.0, 55: 13.4,
}


def estimate_expm_multiply_parameters(t_max: float, norm_bound: float) -> Tuple[int, int]:
    """(Taylor degree m, segments s) for :func:`expm_multiply_evol`: the
    pair of least cost m·s with s = ceil(t_max · norm_bound / θ_m)."""
    t_max, norm_bound = float(t_max), float(norm_bound)
    if not math.isfinite(t_max) or t_max < 0:
        raise ValueError("t_max must be a finite non-negative number.")
    if not math.isfinite(norm_bound) or norm_bound < 0:
        raise ValueError("norm_bound must be a finite non-negative number.")
    scaled = t_max * norm_bound
    if scaled == 0:
        return 0, 1
    _, m, s = min((m * max(1, int(math.ceil(scaled / th))), m, max(1, int(math.ceil(scaled / th))))
                  for m, th in _EXPM_MULTIPLY_THETA.items())
    return m, s


def expm_multiply_evol(
    hamiltonian: Any,
    initial_state: Any,
    times: Any,
    m: Optional[int] = None,
    s: Optional[int] = None,
    norm_bound: Optional[float] = None,
) -> torch.Tensor:
    """e^{-iHt}|ψ⟩ at each time by :func:`expm_multiply`; without (m, s)
    they come from ``norm_bound`` (or the 1-norm of a dense Hamiltonian,
    else 10) and max |t|."""
    times_np = np.asarray(times.detach().cpu() if isinstance(times, torch.Tensor) else times).real
    if m is None or s is None:
        if norm_bound is None:
            if isinstance(hamiltonian, (np.ndarray, torch.Tensor)) and not K.is_sparse(hamiltonian):
                h_np = K.numpy(hamiltonian) if isinstance(hamiltonian, torch.Tensor) else hamiltonian
                norm_bound = float(np.linalg.norm(h_np, 1))
            else:
                norm_bound = 10.0
        m, s = estimate_expm_multiply_parameters(float(np.abs(times_np).max()), norm_bound)
    outs = [expm_multiply(hamiltonian, initial_state, float(t), m=max(m, 1), s=s) for t in np.atleast_1d(times_np)]
    return outs[0] if np.ndim(times_np) == 0 else torch.stack(outs)


# ------------------------------------------------------------------
# ODE evolution: the Dormand-Prince step of jax.experimental.ode.odeint
# ------------------------------------------------------------------

_DOPRI_ALPHA = [1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0, 0]
_DOPRI_BETA = [
    [1 / 5, 0, 0, 0, 0, 0, 0], [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
]
_DOPRI_C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_DOPRI_C_ERR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
                -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0]
_DOPRI_C_MID = [6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
                -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
                -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]


def _combo(coeffs: Sequence[float], k: Sequence[torch.Tensor]) -> torch.Tensor:
    out = None
    for c, ki in zip(coeffs, k):
        if c:
            out = c * ki if out is None else out + c * ki
    return out if out is not None else torch.zeros_like(k[0])


def _initial_step(fun, t0: float, y0, f0, rtol: float, atol: float, order: int = 4) -> float:
    """Hairer, Nørsett and Wanner's initial step (Sec. II.4), as odeint."""
    scale = atol + torch.abs(y0) * rtol
    d0 = float(torch.linalg.vector_norm(y0 / scale))
    d1 = float(torch.linalg.vector_norm(f0 / scale))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    f1 = fun(y0 + h0 * f0, t0 + h0)
    d2 = float(torch.linalg.vector_norm((f1 - f0) / scale)) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** (1.0 / (order + 1.0))
    return min(100.0 * h0, h1)


def _dopri_step(fun, y0, f0, t0: float, dt: float):
    k = [f0]
    for i in range(1, 7):
        k.append(fun(y0 + dt * _combo(_DOPRI_BETA[i - 1], k), t0 + dt * _DOPRI_ALPHA[i - 1]))
    y1 = dt * _combo(_DOPRI_C_SOL, k) + y0
    return y1, k[-1], dt * _combo(_DOPRI_C_ERR, k), k


def _error_ratio(err, rtol: float, atol: float, y0, y1) -> float:
    tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return float(torch.sqrt(torch.mean((err / tol) ** 2)))


def _optimal_step(dt: float, ratio: float, safety: float = 0.9, ifactor: float = 10.0, dfactor: float = 0.2,
                  order: float = 5.0) -> float:
    if ratio == 0:
        return dt * ifactor
    dfactor = 1.0 if ratio < 1 else dfactor
    return dt * min(ifactor, max(ratio ** (-1.0 / order) * safety, dfactor))


def _dopri_interp(y0, y1, k, dt: float):
    """The 4th-order polynomial of a step (odeint's ``interp_fit_dopri``),
    highest power first."""
    y_mid = y0 + dt * _combo(_DOPRI_C_MID, k)
    dy0, dy1 = k[0], k[-1]
    a = -2.0 * dt * dy0 + 2.0 * dt * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * dt * dy0 - 3.0 * dt * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * dt * dy0 + dt * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    return [a, b, c, dt * dy0, y0]


def _dopri5(fun: Callable, y0: torch.Tensor, ts: Sequence[float], rtol: float, atol: float) -> torch.Tensor:
    """y at each of ``ts`` (increasing, ts[0] the start) of dy/dt =
    fun(y, t), the real vector ``y0``: Dormand-Prince steps under odeint's
    controller, each output by the dense-output polynomial of the step that
    passed it.  Accept/reject and the step sizes are host decisions; the
    gradient flows through the accepted steps."""
    f0 = fun(y0, ts[0])
    dt = _initial_step(fun, ts[0], y0, f0, rtol, atol)
    y, f, t, last_t = y0, f0, ts[0], ts[0]
    interp = [y0] * 5
    out = [y0]
    for target in ts[1:]:
        while t < target and dt > 0:
            ny, nf, err, k = _dopri_step(fun, y, f, t, dt)
            ratio = _error_ratio(err, rtol, atol, y, ny)
            new_dt = _optimal_step(dt, ratio)
            if ratio <= 1.0:
                interp = _dopri_interp(y, ny, k, dt)
                y, f, last_t, t = ny, nf, t, t + dt
            dt = new_dt
        x = (target - last_t) / (t - last_t)
        yt = torch.zeros_like(y0)
        for c in interp:
            yt = yt * x + c
        out.append(yt)
    return torch.stack(out)


def _odeint(f: Callable, y0: torch.Tensor, ts: Sequence[float], *args: Any, ode_backend: str = "jaxode",
            **solver_kws: Any) -> torch.Tensor:
    """``f(y, t, *args)`` integrated by :func:`_dopri5` on the stacked real
    and imaginary planes of a complex ``y0``."""
    if ode_backend == "diffrax":
        raise NotImplementedError("ode_backend='diffrax' is a JAX package route: the port integrates with its "
                                  "own Dormand-Prince step (ode_backend='jaxode')")
    rtol, atol = solver_kws.get("rtol", 1.4e-7), solver_kws.get("atol", 1.4e-7)
    rdt = _real_dtype(y0.dtype)

    def tt(t: float) -> torch.Tensor:
        return torch.tensor(t, dtype=rdt, device=y0.device)

    if y0.is_complex():
        dim = y0.shape[0]

        def f_ri(y, t):
            dy = f(torch.complex(y[:dim], y[dim:]), tt(t), *args)
            return torch.cat([torch.real(dy), torch.imag(dy)])

        out = _dopri5(f_ri, torch.cat([torch.real(y0), torch.imag(y0)]), ts, rtol, atol)
        return torch.complex(out[:, :dim], out[:, dim:])
    return _dopri5(lambda y, t: f(y, tt(t), *args), y0, ts, rtol, atol)


def _ode_times(times: Any) -> Tuple[bool, list]:
    """(one time?, the grid from 0 with each point strictly after the
    last: a point not past its predecessor moves 1e-6 on, as in the JAX
    package)."""
    t = np.asarray(times.detach().cpu() if isinstance(times, torch.Tensor) else times, dtype=np.float64)
    single = t.ndim == 0
    ts = np.concatenate([[0.0], np.reshape(t, (-1,))])
    ts[1:] += np.cumsum(np.where(np.diff(ts) <= 0, 1e-6, 0.0))
    return single, ts.tolist()


def _ode_out(ys: torch.Tensor, single: bool, callback: Optional[Callable]) -> torch.Tensor:
    ys = ys[1:]
    if callback is not None:
        ys = torch.stack([callback(y) for y in ys])
    return ys[0] if single else ys


def ode_evol_global(
    hamiltonian: Callable[..., Any],
    psi0: Any,
    times: Any,
    *args: Any,
    ode_backend: str = "jaxode",
    callback: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    **solver_kws: Any,
) -> torch.Tensor:
    r"""Solve i d|psi>/dt = H(t)|psi> for the whole register:
    ``hamiltonian(t, *args)`` returns a dense or sparse matrix or a
    matrix-vector product; ``t`` is a 0-d real tensor on the state's
    device."""
    psi0 = _state(psi0)
    single, ts = _ode_times(times)

    def rhs(y, t, *a):
        h = hamiltonian(t, *a)
        if callable(h) and not hasattr(h, "shape"):
            hy = h(y)
        elif K.is_sparse(h):
            hy = h @ y
        else:
            hy = _state(h).to(device=y.device, dtype=y.dtype) @ y
        return (-1j * hy).to(y.dtype)

    return _ode_out(_odeint(rhs, psi0, ts, *args, ode_backend=ode_backend, **solver_kws), single, callback)


def ode_evol_local(
    hamiltonian: Callable[..., Any],
    psi0: Any,
    times: Any,
    index: Sequence[int],
    *args: Any,
    ode_backend: str = "jaxode",
    callback: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    **solver_kws: Any,
) -> torch.Tensor:
    r"""Solve i d|psi>/dt = H(t)|psi> for a local ``hamiltonian(t, *args)``
    (2^k x 2^k) on the qubits ``index``."""
    psi0 = _state(psi0)
    single, ts = _ode_times(times)

    def rhs(y, t, *a):
        hloc = _state(hamiltonian(t, *a)).to(device=y.device, dtype=y.dtype)
        return (-1j * statevec.apply_unitary(y, hloc, list(index))).to(y.dtype)

    return _ode_out(_odeint(rhs, psi0, ts, *args, ode_backend=ode_backend, **solver_kws), single, callback)


evol_local = ode_evol_local
evol_global = ode_evol_global


# ------------------------------------------------------------------
# Chebyshev evolution
# ------------------------------------------------------------------


def _bessel_jn_array(kmax: int, x: float) -> np.ndarray:
    """J_0..J_kmax at a real x on the host (scipy)."""
    from scipy.special import jv

    return jv(np.arange(kmax + 1), x)


def _bessel_jn_miller(kmax: int, x: torch.Tensor) -> torch.Tensor:
    """J_0..J_kmax at a real tensor x by Miller's downward recurrence
    f_{k-1} = (2k/x) f_k - f_{k+1} from k = 2 kmax + 18, rescaled each step
    and normalized by J_0 + 2 Σ J_{2m} = 1; J_k(0) = δ_k0."""
    pad = kmax + 18
    kstart = kmax + pad
    small = torch.abs(x) < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    fk, fk1 = torch.full_like(xs, 1e-10), torch.zeros_like(xs)
    emits, logs = [], []
    for k in range(kstart, 0, -1):
        fkm1 = (2.0 * k / xs) * fk - fk1
        s = torch.clamp(torch.abs(fkm1), min=1.0)
        emits.append(fkm1)
        logs.append(torch.log(s))
        fk, fk1 = fkm1 / s, fk / s
    emits, logs = torch.stack(emits), torch.stack(logs)
    lcum = torch.cat([torch.zeros((1,), dtype=xs.dtype, device=xs.device), torch.cumsum(logs, 0)[:-1]])
    rel = emits * torch.exp(lcum - torch.max(lcum))
    allf = torch.flip(rel, (0,))
    norm = allf[0] + 2.0 * torch.sum(allf[2::2])
    j = allf[: kmax + 1] / norm
    at0 = torch.zeros((kmax + 1,), dtype=j.dtype, device=j.device)
    at0[0] = 1.0
    return torch.where(small, at0, j)


class _BesselJn(torch.autograd.Function):
    """J_0..J_kmax(x) with dJ_k/dx = (J_{k-1} - J_{k+1}) / 2 (J_{-1} = -J_1)."""

    @staticmethod
    def forward(x, kmax):
        jext = _bessel_jn_miller(kmax + 1, x)
        return jext[: kmax + 1], jext

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kmax = inputs[1]
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g, _):
        (jext,) = ctx.saved_tensors
        kmax = ctx.kmax
        jm1 = torch.cat([-jext[1:2], jext[:kmax]])
        jp1 = jext[1: kmax + 2]
        return torch.sum(g * (jm1 - jp1) / 2.0), None


def bessel_jn_traced(kmax: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """A differentiable J_0..J_kmax(x) of a real tensor x."""
    return lambda x: _BesselJn.apply(x, kmax)[0]


def chebyshev_evol(
    h: Any,
    psi0: Any,
    t: Union[float, torch.Tensor],
    spectral_bounds: Tuple[float, float],
    k: Optional[int] = None,
    M: Optional[int] = None,
) -> torch.Tensor:
    r"""exp(-i H t)|psi0⟩ by the Chebyshev expansion of H rescaled to
    [-1, 1] by ``spectral_bounds=(Emax, Emin)``, M + 1 terms with Bessel
    coefficients (a tensor ``t``: differentiable coefficients); not
    renormalized (the norm's error is an accuracy check)."""
    if M is None:
        M = estimate_M(float(t), spectral_bounds, k)
    emax, emin = spectral_bounds
    a = (emax - emin) / 2.0
    b = (emax + emin) / 2.0
    hmvp = _mvp_of(h)
    psi0 = _state(psi0)
    rdt = _real_dtype(psi0.dtype)

    def htilde(v: torch.Tensor) -> torch.Tensor:
        return (hmvp(v) - b * v) / a

    if isinstance(t, torch.Tensor):
        bessels = bessel_jn_traced(M)(a * t.to(device=psi0.device, dtype=rdt))
        ik = torch.as_tensor(np.power(-1j, np.arange(M + 1)), device=psi0.device).to(psi0.dtype)
        coeffs = 2.0 * ik * bessels.to(psi0.dtype)
        coeffs = torch.cat([coeffs[:1] / 2.0, coeffs[1:]])
        phase = torch.exp(-1j * (b * t).to(device=psi0.device, dtype=rdt)).to(psi0.dtype)
    else:
        bessels = _bessel_jn_array(M, a * t)
        c = 2.0 * ((-1j) ** np.arange(M + 1)) * bessels
        c[0] = c[0] / 2.0
        coeffs = torch.as_tensor(c, device=psi0.device).to(psi0.dtype)
        phase = torch.exp(-1j * torch.as_tensor(b * t, dtype=rdt, device=psi0.device)).to(psi0.dtype)
    tm1, tm0 = psi0, htilde(psi0)
    acc = coeffs[0] * tm1 + coeffs[1] * tm0
    for c_k in coeffs[2:]:
        t_next = 2.0 * htilde(tm0) - tm1
        acc = acc + c_k * t_next
        tm1, tm0 = tm0, t_next
    return phase * acc


def estimate_spectral_bounds(
    h: Any,
    n_iter: int = 30,
    psi0: Optional[Any] = None,
    shape: Optional[Sequence[int]] = None,
) -> Tuple[float, float]:
    """(Emax, Emin) from the Ritz values of ``n_iter`` Lanczos steps (both
    edges at once); the start vector is ``psi0`` or, as in the JAX
    package, ``np.random.default_rng(42).normal(size=dim)``."""
    hmvp = _mvp_of(h)
    dev = h.device if isinstance(h, torch.Tensor) else config.resolve_device()
    if psi0 is None:
        if shape is None:
            shape = h.shape if hasattr(h, "shape") else None
        psi0 = np.random.default_rng(42).normal(size=int(shape[-1]))
    psi0 = torch.as_tensor(np.asarray(K.numpy(psi0) if isinstance(psi0, torch.Tensor) else psi0),
                           device=dev).to(config.torch_dtype())
    psi0 = psi0 / torch.linalg.vector_norm(psi0)
    t_mat, _ = lanczos_iteration_scan(hmvp, psi0, min(n_iter, psi0.shape[0]))
    ritz = np.linalg.eigvalsh(K.numpy(torch.real(t_mat)))
    return float(ritz[-1]), float(ritz[0])


def estimate_k(t: float, spectral_bounds: Tuple[float, float]) -> int:
    """The Chebyshev truncation order for the time t."""
    emax, emin = spectral_bounds
    tau = abs((emax - emin) / 2.0 * t)
    return max(int(1.1 * tau), int(tau + 20))


def estimate_M(t: float, spectral_bounds: Tuple[float, float], k: Optional[int] = None) -> int:
    """The number of Chebyshev terms for the time t."""
    emax, emin = spectral_bounds
    tau = abs((emax - emin) / 2.0 * t)
    if k is None:
        k = estimate_k(t, spectral_bounds)
    return max(max(k, int(tau)) + int(15.0 * math.sqrt(tau)), k + 30)
