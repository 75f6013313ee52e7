"""QUBO / Ising optimization via QAOA (reference ``applications/optimization.py:85,316``).

The losses are torch functions of the angles on the port's circuits;
:func:`QUBO_QAOA` trains them with ``torch.optim.Adam`` through
``backend.jit(backend.value_and_grad(loss))`` (a captured CUDA graph on the
card, eager on the CPU), and :func:`QUBO_QAOA_cvar` drives scipy's COBYLA
through a numpy function.  Initial draws come from numpy as in the JAX
package, so one seed gives one start in both.
"""

from __future__ import annotations

from functools import partial as _partial
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..backend import backend as K
from ..templates.ansatz import QAOA_ansatz_for_Ising
from ..templates.conversions import QUBO_to_Ising

__all__ = ["QUBO_QAOA", "cvar_loss", "cvar_from_counts", "ising_energy_vector"]


def _rdtype() -> torch.dtype:
    return getattr(torch, config.rdtypestr())


def _real(x: Any, device: Any = None) -> torch.Tensor:
    """``x`` as a float32 tensor, on its own device if it is a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=config.resolve_device(device))


def ising_energy_vector(
    structures: Sequence[Sequence[int]], weights: Sequence[float], offset: float = 0.0, device: Any = None
) -> torch.Tensor:
    """Diagonal energy over all 2^n basis states for Z-type structures, in
    the configured real dtype on ``device``: float64 sums on the device in
    the structures' order, each term its weight times its Z signs (the JAX
    package's numpy values, bit for bit, before the cast)."""
    dev = config.resolve_device(device)
    n = len(structures[0])
    basis = torch.arange(2**n, device=dev)
    signs = {}
    e = torch.full((2**n,), float(offset), dtype=torch.float64, device=dev)
    for l, w in zip(structures, weights):
        term = torch.full((2**n,), float(w), dtype=torch.float64, device=dev)
        for q, v in enumerate(l):
            if v == 3:
                if q not in signs:
                    signs[q] = (1 - 2 * ((basis >> (n - 1 - q)) & 1)).to(torch.float64)
                term = term * signs[q]
        e = e + term
    return e.to(_rdtype())


def cvar_loss(probs: torch.Tensor, energies: torch.Tensor, alpha: float = 0.25) -> torch.Tensor:
    """Conditional value at risk of the energy distribution (reference ``:316``)."""
    order = torch.argsort(energies, stable=True)
    p = probs[order]
    e = energies[order]
    cum = torch.cumsum(p, dim=0)
    w = torch.clamp(torch.clamp(cum, max=alpha) - (cum - p), min=0.0)
    return torch.sum(w * e) / alpha


def cvar_from_counts(counts: Dict[str, int], energy_fn: Callable[[str], float], alpha: float = 0.25) -> float:
    pairs = sorted(((energy_fn(k), v) for k, v in counts.items()))
    total = sum(v for _, v in pairs)
    cutoff = alpha * total
    acc = 0.0
    used = 0.0
    for e, v in pairs:
        take = min(v, cutoff - used)
        if take <= 0:
            break
        acc += take * e
        used += take
    return acc / max(used, 1e-12)


def QUBO_QAOA(
    Q: Any,
    nlayers: int = 3,
    steps: int = 200,
    learning_rate: float = 0.05,
    alpha: Optional[float] = None,
    seed: int = 42,
    callback: Optional[Callable[[int, float], None]] = None,
    device: Any = None,
) -> Tuple[torch.Tensor, float, str]:
    """Optimize a QUBO with QAOA; returns (params, best energy, best bitstring).

    ``alpha`` switches the loss to CVaR_alpha (reference ``:85-200``).  The
    value and gradient go through ``backend.jit``, the step through
    ``torch.optim.Adam`` with optax's defaults.
    """
    dev = config.resolve_device(device)
    structures, weights, offset = QUBO_to_Ising(Q)
    n = np.asarray(Q).shape[0]
    energies = ising_energy_vector(structures, weights, offset, device=dev)

    def loss(params: torch.Tensor) -> torch.Tensor:
        c = QAOA_ansatz_for_Ising(params, nlayers, structures, weights, device=dev)
        p = c.probability()
        p = p / torch.sum(p)
        if alpha is not None:
            return cvar_loss(p, energies, alpha)
        return torch.sum(p * energies)

    params = torch.as_tensor(
        np.random.default_rng(seed).uniform(0.0, 0.5, size=2 * nlayers), dtype=torch.float32, device=dev
    )
    opt = torch.optim.Adam([params], lr=learning_rate)
    vg = K.jit(K.value_and_grad(loss))
    for step in range(steps):
        v, g = vg(params)
        params.grad = g
        opt.step()
        if callback is not None:
            callback(step, float(v))
    params = params.detach()
    with torch.no_grad():
        p = QAOA_ansatz_for_Ising(params, nlayers, structures, weights, device=dev).probability()
    best_idx = int(torch.argmax(p))
    best_bits = format(best_idx, f"0{n}b")
    e_best = float(energies[best_idx])
    return params, e_best, best_bits


# ======================================================================
# reference-parity QUBO/CVaR API (applications/optimization.py:22-364)
# ======================================================================


def Ising_loss(c: Any, pauli_terms: Any, weights: Sequence[float]) -> torch.Tensor:
    """Σ_k w_k ⟨Z...Z⟩ over 1- and 2-local Ising terms (reference :22).

    A Z position is marked 1 (the reference's terms) or 3 (the Pauli codes
    of :func:`QUBO_to_Ising`); the JAX package reads only 1, so it gives
    Σ_k w_k for :func:`QUBO_to_Ising`'s terms (``ROADMAP.md`` Queue 3, F26)."""
    loss = 0.0
    for k, term in enumerate(pauli_terms):
        ones = [l for l, v in enumerate(term) if v in (1, 3)]
        if len(ones) == 1:
            loss += weights[k] * c.expectation_ps(z=[ones[0]])
        else:
            loss += weights[k] * c.expectation_ps(z=ones[:2])
    return torch.real(loss)


def QAOA_loss(
    nlayers: int,
    pauli_terms: Any,
    weights: Sequence[float],
    params: Any,
    full_coupling: bool = False,
    mixer: str = "X",
) -> torch.Tensor:
    """Ising loss of the QAOA ansatz state (reference :57), on ``params``'
    device."""
    kw = {"device": params.device} if isinstance(params, torch.Tensor) else {}
    c = QAOA_ansatz_for_Ising(
        params, nlayers, pauli_terms, weights, mixer=mixer, full_coupling=full_coupling, **kw
    )
    return Ising_loss(c, pauli_terms, weights)


def cvar_value(r: Any, p: Any, percent: float) -> torch.Tensor:
    """CVaR of outcomes ``r`` with probabilities ``p`` (reference :163).

    Differentiable: sort, cumulative sum and a mask, in float32."""
    dev = p.device if isinstance(p, torch.Tensor) else (r.device if isinstance(r, torch.Tensor) else None)
    r = _real(r, dev)
    p = _real(p, dev)
    order = torch.argsort(r, stable=True)
    r_s = r[order]
    p_s = p[order]
    cum = torch.cumsum(p_s, dim=0)
    mask = (cum < percent).to(torch.float32)
    head = torch.sum(mask * p_s * r_s)
    last_idx = torch.argmax((cum >= percent).to(torch.float32))
    prev_cum = torch.where(last_idx > 0, cum[last_idx - 1], torch.zeros((), dtype=cum.dtype, device=cum.device))
    tail = (percent - prev_cum) * r_s[last_idx]
    return (head + tail) / percent


def _qubo_values(Q: Any, device: Any = None) -> torch.Tensor:
    """Cost x^T Q x of every binary assignment, shape [2^n] (helper)."""
    Q = np.asarray(Q, dtype=np.float32)
    n = Q.shape[0]
    states = ((np.arange(2**n)[:, None] >> np.arange(n - 1, -1, -1)) & 1).astype(np.float32)
    return torch.as_tensor(np.einsum("si,ij,sj->s", states, Q, states), device=config.resolve_device(device))


def cvar_from_circuit(circuit: Any, nsamples: int, Q: Any, alpha: float) -> torch.Tensor:
    """CVaR from sampled measurement outcomes (reference :197): the shots
    from the implicit generator of the circuit's device."""
    p = torch.real(circuit.probability())
    p = p / torch.sum(p)
    idx = K.probability_sample(nsamples, p)
    values = _qubo_values(Q, p.device)
    counts = torch.bincount(idx.long(), minlength=p.shape[0]).to(torch.float32)
    probs = counts / nsamples
    return cvar_value(values, probs, alpha)


def cvar_from_expectation(circuit: Any, Q: Any, alpha: float) -> torch.Tensor:
    """CVaR from the exact outcome distribution (reference :244)."""
    p = torch.real(circuit.probability())
    p = p / torch.sum(p)
    return cvar_value(_qubo_values(Q, p.device), p, alpha)


def _cvar_loss_ref(
    nlayers: int,
    Q: Any,
    nsamples: int,
    alpha: float,
    expectation_based: bool,
    params: Any,
) -> torch.Tensor:
    pauli_terms, weights, _ = QUBO_to_Ising(Q)
    c = QAOA_ansatz_for_Ising(params, nlayers, pauli_terms, weights, device=params.device)
    if expectation_based:
        return cvar_from_expectation(c, Q, alpha)
    return cvar_from_circuit(c, nsamples, Q, alpha)


def QUBO_QAOA_cvar(
    Q: Any,
    nlayers: int,
    alpha: float,
    nsamples: int = 1000,
    callback: Optional[Callable[..., None]] = None,
    expectation_based: bool = False,
    maxiter: int = 1000,
    init_params: Optional[Any] = None,
    device: Any = None,
) -> Any:
    """COBYLA optimization of the CVaR objective (reference :316); the
    circuits on ``device``, the optimizer on numpy."""
    import scipy.optimize as sopt

    dev = config.resolve_device(device)
    loss = _partial(_cvar_loss_ref, nlayers, Q, nsamples, alpha, expectation_based)

    def f_np(x: Any) -> float:
        with torch.no_grad():
            return float(loss(torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)))

    if init_params is None:
        init_params = np.random.normal(scale=0.5, size=[2 * nlayers])
    r = sopt.minimize(
        f_np, np.asarray(init_params), method="COBYLA", callback=callback,
        options={"maxiter": maxiter},
    )
    return r.x
