"""DQAS application kernels: value-and-gradient (vag) functions.

Counterpart of reference ``applications/vags.py`` (TF-based; its tfq/cirq
sections are legacy).  The vag contract is preserved: ``vag(gdata, nnp,
preset) -> (loss, grad)`` where ``grad`` has nnp's shape with per-slot
gradients scattered at ``(i, preset[i])``; the gradients come from torch's
autograd, the circuits run on ``nnp``'s device (the configured one for a
numpy ``nnp``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..models.circuit import Circuit
from ..models.densitymatrix import DMCircuit
from ..ops import gates as G
from .dqas import _adam, _np, _step, get_op_pool, value_and_grad

Tensor = Any
Graph = Any

__all__ = [
    "GHZ_vag",
    "energy",
    "ave_func",
    "exp_forward",
    "cvar",
    "qaoa_vag",
    "qaoa_block_vag",
    "evaluate_vag",
    "noise_forward",
    "maxcut_measurements_tc",
    "tfim_measurements_tc",
    "heisenberg_measurements_tc",
    "qaoa_noise_vag",
    "qaoa_train",
    "compose_tc_circuit_with_multiple_pools",
    "gatewise_vqe_vag",
    "correlation",
]


def _device(x: Any) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return x[0].device
    return config.resolve_device()


def _picked(nnp: Tensor, preset: Sequence[int]) -> torch.Tensor:
    """nnp[i, preset[i]] for each slot, float32 on nnp's device."""
    nnp_np = _np(nnp)
    return torch.as_tensor(np.array([nnp_np[i, j] for i, j in enumerate(preset)]), dtype=torch.float32,
                           device=_device(nnp))


def GHZ_vag(
    gdata: Any, nnp: Tensor, preset: Sequence[int], verbose: bool = False, n: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GHZ-preparation toy DQAS kernel (reference ``vags.py:54``).

    Ops in the pool are strings like "H0", "CNOT01", "I" applied by name;
    loss = 1 - |⟨GHZ|ψ⟩|².
    """
    dev = _device(nnp)
    reference = np.zeros([2**n])
    reference[0] = reference[-1] = 1.0 / np.sqrt(2.0)
    reference = torch.as_tensor(reference.astype(np.complex64), device=dev)
    cset = get_op_pool()

    c = Circuit(n, device=dev)
    for j in preset:
        op = cset[j]
        if isinstance(op, str):
            if op.startswith("CNOT"):
                c.cnot(int(op[4]), int(op[5]))
            elif op.startswith("H"):
                c.h(int(op[1]))
            elif op.upper() == "I":
                pass
            else:
                getattr(c, op[0].lower())(int(op[1]))
        else:
            op(c)
    psi = c.state()
    loss = 1.0 - torch.abs(torch.vdot(reference, psi.to(reference.dtype))) ** 2
    if verbose:  # pragma: no cover
        print("GHZ loss:", float(torch.real(loss)))
    return loss, torch.zeros_like(torch.as_tensor(_np(nnp), device=dev))


def energy(i: int, n: int, g: Graph) -> float:
    """Maxcut energy of the i-th computational basis state (reference :109)."""
    basis = bin(i)[2:].zfill(n)
    r = 0.0
    for e in g.edges:
        r += g[e[0]][e[1]].get("weight", 1.0) * int(basis[e[0]] != basis[e[1]])
    return r


def _cut_values(n: int, g: Graph) -> np.ndarray:
    """:func:`energy` of every basis state at once: the same float64 sums
    over the edges in their order."""
    idx = np.arange(2**n)
    r = np.zeros(2**n)
    for e in g.edges:
        cut = ((idx >> (n - 1 - e[0])) & 1) != ((idx >> (n - 1 - e[1])) & 1)
        r += g[e[0]][e[1]].get("weight", 1.0) * cut
    return r


def ave_func(state: Tensor, g: Graph, *fs: Any) -> Sequence[torch.Tensor]:
    """Averages of transformed maxcut energies over |ψ|² (reference :125).

    Each ``fs`` entry is (f, f2) or (f, f2, f3): result = f2(Σ_i f3?(f(e_i)) p_i).
    """
    n = int(round(np.log2(state.shape[0])))
    ebasis = _cut_values(n, g)
    p = torch.real(torch.abs(state) ** 2)
    out = []
    for ftuple in fs:
        if len(ftuple) == 2:
            f, f2 = ftuple
            r = np.asarray([f(e) for e in ebasis])
        else:
            f, f2, f3 = ftuple
            r = np.asarray(f3([f(e) for e in ebasis], p))
        r = torch.as_tensor(r.astype(np.float32), device=p.device).to(p.dtype)
        out.append(f2(torch.real(torch.tensordot(r, p, dims=([0], [0])))))
    return out


def exp_forward(theta: Tensor, preset: Sequence[int], g: Graph, *fs: Any) -> Sequence[torch.Tensor]:
    """Build the pooled-op circuit and average measurements (reference :173)."""
    n = len(g.nodes)
    ci = Circuit(n, device=_device(theta))
    cset = get_op_pool()
    for i, j in enumerate(preset):
        if callable(cset[j]):
            cset[j](ci, theta[i], g)
        else:
            layer, graph = cset[j]
            layer(ci, theta[i], graph)
    state = ci.wavefunction()
    return ave_func(state, g, *fs)


def _identity(s: Any) -> Any:
    return s


def _neg(s: Any) -> Any:
    return -s


def _exp_fun(s: Any, lbd: float = 1.0) -> Any:
    return np.exp(-lbd * s)


def _overlap_fun(s: Any, overlap_threhold: float = 0.0) -> Any:
    if s >= overlap_threhold > 0:
        return 1.0
    return 0.0


def cvar(r: List[float], p: Tensor, percent: float = 0.2) -> Sequence[float]:
    """CVaR reweighting of basis energies (as an ``f3``; reference :212)."""
    r = list(r)
    p = _np(p)
    rs = sorted(enumerate(r), key=lambda s: -s[1])
    sump = 0.0
    count = 0
    while sump < percent and count < len(rs):
        idx = rs[count][0]
        if sump + p[idx] > percent:
            r[idx] = (percent - sump) / p[idx] * r[idx]
            count += 1
            break
        sump += p[idx]
        count += 1
    for i in range(count, len(rs)):
        r[rs[i][0]] = 0.0
    return [k / percent for k in r]


def _scatter_grad(nnp: Tensor, preset: Sequence[int], gr: Tensor) -> torch.Tensor:
    gmatrix = np.zeros_like(_np(nnp), dtype=np.float32)
    gr = _np(torch.real(gr))
    gr = np.where(np.isnan(gr), 0.0, gr)
    for i, j in enumerate(preset):
        gmatrix[i, j] = gr[i]
    return torch.as_tensor(gmatrix, device=_device(nnp))


def qaoa_vag(
    gdata: Graph,
    nnp: Tensor,
    preset: Sequence[int],
    f: Optional[Tuple[Callable[[float], float], Callable[[Tensor], Tensor]]] = None,
    forward_func: Optional[Callable[..., Any]] = None,
    verbose_fs: Optional[Sequence[Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """QAOA DQAS kernel: loss + gradient matrix (reference ``vags.py:242``)."""
    if forward_func is None:
        forward_func = exp_forward
    if f is None:
        f = (_identity, _neg)
    pnnp = _picked(nnp, preset)

    def lossf(theta: torch.Tensor) -> torch.Tensor:
        return torch.real(forward_func(theta, preset, gdata, f)[0])

    loss, gr = value_and_grad(lossf, pnnp)
    if verbose_fs:  # pragma: no cover
        for vf in verbose_fs:
            print(forward_func(pnnp, preset, gdata, vf))
    return loss, _scatter_grad(nnp, preset, gr)


def qaoa_block_vag(
    gdata: Graph,
    nnp: Tensor,
    preset: Sequence[int],
    f: Optional[Tuple[Callable[[float], float], Callable[[Tensor], Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-op DQAS kernel: 2 params per block op (reference ``vags.py:288``).

    ``nnp`` has 2 rows per slot; ops whose repr ends with ``_block`` consume
    both, plain layers consume the first.
    """
    if f is None:
        f = (_identity, _neg)
    nnp_np = _np(nnp)
    ops = get_op_pool()
    widths = []
    flat = []
    for i, j in enumerate(preset):
        name = getattr(ops[j], "__doc__", "") or ""
        if name.endswith("_block"):
            widths.append(2)
            flat.extend([nnp_np[2 * i, j], nnp_np[2 * i + 1, j]])
        else:
            widths.append(1)
            flat.append(nnp_np[2 * i, j])
    flat = torch.as_tensor(np.array(flat), dtype=torch.float32, device=_device(nnp))

    def unflatten(v: torch.Tensor) -> List[torch.Tensor]:
        out = []
        k = 0
        for w in widths:
            out.append(v[k: k + w])
            k += w
        return out

    def lossf(v: torch.Tensor) -> torch.Tensor:
        theta = unflatten(v)
        return torch.real(exp_forward(theta, preset, gdata, f)[0])

    loss, gr = value_and_grad(lossf, flat)
    gr = _np(torch.real(gr))
    gr = np.where(np.isnan(gr), 0.0, gr)
    gmatrix = np.zeros_like(nnp_np, dtype=np.float32)
    k = 0
    for i, (j, w) in enumerate(zip(preset, widths)):
        gmatrix[2 * i, j] = gr[k]
        if w == 2:
            gmatrix[2 * i + 1, j] = gr[k + 1]
        k += w
    return loss, torch.as_tensor(gmatrix, device=_device(nnp))


# energy-objective variants: loss is the raw (negated) energy expectation
_ENERGY_OBJECTIVE = (_identity, _neg)
qaoa_vag_energy = partial(qaoa_vag, f=_ENERGY_OBJECTIVE)
qaoa_block_vag_energy = partial(qaoa_block_vag, f=_ENERGY_OBJECTIVE)


def evaluate_vag(
    params: Any,
    preset: Sequence[int],
    g: Graph,
    lbd: float = 0.0,
    overlap_threhold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gibbs objective, energy, gradient, overlap-probability) (ref :348)."""
    params = torch.as_tensor(_np(params), dtype=torch.float32, device=_device(params))
    exp_partial = partial(_exp_fun, lbd=lbd)
    overlap_partial = partial(_overlap_fun, overlap_threhold=overlap_threhold)

    def forward(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        expe, ene, probasum = exp_forward(
            p,
            preset,
            g,
            (exp_partial, torch.log),
            (_identity, _neg),
            (overlap_partial, _identity),
        )
        return torch.real(expe), torch.real(ene), torch.real(probasum)

    def objective(p: torch.Tensor) -> torch.Tensor:
        expe, ene, _ = forward(p)
        return ene if lbd == 0 else expe

    with torch.no_grad():
        expe, ene, probasum = forward(params)
    _, gr = value_and_grad(objective, params)
    return expe, ene, torch.real(gr), probasum


def noise_forward(
    theta: Tensor,
    preset: Sequence[int],
    g: Graph,
    measure_func: Callable[[Any, Graph], Tensor],
    is_mc: bool = False,
) -> torch.Tensor:
    """Noisy pooled-op forward: DMCircuit exact or Circuit MC (reference :391)."""
    n = len(g.nodes)
    dev = _device(theta)
    ci: Any = Circuit(n, device=dev) if is_mc else DMCircuit(n, device=dev)
    cset = get_op_pool()
    for i, j in enumerate(preset):
        entry = cset[j]
        if callable(entry):
            entry(ci, theta[i], g)
        elif len(entry) == 3:
            layer, graph, params = entry
            layer(ci, theta[i], graph, *params)
        elif len(entry) == 4:
            layer, graph, noisemodel, params = entry
            layer(ci, theta[i], graph)
            noisemodel(ci, g, *params)
        elif len(entry) == 2:
            layer, params = entry
            layer(ci, theta[i], g, *params)
        else:
            entry[0](ci, theta[i], g)
    return measure_func(ci, g)


def maxcut_measurements_tc(c: Any, g: Graph) -> torch.Tensor:
    """Maxcut loss Σ w/2 (⟨ZZ⟩ - 1) (reference ``vags.py:422``)."""
    loss = 0.0
    for e in g.edges:
        loss += (
            g[e[0]][e[1]].get("weight", 1.0)
            * 0.5
            * (c.expectation((G.z(), [e[0]]), (G.z(), [e[1]])) - 1.0)
        )
    return loss


def tfim_measurements_tc(
    c: Any, g: Graph, hzz: float = 1.0, hx: float = 0.0, hz: float = 0.0
) -> torch.Tensor:
    """TFIM energy measurement set (reference ``vags.py:433``)."""
    loss = 0.0
    for e in g.edges:
        loss += g[e[0]][e[1]].get("weight", 1.0) * hzz * c.expectation(
            (G.z(), [e[0]]), (G.z(), [e[1]])
        )
    if hx:
        for i in range(len(g.nodes)):
            loss += hx * c.expectation((G.x(), [i]))
    if hz:
        for i in range(len(g.nodes)):
            loss += hz * c.expectation((G.z(), [i]))
    return loss


def heisenberg_measurements_tc(
    c: Any,
    g: Graph,
    hzz: float = 1.0,
    hxx: float = 1.0,
    hyy: float = 1.0,
    hz: float = 0.0,
    hx: float = 0.0,
    hy: float = 0.0,
    reuse: bool = True,
) -> torch.Tensor:
    """Heisenberg energy measurement set (reference ``vags.py:456``)."""
    loss = 0.0
    for e in g.edges:
        w = g[e[0]][e[1]].get("weight", 1.0)
        loss += w * hzz * c.expectation((G.z(), [e[0]]), (G.z(), [e[1]]))
        loss += w * hyy * c.expectation((G.y(), [e[0]]), (G.y(), [e[1]]))
        loss += w * hxx * c.expectation((G.x(), [e[0]]), (G.x(), [e[1]]))
    for coef, gate in ((hx, G.x), (hy, G.y), (hz, G.z)):
        if coef:
            for i in range(len(g.nodes)):
                loss += coef * c.expectation((gate(), [i]))
    return loss


def qaoa_noise_vag(
    gdata: Graph,
    nnp: Tensor,
    preset: Sequence[int],
    measure_func: Optional[Callable[[Any, Graph], Tensor]] = None,
    forward_func: Optional[Callable[..., Tensor]] = None,
    **kws: Any,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noisy QAOA DQAS kernel (reference ``vags.py:496``)."""
    if measure_func is None:
        measure_func = maxcut_measurements_tc
    if forward_func is None:
        forward_func = noise_forward
    pnnp = _picked(nnp, preset)

    def lossf(theta: torch.Tensor) -> torch.Tensor:
        return torch.real(forward_func(theta, preset, gdata, measure_func, **kws))

    loss, gr = value_and_grad(lossf, pnnp)
    return loss, _scatter_grad(nnp, preset, gr)


def qaoa_train(
    preset: Sequence[int],
    g: Union[Graph, Iterator[Graph]],
    epochs: int = 60,
    batch: int = 1,
    initial_param: Optional[Any] = None,
    opt: Any = None,
    lbd: float = 0.0,
    overlap_threhold: float = 0.0,
    verbose: bool = True,
    device: Any = None,
) -> Tuple[torch.Tensor, Sequence[torch.Tensor], Sequence[torch.Tensor], Sequence[torch.Tensor]]:
    """Train a fixed QAOA architecture over (a stream of) graphs (ref :534);
    ``opt`` a factory ``params -> torch.optim.Optimizer``, default
    Adam(1e-2); the angles float32 on ``device``."""
    if initial_param is None:
        rng = np.random.default_rng()
        initial_param = 0.3 + 0.05 * rng.standard_normal(len(preset))
    theta = torch.tensor(_np(initial_param), dtype=torch.float32, device=config.resolve_device(device))
    if opt is None:
        opt = _adam(1e-2)
    state = opt([theta])
    if hasattr(g, "edges"):

        def one_generator() -> Iterator[Graph]:
            while True:
                yield g

        gen = one_generator()
    else:
        gen = g
    gibbs_history, mean_history, overlap_history = [], [], []
    for _epoch in range(epochs):
        grads = torch.zeros_like(theta)
        for _ in range(batch):
            gdata = next(gen)
            expe, ene, gr, probasum = evaluate_vag(
                theta, preset, gdata, lbd=lbd, overlap_threhold=overlap_threhold
            )
            grads = grads + gr / batch
        gibbs_history.append(expe)
        mean_history.append(ene)
        overlap_history.append(probasum)
        _step(state, theta, grads)
        if verbose and _epoch % 10 == 0:  # pragma: no cover
            print(f"epoch {_epoch}: energy {float(ene):.6f}")
    return theta, mean_history, gibbs_history, overlap_history


def compose_tc_circuit_with_multiple_pools(
    c: Circuit,
    presets: Sequence[Sequence[int]],
    pools: Sequence[Sequence[Any]],
    thetas: Sequence[Tensor],
    g: Graph,
) -> Circuit:
    """Apply several (preset, pool, theta) stacks onto one circuit (ref :613)."""
    for preset, pool, theta in zip(presets, pools, thetas):
        for i, j in enumerate(preset):
            pool[j](c, theta[i], g)
    return c


def gatewise_vqe_vag(
    gdata: Graph,
    nnp: Tensor,
    preset: Sequence[int],
    measure_func: Optional[Callable[[Any, Graph], Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate-wise VQE DQAS kernel: pool entries are (gate_name, qubits) (ref :642)."""
    if measure_func is None:
        measure_func = tfim_measurements_tc
    cset = get_op_pool()
    n = len(gdata.nodes)
    pnnp = _picked(nnp, preset)

    def lossf(theta: torch.Tensor) -> torch.Tensor:
        c = Circuit(n, device=theta.device)
        for i, j in enumerate(preset):
            name, qubits = cset[j]
            meth = getattr(c, name.lower())
            if name.lower() in ("h", "x", "y", "z", "cnot", "cx", "cz", "swap", "i"):
                if name.lower() != "i":
                    meth(*qubits)
            else:
                meth(*qubits, theta=theta[i])
        return torch.real(measure_func(c, gdata))

    loss, gr = value_and_grad(lossf, pnnp)
    return loss, _scatter_grad(nnp, preset, gr)


def correlation(m: Tensor, rho: Tensor) -> torch.Tensor:
    """tr(m ρ) (reference ``vags.py`` helper)."""
    rho = rho if isinstance(rho, torch.Tensor) else torch.as_tensor(np.asarray(rho))
    m = m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m), device=rho.device)
    return torch.real(torch.trace(m.to(rho.dtype) @ rho))


# re-exports used by reference scripts (defined in the quantum toolbox here)
from ..quantum import (  # noqa: E402,F401
    entropy,
    renyi_entropy,
    reduced_density_matrix,
    entanglement_entropy,
    free_energy,
    renyi_free_energy,
    taylorlnm,
    truncated_free_energy,
    trace_distance,
    fidelity,
    gibbs_state,
    double_state,
)
