"""DQAS: differentiable quantum architecture search (reference ``applications/dqas.py:190,666``).

Probabilistic-model view: a categorical distribution over operation choices
per layer slot; the objective is E_{ops~p}[loss(circuit(ops, params))],
optimized by Monte-Carlo score-function gradients for the structure
parameters plus plain AD for the circuit parameters.

The optimizers are ``torch.optim`` (Adam with the JAX package's optax
settings); an optimizer argument is a factory ``params -> Optimizer`` such
as ``functools.partial(torch.optim.Adam, lr=0.1)``.  Architectures are drawn
from numpy, as in the JAX package, from float32 softmax probabilities: one
seed samples the same architectures in both.  The autoregressive samplers
(:func:`van_sample`) draw from a ``torch.Generator``.
"""

from __future__ import annotations

import itertools as _itertools
import sys as _sys
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config

__all__ = ["DQAS_search"]

Optimizer = Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]


def _np(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _adam(lr: float, b1: float = 0.9, b2: float = 0.999) -> Optimizer:
    """optax.adam(lr, b1, b2) as a ``torch.optim.Adam`` factory (eps 1e-8
    outside the square root in both)."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def _step(opt: torch.optim.Optimizer, param: torch.Tensor, grad: Any) -> None:
    """One optimizer step of ``param`` along ``grad`` (numpy or a tensor)."""
    param.grad = torch.as_tensor(_np(grad) if not isinstance(grad, torch.Tensor) else grad,
                                 dtype=param.dtype, device=param.device)
    opt.step()


def value_and_grad(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(f(x), ∂Re f/∂x)`` by autograd on a detached copy of ``x``; zeros
    where ``f`` does not use ``x``, as ``jax.value_and_grad`` gives."""
    x = x.detach().clone().requires_grad_()
    with torch.enable_grad():
        v = f(x)
        g = None
        if isinstance(v, torch.Tensor) and v.requires_grad:
            (g,) = torch.autograd.grad(torch.real(v), x, allow_unused=True)
    v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=x.device)
    return v, torch.zeros_like(x) if g is None else g


def DQAS_search(
    op_pool: Sequence[Callable[[Any, Any, int], None]],
    nslots: int,
    loss_fn: Callable[[Sequence[int], torch.Tensor], torch.Tensor],
    nparams_per_slot: int = 1,
    batch: int = 16,
    steps: int = 100,
    lr_struct: float = 0.1,
    lr_param: float = 0.05,
    seed: int = 42,
    verbose: bool = False,
    device: Any = None,
) -> Tuple[List[int], torch.Tensor, List[float]]:
    """Search over op choices per slot.

    ``loss_fn(ops, params)`` evaluates a concrete architecture; returns the
    best op sequence, trained parameters (on ``device``), and the loss
    history.
    """
    dev = config.resolve_device(device)
    rng = np.random.default_rng(seed)
    npool = len(op_pool) if not callable(op_pool) else op_pool  # allow int
    if not isinstance(npool, int):
        npool = len(op_pool)
    alpha = torch.zeros((nslots, npool), dtype=torch.float32, device=dev)  # structure logits
    params = torch.as_tensor(rng.normal(size=(nslots, nparams_per_slot)) * 0.1, dtype=torch.float32, device=dev)
    opt_s = _adam(lr_struct)([alpha])
    opt_p = _adam(lr_param)([params])

    history: List[float] = []
    for step in range(steps):
        probs = _np(torch.softmax(alpha, dim=-1))
        samples = np.stack(
            [[rng.choice(npool, p=probs[s]) for s in range(nslots)] for _ in range(batch)]
        )
        losses = []
        grads_p = torch.zeros_like(params)
        for b in range(batch):
            ops = [int(x) for x in samples[b]]
            v, gp = value_and_grad(lambda p: loss_fn(ops, p), params)
            losses.append(float(torch.real(v)))
            grads_p = grads_p + gp / batch
        losses_np = np.asarray(losses)
        baseline = losses_np.mean()
        # score-function gradient for structure logits
        galpha = np.zeros(tuple(alpha.shape))
        for b in range(batch):
            adv = (losses_np[b] - baseline) / (losses_np.std() + 1e-8)
            for s in range(nslots):
                onehot = np.zeros(npool)
                onehot[samples[b, s]] = 1.0
                galpha[s] += adv * (onehot - probs[s]) / batch
        _step(opt_s, alpha, galpha.astype(np.float32))
        _step(opt_p, params, grads_p)
        history.append(float(baseline))
        if verbose and step % 10 == 0:
            print(f"step {step}: mean loss {baseline:.6f}")
    a = _np(alpha)
    best_ops = [int(np.argmax(a[s])) for s in range(nslots)]
    return best_ops, params, history


# ======================================================================
# reference-parity DQAS infrastructure (applications/dqas.py:38-972)
# ======================================================================

_op_pool: Sequence[Any] = []


def set_op_pool(l: Sequence[Any]) -> None:
    """Set the global operator pool (role of reference ``dqas.py:38``)."""
    global _op_pool
    _op_pool = l


def get_op_pool() -> Sequence[Any]:
    """Get the global operator pool (role of reference ``dqas.py:44``)."""
    return _op_pool


def get_var(name: str) -> Any:
    """Fetch a local from the nearest enclosing frame that defines it.

    Plays the role of the reference's fixed-depth stack peek (``dqas.py:52``)
    but walks outward until the name is found, so helpers may be nested at
    any depth inside the search loop.
    """
    frame = _sys._getframe(1)
    while frame is not None:
        if name in frame.f_locals:
            return frame.f_locals[name]
        frame = frame.f_back
    raise KeyError(f"no enclosing DQAS frame defines {name!r}")


def verbose_output(max_prob: bool = True, weight: bool = True) -> None:
    """Report loop diagnostics from inside a DQAS search (role of ref :64)."""
    lines: List[str] = []
    if max_prob:
        peaks = _np(get_var("prob")).max(axis=1)
        lines.append(f"max probability for each layer:\n{peaks}")
    if weight:
        active = get_weights(get_var("nnp"), get_var("stp"))
        lines.append(f"associating weights: {_np(active)}")
    print("\n".join(lines))


def preset_byprob(prob: Any) -> List[int]:
    """Draw one op index per layer via vectorized inverse-CDF sampling
    (role of reference :86), from ``np.random``."""
    prob = _np(prob).astype(np.float64)
    cdf = np.cumsum(prob, axis=1)
    u = np.random.random(prob.shape[0]) * cdf[:, -1]
    picks = (u[:, None] > cdf).sum(axis=1)
    return np.minimum(picks, prob.shape[1] - 1).astype(int).tolist()


def _tensor(x: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=config.resolve_device())


def get_preset(stp: Any) -> torch.Tensor:
    """argmax op per layer (role of reference :96)."""
    return torch.argmax(_tensor(stp), dim=1)


def get_weights(nnp: Any, stp: Any = None, preset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Per-layer weights selected by preset/argmax(stp) (role of ref :100)."""
    nnp = _tensor(nnp)
    idx = get_preset(stp) if preset is None else torch.as_tensor(list(preset), dtype=torch.int64)
    return torch.gather(nnp, 1, idx.to(nnp.device)[:, None])[:, 0]


def get_weights_v2(nnp: Any, preset: Sequence[int]) -> torch.Tensor:
    """Multi-param-per-op variant (role of reference :118): gathers the
    chosen op's parameter row per layer, squeezing a trailing singleton."""
    nnp = _tensor(nnp)
    if nnp.dim() != 3:
        return get_weights(nnp, preset=list(preset))
    idx = torch.as_tensor(list(preset), dtype=torch.int64, device=nnp.device)[:, None, None]
    picked = torch.gather(nnp, 1, idx.expand(nnp.shape[0], 1, nnp.shape[2]))[:, 0, :]
    return picked[:, 0] if nnp.shape[2] == 1 else picked


def parallel_kernel(
    prob: Any,
    gdata: Any,
    nnp: Any,
    kernel_func: Callable[[Any, Any, Sequence[int]], Tuple[Any, Any]],
) -> Tuple[Any, Any, torch.Tensor]:
    """One MC sample: draw a preset, evaluate, return (loss, gnnp, ∇lnP).

    Role of reference :133; ∇_stp lnP(preset) for a softmax categorical is
    onehot(preset) − prob, built here by row indexing into an identity (a
    float32 tensor on ``prob``'s device).  The reference reseeds np.random
    because it forks worker processes; here the samples run in-process, so
    reseeding is deliberately omitted — it would clobber the caller's seed.
    """
    dev = prob.device if isinstance(prob, torch.Tensor) else config.resolve_device()
    prob = _np(prob)
    preset = preset_byprob(prob)
    loss, gnnp = kernel_func(gdata, nnp, preset)
    score = np.eye(prob.shape[1])[preset] - prob
    return loss, gnnp, torch.as_tensor(score, dtype=torch.float32, device=dev)


def void_generator() -> Iterator[Any]:
    return _itertools.repeat(None)


def single_generator(g: Any) -> Iterator[Any]:
    return _itertools.repeat(g)


def history_loss() -> Any:
    """Current baseline loss inside a DQAS loop (role of reference :175)."""
    return np.asarray(get_var("avcost1"))


def repr_op(element: Any) -> str:
    """Readable operator name (role of reference :179)."""
    if isinstance(element, str):
        return element
    if isinstance(element, (list, tuple)):
        return str(tuple(map(repr_op, element)))
    first_doc_line = (getattr(element, "__doc__", None) or "").split("\n", 1)[0]
    return first_doc_line or repr(element)


DQAS_search_simple = DQAS_search  # keep the compact API under its own name


def _dqas_search_reference(
    kernel_func: Callable[[Any, Any, Sequence[int]], Tuple[Any, Any]],
    *,
    g: Optional[Iterator[Any]] = None,
    op_pool: Optional[Sequence[Any]] = None,
    p: Optional[int] = None,
    p_nnp: Optional[int] = None,
    p_stp: Optional[int] = None,
    batch: int = 300,
    prethermal: int = 0,
    epochs: int = 100,
    parallel_num: int = 0,
    verbose: bool = False,
    verbose_func: Optional[Callable[[], None]] = None,
    history_func: Optional[Callable[[], Any]] = None,
    prob_clip: Optional[float] = None,
    baseline_func: Optional[Callable[[Sequence[float]], float]] = None,
    pertubation_func: Optional[Callable[[], Any]] = None,
    nnp_initial_value: Optional[Any] = None,
    stp_initial_value: Optional[Any] = None,
    network_opt: Optional[Optimizer] = None,
    structure_opt: Optional[Optimizer] = None,
    prethermal_opt: Optional[Optimizer] = None,
    prethermal_preset: Optional[Sequence[int]] = None,
    stp_regularization: Optional[Callable[[Any, Any], Any]] = None,
    nnp_regularization: Optional[Callable[[Any, Any], Any]] = None,
    device: Any = None,
) -> Tuple[Any, Any, Sequence[Any]]:
    """Reference-signature DQAS entrypoint (``dqas.py:190``).

    ``kernel_func(gdata, nnp, preset) -> (loss, grad_nnp)``; the structure
    distribution updates by REINFORCE with the batch-mean baseline;
    ``parallel_num`` is accepted for parity — the samples run in-process.
    The optimizers are factories ``params -> torch.optim.Optimizer``
    (default Adam(0.1), the structure's with betas (0.8, 0.99)); ``stp``
    and ``nnp`` are float32 tensors on ``device``.
    """
    dev = config.resolve_device(device)
    if op_pool is None:
        op_pool = get_op_pool()
    c = len(op_pool)
    set_op_pool(op_pool)
    if g is None:
        g = void_generator()
    if network_opt is None:
        network_opt = _adam(0.1)
    if structure_opt is None:
        structure_opt = _adam(0.1, b1=0.8, b2=0.99)
    if prethermal_opt is None:
        prethermal_opt = _adam(0.1)
    if nnp_initial_value is None:
        if p_nnp is None:
            p_nnp = p
        if p_nnp is None:
            raise ValueError(
                "cannot infer the nnp parameter shape: pass nnp_initial_value, p_nnp, or p"
            )
        nnp_initial_value = np.random.uniform(size=[p_nnp, c])
    if stp_initial_value is None:
        if p_stp is None:
            p_stp = p
        if p_stp is None:
            raise ValueError(
                "cannot infer the stp parameter shape: pass stp_initial_value, p_stp, or p"
            )
        stp_initial_value = np.zeros([p_stp, c])
    if p is None:
        p = stp_initial_value.shape[0]
    if baseline_func is None:
        baseline_func = np.mean
    nnp = torch.tensor(_np(nnp_initial_value), dtype=torch.float32, device=dev)
    stp = torch.tensor(_np(stp_initial_value), dtype=torch.float32, device=dev)
    net_state = network_opt([nnp])
    struct_state = structure_opt([stp])
    pre_state = prethermal_opt([nnp])
    history: List[Any] = []
    avcost1 = 0.0

    prob = torch.softmax(stp, dim=-1)
    for _, gdata in zip(range(prethermal), g):
        preset = prethermal_preset or preset_byprob(prob)
        _, gnnp = kernel_func(gdata, nnp, preset)
        _step(pre_state, nnp, gnnp)

    for epoch in range(epochs):
        prob = torch.softmax(stp, dim=-1)
        if prob_clip is not None:
            prob = torch.clamp(prob, (1 - prob_clip) / c, prob_clip)
            prob = prob / torch.sum(prob, dim=1, keepdim=True)
        deri_stp, deri_nnp, costl = [], [], []
        stp_pen = (
            stp_regularization(stp, nnp) if stp_regularization is not None else 0.0
        )
        nnp_pen = (
            nnp_regularization(stp, nnp) if nnp_regularization is not None else 0.0
        )
        for _, gdata in zip(range(batch), g):
            loss, gnnp, gs = parallel_kernel(
                prob,
                gdata,
                nnp + pertubation_func() if pertubation_func is not None else nnp,
                kernel_func,
            )
            lossf = float(np.real(_np(loss)))
            deri_stp.append((lossf - float(np.asarray(avcost1))) * _np(gs))
            deri_nnp.append(_np(gnnp))
            costl.append(lossf)
        avcost1 = baseline_func(costl)
        batched_gs = torch.as_tensor(np.mean(deri_stp, axis=0), dtype=torch.float32, device=dev) + stp_pen
        batched_gnnp = torch.as_tensor(np.mean(deri_nnp, axis=0), dtype=torch.float32, device=dev) + nnp_pen
        _step(net_state, nnp, batched_gnnp)
        _step(struct_state, stp, batched_gs)
        if verbose:  # pragma: no cover
            print(f"epoch {epoch}: mean loss {np.mean(costl):.6f} baseline {avcost1:.6f}")
            if verbose_func is not None:
                verbose_func()
        if history_func is not None:
            history.append(history_func())
        else:
            history.append(float(np.mean(costl)))
    return stp, nnp, history


_DQAS_search_simple_impl = DQAS_search_simple


def _dqas_dispatch(*args: Any, **kws: Any) -> Any:
    """``DQAS_search``: reference kernel_func API, or the compact
    (op_pool, nslots, loss_fn) form kept for backward compatibility."""
    if "loss_fn" in kws or "nslots" in kws or (len(args) >= 3 and not callable(args[0])):
        return _DQAS_search_simple_impl(*args, **kws)
    return _dqas_search_reference(*args, **kws)


DQAS_search = _dqas_dispatch  # type: ignore[assignment]


def qaoa_simple_train(
    preset: Sequence[int],
    graph: Any,
    vag_func: Optional[Any] = None,
    epochs: int = 60,
    batch: int = 1,
    nnp_shape: Optional[Sequence[int]] = None,
    nnp_initial_value: Optional[Any] = None,
    opt: Optional[Optimizer] = None,
    verbose: bool = False,
    device: Any = None,
) -> Tuple[torch.Tensor, float]:
    """Train circuit weights for a FIXED preset (reference ``dqas.py:454``);
    ``opt`` a factory ``params -> Optimizer``, default Adam(0.05)."""
    from . import vags as _vags

    dev = config.resolve_device(device)
    if vag_func is None:
        vag_func = _vags.qaoa_vag_energy
    if hasattr(graph, "edges"):
        gen = single_generator(graph)
    elif isinstance(graph, (list, tuple)):
        def _cyc() -> Iterator[Any]:
            while True:
                for gg in graph:
                    yield gg

        gen = _cyc()
    else:
        gen = graph
    c = len(get_op_pool())
    if nnp_initial_value is None:
        shape = list(nnp_shape) if nnp_shape is not None else [len(preset), c]
        nnp_initial_value = np.random.uniform(size=shape)
    nnp = torch.tensor(_np(nnp_initial_value), dtype=torch.float32, device=dev)
    if opt is None:
        opt = _adam(0.05)
    state = opt([nnp])
    loss = 0.0
    for _epoch in range(epochs):
        grad = torch.zeros_like(nnp)
        lsum = 0.0
        for _ in range(batch):
            gdata = next(gen)
            loss, gnnp = vag_func(gdata, nnp, preset)
            grad = grad + _tensor(gnnp).to(nnp.device) / batch
            lsum += float(np.real(_np(loss))) / batch
        _step(state, nnp, grad)
        if verbose and _epoch % 10 == 0:  # pragma: no cover
            print(f"epoch {_epoch}: loss {lsum:.6f}")
    return nnp, lsum


def parallel_qaoa_train(
    preset: Sequence[int],
    g: Any,
    vag_func: Any = None,
    opt: Optional[Optimizer] = None,
    epochs: int = 60,
    tries: int = 16,
    batch: int = 1,
    cores: int = 0,
    loc: float = 0.0,
    scale: float = 0.2,
    verbose: bool = False,
    device: Any = None,
) -> Sequence[Any]:
    """Multi-restart training for a fixed preset (reference ``dqas.py:528``).

    The reference farms tries over multiprocessing; here restarts run
    sequentially in this process.
    """
    c = len(get_op_pool())
    results = []
    for t in range(tries):
        init = np.random.normal(loc=loc, scale=scale, size=[len(preset), c])
        nnp, loss = qaoa_simple_train(
            preset, g, vag_func=vag_func, epochs=epochs, batch=batch,
            nnp_initial_value=init, opt=opt, verbose=False, device=device,
        )
        results.append((nnp, loss))
        if verbose:  # pragma: no cover
            print(f"try {t}: loss {loss:.6f}")
    return results


def evaluate_everyone(
    vag_func: Any,
    gdata: Iterator[Any],
    nnp: Any,
    presets: Sequence[Sequence[int]],
    batch: int = 1,
) -> Sequence[Tuple[Any, float]]:
    """Mean loss of each candidate preset (reference ``dqas.py:598``)."""
    losses = []
    nnp = _tensor(nnp, torch.float32)
    for preset in presets:
        loss = 0.0
        for _, g in zip(range(batch), gdata):
            loss += float(np.real(_np(vag_func(g, nnp, preset)[0])))
        losses.append((preset, loss / batch))
    return losses


# -- probabilistic-model (VAN/MADE) based DQAS (reference dqas.py:621-972) --


def _model(prob_model: Any) -> torch.nn.Module:
    return prob_model["model"] if isinstance(prob_model, dict) else prob_model


def log_prob_grads(model: torch.nn.Module, samples: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """∇ ln P(x) in the model's parameters for each row x of ``samples``:
    ``torch.func.vmap`` of ``torch.func.grad`` of ``model.log_prob`` on one
    row, a dict of parameter name to gradient per sample."""
    params = {k: v.detach() for k, v in model.named_parameters()}

    def lnp_one(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, p, (x[None, :],))[0]

    grads = torch.func.vmap(torch.func.grad(lnp_one), in_dims=(None, 0))(params, samples)
    return [{k: v[i] for k, v in grads.items()} for i in range(samples.shape[0])]


def van_sample(
    prob_model: Any, batch_size: int, key: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Sample architectures + per-sample ∇lnP from a MADE model.

    Reference ``dqas.py:621`` (TF GradientTape); ``prob_model`` is the
    module or a dict ``{"model": module}``; ``key`` a ``torch.Generator``
    on the model's device (default: one seeded from ``np.random``, as the
    JAX package seeds its key).  Returns (samples, [dict of parameter
    name to gradient, per sample]).
    """
    model = _model(prob_model)
    dev = next(model.parameters()).device
    if key is None:
        key = torch.Generator(device=dev).manual_seed(int(np.random.randint(0, 2**31 - 1)))
    with torch.no_grad():
        samples = model.sample(key, batch_size)
    return samples, log_prob_grads(model, samples)


def van_regularization(prob_model: Any, nnp: Any = None, lbd_w: float = 0.01, lbd_b: float = 0.01) -> torch.Tensor:
    """L2 regularization over the VAN's kernels/biases (reference :636)."""
    from .van import _l2_regularization

    return _l2_regularization(_model(prob_model), lbd_w, lbd_b)


def micro_sample(
    prob_model: Any,
    batch_size: int,
    repetitions: Optional[List[int]] = None,
    key: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """van_sample with layer-repetition expansion (reference ``dqas.py:642``)."""
    samples, glnprob_list = van_sample(prob_model, batch_size, key=key)
    samples = samples.to(torch.int32)
    if repetitions:
        # expand layer choices to their repeated slots by column gather
        samples = samples[:, torch.as_tensor(list(repetitions), dtype=torch.int64, device=samples.device)]
    return samples, glnprob_list


def DQAS_search_pmb(
    kernel_func: Callable[[Any, Any, Sequence[int]], Tuple[Any, Any]],
    prob_model: Any,
    *,
    sample_func: Optional[Callable[..., Any]] = None,
    g: Optional[Iterator[Any]] = None,
    op_pool: Optional[Sequence[Any]] = None,
    p_nnp: Optional[int] = None,
    batch: int = 16,
    epochs: int = 20,
    verbose: bool = False,
    nnp_initial_value: Optional[Any] = None,
    network_opt: Optional[Optimizer] = None,
    structure_opt: Optional[Optimizer] = None,
    loss_func: Optional[Callable[[Any], Any]] = None,
    loss_derivative_func: Optional[Callable[[Any], Any]] = None,
    validate_period: int = 0,
) -> Tuple[Any, torch.Tensor, Sequence[Any]]:
    """Probabilistic-model-based DQAS (reference ``dqas.py:666``).

    The architecture distribution is an autoregressive model (MADE); its
    parameters update in place by REINFORCE over sampled presets
    (``structure_opt``, default Adam(0.01)); circuit weights by the kernel
    gradients (``network_opt``, default Adam(0.1)), on the model's device.
    """
    if op_pool is None:
        op_pool = get_op_pool()
    c = len(op_pool)
    set_op_pool(op_pool)
    if g is None:
        g = void_generator()
    if sample_func is None:
        sample_func = van_sample
    if network_opt is None:
        network_opt = _adam(0.1)
    if structure_opt is None:
        structure_opt = _adam(0.01)
    model = _model(prob_model)
    mparams = dict(model.named_parameters())
    dev = next(iter(mparams.values())).device
    if nnp_initial_value is None:
        if p_nnp is None:
            p_nnp = model.n
        nnp_initial_value = np.random.uniform(size=[p_nnp, c])
    nnp = torch.tensor(_np(nnp_initial_value), dtype=torch.float32, device=dev)
    net_state = network_opt([nnp])
    struct_state = structure_opt(list(mparams.values()))
    history: List[Any] = []
    for epoch in range(epochs):
        samples, glnprob_list = sample_func(prob_model, batch)
        samples_np = _np(samples).astype(np.int32)
        losses, gnnps = [], []
        for b in range(batch):
            gdata = next(g)
            # binary MADE bits -> op index (c == 2) or modulo for small pools
            preset = [int(x) % c for x in samples_np[b]]
            loss, gnnp = kernel_func(gdata, nnp, preset)
            losses.append(float(np.real(_np(loss))))
            gnnps.append(_np(gnnp))
        baseline = float(np.mean(losses))
        # REINFORCE over the model parameters
        for name, prm in mparams.items():
            gstruct = torch.zeros_like(prm)
            for b in range(batch):
                gstruct = gstruct + (losses[b] - baseline) / batch * glnprob_list[b][name]
            prm.grad = gstruct.detach()
        with torch.no_grad():
            struct_state.step()
        _step(net_state, nnp, np.mean(gnnps, axis=0).astype(np.float32))
        history.append(baseline)
        if verbose:  # pragma: no cover
            print(f"epoch {epoch}: mean loss {baseline:.6f}")
    return prob_model, nnp, history
