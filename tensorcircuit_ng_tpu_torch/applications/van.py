"""Autoregressive models for neural-quantum-state workflows.

Counterpart of reference ``applications/van.py`` (MADE / PixelCNN used by
VQNHE): ``torch.nn`` modules with log-prob and autoregressive sampling.
Each module's parameters are created on ``device`` (default: the configured
one) from ``generator`` (a ``torch.Generator`` on the CPU, else torch's
global one) with flax's initializers; :func:`convert.van_params` loads a
flax parameter tree instead.  Each ``sample`` draws from a
``torch.Generator`` on the module's device (``None``: torch's default one
there).  The layouts are torch's: a dense weight is ``(out, in)``, a
convolution's ``(out, in, kh, kw)``; a PixelCNN takes and returns NHWC, as
the JAX package's does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import config

__all__ = ["MADE", "MaskedLinear", "MaskedConv2D", "ResidualBlock", "PixelCNN", "NMF"]

#: flax's lecun_normal: a normal truncated at ±2, scaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape: Sequence[int], fan_in: int, generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    return (w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(device)


class MaskedDense(torch.nn.Module):
    """A dense layer ``x @ (W * mask)^T + b``; ``mask`` in flax's ``(in,
    out)`` layout, kept transposed as a buffer beside the ``(out, in)``
    weight."""

    def __init__(self, features: int, mask: Any, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev = config.resolve_device(device)
        mask = np.asarray(mask, dtype=np.float32)
        self.features = features
        self.weight = torch.nn.Parameter(_lecun_normal((mask.shape[1], mask.shape[0]), mask.shape[0], generator, dev))
        self.bias = torch.nn.Parameter(torch.zeros(features, dtype=torch.float32, device=dev))
        self.register_buffer("mask", torch.as_tensor(np.ascontiguousarray(mask.T), device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.mask, self.bias)

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    def regularization(self, params: Any = None, lbd_w: float = 0.01, lbd_b: float = 0.01) -> torch.Tensor:
        """L2 penalty over kernels/biases (reference ``regularization``)."""
        return _l2_regularization(self if params is None else params, lbd_w, lbd_b)


MaskedLinear = MaskedDense  # reference name for the masked dense layer


class MADE(torch.nn.Module):
    """Masked autoencoder for distribution estimation over n binary spins."""

    def __init__(self, n: int, hidden: int = 64, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.n, self.hidden = n, hidden
        h = hidden
        # degrees: input i has degree i+1; hidden units cycle 1..n-1
        deg_in = np.arange(1, n + 1)
        deg_h = (np.arange(h) % max(n - 1, 1)) + 1
        mask1 = (deg_h[None, :] >= deg_in[:, None]).astype(np.float32)
        mask2 = (np.arange(1, n + 1)[None, :] > deg_h[:, None]).astype(np.float32)
        self.l1 = MaskedDense(h, mask1, device, generator)
        self.l2 = MaskedDense(n, mask2, device, generator)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Conditional logits p(x_i = 1 | x_<i>)."""
        return self.l2(torch.relu(self.l1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob(x)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        lg = self.logits(x)
        lp = -F.softplus(-lg) * x - F.softplus(lg) * (1 - x)
        return torch.sum(lp, dim=-1)

    def sample(self, generator: Optional[torch.Generator], batch: int) -> torch.Tensor:
        """``batch`` configurations, site by site: bit i is 1 where a
        uniform from ``generator`` lies below sigmoid(logit i)."""
        dev = self.l1.weight.device
        x = torch.zeros((batch, self.n), dtype=torch.float32, device=dev)
        for i in range(self.n):
            lg = self.logits(x)
            u = torch.rand((batch,), generator=generator, device=dev)
            x[:, i] = (u < torch.sigmoid(lg[:, i])).to(x.dtype)
        return x

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    @property
    def model(self) -> "MADE":
        """Self-reference for TF-era ``.model`` access (reference parity)."""
        return self

    def regularization(self, params: Any = None, lbd_w: float = 0.01, lbd_b: float = 0.01) -> torch.Tensor:
        """L2 penalty over kernels/biases (reference ``regularization``)."""
        return _l2_regularization(self if params is None else params, lbd_w, lbd_b)


# ======================================================================
# reference-parity autoregressive models (applications/van.py:57-400)
# ======================================================================


def conv_mask(mask_type: str, k: int) -> np.ndarray:
    """The ``(k, k)`` raster-order mask: rows below the centre and, on the
    centre row, the centre ("A") or what follows it ("B") cut."""
    assert mask_type in ("A", "B")
    mask = np.ones((k, k), dtype=np.float32)
    c = k // 2
    mask[c, c + (1 if mask_type == "B" else 0):] = 0.0
    mask[c + 1:, :] = 0.0
    return mask


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN in float32 (no TF32, whatever the global setting), restored
    on exit."""
    prior = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prior


class _Conv2dFP32(torch.autograd.Function):
    """``F.conv2d(x, w, b, padding=pad)`` (stride 1, NCHW) whose forward and
    backward both run with cuDNN's TF32 off: PyTorch leaves it on by
    default, and the port computes in float32."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
        with _cudnn_fp32():
            return F.conv2d(x, w, b, padding=pad)

    @staticmethod
    def setup_context(ctx: Any, inputs: Any, output: Any) -> None:
        x, w, _, ctx.pad = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx: Any, gy: torch.Tensor) -> Any:
        x, w = ctx.saved_tensors
        p = ctx.pad
        with _cudnn_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]], [1, 1], [p, p], [1, 1], False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


class MaskedConv2D(torch.nn.Module):
    """Autoregressive 2D convolution, mask type "A" (strict) or "B".

    Reference ``van.py:238`` (TF); pixels see only earlier pixels in
    raster order — the PixelCNN building block.  NHWC in and out, "SAME"
    padding; ``in_features`` channels in (flax infers them).  Forward and
    backward compute in float32 on the card whatever
    ``torch.backends.cudnn.allow_tf32`` says.
    """

    def __init__(self, mask_type: str, features: int, kernel_size: int = 3, in_features: int = 1,
                 device: Any = None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev = config.resolve_device(device)
        k = kernel_size
        self.mask_type, self.features, self.kernel_size = mask_type, features, k
        self.weight = torch.nn.Parameter(_lecun_normal((features, in_features, k, k), k * k * in_features,
                                                       generator, dev))
        self.bias = torch.nn.Parameter(torch.zeros(features, dtype=torch.float32, device=dev))
        self.register_buffer("mask", torch.as_tensor(conv_mask(mask_type, k), device=dev)[None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _Conv2dFP32.apply(x.permute(0, 3, 1, 2), self.weight * self.mask, self.bias, self.kernel_size // 2)
        return y.permute(0, 2, 3, 1)

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    def build(self, shape: Any = None) -> None:
        """keras-era no-op."""


class ResidualBlock(torch.nn.Module):
    """y = x + layers(x) (reference ``van.py:265``); a layer is a module or
    the string "relu"."""

    def __init__(self, layers: Sequence[Any]) -> None:
        super().__init__()
        self.layers = torch.nn.ModuleList([torch.nn.ReLU() if isinstance(l, str) else l for l in layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.layers:
            y = layer(y)
        return y + x

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)


class PixelCNN(torch.nn.Module):
    """Autoregressive PixelCNN over a 2D spin lattice (reference :277).

    ``forward(x[N,H,W,spin_channel]) -> logits[N,H,W,spin_channel]``; joint
    log-prob and raster-order sampling included.
    """

    def __init__(self, spin_channel: int, depth: int, filters: int, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spin_channel, self.depth, self.filters = spin_channel, depth, filters
        kw = {"device": device, "generator": generator}
        self.first = MaskedConv2D("A", filters, in_features=spin_channel, **kw)
        self.blocks = torch.nn.ModuleList([
            ResidualBlock([MaskedConv2D("B", filters, in_features=filters, **kw), "relu"])
            for _ in range(max(depth - 1, 0))
        ])
        self.head = MaskedConv2D("B", spin_channel, in_features=filters, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.first(x))
        for blk in self.blocks:
            y = blk(y)
        return self.head(y)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N,H,W] integer spins in [0, spin_channel)."""
        x = x.long()
        logits = self(F.one_hot(x, self.spin_channel).to(torch.float32))
        lp = torch.log_softmax(logits, dim=-1)
        sel = torch.gather(lp, -1, x[..., None])[..., 0]
        return torch.sum(sel, dim=(-1, -2))

    def sample(self, generator: Optional[torch.Generator], batch: int, h: int, w: int) -> torch.Tensor:
        """``batch`` [h, w] lattices in raster order, each pixel drawn from
        the softmax of its logits by ``generator``."""
        dev = self.head.weight.device
        x = torch.zeros((batch, h, w), dtype=torch.int64, device=dev)
        for i in range(h):
            for j in range(w):
                logits = self(F.one_hot(x, self.spin_channel).to(torch.float32))[:, i, j]
                x[:, i, j] = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]
        return x.to(torch.int32)

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)


class NMF(torch.nn.Module):
    """Naive-mean-field factorized distribution (reference ``van.py:345``).

    Independent categorical per site with trainable logits (``meanfield``,
    flax's "meanfield-parameter"); same log_prob/sample interface as
    MADE/PixelCNN.
    """

    def __init__(self, spin_channel: int, dimensions: Sequence[int], device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spin_channel, self.dimensions = spin_channel, tuple(dimensions)
        shape = self.dimensions + (spin_channel,)
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        self.meanfield = torch.nn.Parameter(w.to(config.resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob(x)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        lp = torch.log_softmax(self.meanfield, dim=-1)
        sel = torch.gather(lp.expand(x.shape + (self.spin_channel,)), -1, x[..., None])[..., 0]
        return torch.sum(sel, dim=tuple(range(1, sel.dim())))

    def sample(self, generator: Optional[torch.Generator], batch: int) -> torch.Tensor:
        """``batch`` draws, each site from its own softmax."""
        flat = torch.reshape(self.meanfield, (-1, self.spin_channel))
        cols = torch.multinomial(torch.softmax(flat, dim=-1), batch, replacement=True, generator=generator)
        return torch.reshape(cols.T.to(torch.int32), (batch,) + self.dimensions)

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)


def _l2_regularization(params: Any, lbd_w: float = 0.01, lbd_b: float = 0.01) -> torch.Tensor:
    """Σ λ |w|² over a module's parameters (or a dict of name to tensor):
    ``lbd_b`` for the names with "bias" in them, ``lbd_w`` for the rest."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    reg: Any = 0.0
    for name, leaf in items:
        lbd = lbd_b if "bias" in name else lbd_w
        reg = reg + lbd * torch.sum(leaf**2)
    return reg
