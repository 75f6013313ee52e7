"""Exact scalar arithmetic for stabilizer ZX evaluation.

Counterpart of ``tensorcircuit_ng_tpu/zx/evaluator.py``: exact scalars of
the ring Z[ω] (ω = e^{iπ/4}) scaled by powers of √2,
(a + bω + cω² + dω³)·√2^p, as int32 torch tensors (coefficients [..., 4],
powers [...]) on their device, plus GF(2) linear algebra for
stabilizer-graph evaluation.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import config

Tensor = Any

__all__ = ["ExactScalarArray", "gf2_matmul", "gf2_rank", "evaluate"]


def _int32(x: Any, device: Any = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32) if device is None else x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.array(x), dtype=torch.int32, device=config.resolve_device(device))


class ExactScalarArray:
    """Batched exact scalars (a + bω + cω² + dω³)·(√2)^p, ω = e^{iπ/4}.

    ``coeffs``: int array [..., 4]; ``power``: int array [...] (zeros by
    default), both int32 tensors on the device of ``coeffs`` (the
    configured one for a non-tensor).  Products are exact integer
    arithmetic; :meth:`to_complex` materializes complex64."""

    def __init__(self, coeffs: Tensor, power: Optional[Tensor] = None):
        self.coeffs = _int32(coeffs)
        if power is None:
            power = torch.zeros(self.coeffs.shape[:-1], dtype=torch.int32, device=self.coeffs.device)
        self.power = _int32(power, self.coeffs.device)

    # constructors ------------------------------------------------------

    @classmethod
    def one(cls, shape: Tuple[int, ...] = ()) -> "ExactScalarArray":
        c = np.zeros(shape + (4,), dtype=np.int32)
        c[..., 0] = 1
        return cls(c)

    @classmethod
    def zero(cls, shape: Tuple[int, ...] = ()) -> "ExactScalarArray":
        return cls(np.zeros(shape + (4,), dtype=np.int32))

    @classmethod
    def from_phase_eighth(cls, k: Union[int, Tensor], shape: Tuple[int, ...] = ()) -> "ExactScalarArray":
        """ω^k (phase multiples of π/4); ``k`` an int or an int tensor."""
        k = torch.remainder(_int32(k), 8)
        sign = torch.where(k >= 4, -1, 1).to(torch.int32)
        c = sign[..., None] * torch.nn.functional.one_hot((k % 4).long(), 4).to(torch.int32)
        return cls(c)

    # arithmetic --------------------------------------------------------

    def __mul__(self, other: "ExactScalarArray") -> "ExactScalarArray":
        a, b = self.coeffs, other.coeffs
        shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
        out = [torch.zeros(shape, dtype=torch.int32, device=a.device) for _ in range(4)]
        # polynomial product mod ω^4 = -1
        for i in range(4):
            for j in range(4):
                term = a[..., i] * b[..., j]
                if i + j < 4:
                    out[i + j] = out[i + j] + term
                else:
                    out[i + j - 4] = out[i + j - 4] - term
        return ExactScalarArray(torch.stack(out, dim=-1), self.power + other.power)

    def __add__(self, other: "ExactScalarArray") -> "ExactScalarArray":
        # equal √2 powers add coefficientwise; otherwise the larger power is
        # lowered by multiplying with √2 = ω - ω³ on the host
        pa, pb = self.power, other.power
        if pa.shape == pb.shape and bool(torch.all(pa == pb)):
            return ExactScalarArray(self.coeffs + other.coeffs, pa)
        sa = self.coeffs.cpu().numpy()
        sb = other.coeffs.cpu().numpy()
        ppa = pa.cpu().numpy()
        ppb = pb.cpu().numpy()
        target = np.minimum(ppa, ppb)
        root2 = np.array([0, 1, 0, -1], dtype=np.int64)  # ω - ω³ = √2

        def lift(c: np.ndarray, times: int) -> np.ndarray:
            for _ in range(times):
                c = _poly_mul_np(c, root2)
            return c

        out = np.zeros(np.broadcast_shapes(sa.shape, sb.shape), dtype=np.int64)
        flat_shape = out.shape[:-1]
        sa_b = np.broadcast_to(sa, out.shape)
        sb_b = np.broadcast_to(sb, out.shape)
        ppa_b = np.broadcast_to(ppa, flat_shape)
        ppb_b = np.broadcast_to(ppb, flat_shape)
        t_b = np.broadcast_to(target, flat_shape)
        for mi in np.ndindex(*flat_shape):
            ca = lift(sa_b[mi].astype(np.int64), int(ppa_b[mi] - t_b[mi]))
            cb = lift(sb_b[mi].astype(np.int64), int(ppb_b[mi] - t_b[mi]))
            out[mi] = ca + cb
        dev = self.coeffs.device
        return ExactScalarArray(_int32(out, dev), _int32(np.array(t_b), dev))

    def __neg__(self) -> "ExactScalarArray":
        return ExactScalarArray(-self.coeffs, self.power)

    def scale_sqrt2(self, k: int) -> "ExactScalarArray":
        return ExactScalarArray(self.coeffs, self.power + k)

    def to_complex(self) -> torch.Tensor:
        """The scalars as complex64."""
        w = np.exp(1j * np.pi / 4)
        basis = torch.as_tensor(np.array([1.0, w, w**2, w**3], dtype=np.complex64), device=self.coeffs.device)
        val = torch.sum(self.coeffs.to(torch.complex64) * basis, dim=-1)
        return val * torch.pow(math.sqrt(2.0), self.power.to(torch.float32)).to(torch.complex64)

    def __repr__(self) -> str:
        return f"ExactScalarArray(coeffs={self.coeffs.cpu().numpy()}, power={self.power.cpu().numpy()})"

    @classmethod
    def create(cls, coeffs: Any, power: Any = None) -> "ExactScalarArray":
        """Constructor alias."""
        return cls(coeffs, power)

    def _split(self, axis: int):
        return [ExactScalarArray(torch.select(self.coeffs, axis, i), torch.select(self.power, axis, i))
                for i in range(self.coeffs.shape[axis])]

    def prod(self, axis: int = 0) -> "ExactScalarArray":
        """Product along ``axis`` by repeated exact products."""
        arrs = self._split(axis)
        out = arrs[0]
        for a in arrs[1:]:
            out = out * a
        return out

    def sum(self, axis: int = 0) -> "ExactScalarArray":
        """Sum along ``axis`` with exact power alignment."""
        arrs = self._split(axis)
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out

    def reduce(self, op: str = "prod", axis: int = 0) -> "ExactScalarArray":
        """``prod`` or ``sum`` along ``axis``."""
        return self.prod(axis) if op == "prod" else self.sum(axis)


def _poly_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(4, dtype=np.int64)
    for i in range(4):
        for j in range(4):
            k = i + j
            if k < 4:
                out[k] += a[i] * b[j]
            else:
                out[k - 4] -= a[i] * b[j]
    return out


def gf2_matmul(a: Tensor, b: Tensor) -> torch.Tensor:
    """(a @ b) mod 2 of integer arrays, int32 on the device of ``a`` (the
    configured one for a non-tensor).  The product runs in float64 (exact
    below 2^53; the card has no integer GEMM)."""
    ta = _int32(a)
    tb = _int32(b, ta.device)
    return torch.remainder(torch.matmul(ta.double(), tb.double()), 2).to(torch.int32)


def gf2_rank(m: Tensor) -> int:
    """GF(2) rank (host elimination, ``core.tableau._gf2_rank``)."""
    from ..core.tableau import _gf2_rank

    arr = m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
    return _gf2_rank(arr.astype(np.uint8))


def evaluate(compiled: Any, params: Any) -> Any:
    """A compiled scalar graph on a parameter batch: rows of (f-bits...,
    outcome bits..., 1), the probability of each row
    (``zx/scalar_graph.py``)."""
    return compiled.eval(params)
