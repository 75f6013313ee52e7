"""``FiniteMPS``: an MPS state container over the port's ``MPSCircuit``.

Counterpart of ``tensorcircuit_ng_tpu/models/mps_base.py``: a stateful
facade with the same canonical-centre discipline and the same truncating
two-site update as :class:`~.mpscircuit.MPSCircuit`, plus transfer-matrix
environments for local observables and two-body correlators.  The tensors
live on the device of ``device`` (the configured device by default).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .mpscircuit import MPSCircuit, _as_tensor, _operand

__all__ = ["FiniteMPS"]


class FiniteMPS:
    """Finite MPS with a canonical centre and truncating two-site updates."""

    def __init__(
        self,
        tensors: Sequence[Any],
        center_position: Optional[int] = None,
        canonicalize: bool = True,
        device: Union[None, str, torch.device] = None,
    ):
        self._c = MPSCircuit(len(tensors), tensors=tensors, center_position=center_position or 0, device=device)
        if canonicalize:
            self.position(center_position or 0)

    @property
    def device(self) -> torch.device:
        return self._c.device

    @property
    def tensors(self) -> List[torch.Tensor]:
        return self._c._tensors

    @tensors.setter
    def tensors(self, ts: Sequence[Any]) -> None:
        self._c._tensors = [_as_tensor(t, self.device) for t in ts]

    @property
    def center_position(self) -> Optional[int]:
        return self._c._center

    @center_position.setter
    def center_position(self, pos: int) -> None:
        self._c._center = pos

    def __len__(self) -> int:
        return self._c._nqubits

    def position(self, site: int) -> None:
        """Move the orthogonality centre (QR sweeps, exact)."""
        self._c.position(site)

    def bond_dimensions(self) -> List[int]:
        return self._c.get_bond_dimensions()

    def norm(self) -> torch.Tensor:
        return self._c.norm()

    def apply_one_site_gate(self, gate: Any, site: int) -> None:
        self._c.apply_single_gate(gate, site)

    def apply_two_site_gate(
        self,
        gate: Any,
        site1: int,
        site2: int,
        max_singular_values: Optional[int] = None,
        max_truncation_err: Optional[float] = None,
        center_position: Optional[int] = None,
        relative: bool = False,
    ) -> torch.Tensor:
        """The truncating two-site update on adjacent sites.  Returns an
        empty tensor, as the JAX package does, not the discarded singular
        values."""
        assert abs(site1 - site2) == 1, "sites must be adjacent"
        split = {
            "max_singular_values": max_singular_values,
            "max_truncation_err": max_truncation_err or 0.0,
            "relative": relative,
        }
        self._c.apply_adjacent_double_gate(gate, min(site1, site2), max(site1, site2), split=split)
        if center_position is not None:
            self._c.position(center_position)
        return torch.zeros((0,), device=self.device)

    def _like(self, tensors: List[torch.Tensor]) -> "FiniteMPS":
        out = FiniteMPS(tensors, canonicalize=False, device=self.device)
        out.center_position = self.center_position
        return out

    def copy(self) -> "FiniteMPS":
        """A copy with its own tensors and the same centre."""
        return self._like([t.clone() for t in self.tensors])

    def conj(self) -> "FiniteMPS":
        """The complex-conjugate state, with the same centre."""
        return self._like([torch.conj(t).resolve_conj() for t in self.tensors])

    # -- transfer-matrix environments ----------------------------------

    def _left_envs(self) -> List[torch.Tensor]:
        """L[i]: ⟨psi|psi⟩ contracted strictly left of site i, (χ, χ)."""
        envs = []
        t0 = self.tensors[0]
        L = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
        for t in self.tensors:
            envs.append(L)
            L = torch.einsum("ab,adr,bds->rs", L, t, torch.conj(t))
        self._norm_sq = L[0, 0]
        return envs

    def _right_envs(self) -> List[torch.Tensor]:
        """R[i]: contracted strictly right of site i, (χ, χ)."""
        n = len(self)
        envs: List[Any] = [None] * n
        t0 = self.tensors[0]
        R = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
        for i in range(n - 1, -1, -1):
            envs[i] = R
            t = self.tensors[i]
            R = torch.einsum("ldr,mds,rs->lm", t, torch.conj(t), R)
        return envs

    def measure_local_operator(self, ops: List[Any], sites: Sequence[int]) -> List[torch.Tensor]:
        """⟨ops[k]⟩ at sites[k] (unnormalized)."""
        if len(ops) != len(sites):
            raise ValueError("measure_local_operator: len(ops) must equal len(sites)")
        lenvs, renvs = self._left_envs(), self._right_envs()
        res = []
        for op, site in zip(ops, sites):
            t = self.tensors[site]
            o = _operand(op, t, (t.shape[1], t.shape[1]))
            res.append(torch.einsum("ab,adr,ed,bes,rs->", lenvs[site], t, o, torch.conj(t), renvs[site]))
        return res

    def measure_two_body_correlator(
        self, op1: Any, op2: Any, site1: int, sites2: Sequence[int]
    ) -> List[torch.Tensor]:
        """⟨op1(site1) op2(s)⟩ for each s in ``sites2``; at s == site1 op2
        acts first (⟨op1 op2⟩ on that site)."""
        n = len(self)
        if not 0 <= site1 < n:
            raise ValueError(f"site1 {site1} out of range for n={n}")
        lenvs, renvs = self._left_envs(), self._right_envs()
        t0 = self.tensors[0]
        d = t0.shape[1]
        op1, op2 = _operand(op1, t0, (d, d)), _operand(op2, t0, (d, d))
        res = []
        for s in sites2:
            lo, hi = (s, site1) if s < site1 else (site1, s)
            env = lenvs[lo]
            for i in range(lo, hi + 1):
                t = self.tensors[i]
                if i == s == site1:
                    op = op1 @ op2
                elif i == site1:
                    op = op1
                elif i == s:
                    op = op2
                else:
                    op = None
                if op is None:
                    env = torch.einsum("ab,adr,bds->rs", env, t, torch.conj(t))
                else:
                    env = torch.einsum("ab,adr,ed,bes->rs", env, t, op, torch.conj(t))
            res.append(torch.einsum("rs,rs->", env, renvs[hi]))
        return res

    def left_envs(self, sites: Sequence[int]) -> Dict[int, torch.Tensor]:
        """Site -> its left environment."""
        envs = self._left_envs()
        return {s: envs[s] for s in sites}

    def right_envs(self, sites: Sequence[int]) -> Dict[int, torch.Tensor]:
        envs = self._right_envs()
        return {s: envs[s] for s in sites}

    def check_canonical(self) -> float:
        """The largest deviation from canonical form outside the centre."""
        dev = 0.0
        c = self._c._center
        for i, t in enumerate(self._c._tensors):
            bl, d, br = t.shape
            if c is not None and i < c:
                m = torch.reshape(t, (bl * d, br))
                eye = torch.eye(br, dtype=m.dtype, device=m.device)
                dev = max(dev, float(torch.abs(m.mH @ m - eye).max()))
            elif c is not None and i > c:
                m = torch.reshape(t, (bl, d * br))
                eye = torch.eye(bl, dtype=m.dtype, device=m.device)
                dev = max(dev, float(torch.abs(m @ m.mH - eye).max()))
        return dev
