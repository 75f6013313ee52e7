"""``MPSCircuit``: the matrix-product-state simulator of the port.

Counterpart of ``tensorcircuit_ng_tpu/models/mpscircuit.py``.  The state is
a chain of site tensors (l, d, r) on the circuit's device with a canonical
centre; a one-site gate contracts into its site, a two-site gate on
adjacent sites moves the centre there (QR sweeps), contracts the pair and
splits it again by the truncated SVD of ``core/linalg.truncated_svd`` (the
Gram-eigh SVD on a CUDA tensor, the exact SVD elsewhere; on the Gram
route a complex64 chain's SVDs and QRs run in complex128), and gates on
sites further apart go through a SWAP network.  Bond dimensions are plain
Python ints that grow as min(rows, cols, cap) with each gate, the cap the
natural bound d^min(b, n-b) and the split rule's ``max_singular_values``;
``max_truncation_err`` masks singular values inside that static rank.

Readouts contract the chain without densifying it (``expectation``,
``expectation_ps``, ``amplitude``, ``norm``, ``proj_with_mps``,
``reduced_density_matrix``) unless asked for the state.  ``sample`` draws
all shots in one sweep from the right-canonical chain, a shot axis on the
boundary vector: the same ``status`` gives the JAX package's shots.
``device`` defaults to the configured device (``"cuda"`` unless
:func:`config.set_device` says otherwise); given tensors move there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from .. import quantum as qu
from ..backend import device_tensor
from ..core import linalg as _linalg
from ..core import statevec
from ..ops import gates as gates_mod
from ..ops.gates import Gate
from .abstractcircuit import AbstractCircuit
from .basecircuit import BaseCircuit

__all__ = ["MPSCircuit", "split_tensor"]


def _as_tensor(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A tensor keeps its device unless ``device`` is given; anything else
    goes to ``device`` or the configured device."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=config.resolve_device(device))


def _operand(g: Any, like: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """A gate (a ``Gate``, numpy or a tensor) in ``like``'s dtype and device."""
    if isinstance(g, Gate):
        g = g.tensor
    return torch.reshape(statevec._as_tensor(g, like), shape)


def split_tensor(
    tensor: Any,
    center_left: bool = True,
    split: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a matrix by the truncated SVD (when split rules are given) or
    by QR/RQ; the orthogonality centre lands on the left factor with
    ``center_left``, else on the right one."""
    split = split or {}
    use_svd = any(split.get(k) not in (None, 0, 0.0, False) for k in ("max_singular_values", "max_truncation_err"))
    tensor = _as_tensor(tensor)
    if use_svd:
        msv = split.get("max_singular_values")
        if msv is None:
            msv = min(tensor.shape)
        u, s, vh, _ = _linalg.truncated_svd(
            tensor,
            max_singular_values=msv,
            max_truncation_err=split.get("max_truncation_err", 0.0) or 0.0,
            relative=split.get("relative", False),
        )
        if center_left:
            return u * s.to(u.dtype)[None, :], vh
        return u, s.to(vh.dtype)[:, None] * vh
    return (_linalg.adaware_rq if center_left else _linalg.adaware_qr)(tensor)


def _truncate_to(m: torch.Tensor, cap: int, rules: Dict[str, Any]):
    u, s, vh, _ = _linalg.truncated_svd(
        m,
        max_singular_values=cap,
        max_truncation_err=rules.get("max_truncation_err", 0.0) or 0.0,
        relative=rules.get("relative", False),
    )
    return u, s, vh, cap


def _mps_sample(tensors: Sequence[torch.Tensor], status: torch.Tensor, d: int, eps: float):
    """Autoregressive shots of a right-canonical chain (centre at 0), one a
    row of ``status`` [batch, n]: the outcomes [batch, n] (int32) and each
    shot's probability [batch] (float32, as the JAX package keeps it).

    Each site contracts the shots' boundary vectors [batch, bond] into the
    site tensor, weighs the d outcomes by the squared norms of the rows,
    picks the first whose cdf reaches the uniform + ``eps``
    (``searchsorted(side="left")``, held to d-1), and carries that row,
    normalized, to the next site."""
    batch = status.shape[0]
    rows = torch.arange(batch, device=status.device)
    prob = torch.ones((batch,), dtype=torch.float32, device=status.device)
    v = None
    outcomes = []
    for i, t in enumerate(tensors):
        m = t[0].expand(batch, *t[0].shape) if v is None else torch.einsum("sb,bdc->sdc", v, t)
        weights = torch.sum(torch.abs(m) ** 2, dim=2)
        weights = weights / torch.sum(weights, dim=1, keepdim=True)
        cdf = torch.cumsum(weights, dim=1)
        r = status[:, i].to(cdf.dtype) + eps
        x = torch.clamp(torch.searchsorted(cdf, r[:, None].contiguous(), side="left")[:, 0], 0, d - 1)
        outcomes.append(x)
        prob = prob * weights[rows, x].to(prob.dtype)
        row = m[rows, x]
        v = row / torch.linalg.vector_norm(row, dim=1, keepdim=True).to(row.dtype)
    return torch.stack(outcomes, dim=1).to(torch.int32), prob


def _transfer(env: Optional[torch.Tensor], bra: torch.Tensor, ket: torch.Tensor) -> torch.Tensor:
    """Σ_{b,c,d} env[b, c] conj(bra[b, d, e]) ket[c, d, f] -> (e, f) as two
    matmuls (``env`` None: the chain's left end)."""
    c, d, f = ket.shape
    tmp = torch.reshape(ket, (c * d, f)) if env is None else torch.reshape(env @ torch.reshape(ket, (c, d * f)), (-1, f))
    return torch.reshape(bra, (-1, bra.shape[2])).mH @ tmp


class MPSCircuit(AbstractCircuit):
    """Matrix-product-state circuit simulator (TEBD-style)."""

    is_mps = True

    def __init__(
        self,
        nqubits: int,
        tensors: Optional[Sequence[Any]] = None,
        wavefunction: Optional[Any] = None,
        split: Optional[Dict[str, Any]] = None,
        dim: int = 2,
        center_position: Optional[int] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        super().__init__()
        self._nqubits = nqubits
        self._d = dim
        self._device = config.resolve_device(device)
        split = split or {}
        self.split = {
            "max_singular_values": split.get("max_singular_values"),
            "max_truncation_err": split.get("max_truncation_err", 0.0) or 0.0,
            "relative": split.get("relative", False),
        }
        dt = config.torch_dtype()
        if wavefunction is not None:
            self._tensors = self.wavefunction_to_tensors(wavefunction)
            self._center = nqubits - 1
        elif tensors is not None:
            self._tensors = [_as_tensor(t, self._device).to(dt) for t in tensors]
            self._center = center_position if center_position is not None else 0
        else:
            zero = torch.zeros((1, dim, 1), dtype=dt, device=self._device)
            zero[0, 0, 0] = 1.0
            self._tensors = [zero.clone() for _ in range(nqubits)]
            self._center = 0

    @property
    def device(self) -> torch.device:
        return self._device

    def _bond_cap(self, b: int) -> Optional[int]:
        """χ bound at bond b (between sites b-1 and b)."""
        chi = self.split["max_singular_values"]
        nat = min(self._d**b, self._d ** (self._nqubits - b))
        return nat if chi is None else min(nat, chi)

    def _copy_params(self) -> Dict[str, Any]:
        return {"nqubits": self._nqubits, "split": dict(self.split), "dim": self._d, "device": self._device}

    def copy(self) -> "MPSCircuit":
        c = MPSCircuit(**self._copy_params())
        c._tensors = list(self._tensors)
        c._center = self._center
        c._qir = [dict(i) for i in self._qir]
        return c

    # ------------------------------------------------------------------
    # split rules
    # ------------------------------------------------------------------

    def set_split_rules(self, split: Dict[str, Any]) -> None:
        """Set the truncation rules of the later two-site updates."""
        for key in ("max_singular_values", "max_truncation_err", "relative"):
            if key in split:
                self.split[key] = split[key]
        if self.split["max_truncation_err"] is None:
            self.split["max_truncation_err"] = 0.0

    # ------------------------------------------------------------------
    # canonical centre movement (QR sweeps)
    # ------------------------------------------------------------------

    def position(self, site: int) -> None:
        """Move the canonical centre to ``site`` by QR (RQ) sweeps."""
        while self._center < site:
            self._shift_right(self._center)
            self._center += 1
        while self._center > site:
            self._shift_left(self._center)
            self._center -= 1

    def _shift_right(self, i: int) -> None:
        t = self._tensors[i]
        bl, d, br = t.shape
        q, r = _linalg.adaware_qr(torch.reshape(t, (bl * d, br)))
        self._tensors[i] = torch.reshape(q, (bl, d, min(bl * d, br)))
        self._tensors[i + 1] = torch.einsum("ab,bdc->adc", r, self._tensors[i + 1])

    def _shift_left(self, i: int) -> None:
        t = self._tensors[i]
        bl, d, br = t.shape
        r, q = _linalg.adaware_rq(torch.reshape(t, (bl, d * br)))
        self._tensors[i] = torch.reshape(q, (min(bl, d * br), d, br))
        self._tensors[i - 1] = torch.einsum("adb,bc->adc", self._tensors[i - 1], r)

    # ------------------------------------------------------------------
    # gate application
    # ------------------------------------------------------------------

    def apply_general_gate(
        self,
        gate: Any,
        *index: int,
        name: Optional[str] = None,
        split: Optional[Dict[str, Any]] = None,
        mpo: bool = False,
        ir_dict: Optional[Dict[str, Any]] = None,
    ) -> None:
        if not isinstance(gate, Gate):
            gate = Gate(gate, name=name or "any")
        index = tuple(int(i) % self._nqubits for i in index)
        if ir_dict is None:
            ir_dict = {"gatef": None, "gate": gate, "index": index, "name": name or gate.name,
                       "split": split, "mpo": False}
        else:
            ir_dict = dict(ir_dict)
            ir_dict["index"] = index
        self._qir.append(ir_dict)
        k = len(index)
        if k == 1:
            self._apply_single(gate.tensor, index[0])
        elif k == 2:
            self.apply_double_gate(gate.tensor, index[0], index[1], split=split)
        else:
            self.apply_nqubit_gate(gate.tensor, *index, split=split)

    def _apply_single(self, g: Any, i: int) -> None:
        t = self._tensors[i]
        self._tensors[i] = torch.einsum("pq,aqb->apb", _operand(g, t, (self._d, self._d)), t)

    def _truncate_theta(self, theta: torch.Tensor, bond: int, rules: Dict[str, Any]):
        """SVD of theta with the static rank k = min(rows, cols, cap)."""
        rows, cols = theta.shape
        cap = self._bond_cap(bond)
        k = min(rows, cols) if cap is None else min(rows, cols, cap)
        u, s, vh, _ = _linalg.truncated_svd(
            theta,
            max_singular_values=k,
            max_truncation_err=rules.get("max_truncation_err", 0.0) or 0.0,
            relative=rules.get("relative", False),
        )
        return u, s, vh, k

    def _rules(self, split: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        rules = dict(self.split)
        if split:
            rules.update({k: v for k, v in split.items() if v is not None})
        return rules

    def apply_adjacent_double_gate(self, g: Any, i: int, j: int, split: Optional[Dict[str, Any]] = None) -> None:
        """The two-site update: the centre moves to the left site, the pair
        is contracted with the gate and split by the truncated SVD, the
        singular values kept on the left site (the centre stays there)."""
        assert abs(i - j) == 1
        left = min(i, j)
        self.position(left)
        d = self._d
        a, b = self._tensors[left], self._tensors[left + 1]
        g = _operand(g, a, (d,) * 4)
        if j < i:
            g = torch.permute(g, (1, 0, 3, 2))
        theta = torch.einsum("adb,bec->adec", a, b)
        theta = torch.einsum("pqde,adec->apqc", g, theta)
        bl, br = a.shape[0], b.shape[2]
        u, s, vh, k = self._truncate_theta(torch.reshape(theta, (bl * d, d * br)), left + 1, self._rules(split))
        self._tensors[left] = torch.reshape(u * s.to(u.dtype)[None, :], (bl, d, k))
        self._tensors[left + 1] = torch.reshape(vh, (k, d, br))

    def _swap(self, like: torch.Tensor) -> torch.Tensor:
        d = self._d
        swap = np.zeros((d, d, d, d))
        for a in range(d):
            for b in range(d):
                swap[b, a, a, b] = 1.0
        return config.device_constant(swap, like.device, like.dtype)

    def consecutive_swap(self, start: int, end: int) -> None:
        """A SWAP chain moving site ``start`` to ``end``."""
        swap = self._swap(self._tensors[0])
        step = 1 if end > start else -1
        for i in range(start, end, step):
            self.apply_adjacent_double_gate(swap, i, i + step)

    def apply_double_gate(self, g: Any, i: int, j: int, split: Optional[Dict[str, Any]] = None) -> None:
        """A two-site gate, through a SWAP network when the sites are not
        adjacent."""
        if abs(i - j) == 1:
            self.apply_adjacent_double_gate(g, i, j, split=split)
            return
        lo, hi = (i, j) if i < j else (j, i)
        self.consecutive_swap(lo, hi - 1)
        if i < j:
            self.apply_adjacent_double_gate(g, hi - 1, hi, split=split)
        else:
            self.apply_adjacent_double_gate(g, hi, hi - 1, split=split)
        self.consecutive_swap(hi - 1, lo)

    def apply_nqubit_gate(self, g: Any, *index: int, split: Optional[Dict[str, Any]] = None) -> None:
        """A gate on up to 6 sites: swapped into a contiguous window,
        applied to the window's dense block and split again site by site
        (ValueError past 6 sites, as in the JAX package)."""
        d = self._d
        k = len(index)
        if k > 6:
            raise ValueError("n-qubit MPS gates supported up to 6 sites")
        lo = min(index)
        sorted_idx = sorted(index)
        target = list(range(lo, lo + k))
        for pos in range(k):
            if sorted_idx[pos] != target[pos]:
                self.consecutive_swap(sorted_idx[pos], target[pos])
        order = sorted(range(k), key=lambda t: index[t])
        self.position(lo)
        block = self._tensors[lo]
        for s in range(lo + 1, lo + k):
            block = torch.tensordot(block, self._tensors[s], dims=([block.ndim - 1], [0]))
        bl, br = block.shape[0], block.shape[-1]
        gt = torch.permute(_operand(g, block, (d,) * (2 * k)), order + [k + o for o in order])
        gm = torch.reshape(gt, (d**k, d**k))
        bm = torch.einsum("pq,aqb->apb", gm, torch.reshape(block, (bl, d**k, br)))
        rest = torch.reshape(bm, (bl, -1))
        left_rows = bl
        rules = self._rules(split)
        for s in range(lo, lo + k - 1):
            u, sv, vh, kdim = self._truncate_theta(torch.reshape(rest, (left_rows * d, -1)), s + 1, rules)
            self._tensors[s] = torch.reshape(u, (left_rows, d, kdim))
            rest = sv.to(vh.dtype)[:, None] * vh
            left_rows = kdim
        self._tensors[lo + k - 1] = torch.reshape(rest, (left_rows, d, br))
        self._center = lo + k - 1
        for pos in range(k - 1, -1, -1):
            if target[pos] != sorted_idx[pos]:
                self.consecutive_swap(target[pos], sorted_idx[pos])

    # ------------------------------------------------------------------
    # MPO machinery
    # ------------------------------------------------------------------

    def gate_to_mpo(self, gate: Any, k: int) -> List[torch.Tensor]:
        """A dense k-site gate as MPO site tensors (l, out, in, r): exact
        successive SVDs along the chain (bonds up to d^2 a cut)."""
        d = self._d
        g = _as_tensor(gate.tensor if isinstance(gate, Gate) else gate, self._device)
        g = torch.reshape(g, (d,) * (2 * k))
        perm = []
        for j in range(k):
            perm.extend([j, k + j])
        rest = torch.reshape(torch.permute(g, perm), (1, -1))
        tensors: List[torch.Tensor] = []
        left_bond = 1
        for _ in range(k - 1):
            m = torch.reshape(rest, (left_bond * d * d, -1))
            u, s, vh = _linalg.adaware_svd(m)
            bond = min(m.shape)
            tensors.append(torch.reshape(u[:, :bond], (left_bond, d, d, bond)))
            rest = s[:bond].to(vh.dtype)[:, None] * vh[:bond]
            left_bond = bond
        tensors.append(torch.reshape(rest, (left_bond, d, d, 1)))
        return tensors

    def apply_mpo(self, mpo_tensors: Sequence[Any], *index: int, compress: bool = True) -> None:
        """Apply an MPO on contiguous ascending sites (each site's bond
        dimensions multiply), then :meth:`compress` unless told not to."""
        index = [int(q) for q in index]
        assert index == list(range(index[0], index[0] + len(index))), (
            "apply_mpo requires contiguous ascending sites; use swaps first"
        )
        for w, q in zip(mpo_tensors, index):
            a = self._tensors[q]
            w = statevec._as_tensor(w, a)
            new = torch.einsum("loir,bic->lborc", w, a)
            l, b, o, r, c2 = new.shape
            self._tensors[q] = torch.reshape(new, (l * b, o, r * c2))
        self._center = index[0]
        if compress:
            self.compress()

    def compress(self, max_singular_values: Optional[int] = None, max_truncation_err: Optional[float] = None) -> None:
        """A truncation sweep restoring the bond caps after bond-inflating
        operations (the centre ends on the last site)."""
        rules = dict(self.split)
        if max_singular_values is not None:
            rules["max_singular_values"] = max_singular_values
        if max_truncation_err is not None:
            rules["max_truncation_err"] = max_truncation_err
        n = self._nqubits
        self.position(n - 1)
        self.position(0)
        for i in range(n - 1):
            t = self._tensors[i]
            bl, d, br = t.shape
            m = torch.reshape(t, (bl * d, br))
            cap = br
            chi = rules.get("max_singular_values")
            nat = self._bond_cap(i + 1)
            if nat is not None:
                cap = min(cap, nat)
            if chi is not None:
                cap = min(cap, chi)
            cap = min(cap, bl * d)
            if cap == self._bond_cap(i + 1):
                u, s, vh, _ = self._truncate_theta(m, i + 1, rules)
            else:
                u, s, vh, _ = _truncate_to(m, cap, rules)
            self._tensors[i] = torch.reshape(u, (bl, d, u.shape[1]))
            carry = s.to(vh.dtype)[:, None] * vh
            self._tensors[i + 1] = torch.einsum("ab,bdc->adc", carry, self._tensors[i + 1])
        self._center = n - 1

    # ------------------------------------------------------------------
    # readout
    # ------------------------------------------------------------------

    def wavefunction(self, form: str = "default") -> torch.Tensor:
        """The full d^n vector, grown as (rows, bond) matrices."""
        psi = None
        for t in self._tensors:
            bl, d, br = t.shape
            if psi is None:
                psi = torch.reshape(t, (bl * d, br))
            else:
                psi = torch.reshape(psi @ torch.reshape(t, (bl, d * br)), (-1, br))
        return torch.reshape(psi, (-1,))

    state = wavefunction

    def proj_with_mps(self, other: "MPSCircuit") -> torch.Tensor:
        """⟨other|self⟩ by transfer contraction."""
        env = None
        for a, b in zip(other._tensors, self._tensors):
            env = _transfer(env, a, b)
        return env[0, 0]

    def norm(self) -> torch.Tensor:
        """||psi|| by transfer contraction (no densification)."""
        return torch.sqrt(torch.real(self.proj_with_mps(self)))

    def normalize(self) -> None:
        nrm = self.norm()
        c = self._center
        self._tensors[c] = self._tensors[c] / nrm.to(self._tensors[c].dtype)

    def amplitude(self, l: Union[str, Sequence[int]]) -> torch.Tensor:
        if isinstance(l, str):
            l = [int(ch, 36) for ch in l]
        env = None
        for t, v in zip(self._tensors, l):
            m = t[:, int(v), :]
            env = m if env is None else env @ m
        return env[0, 0]

    def expectation(
        self,
        *ops: Tuple[Any, Sequence[int]],
        reuse: bool = True,
        normalized: bool = True,
        **kws: Any,
    ) -> torch.Tensor:
        """⟨psi|O|psi⟩ by a transfer sandwich; with an operator on several
        sites, the overlap with a copy that has the operators applied."""
        norm_ops = []
        has_multi = False
        for o, wires in ops:
            if isinstance(o, Gate):
                o = o.tensor
            if not hasattr(wires, "__len__"):
                wires = [wires]
            wires = [int(w) % self._nqubits for w in wires]
            norm_ops.append((o, wires))
            has_multi = has_multi or len(wires) > 1
        if has_multi:
            c2 = self.copy()
            for o, wires in norm_ops:
                c2.any(*wires, unitary=o)
            val = self.proj_with_mps(c2)
        else:
            site_ops: Dict[int, torch.Tensor] = {}
            for o, wires in norm_ops:
                q = wires[0]
                m = _operand(o, self._tensors[q], (self._d, self._d))
                site_ops[q] = m if q not in site_ops else site_ops[q] @ m
            env = None
            for q, t in enumerate(self._tensors):
                env = _transfer(env, t, torch.einsum("pq,aqb->apb", site_ops[q], t) if q in site_ops else t)
            val = env[0, 0]
        if normalized:
            val = val / torch.real(self.proj_with_mps(self)).to(val.dtype)
        return val

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        **kws: Any,
    ) -> torch.Tensor:
        obs = []
        for name, qs in (("x", x), ("y", y), ("z", z)):
            for q in qs or ():
                obs.append((gates_mod.GATES[name](), [int(q)]))
        return self.expectation(*obs, **kws)

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------

    def wavefunction_to_tensors(self, wavefunction: Any) -> List[torch.Tensor]:
        """Factorize a dense state into site tensors by successive truncated
        SVDs (under this circuit's split rules)."""
        d, n = self._d, self._nqubits
        psi = torch.reshape(_as_tensor(wavefunction, self._device).to(config.torch_dtype()), (1, -1))
        tensors: List[torch.Tensor] = []
        rules = dict(self.split)
        for i in range(n - 1):
            bl = psi.shape[0]
            u, s, vh, k = self._truncate_theta(torch.reshape(psi, (bl * d, -1)), i + 1, rules)
            tensors.append(torch.reshape(u, (bl, d, k)))
            psi = s.to(vh.dtype)[:, None] * vh
        tensors.append(torch.reshape(psi, (psi.shape[0], d, 1)))
        return tensors

    def get_bond_dimensions(self) -> List[int]:
        return [int(t.shape[2]) for t in self._tensors[:-1]]

    def entanglement_entropy(self, cut: int) -> torch.Tensor:
        """The entropy of the Schmidt values of site ``cut``'s tensor with the
        centre moved there."""
        c2 = self.copy()
        c2.position(cut)
        t = c2._tensors[cut]
        bl, d, br = t.shape
        _, s, _ = _linalg.adaware_svd(torch.reshape(t, (bl * d, br)))
        p = s * s
        p = torch.clamp(p / torch.sum(p), 1e-12, 1.0)
        return -torch.sum(p * torch.log(p))

    @property
    def tensors(self) -> List[torch.Tensor]:
        return self._tensors

    # ------------------------------------------------------------------
    # sampling (no densification)
    # ------------------------------------------------------------------

    _MEASURE_EPS = 0.31415926e-12

    _uniforms = BaseCircuit._uniforms

    def _right_canonical(self) -> List[torch.Tensor]:
        c2 = self.copy()
        c2.position(0)
        return c2._tensors

    def perfect_sampling(
        self, status: Optional[Any] = None, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shot of every qubit, left to right, from the right-canonical
        chain: (outcomes (n,) int32, their probability).  The uniforms come
        from ``status`` (n), else from ``generator`` or the backend's
        implicit generator on the circuit's device."""
        n = self._nqubits
        if status is None:
            status = self._uniforms([n], generator)
        status = torch.reshape(device_tensor(status, self._device), (1, n))
        bits, prob = _mps_sample(self._right_canonical(), status, self._d, self._MEASURE_EPS)
        return bits[0], prob[0]

    def measure(
        self, *index: int, with_prob: bool = False, status: Optional[Any] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Measure the listed qubits: a shot of the whole register, the
        listed outcomes returned.  With ``status`` (one a listed qubit) the
        other qubits' uniforms are drawn from ``np.random.uniform``, as in
        the JAX package, so the outcome is not fixed by ``status`` alone."""
        full_status = None
        if status is not None:
            full = np.random.uniform(size=self._nqubits)
            st = status.detach().cpu().numpy() if isinstance(status, torch.Tensor) else np.asarray(status)
            for k, q in enumerate(index):
                full[q] = st[k]
            full_status = full
        bits, prob = self.perfect_sampling(status=full_status)
        res = bits[torch.as_tensor([int(q) for q in index], device=bits.device)]
        if with_prob:
            return res, prob
        return res, torch.tensor(-1.0, device=self._device)

    measure_jit = measure

    def sample(
        self,
        batch: Optional[int] = None,
        status: Optional[Any] = None,
        format: Optional[str] = None,
        allow_state: bool = False,
        random_generator: Optional[torch.Generator] = None,
        **kws: Any,
    ) -> Any:
        """``batch`` shots (one when None) in one batched sweep of the
        right-canonical chain; ``status`` [batch, n], else uniforms from
        ``random_generator`` (a ``torch.Generator`` on the circuit's device)
        or the backend's implicit generator.  ``format`` None gives
        (outcomes, probability) for ``batch=None``, else a list of them;
        else one of :func:`quantum.sample2all`'s formats."""
        nbatch = 1 if batch is None else batch
        n, d = self._nqubits, self._d
        if status is None:
            status = self._uniforms([nbatch, n], random_generator)
        status = torch.reshape(device_tensor(status, self._device), (-1, n))
        bits, probs = _mps_sample(self._right_canonical(), status, d, self._MEASURE_EPS)
        if format is None:
            if batch is None:
                return bits[0], probs[0]
            return [(bits[b], probs[b]) for b in range(nbatch)]
        idx = qu.sample_bin2int(bits, n, d)
        return qu.sample2all(idx, n, format=format, jittable=False, d=d)

    def get_quvector(self) -> qu.QuVector:
        return qu.QuVector.from_tensor(torch.reshape(self.wavefunction(), (self._d,) * self._nqubits))

    # ------------------------------------------------------------------
    # the rest of the JAX package's MPS API
    # ------------------------------------------------------------------

    def apply_single_gate(self, gate: Any, index: int) -> None:
        """A one-site gate, not recorded in the QIR."""
        self._apply_single(gate.tensor if isinstance(gate, Gate) else gate, int(index) % self._nqubits)

    def get_tensors(self) -> List[torch.Tensor]:
        return list(self._tensors)

    def get_center_position(self) -> Optional[int]:
        return self._center

    def get_norm(self) -> torch.Tensor:
        return self.norm()

    def conj(self) -> "MPSCircuit":
        """A copy with the tensors conjugated (on this circuit's device)."""
        c = self.copy()
        c._tensors = [torch.conj(t).resolve_conj() for t in c._tensors]
        return c

    def copy_without_tensor(self) -> "MPSCircuit":
        """A copy of the rules and the QIR on |0...0> (this device)."""
        c = MPSCircuit(**self._copy_params())
        c._qir = [dict(i) for i in self._qir]
        return c

    def is_valid(self) -> bool:
        """Whether the chain has n rank-3 tensors with matching bonds."""
        if len(self._tensors) != self._nqubits:
            return False
        if any(t.ndim != 3 for t in self._tensors):
            return False
        return all(self._tensors[i].shape[-1] == self._tensors[i + 1].shape[0] for i in range(self._nqubits - 1))

    def mid_measurement(self, index: int, keep: int = 0) -> None:
        """Post-select qubit ``index`` onto ``keep``, unnormalized."""
        proj = np.zeros((self._d, self._d))
        proj[keep, keep] = 1.0
        self.apply_single_gate(proj, index)

    def slice(self, begin: int, end: int) -> "MPSCircuit":
        """The sub-chain of qubits [begin, end] (inclusive), on this device."""
        tensors = [self._tensors[i] for i in range(begin, end + 1)]
        center = self._center - begin if begin <= self._center <= end else None
        return MPSCircuit(end - begin + 1, tensors=tensors, dim=self._d, split=dict(self.split),
                          center_position=center, device=self._device)

    @classmethod
    def reduce_tensor_dimension(
        cls,
        tensor_left: Any,
        tensor_right: Any,
        center_left: bool = True,
        split: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Truncate the shared bond of two site tensors by :func:`split_tensor`."""
        tensor_left, tensor_right = _as_tensor(tensor_left), _as_tensor(tensor_right)
        ni, di = tensor_left.shape[0], tensor_left.shape[1]
        dk, nk = tensor_right.shape[1], tensor_right.shape[2]
        theta = torch.reshape(torch.einsum("iaj,jbk->iabk", tensor_left, tensor_right), (ni * di, dk * nk))
        left, right = split_tensor(theta, center_left=center_left, split=split)
        return torch.reshape(left, (ni, di, -1)), torch.reshape(right, (-1, dk, nk))

    def reduce_dimension(
        self, index_left: int, center_left: bool = True, split: Optional[Dict[str, Any]] = None
    ) -> None:
        """Truncate the bond between sites ``index_left`` and ``index_left + 1``."""
        if split is None:
            split = self.split
        if self._center not in (index_left, index_left + 1):
            self.position(index_left)
        tl, tr = self._tensors[index_left], self._tensors[index_left + 1]
        ntl, ntr = self.reduce_tensor_dimension(tl, tr, center_left=center_left, split=split)
        self._tensors[index_left] = ntl
        self._tensors[index_left + 1] = ntr
        self._center = index_left if center_left else index_left + 1

    def gate_to_MPO(self, gate: Any, *index: int) -> Tuple[List[torch.Tensor], int]:
        """A dense gate on strictly increasing (possibly gapped) sites as
        MPO tensors (l, out, in, r), identities on the gaps, and the first
        site."""
        if not index:
            raise ValueError("`index` must contain at least one site.")
        if not all(index[i] < index[i + 1] for i in range(len(index) - 1)):
            raise ValueError("`index` must be strictly increasing.")
        core = self.gate_to_mpo(gate, len(index))
        index_left = int(index[0])
        rel = [int(q) - index_left for q in index]
        tensors: List[torch.Tensor] = []
        prev = None
        d = self._d
        for pos, w in zip(rel, core):
            if prev is not None:
                for _ in range(prev + 1, pos):
                    last = tensors[-1]
                    bond = last.shape[-1]
                    eye = torch.reshape(torch.eye(bond * d, dtype=last.dtype, device=last.device), (bond, d, bond, d))
                    tensors.append(torch.permute(eye, (0, 1, 3, 2)))
            tensors.append(w)
            prev = pos
        return tensors, index_left

    @classmethod
    def MPO_to_gate(cls, tensors: Sequence[Any]) -> Gate:
        """Contract MPO tensors (l, out, in, r) back into a dense gate."""
        out = None
        for w in tensors:
            w = _as_tensor(w)
            out = w if out is None else torch.einsum("...b,boir->...oir", out, w.to(out.device))
        k = (out.ndim - 2) // 2
        out = out[0, ..., 0]
        perm = list(range(0, 2 * k, 2)) + list(range(1, 2 * k, 2))
        return Gate(torch.permute(out, perm))

    def apply_MPO(
        self,
        tensors: Sequence[Any],
        index_left: int,
        center_left: bool = True,
        split: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Apply MPO tensors on the sites from ``index_left`` on."""
        self.apply_mpo(tensors, *range(index_left, index_left + len(tensors)))

    def reduced_density_matrix(self, subsystem_to_keep: Sequence[int]) -> torch.Tensor:
        """ρ of the KEPT qubits, in the order given (the opposite convention
        to ``quantum.reduced_density_matrix``, as in the JAX package)."""
        keep = list(subsystem_to_keep)
        env = torch.ones((1, 1), dtype=self._tensors[0].dtype, device=self._tensors[0].device)
        open_dims: List[int] = []
        for q in range(self._nqubits):
            t = self._tensors[q]
            if q in keep:
                env = torch.einsum("ab...,apc,bqd->cd...pq", env, t, torch.conj(t))
                open_dims.append(t.shape[1])
            else:
                env = torch.einsum("ab...,apc,bpd->cd...", env, t, torch.conj(t))
        rho = torch.reshape(env, tuple(d for d in open_dims for _ in (0, 1)))
        pos = {q: i for i, q in enumerate(sorted(keep))}
        perm = [2 * pos[q] for q in keep] + [2 * pos[q] + 1 for q in keep]
        dim = int(np.prod(open_dims))
        return torch.reshape(torch.permute(rho, perm), (dim, dim))
