"""Pauli propagation: the observable evolved backwards through the circuit.

Counterpart of ``tensorcircuit_ng_tpu/models/pauliprop.py``.  The dense
engine keeps a float32 coefficient vector over the Pauli strings of weight
at most k, in the JAX package's order (weight, then the sites as
``itertools.combinations``, then the codes 1-3 as ``itertools.product``),
plus a SINK entry for the weight pushed past k.  The basis lives on the
device as ``sites`` and ``codes`` ([dim, k], padded with site n and code 0);
the index of any string is computed from its sorted sites by the
combinatorial number system, so no Python tuple per string is made (the
``basis`` list and the ``index`` dict are built on first use only).

A gate on wires W groups the strings by their part off W (the "rest"):
group g holds the strings rest_g ⊗ c for the local codes c whose weight
stays within k.  A unitary's Pauli transfer matrix R[b, c] = tr(P_b U† P_c
U) / 2^m keeps the identity and mixes the other codes among themselves,
so the strings with nothing on W keep their coefficients, and with the
others gathered into a [groups, 4^m - 1] table G (a missing string reads 0)

    new[rest_g ⊗ b] = (G R'ᵀ)[g, b],   R' = R without the identity's row and column,

and the SINK gains the entries (G R'ᵀ)[g, b] whose string is above k, plus
its own coefficient.  That is one gather, one matmul, one ``index_copy`` and
one fixed-order sum: each output is summed in one order, so one input
gives the same bits twice (the JAX package's scatter-add adds in no fixed
order on the card; its R's identity row and column hold only rounding,
1e-17).  The maps are cached by wire tuple.  ``expectation`` and :func:`pauli_propagation` run
over the circuit's expanded QIR (``_expanded_qir``), so ``h_layer``,
``zzrx_layer`` and the other fused items propagate as their gates (the JAX
package reads ``to_qir()``, whose fused items have no gate: a KeyError).

:class:`SparsePauliPropagationEngine` is the host dict engine, as in the JAX
package; it copies each gate to the host.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config

__all__ = ["PauliPropagationEngine", "SparsePauliPropagationEngine", "pauli_propagation"]

_P = [
    np.eye(2, dtype=complex),
    np.array([[0, 1], [1, 0]], dtype=complex),
    np.array([[0, -1j], [1j, 0]], dtype=complex),
    np.array([[1, 0], [0, -1]], dtype=complex),
]


def _pauli_kron(codes: Sequence[int]) -> np.ndarray:
    m = np.eye(1, dtype=complex)
    for c in codes:
        m = np.kron(m, _P[c])
    return m


@functools.lru_cache(maxsize=8)
def _pauli_stack(m: int) -> np.ndarray:
    """[4^m, 2^m, 2^m]: the m-qubit Pauli products, the first qubit's code
    most significant."""
    return np.stack([_pauli_kron(c) for c in itertools.product(range(4), repeat=m)])


def _ptm(u: torch.Tensor, m: int) -> torch.Tensor:
    r"""R with U† P_a U = Σ_b R[b, a] P_b (real for a unitary U), float64, on
    the gate's device in complex128 (no host copy of a device gate): U† P_a
    U for the whole Pauli stack in one batched product, then R[b, a] = Re
    Σ_ij P_b[i, j] (U† P_a U)[j, i] / 2^m as one matmul."""
    d = 2**m
    u = u.reshape(d, d).to(torch.complex128)
    p = config.device_constant(_pauli_stack(m), u.device, torch.complex128)
    conj = u.mH @ p @ u  # [4^m, d, d]
    return torch.real(p.reshape(4**m, d * d) @ conj.transpose(1, 2).reshape(4**m, d * d).T) / d


def _gate_tensor(item: Dict[str, Any]) -> Any:
    g = item["gate"]
    return g.tensor if hasattr(g, "tensor") else g


def _host(u: Any) -> np.ndarray:
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().resolve_conj().numpy()
    return np.asarray(u)


def _plain_items(n: int, qir: Any) -> List[Dict[str, Any]]:
    """A circuit's or a QIR's items with the fused ones (``h_layer``,
    ``zzrx_layer``, ...) unfolded into their gates."""
    if hasattr(qir, "_expanded_qir"):
        return qir._expanded_qir()
    qir = list(qir)
    if all(item.get("gate") is not None for item in qir):
        return qir
    from .circuit import Circuit

    return Circuit(n, device="cpu")._expanded_qir(qir)


def _binom_table(n: int, k: int) -> np.ndarray:
    """[n + 1, k + 2] int64: C(a, b) (0 for b > a)."""
    t = np.zeros((n + 1, k + 2), dtype=np.int64)
    for a in range(n + 1):
        for b in range(min(a, k + 1) + 1):
            t[a, b] = math.comb(a, b)
    return t


def _combinations(n: int, w: int) -> np.ndarray:
    """[C(n, w), w] int64: ``itertools.combinations(range(n), w)`` in order,
    built a column at a time."""
    rows = np.zeros((1, 0), dtype=np.int64)
    for col in range(w):
        first = rows[:, -1] + 1 if col else np.zeros(len(rows), dtype=np.int64)
        last = n - (w - col)  # the largest entry that leaves room for the rest
        counts = np.maximum(last - first + 1, 0)
        rep = np.repeat(np.arange(len(rows)), counts)
        offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        rows = np.concatenate([rows[rep], (first[rep] + offs)[:, None]], axis=1)
    return rows


class PauliPropagationEngine:
    """Propagate a weight-truncated Pauli observable backwards through gates,
    on ``device`` (default: the configured device, which needs a card when
    it is CUDA)."""

    def __init__(self, n: int, k: int = 2, device: Union[None, str, torch.device] = None) -> None:
        self.n = n
        self.k = k
        self.device = config.resolve_device(device)
        dev = self.device
        sites, codes = [], []
        for w in range(k + 1):
            combos = torch.as_tensor(_combinations(n, w)).to(dev)
            ncode = 3**w
            j = torch.arange(ncode, device=dev)
            digits = torch.stack([(j // 3 ** (w - 1 - i)) % 3 + 1 for i in range(w)], dim=1) if w else j[:, None][:, :0]
            s = combos.repeat_interleave(ncode, dim=0)
            c = digits.repeat(combos.shape[0], 1)
            pad = k - w
            sites.append(torch.cat([s, torch.full((s.shape[0], pad), n, dtype=torch.int64, device=dev)], dim=1))
            codes.append(torch.cat([c, torch.zeros((c.shape[0], pad), dtype=torch.int64, device=dev)], dim=1))
        #: [dim, k] int64: each string's sites, ascending, padded with n
        self.sites = torch.cat(sites)
        #: [dim, k] int64: each string's codes (1 X, 2 Y, 3 Z), padded with 0
        self.codes = torch.cat(codes)
        self.dim = int(self.sites.shape[0])
        self.SINK = self.dim  # strings above locality k
        binom = _binom_table(n, k)
        self._binom = torch.as_tensor(binom).to(dev)
        offsets = np.concatenate([[0], np.cumsum([binom[n, w] * 3**w for w in range(k + 1)])])
        self._offsets = torch.as_tensor(offsets).to(dev)
        self._pow3 = torch.as_tensor(3 ** np.arange(k + 1, dtype=np.int64)).to(dev)
        self._weight = (self.sites < n).sum(dim=1)
        self._gate_map_cache: Dict[Tuple[int, ...], Tuple[torch.Tensor, ...]] = {}
        self._basis: Optional[List[Tuple[Tuple[int, int], ...]]] = None
        self._index: Optional[Dict[Tuple[Tuple[int, int], ...], int]] = None
        self._zmask: Optional[torch.Tensor] = None
        self._dense: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # the basis
    # ------------------------------------------------------------------

    @property
    def basis(self) -> List[Tuple[Tuple[int, int], ...]]:
        """Every string as a tuple of (site, code) pairs, in index order
        (built on first use: a Python tuple a string)."""
        if self._basis is None:
            sites, codes = self.sites.cpu().numpy(), self.codes.cpu().numpy()
            self._basis = [
                tuple((int(s), int(c)) for s, c in zip(srow, crow) if c) for srow, crow in zip(sites, codes)
            ]
        return self._basis

    @property
    def index(self) -> Dict[Tuple[Tuple[int, int], ...], int]:
        """String -> its index (built on first use)."""
        if self._index is None:
            self._index = {b: i for i, b in enumerate(self.basis)}
        return self._index

    def _rank(self, sites: torch.Tensor, codes: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """The basis index of each row's string made of its kept (site, code)
        pairs (sites ascending along a row); rows of weight above k give
        garbage, the caller masks them."""
        n = self.n
        keep = keep.to(torch.int64)
        w = keep.sum(dim=1).clamp(max=self.k)
        after = keep.flip(1).cumsum(1).flip(1)  # kept pairs from this one on
        a = (n - 1 - sites).clamp(min=0)
        terms = self._binom[a, after.clamp(max=self.k + 1)] * keep
        comb = self._binom[n, w] - 1 - terms.sum(dim=1)
        code = ((codes - 1) * self._pow3[(after - 1).clamp(min=0)] * keep).sum(dim=1)
        return self._offsets[w] + comb * self._pow3[w] + code

    def string_to_code(self, ps: Sequence[int]) -> int:
        """Index of a Pauli string in the truncated basis (SINK if weight > k)."""
        pairs = [(i, int(v)) for i, v in enumerate(ps) if v]
        if len(pairs) > self.k:
            return self.SINK
        if not pairs:
            return 0
        s = torch.tensor([[p[0] for p in pairs]], dtype=torch.int64, device=self.device)
        c = torch.tensor([[p[1] for p in pairs]], dtype=torch.int64, device=self.device)
        return int(self._rank(s, c, torch.ones_like(s, dtype=torch.bool))[0])

    def observable_vector(self, ps: Sequence[int]) -> torch.Tensor:
        """Coefficient vector (float32, length dim + 1) of one Pauli string."""
        v = torch.zeros(self.dim + 1, dtype=torch.float32, device=self.device)
        v[self.string_to_code(ps)] = 1.0
        return v

    get_initial_state = observable_vector

    # ------------------------------------------------------------------
    # gates
    # ------------------------------------------------------------------

    def _gate_maps(self, wires: Tuple[int, ...]) -> Tuple[Any, ...]:
        """(touch [T], slot [T], table [groups · (4^m - 1)], overflow or None)
        for the support ``wires``: the strings with a Pauli on the wires,
        each one's slot in the (group, local code) table, the string each
        slot holds (dim where it is above k), and the slots above k.  A
        group is a rest of weight below k (only those hold such strings).
        Built on the device, cached by wire tuple."""
        cached = self._gate_map_cache.get(wires)
        if cached is not None:
            return cached
        dev, n, dim = self.device, self.n, self.dim
        m = len(wires)
        nloc = 4**m - 1  # the local codes but the identity
        w = torch.as_tensor(wires, dtype=torch.int64, device=dev)
        if self._dense is None:  # [dim, n + 1] int8: each string's code a site
            self._dense = torch.zeros((dim, n + 1), dtype=torch.int8, device=dev)
            self._dense.scatter_(1, self.sites, self.codes.to(torch.int8))
        code = torch.zeros(dim, dtype=torch.int64, device=dev)
        for q in wires:
            code = code * 4 + self._dense[:, q]
        touch = torch.nonzero(code).reshape(-1)
        s, c = self.sites[touch], self.codes[touch]
        rest = self._rank(s, c, (s < n) & ~(s[:, :, None] == w).any(2))
        group = (code == 0) & (self._weight < self.k)
        gid = torch.cumsum(group, 0) - 1
        ngroups = int(gid[-1]) + 1 if dim else 0
        slot = gid[rest] * nloc + code[touch] - 1
        table = torch.full((ngroups * nloc,), dim, dtype=torch.int64, device=dev)
        table[slot] = touch
        overflow = None
        if self.k < n:
            j = torch.arange(1, nloc + 1, device=dev)
            nnz = sum(((j // 4**i) % 4 != 0).to(torch.int64) for i in range(m))
            over = (self._weight[group][:, None] + nnz[None, :]) > self.k
            overflow = over.reshape(-1) if bool(over.any()) else None
        maps = (touch, slot, table, overflow)
        self._gate_map_cache[wires] = maps
        return maps

    def apply_gate(self, coeffs: torch.Tensor, u: Any, wires: Sequence[int]) -> torch.Tensor:
        """obs' = U† obs U in the truncated basis.  A unitary's transfer
        matrix keeps the identity and mixes the other local codes among
        themselves, so the strings with nothing on the wires keep their
        coefficients and the others come from one table product."""
        wires = tuple(int(w) for w in wires)
        m = len(wires)
        if not isinstance(u, torch.Tensor):
            u = config.device_constant(np.asarray(u), coeffs.device, torch.complex128)
        r = _ptm(u.to(coeffs.device), m).to(coeffs.dtype)[1:, 1:]
        touch, slot, table, overflow = self._gate_maps(wires)
        padded = torch.cat([coeffs[: self.dim], coeffs.new_zeros(1)])
        with config.full_float32():
            new = (padded[table].reshape(-1, 4**m - 1) @ r.T).reshape(-1)
        out = coeffs.index_copy(0, touch, new[slot])
        if overflow is not None:
            out = torch.cat([out[: self.SINK], out[self.SINK:] + torch.sum(new * overflow)])
        return out

    def propagate(self, qir: Sequence[Dict[str, Any]], ps: Sequence[int]) -> torch.Tensor:
        """Backward-propagate observable ``ps`` through the gates of ``qir``."""
        coeffs = self.observable_vector(ps)
        for item in reversed(_plain_items(self.n, qir)):
            coeffs = self.apply_gate(coeffs, _gate_tensor(item), item["index"])
        return coeffs

    def _zero_state_mask(self) -> torch.Tensor:
        if self._zmask is None:
            z = ((self.codes == 3) | (self.sites == self.n)).all(dim=1)
            self._zmask = torch.cat([z, z.new_zeros(1)]).to(torch.float32)
        return self._zmask

    def expectation_zero_state(self, coeffs: torch.Tensor) -> torch.Tensor:
        """<0...0| obs |0...0>: the Z-only strings (and the identity) count 1."""
        return torch.sum(coeffs * self._zero_state_mask().to(coeffs.dtype))

    def get_ptm_1q(self, u: Any) -> torch.Tensor:
        """4x4 Pauli transfer matrix of a one-qubit unitary, on its device."""
        return self._ptm_of(u, 1)

    def get_ptm_2q(self, u: Any) -> torch.Tensor:
        """16x16 Pauli transfer matrix of a two-qubit unitary, on its device."""
        return self._ptm_of(u, 2)

    def _ptm_of(self, u: Any, m: int) -> torch.Tensor:
        if not isinstance(u, torch.Tensor):
            u = config.device_constant(np.asarray(u), self.device, torch.complex128)
        return _ptm(u, m).to(torch.float32)

    def expectation(self, circuit: Any, ps: Sequence[int]) -> torch.Tensor:
        """<0|C† P C|0> through this engine, over the circuit's expanded QIR."""
        return self.expectation_zero_state(self.propagate(circuit, ps))

    def compute_expectation_scan(self, qirs: Sequence[Any], ps: Sequence[int]) -> torch.Tensor:
        """<0|P(t)|0> after each segment of ``qirs`` (QIR lists or circuits),
        propagating from the last segment backwards; the first entry is
        <0|P|0>."""
        coeffs = self.observable_vector(ps)
        out = [self.expectation_zero_state(coeffs)]
        for seg in reversed(list(qirs)):
            for item in reversed(_plain_items(self.n, seg)):
                coeffs = self.apply_gate(coeffs, _gate_tensor(item), item["index"])
            out.append(self.expectation_zero_state(coeffs))
        return torch.stack(out)


def pauli_propagation(
    circuit: Any, ps: Sequence[int], k: int = 2, device: Union[None, str, torch.device] = None
) -> torch.Tensor:
    """<0|C† P C|0> by truncated Pauli propagation, on ``device`` (default:
    the circuit's)."""
    eng = PauliPropagationEngine(circuit.nqubits, k, device=getattr(circuit, "device", None) if device is None else device)
    return eng.expectation(circuit, ps)


class SparsePauliPropagationEngine:
    """Dict-of-coefficients Pauli propagation on the host, with magnitude
    truncation ``atol`` and locality cap ``k``: only the nonzero strings are
    kept.  Device gates are copied to the host."""

    def __init__(self, n: int, k: Optional[int] = None, atol: float = 1e-12) -> None:
        self.n = n
        self.k = k if k is not None else n
        self.atol = atol

    def observable_dict(self, ps: Sequence[int]) -> Dict[Tuple[Tuple[int, int], ...], complex]:
        return {self.string_to_code(ps): 1.0}

    get_initial_state = observable_dict

    def apply_gate(
        self, coeffs: Dict[Tuple[Tuple[int, int], ...], complex], u: Any, wires: Sequence[int]
    ) -> Dict[Tuple[Tuple[int, int], ...], complex]:
        wires = tuple(int(w) for w in wires)
        m = len(wires)
        r = _ptm(torch.as_tensor(_host(u)), m).numpy()  # [out, in]
        wire_set = set(wires)
        new: Dict[Tuple[Tuple[int, int], ...], complex] = {}
        for key, c in coeffs.items():
            on = {s: v for s, v in key if s in wire_set}
            rest = tuple((s, v) for s, v in key if s not in wire_set)
            code = 0
            for w in wires:
                code = code * 4 + on.get(w, 0)
            col = r[:, code]
            for new_code in np.flatnonzero(np.abs(col) > self.atol):
                digits = [(int(new_code) // 4 ** (m - 1 - i)) % 4 for i in range(m)]
                nkey = tuple(sorted(list(rest) + [(w, d) for w, d in zip(wires, digits) if d]))
                if len(nkey) > self.k:
                    continue  # locality truncation
                new[nkey] = new.get(nkey, 0.0) + c * col[new_code]
        return {kk: vv for kk, vv in new.items() if abs(vv) > self.atol}

    def propagate(self, qir: Any, ps: Sequence[int]) -> Dict[Any, complex]:
        coeffs = self.observable_dict(ps)
        for item in reversed(_plain_items(self.n, qir)):
            coeffs = self.apply_gate(coeffs, _gate_tensor(item), item["index"])
        return coeffs

    def expectation_zero_state(self, coeffs: Dict[Any, complex]) -> complex:
        return sum(c for key, c in coeffs.items() if all(v == 3 for _, v in key))

    def expectation(self, circuit: Any, ps: Sequence[int]) -> complex:
        """<0|C† P C|0> over the circuit's expanded QIR."""
        return self.expectation_zero_state(self.propagate(circuit, ps))

    def string_to_code(self, ps: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        """The dict key of a Pauli string."""
        return tuple((i, int(v)) for i, v in enumerate(ps) if v)

    def compute_expectation_scan(self, qirs: Sequence[Any], ps: Sequence[int]) -> List[complex]:
        coeffs = self.observable_dict(ps)
        out = [self.expectation_zero_state(coeffs)]
        for seg in reversed(list(qirs)):
            for item in reversed(_plain_items(self.n, seg)):
                coeffs = self.apply_gate(coeffs, _gate_tensor(item), item["index"])
            out.append(self.expectation_zero_state(coeffs))
        return out
