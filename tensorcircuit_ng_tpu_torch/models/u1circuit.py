"""``U1Circuit``: the particle-number-conserving simulator of one sector.

Counterpart of ``tensorcircuit_ng_tpu/models/u1circuit.py``: the state is a
dense C(n, k) vector over the sorted int64 basis of the n-bit strings of
Hamming weight k, on the circuit's device.  Diagonal gates (``rz``,
``rzz``, ``cz``, ``cphase``, ``z``) multiply by phases from bit masks; any
other gate is checked for number conservation on the host copy of its
(2^k, 2^k) matrix (a ValueError otherwise) and applied as a gather,

    new[t] = Σ_b m[code_t, b] · ψ[src(t, b)],

code_t the support bits of basis state t and src(t, b) the basis state with
them replaced by b, over the codes b of code_t's weight (the others leave
the sector).  The maps are built on the device from the basis by bit
arithmetic and ``torch.searchsorted``, the targets grouped by code, and
cached by wire tuple on the circuit; autograd keeps about 1.5 sector
vectors a two-qubit gate.  A gather sums each target's terms in one order,
so a gate gives the same bits every time (a scatter-add on the card adds in
no fixed order).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from .. import quantum as qu
from ..backend import backend as K
from ..backend import device_tensor
from ..core import statevec
from ..ops.gates import Gate
from .abstractcircuit import AbstractCircuit

__all__ = ["U1Circuit", "U1Operator"]


def _sector_basis(n: int, k: int) -> np.ndarray:
    """The n-bit integers with k set bits, ascending (int64): those with
    the top bit clear (all smaller) before those with it set, built bit by
    bit for the weights k can still reach."""
    if not 0 <= k <= n:
        return np.zeros((0,), dtype=np.int64)
    level = {0: np.zeros((1,), dtype=np.int64)}  # weight -> the m-bit strings, ascending
    for m in range(1, n + 1):
        new = {}
        for j in range(max(0, k - (n - m)), min(m, k) + 1):
            parts = [level[j]] if j in level else []
            if j - 1 in level:
                parts.append(level[j - 1] | (1 << (m - 1)))
            new[j] = np.concatenate(parts)
        level = new
    return level[k]


class U1Circuit(AbstractCircuit):
    """Simulator restricted to the Hamming-weight-k U(1) sector."""

    def __init__(
        self,
        nqubits: int,
        filled: Optional[Sequence[int]] = None,
        inputs: Optional[Any] = None,
        k: Optional[int] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        super().__init__()
        if nqubits > 62:
            raise ValueError("U1Circuit supports at most 62 qubits (int64 masks)")
        self._nqubits = nqubits
        self._d = 2
        self._device = config.resolve_device(device)
        if filled is not None:
            k = len(filled)
        if k is None:
            raise ValueError("provide filled=[...] or k=")
        self.k = k
        self._filled = list(filled) if filled is not None else None
        self.basis = torch.as_tensor(_sector_basis(nqubits, k), device=self._device)
        #: wire tuple -> its index maps (:meth:`_index_maps`)
        self._maps: Dict[Tuple[int, ...], Any] = {}
        #: qubit -> its bit of each basis state (:meth:`_bit`)
        self._bits: Dict[int, torch.Tensor] = {}
        dim = self.basis.shape[0]
        cdt = config.torch_dtype()
        if inputs is not None:
            s = inputs if isinstance(inputs, torch.Tensor) else torch.as_tensor(np.asarray(inputs))
            self._state = torch.reshape(s.to(device=self._device, dtype=cdt), (dim,))
        else:
            v = 0
            for q in filled if filled is not None else range(k):
                v |= 1 << (nqubits - 1 - q)
            idx = int(torch.searchsorted(self.basis, torch.tensor(v, device=self._device)).item())
            if idx >= dim or int(self.basis[idx].item()) != v:
                raise ValueError(f"the filled sites {filled} are not a weight-{k} string")
            self._state = torch.zeros((dim,), dtype=cdt, device=self._device)
            self._state[idx] = 1.0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def sector_dim(self) -> int:
        return int(self.basis.shape[0])

    def _bit(self, q: int) -> torch.Tensor:
        """Bit q of each basis state (bool, on the device), kept once made."""
        q = int(q)
        bit = self._bits.get(q)
        if bit is None:
            bit = self._bits[q] = ((self.basis >> (self._nqubits - 1 - q)) & 1).to(torch.bool)
        return bit

    # ------------------------------------------------------------------
    # gates
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
        """A gate on ``index``, checked for number conservation (on the host
        copy of its matrix; a ValueError otherwise) and applied as a gather."""
        index = tuple(int(i) % self._nqubits for i in index)
        if not isinstance(gate, Gate):
            gate = Gate(gate, name=name or "any")
        dim = 2 ** len(index)
        m = gate.tensor
        m = m.reshape(dim, dim) if isinstance(m, torch.Tensor) else np.reshape(np.asarray(m), (dim, dim))
        host = m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else m
        weight = np.array([bin(a).count("1") for a in range(dim)])
        if np.any((np.abs(host) > 1e-9) & (weight[:, None] != weight[None, :])):
            raise ValueError("gate is not particle-number conserving on its support")
        if ir_dict is None:
            ir_dict = {"gatef": None, "gate": gate, "index": index, "name": name or "any", "split": None,
                       "mpo": False}
        else:
            ir_dict = dict(ir_dict)
            ir_dict["index"] = index
        self._qir.append(ir_dict)
        self._apply_sector_gate(m, index)

    def _index_maps(self, index: Tuple[int, ...]) -> Tuple[List[Tuple[int, List[Tuple[int, torch.Tensor]]]],
                                                            torch.Tensor]:
        """(for each support code a that occurs: a and, for each code b of
        the same weight, the source of every target of code a; the
        permutation from those targets, concatenated by code, to the basis
        order), built on the device once a wire tuple.  A source replaces
        the support bits of its target by b, which keeps it in the sector."""
        maps = self._maps.get(index)
        if maps is not None:
            return maps
        n, kk = self._nqubits, len(index)
        codes = torch.zeros_like(self.basis)
        mask = 0
        for q in index:
            codes = codes * 2 + self._bit(q).to(torch.int64)
            mask |= 1 << (n - 1 - q)
        base = self.basis & ~mask
        bits = []
        for b in range(2**kk):
            v = 0
            for pos, q in enumerate(index):
                if (b >> (kk - 1 - pos)) & 1:
                    v |= 1 << (n - 1 - q)
            bits.append(v)
        weight = [bin(b).count("1") for b in range(2**kk)]
        blocks, order = [], []
        for a in range(2**kk):
            targets = torch.nonzero(codes == a).reshape(-1)
            if targets.numel() == 0:
                continue
            base_t = base[targets]
            blocks.append((a, [(b, torch.searchsorted(self.basis, base_t | bits[b]))
                               for b in range(2**kk) if weight[b] == weight[a]]))
            order.append(targets)
        order = torch.cat(order)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        maps = (blocks, inv)
        self._maps[index] = maps
        return maps

    def _apply_sector_gate(self, m: Any, index: Tuple[int, ...]) -> None:
        """new[t] = Σ_b m[code_t, b] ψ[src(t, b)], the targets of one code
        at a time, then put back in the basis order by a gather."""
        blocks, inv = self._index_maps(tuple(int(q) for q in index))
        psi = self._state
        m = m.to(device=psi.device, dtype=psi.dtype) if isinstance(m, torch.Tensor) else \
            config.device_constant(np.asarray(m), psi.device, psi.dtype)
        vals = [sum(m[a, b] * psi[src] for b, src in pairs) for a, pairs in blocks]
        self._state = torch.cat(vals)[inv]

    def _phase(self, theta: Any) -> torch.Tensor:
        """An angle in the complex dtype on the device (keeps autograd)."""
        if isinstance(theta, torch.Tensor):
            theta = device_tensor(theta, self._device, "theta")
        return statevec.real_tensor(theta, self._device, self._state.dtype).to(self._state.dtype)

    def _record(self, name: str, index: Tuple[int, ...], theta: Any = None) -> None:
        item = {"gatef": None, "gate": None, "index": index, "name": name}
        if theta is not None:
            item["parameters"] = {"theta": theta}
        self._qir.append(item)

    def _diag(self, mask: torch.Tensor, off: torch.Tensor, on: torch.Tensor) -> None:
        """ψ times ``on`` where ``mask`` holds, else ``off`` (0-d phases)."""
        self._state = self._state * torch.where(mask, on, off)

    def rz(self, q: int, theta: Any = 0) -> None:
        """exp(-i theta/2) on bit 0, exp(+i theta/2) on bit 1."""
        t = self._phase(theta)
        self._diag(self._bit(q), torch.exp(-0.5j * t), torch.exp(0.5j * t))
        self._record("rz", (q,), theta)

    def rzz(self, i: int, j: int, theta: Any = 0) -> None:
        """exp(-i theta/2 Z_i Z_j)."""
        t = self._phase(theta)
        self._diag(self._bit(i) ^ self._bit(j), torch.exp(-0.5j * t), torch.exp(0.5j * t))
        self._record("rzz", (i, j), theta)

    def cz(self, i: int, j: int) -> None:
        one = torch.ones((), dtype=self._state.dtype, device=self._device)
        self._diag(self._bit(i) & self._bit(j), one, -one)
        self._record("cz", (i, j))

    def cphase(self, i: int, j: int, theta: Any = 0) -> None:
        """exp(i theta) where both bits are 1."""
        t = self._phase(theta)
        self._diag(self._bit(i) & self._bit(j), torch.ones_like(t), torch.exp(1j * t))
        self._record("cphase", (i, j), theta)

    def z(self, q: int) -> None:
        one = torch.ones((), dtype=self._state.dtype, device=self._device)
        self._diag(self._bit(q), one, -one)
        self._record("z", (q,))

    def _expanded_qir(self, items: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
        return list(self._qir if items is None else items)

    # ------------------------------------------------------------------
    # readout
    # ------------------------------------------------------------------

    def state(self, form: str = "default") -> torch.Tensor:
        return self._state

    wavefunction = state

    def to_dense(self) -> torch.Tensor:
        """The sector vector embedded in the full 2^n space."""
        full = torch.zeros((2**self._nqubits,), dtype=self._state.dtype, device=self._device)
        return full.index_put((self.basis,), self._state)

    def probability(self) -> torch.Tensor:
        return torch.real(torch.conj(self._state) * self._state)

    def expectation_ps(
        self,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
        **kws: Any,
    ) -> torch.Tensor:
        """⟨P⟩ of a Pauli string: a Z string from bit masks in the sector, any
        other through the dense embedding (the port's ``Circuit``)."""
        if not x and not y:
            p = self.probability()
            sign = torch.ones_like(p)
            for q in z or ():
                sign = sign * (1.0 - 2.0 * self._bit(q).to(p.dtype))
            return torch.sum(p * sign).to(self._state.dtype)
        from .circuit import Circuit

        return Circuit(self._nqubits, inputs=self.to_dense(), device=self._device).expectation_ps(x=x, y=y, z=z)

    def expectation_two_body(self, i: int, j: int) -> torch.Tensor:
        """⟨ψ| (|01⟩⟨10|)_{ij} |ψ⟩: the hopping of a particle from j to i."""
        m = np.zeros((4, 4), dtype=complex)
        m[1, 2] = 1.0
        c2 = self.copy()
        c2._apply_sector_gate(m, (int(i), int(j)))
        return torch.vdot(self._state, c2._state)

    def entanglement_entropy(self, cut: Sequence[int]) -> torch.Tensor:
        """The entropy of the qubits ``cut`` (through the dense embedding)."""
        other = [q for q in range(self._nqubits) if q not in set(cut)]
        return qu.entropy(qu.reduced_density_matrix(self.to_dense(), other))

    def copy(self) -> "U1Circuit":
        c = U1Circuit(self._nqubits, k=self.k, inputs=self._state, device=self._device)
        c._qir = [dict(i) for i in self._qir]
        c._maps = self._maps
        return c

    def expectation_z(self, i: int) -> torch.Tensor:
        """⟨Z_i⟩ from bit masks (no dense embedding)."""
        p = self.probability()
        return torch.sum(p * (1.0 - 2.0 * self._bit(i).to(p.dtype)))

    def expectation_pss(self, ps_list: Sequence[Any], coefficients: Any) -> torch.Tensor:
        """Σ_j c_j ⟨P_j⟩, each P_j a ``ps`` list (0/1/2/3) or an x/y/z dict;
        real unless the coefficients are complex."""
        coefficients = coefficients if isinstance(coefficients, torch.Tensor) else torch.as_tensor(
            np.asarray(coefficients), device=self._device)
        acc = None
        for j, ps in enumerate(ps_list):
            if isinstance(ps, dict):
                x, y, z = ps.get("x"), ps.get("y"), ps.get("z")
            else:
                x = [q for q, v in enumerate(ps) if v == 1]
                y = [q for q, v in enumerate(ps) if v == 2]
                z = [q for q, v in enumerate(ps) if v == 3]
            ev = self.expectation_ps(x=x, y=y, z=z)
            if not coefficients.is_complex():
                ev = torch.real(ev)
            term = coefficients[j] * ev.to(coefficients.dtype)
            acc = term if acc is None else acc + term
        return acc

    def probability_full(self) -> torch.Tensor:
        """The probabilities over the full 2^n basis."""
        dense = self.to_dense()
        return torch.real(torch.conj(dense) * dense)

    def measure(self, *index: int, with_prob: bool = False, status: Optional[Any] = None) -> Tuple[torch.Tensor, Any]:
        """Sample the register once (one uniform: ``status``), the bits at
        ``index`` (and the shot's probability with ``with_prob``)."""
        p = self.probability()
        p = p / torch.sum(p)
        idx = K.probability_sample(1, p, status=status)
        bits = qu.sample_int2bin(self.basis[idx.to(torch.int64)], self._nqubits)[0]
        sel = bits[torch.as_tensor([int(q) for q in index], device=self._device)]
        if with_prob:
            return sel, p[idx[0].to(torch.int64)]
        return sel, -1.0

    measure_jit = measure

    def reduced_density_matrix(
        self,
        subsystem_to_keep: Optional[Sequence[int]] = None,
        subsystem_to_traceout: Optional[Sequence[int]] = None,
        return_blocks: bool = False,
    ) -> Any:
        """ρ of the kept qubits, or with ``return_blocks`` its k_A-charge
        blocks (ρ of a number-conserving state is block diagonal in the
        charge of the kept register), k_A = 0..|A|."""
        n = self._nqubits
        if subsystem_to_keep is None and subsystem_to_traceout is None:
            raise ValueError("specify one of subsystem_to_keep / subsystem_to_traceout")
        if subsystem_to_keep is not None:
            keep = list(subsystem_to_keep)
            traceout = [q for q in range(n) if q not in set(keep)]
        else:
            traceout = list(subsystem_to_traceout)
            keep = [q for q in range(n) if q not in set(traceout)]
        rho = qu.reduced_density_matrix(self.to_dense(), traceout)
        if not return_blocks:
            return rho
        blocks = []
        for ka in range(len(keep) + 1):
            inds = torch.as_tensor(qu.u1_inds(len(keep), ka), device=rho.device)
            blocks.append(rho[inds][:, inds])
        return blocks

    def _copy_params(self) -> Dict[str, Any]:
        return {"nqubits": self._nqubits, "filled": self._filled, "k": self.k, "device": self._device}

    def sample(
        self,
        batch: Optional[int] = None,
        status: Optional[Any] = None,
        format: Optional[str] = None,
        random_generator: Optional[torch.Generator] = None,
        **kws: Any,
    ) -> Any:
        """``batch`` shots by inverse CDF over the sector, one uniform a
        shot: ``status`` [batch], or the first column of a [batch, n] one
        (the trajectory route's shape).  ``format`` None: (bits, -1.0) a
        shot; else :func:`quantum.sample2all`'s formats."""
        nbatch = 1 if batch is None else batch
        p = self.probability()
        p = p / torch.sum(p)
        if status is not None:
            status = device_tensor(status, self._device)
            if status.ndim == 2:
                status = status[:, 0]
        idx = K.probability_sample(nbatch, p, status=status, g=random_generator)
        full_idx = self.basis[idx.to(torch.int64)]
        if format is None:
            bins = qu.sample_int2bin(full_idx, self._nqubits)
            if batch is None:
                return bins[0], -1.0
            return [(bins[b], -1.0) for b in range(nbatch)]
        return qu.sample2all(full_idx, self._nqubits, format=format, jittable=False)


class U1Operator:
    """A Pauli-string sum projected on the weight-k sector, as a dense
    C(n, k) matrix on ``device`` (the configured one by default)."""

    def __init__(self, n: int, k: int, ps_list: Sequence[Any], coefficients: Any,
                 device: Union[None, str, torch.device] = None):
        self.n = n
        self.k = k
        inds = _sector_basis(n, k)
        ls = [[int(v) for v in (qu.xyz2ps(ps, n) if isinstance(ps, dict) else ps)] for ps in ps_list]
        coeffs = coefficients.detach().cpu().numpy() if isinstance(coefficients, torch.Tensor) else coefficients
        dense = qu.PauliStringSum2Dense(ls, list(np.asarray(coeffs)), numpy=True)
        self.matrix = torch.as_tensor(dense[np.ix_(inds, inds)], device=config.resolve_device(device))

    def __call__(self, state: Any) -> torch.Tensor:
        s = state if isinstance(state, torch.Tensor) else torch.as_tensor(np.asarray(state))
        return self.matrix @ s.to(device=self.matrix.device, dtype=self.matrix.dtype)

    matvec = __call__

    def expectation(self, state: Any) -> torch.Tensor:
        s = state if isinstance(state, torch.Tensor) else torch.as_tensor(np.asarray(state))
        s = s.to(device=self.matrix.device, dtype=self.matrix.dtype)
        return torch.vdot(s, self.matrix @ s)
