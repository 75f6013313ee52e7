"""Sharded statevector simulation: one exact state split over a mesh.

Counterpart of ``tensorcircuit_ng_tpu/parallel/sharded_state.py``.  The
(2^n,) state is split on its leading axis over a 1-D mesh
(:mod:`parallel.mesh`): the top ``k = log2(ndev)`` qubits index the shard
and the other ``n - k`` the shard's chunk, so every gate on those is local,
and a gate on a top qubit is an exchange between shard pairs ``(d, d ^
mask)``.  Per layer: diagonal ops (zz phases, ``multicz``, ``rzm``) on any
wires need no communication (the top bits are constants of the shard); a
1q gate on a top wire is one paired exchange of the chunk; a generic
k-local gate with t top wires swaps them with free local wires and back
(2t exchanges).  Z-string readouts are one ``psum``.

The state is a :class:`ShardedState`, one local tensor a shard of this
process; only :meth:`ShardedStatevec.gather` joins the chunks.  Each
shard's local step calls the dense layer functions of ``core/kernels``
(``fused_zzrx_layer``, ``fused_rx_layer``, ``fused_single_qubit_layer``)
and ``core/statevec`` (``apply_unitary``, ``apply_diagonal``,
``apply_zz_product_phase``): a CUDA shard launches the kernels (K1/K6
forward, K3/K7/K8 backward), a CPU shard takes their plain versions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..backend import backend as K
from ..backend import check_generator
from ..core import kernels, statevec
from ..ops.gates import Gate, rx_matrix, rzm_diagonal
from .mesh import AnyMesh

Tensor = Any

__all__ = ["ShardedStatevec", "ShardedState"]

_H = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)


class ShardedState:
    """The chunks of one sharded statevector that this process holds:
    ``shards[i]`` is shard ``engine.mesh.shard_ids[i]``'s, on its device.
    Never joined implicitly: :meth:`gather` gives the dense state."""

    def __init__(self, engine: "ShardedStatevec", shards: List[Tensor]) -> None:
        self.engine = engine
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self) -> Tensor:
        return self.engine.gather(self)

    def __repr__(self) -> str:
        return (f"ShardedState(n={self.engine.n}, {len(self.shards)} of {self.engine.ndev} shards of "
                f"{self.engine.local_size}, {self.dtype})")


def _matrix(g: Any) -> Any:
    """A gate operand as its array: a ``Gate``'s tensor, else as given."""
    return g.tensor if isinstance(g, Gate) else g


class ShardedStatevec:
    """Exact n-qubit statevector split over a 1-D mesh.

    Usage::

        mesh = Mesh(["cuda:0"] * 4, ("sv",))
        sv = ShardedStatevec(n, mesh)
        psi = sv.init_zero()
        psi = sv.h(psi, 0)
        psi = sv.apply(psi, rx_matrix(theta), [5])
        e = sv.expectation_z(psi, [0, 1])

    The methods are functional (state in, state out) and differentiable."""

    def __init__(self, n: int, mesh: AnyMesh, axis: str = "sv") -> None:
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        self.k = int(round(math.log2(self.ndev)))
        if 2**self.k != self.ndev:
            raise ValueError(f"the shard count must be a power of two, got {self.ndev}")
        if n <= self.k:
            raise ValueError(f"need at least one local qubit: n={n} on {self.ndev} shards")
        self.nlocal = n - self.k
        self.local_size = 2**self.nlocal

    # -- helpers ---------------------------------------------------------

    def _state(self, shards: List[Tensor]) -> ShardedState:
        return ShardedState(self, shards)

    def _shards(self, psi: ShardedState) -> List[Tuple[Tensor, int]]:
        return list(zip(psi.shards, self.mesh.shard_ids))

    def _device_bit(self, q: int, d: int) -> int:
        """Shard ``d``'s value of top qubit ``q``."""
        return (d >> (self.k - 1 - q)) & 1

    def _pairs(self, q: int) -> List[Tuple[int, int]]:
        mask = 1 << (self.k - 1 - q)
        return [(d, d ^ mask) for d in range(self.ndev)]

    def _cdtype(self) -> torch.dtype:
        return config.torch_dtype()

    def _rdtype(self) -> torch.dtype:
        return getattr(torch, config.rdtypestr())

    def _rep(self, x: Any) -> Any:
        """A value every shard reads whole, through ``mesh.replicate``."""
        return self.mesh.replicate(x) if isinstance(x, torch.Tensor) else x

    def _thetas(self, thetas: Any) -> Tensor:
        t = statevec.real_tensor(thetas, self.mesh.device, self._cdtype())
        return self._rep(torch.reshape(t, (-1,)))

    def _swap_top_local(self, locs: List[Tensor], q_top: int, q_local: int) -> List[Tensor]:
        """SWAP top qubit ``q_top`` with local qubit ``q_local``: each shard
        keeps the half whose local bit equals its top bit and exchanges the
        other half with its partner."""
        lq = q_local - self.k
        left = 2**lq
        right = self.local_size // (2 * left)
        bits = [self._device_bit(q_top, d) for d in self.mesh.shard_ids]
        keeps, sends = [], []
        for x, b in zip(locs, bits):
            v = torch.reshape(x, (left, 2, right))
            keeps.append(v[:, b])
            sends.append(v[:, 1 - b])
        recvs = self.mesh.ppermute(sends, self._pairs(q_top))
        out = []
        for keep, recv, b in zip(keeps, recvs, bits):
            halves = (keep, recv) if b == 0 else (recv, keep)
            out.append(torch.reshape(torch.stack(halves, dim=1), (-1,)))
        return out

    def _apply_list(self, locs: List[Tensor], g: Any, wires: Sequence[int]) -> List[Tensor]:
        wires = [int(w) for w in wires]
        top = [w for w in wires if w < self.k]
        if not top:
            return [statevec.apply_unitary(x, g, [w - self.k for w in wires]) for x in locs]
        used = set(wires)
        free = [w for w in range(self.k, self.n) if w not in used]
        if len(free) < len(top):
            raise ValueError(f"not enough local qubits to stage a gate on {wires}")
        swaps = list(zip(top, free))
        for qt, ql in swaps:
            locs = self._swap_top_local(locs, qt, ql)
        moved = dict(swaps)
        eff = [moved.get(w, w) - self.k for w in wires]
        locs = [statevec.apply_unitary(x, g, eff) for x in locs]
        for qt, ql in reversed(swaps):
            locs = self._swap_top_local(locs, qt, ql)
        return locs

    def _apply(self, psi: ShardedState, g: Any, wires: Sequence[int]) -> ShardedState:
        return self._state(self._apply_list(psi.shards, g, wires))

    def _sign_of_wire(self, w: int, d: int, idx: Tensor, rdt: torch.dtype) -> Any:
        """±1 of wire ``w`` per local element (a number for a top wire)."""
        if w < self.k:
            return 1.0 - 2.0 * self._device_bit(w, d)
        bit = (idx >> (self.nlocal - 1 - (w - self.k))) & 1
        return (1 - 2 * bit).to(rdt)

    def _zz_phases(self, x: Tensor, d: int, pairs: Sequence[Tuple[int, int]], thetas: Tensor) -> Tensor:
        """exp(-i/2 Σ θ s_a s_b) for pairs with a top wire, without
        communication: a top wire's sign is a constant of the shard, so each
        pair is an rz on its local wire (angle ±θ) or, between two top
        wires, a global phase; the angles are summed a local wire and
        applied as one 2-entry diagonal each (the global phase folded into
        the first)."""
        rdt = statevec._real_dtype(x.dtype)
        thetas = thetas.to(device=x.device, dtype=rdt)
        phi: Dict[int, Tensor] = {}
        c0 = torch.zeros((), dtype=rdt, device=x.device)
        for j, (a, b) in enumerate(pairs):
            sa = 1.0 - 2.0 * self._device_bit(a, d) if a < self.k else None
            sb = 1.0 - 2.0 * self._device_bit(b, d) if b < self.k else None
            if sa is not None and sb is not None:
                c0 = c0 + thetas[j] * (sa * sb)
            else:
                w, sign = (b, sa) if sa is not None else (a, sb)
                phi[w] = phi.get(w, 0.0) + thetas[j] * sign
        if not phi:
            return x * torch.polar(torch.ones_like(c0), -0.5 * c0).to(x.dtype)
        for i, (w, f) in enumerate(phi.items()):
            expo = torch.stack([f, -f]) + (c0 if i == 0 else 0.0)
            x = statevec.apply_diagonal(x, torch.polar(torch.ones_like(expo), -0.5 * expo), [w - self.k])
        return x

    def _gate1_top(self, locs: List[Tensor], q: int, g: Any) -> List[Tensor]:
        """A 1q gate on top wire ``q``: one paired exchange."""
        recvs = self.mesh.ppermute(locs, self._pairs(q))
        out = []
        for x, r, d in zip(locs, recvs, self.mesh.shard_ids):
            b = self._device_bit(q, d)
            m = statevec._as_tensor(g, x).reshape(2, 2)
            out.append(m[b, b] * x + m[b, 1 - b] * r)
        return out

    def _diag(self, x: Tensor, d: int, diag: Any, wires: Sequence[int]) -> Tensor:
        """A k-local diagonal on any wires: the top axes taken at the shard's
        bits, the rest by ``statevec.apply_diagonal``."""
        t = torch.reshape(statevec._as_tensor(diag, x), (2,) * len(wires))
        keep: List[int] = []
        for w in wires:
            if w < self.k:
                t = torch.select(t, len(keep), self._device_bit(w, d))
            else:
                keep.append(w - self.k)
        if not keep:
            return x * t
        return statevec.apply_diagonal(x, torch.reshape(t, (-1,)), keep)

    def _diag_state(self, psi: ShardedState, diag: Any, wires: Sequence[int]) -> ShardedState:
        wires = [int(w) for w in wires]
        return self._state([self._diag(x, d, diag, wires) for x, d in self._shards(psi)])

    # -- the functional API ------------------------------------------------

    def init_zero(self) -> ShardedState:
        """|0...0> over the mesh."""
        shards = []
        for d, dev in zip(self.mesh.shard_ids, self.mesh.shard_devices):
            x = torch.zeros((self.local_size,), dtype=self._cdtype(), device=dev)
            if d == 0:
                x[0] = 1.0
            shards.append(x)
        return self._state(shards)

    def uniform(self) -> ShardedState:
        """|+...+> over the mesh (the ``h_fold`` constant)."""
        amp = 1.0 / math.sqrt(2.0**self.n)
        return self._state([
            torch.full((self.local_size,), amp, dtype=self._rdtype(), device=dev).to(self._cdtype())
            for dev in self.mesh.shard_devices
        ])

    def shard_input(self, inputs: Any) -> ShardedState:
        """A full input state split over the mesh (each shard takes its
        chunk; a tensor keeps autograd)."""
        if isinstance(inputs, torch.Tensor):
            psi = self._rep(inputs.to(self._cdtype()))
        else:
            psi = torch.as_tensor(np.asarray(inputs)).to(self._cdtype())
        psi = torch.reshape(psi, (-1,))
        if psi.shape[0] != 2**self.n:
            raise ValueError(f"inputs of {psi.shape[0]} amplitudes for {self.n} qubits")
        return self._state([psi[d * self.local_size:(d + 1) * self.local_size].to(dev)
                            for d, dev in zip(self.mesh.shard_ids, self.mesh.shard_devices)])

    def apply(self, psi: ShardedState, g: Any, wires: Sequence[int]) -> ShardedState:
        """A k-local unitary on ``wires`` (top or local)."""
        return self._apply(psi, self._rep(_matrix(g)), wires)

    def h(self, psi: ShardedState, q: int) -> ShardedState:
        return self._apply(psi, _H, [q])

    def expectation_z(self, psi: ShardedState, wires: Sequence[int]) -> Tensor:
        """<Z_{w1} Z_{w2} ...>: one ``psum``."""
        wires = [int(w) for w in wires]
        parts = []
        for x, d in self._shards(psi):
            rdt = statevec._real_dtype(x.dtype)
            idx = torch.arange(self.local_size, device=x.device)
            sign = 1.0
            par = torch.zeros_like(idx)
            for w in wires:
                if w < self.k:
                    sign *= 1.0 - 2.0 * self._device_bit(w, d)
                else:
                    par = par ^ ((idx >> (self.n - 1 - w)) & 1)
            z = (1 - 2 * par).to(rdt)
            parts.append(sign * torch.sum(torch.abs(x) ** 2 * z))
        return self.mesh.psum(parts)

    def expectation(self, psi: ShardedState, ops: Sequence[Tuple[Any, Sequence[int]]]) -> Tensor:
        """<psi| O_1 O_2 ... |psi> for k-local ops ``(operator, wires)``."""
        phis = psi.shards
        for o, wires in ops:
            phis = self._apply_list(phis, self._rep(_matrix(o)), [int(w) for w in wires])
        return self.mesh.psum([torch.vdot(x, phi) for x, phi in zip(psi.shards, phis)])

    def norm_sq(self, psi: ShardedState) -> Tensor:
        return self.mesh.psum([torch.sum(torch.abs(x) ** 2) for x in psi.shards])

    def gather(self, psi: ShardedState) -> Tensor:
        """The dense state on the mesh's first device (defeats the sharding:
        for checks and small n)."""
        return torch.reshape(self.mesh.all_gather(psi.shards), (-1,))

    # -- layers -------------------------------------------------------------

    def _rzz_product(self, psi: ShardedState, pairs: Sequence[Tuple[int, int]], thetas: Tensor) -> ShardedState:
        local_ids = [j for j, (a, b) in enumerate(pairs) if a >= self.k and b >= self.k]
        cross_ids = [j for j in range(len(pairs)) if j not in local_ids]
        out = []
        for x, d in self._shards(psi):
            th = thetas.to(x.device)
            if cross_ids:
                x = self._zz_phases(x, d, [pairs[j] for j in cross_ids], th[cross_ids])
            if local_ids:
                x = statevec.apply_zz_product_phase(
                    x, [(pairs[j][0] - self.k, pairs[j][1] - self.k) for j in local_ids], th[local_ids])
            out.append(x)
        return self._state(out)

    def rzz_product(self, psi: ShardedState, pairs: Any, thetas: Any) -> ShardedState:
        """exp(-i/2 Σ θ_k Z_a Z_b) over any pairs: no communication."""
        pairs = [(int(a), int(b)) for a, b in pairs]
        return self._rzz_product(psi, pairs, self._thetas(thetas))

    def _rx_top(self, locs: List[Tensor], thetas: Tensor) -> List[Tensor]:
        dt = config.dtypestr()
        for q in range(self.k):
            locs = self._gate1_top(locs, q, rx_matrix(thetas[q], dtype=dt))
        return locs

    def _rx_layer(self, psi: ShardedState, thetas: Tensor) -> ShardedState:
        locs = [kernels.fused_rx_layer(x, thetas[self.k:].to(x.device)) for x in psi.shards]
        return self._state(self._rx_top(locs, thetas))

    def rx_layer(self, psi: ShardedState, thetas: Any) -> ShardedState:
        """rx on every qubit: the local wires fused (K6), each top wire an
        exchange."""
        return self._rx_layer(psi, self._thetas(thetas))

    def _gate_layer_1q(self, psi: ShardedState, gates: Any, constant: bool) -> ShardedState:
        locs = [kernels.fused_single_qubit_layer(x, gates[self.k:], constant=constant) for x in psi.shards]
        for q in range(self.k):
            locs = self._gate1_top(locs, q, gates[q])
        return self._state(locs)

    def gate_layer_1q(self, psi: ShardedState, gates: Any, constant: bool = False) -> ShardedState:
        """gates[q] on every qubit q (the ``fused_1q_layer`` item; K6, with
        K8 backward for ``constant`` gates)."""
        return self._gate_layer_1q(psi, self._rep(gates), bool(constant))

    def _zzrx_layer(self, psi: ShardedState, pairs: Sequence[Tuple[int, int]], zz: Tensor, rx: Tensor
                    ) -> ShardedState:
        local_ids = [j for j, (a, b) in enumerate(pairs) if a >= self.k and b >= self.k]
        cross_ids = [j for j in range(len(pairs)) if j not in local_ids]
        local_pairs = [(pairs[j][0] - self.k, pairs[j][1] - self.k) for j in local_ids]
        locs = []
        for x, d in self._shards(psi):
            zx, rxl = zz.to(x.device), rx[self.k:].to(x.device)
            if cross_ids:
                x = self._zz_phases(x, d, [pairs[j] for j in cross_ids], zx[cross_ids])
            if local_ids:
                x = kernels.fused_zzrx_layer(x, local_pairs, zx[local_ids], rxl)
            else:
                x = kernels.fused_rx_layer(x, rxl)
            locs.append(x)
        return self._state(self._rx_top(locs, rx))

    def zzrx_layer(self, psi: ShardedState, pairs: Any, zz_thetas: Any, rx_thetas: Any) -> ShardedState:
        """The fused TFIM layer: every zz phase without communication, the
        pairs inside the local register with the local rx through
        ``kernels.fused_zzrx_layer`` (K1 forward, K3 backward), each top
        rx one exchange: k exchanges a layer at any width."""
        pairs = [(int(a), int(b)) for a, b in pairs]
        return self._zzrx_layer(psi, pairs, self._thetas(zz_thetas), self._thetas(rx_thetas))

    # -- QIR replay: the Circuit(mesh=...) engine -------------------------

    def apply_item(self, psi: ShardedState, item: Dict[str, Any]) -> ShardedState:
        """One QIR item of the port's ``Circuit`` on the sharded state; a
        kind the engine cannot replay raises ValueError."""
        if item.get("rx_layer"):
            return self.rx_layer(psi, item["thetas"])
        if item.get("fused_1q_layer"):
            return self.gate_layer_1q(psi, item["gates"], constant=bool(item.get("constant")))
        if item.get("zz_product"):
            return self.rzz_product(psi, item["pairs"], item["thetas"])
        if item.get("zzrx_layer"):
            return self.zzrx_layer(psi, item["pairs"], item["zz_thetas"], item["rx_thetas"])
        if item.get("multicz"):
            diag = np.ones(2 ** len(item["index"]), np.float32)
            diag[-1] = -1.0
            return self._diag_state(psi, diag, item["index"])
        if item.get("zstring_rot"):
            diag = rzm_diagonal(self._rep(item["theta"]), len(item["index"]), config.dtypestr())
            return self._diag_state(psi, diag, item["index"])
        if item.get("gate") is None:
            raise ValueError(f"the sharded engine cannot replay the QIR item {item.get('name')!r}")
        gate = self._rep(_matrix(item["gate"]))
        if item.get("diagonal"):
            dim = 2 ** len(item["index"])
            if isinstance(gate, torch.Tensor):
                diag = torch.diagonal(torch.reshape(gate, (dim, dim)))
            else:
                diag = np.diagonal(np.reshape(gate, (dim, dim)))
            return self._diag_state(psi, diag, item["index"])
        return self._apply(psi, gate, item["index"])

    def run_groups(self, groups: Sequence[Any], inputs: Optional[Any] = None,
                   psi: Optional[ShardedState] = None) -> ShardedState:
        """Run grouped QIR (``BaseCircuit._grouped_qir``) from ``psi``, else
        from ``inputs``, else from |0...0> (a leading ``h_fold`` item folds
        to the uniform state)."""
        groups = list(groups)
        if psi is None and inputs is not None:
            psi = self.shard_input(inputs)
        elif psi is None and groups and isinstance(groups[0], dict) and groups[0].get("h_fold"):
            psi = self.uniform()
            groups = groups[1:]
        elif psi is None:
            psi = self.init_zero()
        for group in groups:
            if isinstance(group, list):
                for it in group:
                    psi = self.zzrx_layer(psi, it["pairs"], it["zz_thetas"], it["rx_thetas"])
            else:
                psi = self.apply_item(psi, group)
        return psi

    # -- measurement and sampling ---------------------------------------

    _MEASURE_EPS = statevec.MEASURE_EPS

    def _uniforms(self, shape: Sequence[int], generator: Optional[torch.Generator]) -> Tensor:
        """Uniforms on the mesh's device, the same on every shard: from
        ``generator`` or the backend's implicit generator, then broadcast
        from the first rank."""
        if generator is None:
            u = K.implicit_randu(shape, device=self.mesh.device)
        else:
            check_generator(generator, self.mesh.device)
            u = K.stateful_randu(generator, shape)
        return self.mesh.broadcast(u)

    def measure_jit(
        self,
        psi: ShardedState,
        index: Sequence[int],
        status: Optional[Any] = None,
        with_prob: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Projective measurement of ``index`` in turn: each qubit's one-bit
        marginal is a per-shard sum and a ``psum``, its outcome the status's
        inverse CDF (the dense engine's convention), the collapse a local
        mask and a renormalization: no gather.  Without ``status`` the
        uniforms come from ``generator`` or the backend's generator.
        Returns (outcomes int32, probability or -1)."""
        index = [int(q) for q in index]
        if status is None:
            status = self._uniforms([len(index)], generator)
        rdt = self._rdtype()
        status = torch.reshape(statevec.real_tensor(status, self.mesh.device, self._cdtype()), (-1,)).to(rdt)
        dev = self.mesh.device
        locs = psi.shards
        outs = []
        prob = torch.ones((), dtype=rdt, device=dev)
        for step, q in enumerate(index):
            masses = [torch.abs(x) ** 2 for x in locs]
            tot = self.mesh.psum([torch.sum(m) for m in masses]).to(rdt)
            if q < self.k:
                m1 = self.mesh.psum([torch.sum(m) * self._device_bit(q, d)
                                     for m, d in zip(masses, self.mesh.shard_ids)])
            else:
                left = 2 ** (q - self.k)
                m1 = self.mesh.psum([torch.sum(torch.reshape(m, (left, 2, -1))[:, 1]) for m in masses])
            p1 = m1.to(rdt) / tot
            cdf = torch.stack([1.0 - p1, torch.ones((), dtype=rdt, device=dev)])
            u = (status[step] + self._MEASURE_EPS).reshape(1)
            outcome = torch.clamp(torch.searchsorted(cdf, u, side="left")[0], 0, 1)
            p_out = torch.where(outcome == 1, p1, 1.0 - p1)
            prob = prob * p_out
            scale = torch.sqrt(torch.clamp(p_out * tot, min=1e-30))
            new = []
            for x, d in zip(locs, self.mesh.shard_ids):
                o = outcome.to(x.device)
                if q < self.k:
                    x = x * (o == self._device_bit(q, d)).to(x.dtype)
                else:
                    left = 2 ** (q - self.k)
                    sel = torch.nn.functional.one_hot(o, 2).to(x.dtype)
                    x = torch.reshape(torch.reshape(x, (left, 2, -1)) * sel[None, :, None], (-1,))
                new.append(x / scale.to(x.device).to(x.dtype))
            locs = new
            outs.append(outcome)
        sample = torch.stack(outs).to(torch.int32)
        if with_prob:
            return sample, prob
        return sample, torch.tensor(-1.0, device=dev)

    def amplitude(self, psi: ShardedState, bits: Any) -> Tensor:
        """⟨bits|ψ⟩: the owning shard gives one element, one ``psum``;
        ``bits`` a string or a sequence of 0/1, wire 0 first."""
        bits = [int(b) for b in bits]
        if len(bits) != self.n:
            raise ValueError(f"{len(bits)} bits for {self.n} qubits")
        d_target = int("".join(map(str, bits[:self.k])) or "0", 2)
        li = int("".join(map(str, bits[self.k:])), 2)
        return self.mesh.psum([x[li] * (1.0 if d == d_target else 0.0) for x, d in self._shards(psi)])

    def probability(self, psi: ShardedState, wires: Optional[Sequence[int]] = None) -> Tensor:
        """The marginal Born distribution over ``wires`` (default: all), shape
        ``(2^m,)`` in the order given: local wires by sums over the flat
        chunk split only at those wires, top wires as one-hots of the
        shard's bits, one ``psum``."""
        wires = list(range(self.n)) if wires is None else [int(w) for w in wires]
        if len(set(wires)) != len(wires):
            raise ValueError(f"repeated wires {wires}")
        m = len(wires)
        loc_sorted = sorted(w for w in wires if w >= self.k)
        req_loc = [w for w in wires if w >= self.k]
        shape: List[int] = []
        prev = -1
        for w in loc_sorted:
            ax = w - self.k
            shape += [2 ** (ax - prev - 1), 2]
            prev = ax
        shape.append(2 ** (self.nlocal - 1 - prev))
        parts = []
        for x, d in self._shards(psi):
            mass = torch.real(x) ** 2 + torch.imag(x) ** 2
            out = torch.sum(torch.reshape(mass, shape), dim=tuple(range(0, 2 * len(loc_sorted) + 1, 2)))
            out = torch.permute(out, [loc_sorted.index(w) for w in req_loc])
            for p, w in enumerate(wires):
                if w < self.k:
                    oh = torch.zeros(2, dtype=mass.dtype, device=x.device)
                    oh[self._device_bit(w, d)] = 1.0
                    out = out.unsqueeze(p) * torch.reshape(oh, (1,) * p + (2,) + (1,) * (out.ndim - p))
            parts.append(torch.reshape(out, (2**m,)))
        return self.mesh.psum(parts)

    def sample_direct(self, psi: ShardedState, status: Any) -> Tensor:
        """All shots in one pass, two collectives: each shard takes its
        cumulative mass (``statevec.cumsum_fixed_order``), its exclusive
        prefix over the shards (one ``all_gather`` of totals), maps each
        uniform r (``status · tot · (1 - 1e-7)``) into its interval, and the
        owning shard gives the global index to one ``psum``.  int32 indices
        up to 2^31 amplitudes, int64 past them."""
        status = torch.reshape(statevec.real_tensor(status, self.mesh.device, self._cdtype()), (-1,))
        masses = [torch.real(x) ** 2 + torch.imag(x) ** 2 for x in psi.shards]
        csums = [statevec.cumsum_fixed_order(m) for m in masses]
        all_m = self.mesh.all_gather([c[-1] for c in csums])
        idt = torch.int32 if self.n <= 31 else torch.int64
        parts = []
        for c, d in zip(csums, self.mesh.shard_ids):
            am = all_m.to(c.device)
            mine = c[-1]
            before = torch.sum(torch.where(torch.arange(self.ndev, device=c.device) < d, am, 0.0))
            tot = torch.sum(am)
            r = status.to(device=c.device, dtype=c.dtype) * tot * (1.0 - 1e-7)
            x = r - before
            in_range = (x >= 0) & (x < mine)
            li = torch.clamp(torch.searchsorted(c, x, right=True), 0, self.local_size - 1)
            gidx = d * self.local_size + li
            parts.append(torch.where(in_range, gidx, 0).to(idt))
        return self.mesh.psum(parts)

    def unitary_kraus(
        self,
        psi: ShardedState,
        kraus: Sequence[Any],
        wires: Sequence[int],
        status: Any,
        prob: Optional[Sequence[float]] = None,
    ) -> Tuple[ShardedState, Tensor]:
        """One trajectory of a mixed-unitary channel: branch probabilities
        tr(K†K)/dim (or ``prob``), the branch the number of cdf entries the
        uniform ``status`` reaches, and the selected operator, renormalized,
        applied as one k-local gate.  Numpy operators are worked on the host,
        tensor operators keep autograd.  Returns (state, branch)."""
        mats = [_matrix(m) for m in kraus]
        rdt, cdt = self._rdtype(), self._cdtype()
        dev = self.mesh.device
        status = statevec.real_tensor(status, dev, cdt).to(rdt)
        if not any(isinstance(m, torch.Tensor) for m in mats):
            dim = int(np.prod(np.shape(mats[0]))) ** 0.5
            dim = int(round(dim))
            mats = [np.asarray(m).reshape(dim, dim) for m in mats]
            if prob is None:
                ps = np.array([np.real(np.trace(m.conj().T @ m)) / dim for m in mats])
                mats = [m / np.sqrt(max(p, 1e-30)) for m, p in zip(mats, ps)]
            else:
                ps = np.asarray(prob, dtype=np.float64)
            ps = ps / np.sum(ps)
            cum = torch.as_tensor(np.cumsum(ps), dtype=rdt, device=dev)
            stack = config.device_constant(np.stack(mats), dev, cdt)
        else:
            stack = torch.stack([self._rep(torch.as_tensor(m, device=dev)).to(cdt) for m in mats])
            dim = int(round(math.sqrt(stack[0].numel())))
            stack = torch.reshape(stack, (len(mats), dim, dim))
            if prob is None:
                ps = torch.real(torch.diagonal(stack.mH @ stack, dim1=1, dim2=2).sum(-1)) / dim
                ps = ps.to(rdt)
                stack = stack / torch.sqrt(torch.clamp(ps, min=1e-30)).to(cdt)[:, None, None]
            else:
                ps = statevec.real_tensor(prob, dev, cdt).to(rdt)
            ps = ps / torch.sum(ps)
            cum = torch.cumsum(ps, 0)
        idx = torch.sum((status >= cum[:-1]).to(torch.int32))
        onehot = (torch.arange(len(mats), device=dev) == idx).to(cdt)
        m_sel = torch.einsum("i,iab->ab", onehot, stack)
        return self._apply(psi, m_sel, wires), idx

    def expectation_ising_sum(self, psi: ShardedState, spec: Any) -> Tensor:
        """⟨Σ w_s Π Z + Σ w_q X_q⟩ in one pass and one ``psum``: Z-strings by
        bit signs on |ψ|², each distinct top wire with an X field one
        exchange, local X fields slot-flipped overlaps.  ``spec`` is
        ``kernels.ising_readout_spec``'s."""
        diag_terms, x_terms = spec
        locs = psi.shards
        recvs = {q: self.mesh.ppermute(locs, self._pairs(q))
                 for q in sorted({int(q) for q, _ in x_terms if int(q) < self.k})}
        parts = []
        for i, (x, d) in enumerate(self._shards(psi)):
            rdt = statevec._real_dtype(x.dtype)
            idx = torch.arange(self.local_size, device=x.device)
            e = torch.zeros((), dtype=rdt, device=x.device)
            if diag_terms:
                # the Z-strings' weighted signs as one constant mask
                wmask = torch.zeros(self.local_size, dtype=rdt, device=x.device)
                for qubits, w in diag_terms:
                    s = 1.0
                    for q in qubits:
                        s = s * self._sign_of_wire(int(q), d, idx, rdt)
                    wmask += w * s
                e = e + torch.sum((torch.real(x) ** 2 + torch.imag(x) ** 2) * wmask)
            for q, w in x_terms:
                q = int(q)
                if q < self.k:
                    r = recvs[q][i]
                    e = e + w * torch.sum(torch.real(x) * torch.real(r) + torch.imag(x) * torch.imag(r))
                else:
                    v = torch.reshape(x, (2 ** (q - self.k), 2, -1))
                    e = e + 2.0 * w * torch.sum(torch.real(v[:, 0]) * torch.real(v[:, 1])
                                                + torch.imag(v[:, 0]) * torch.imag(v[:, 1]))
            parts.append(e)
        return self.mesh.psum(parts)

    def expectation_ps(
        self,
        psi: ShardedState,
        x: Optional[Sequence[int]] = None,
        y: Optional[Sequence[int]] = None,
        z: Optional[Sequence[int]] = None,
    ) -> Tensor:
        """⟨Π X_i Π Y_j Π Z_k⟩ as one flip overlap: (Pψ)_b = ψ_{b⊕F} ·
        (−i)^{|y|} Π_{j∈y} s_j(b) Π_{k∈z} s_k(b), F the X∪Y flip mask; the
        top flips share one exchange, one ``psum``."""
        xw = [int(w) for w in (x or ())]
        yw = [int(w) for w in (y or ())]
        zw = [int(w) for w in (z or ())]
        if len(set(xw + yw + zw)) != len(xw + yw + zw):
            raise ValueError("a wire appears in more than one of x, y, z")
        if not xw and not yw:
            return self.expectation_z(psi, zw).to(self._cdtype())
        flips = sorted(xw + yw)
        top_mask = 0
        for w in flips:
            if w < self.k:
                top_mask |= 1 << (self.k - 1 - w)
        loc_flips = [w for w in flips if w >= self.k]
        pref = (-1j) ** (len(yw) % 4)
        phis = []
        for loc in psi.shards:
            phi = loc
            for w in loc_flips:
                phi = torch.reshape(torch.flip(torch.reshape(phi, (2 ** (w - self.k), 2, -1)), dims=[1]), (-1,))
            phis.append(phi)
        if top_mask:
            phis = self.mesh.ppermute(phis, [(d, d ^ top_mask) for d in range(self.ndev)])
        parts = []
        for loc, phi, d in zip(psi.shards, phis, self.mesh.shard_ids):
            rdt = statevec._real_dtype(loc.dtype)
            idx = torch.arange(self.local_size, device=loc.device)
            sign = 1.0
            for w in yw + zw:
                sign = sign * self._sign_of_wire(w, d, idx, rdt)
            parts.append(torch.sum(torch.conj(loc) * phi * sign))
        return pref * self.mesh.psum(parts)
