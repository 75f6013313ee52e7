"""Stim-style detectors on the dense circuit: trajectories and exact rates.

Counterpart of ``tensorcircuit_ng_tpu/models/detectors.py``, mixed into the
port's ``Circuit``.  The ``measure``/``reset`` instructions of
``AbstractCircuit`` make the measurement records (a reset's outcome is a
record too, as in the JAX package); a detector or an observable is the
parity of records, a negative reference counting back from the last record
before it (stim's ``rec[-k]``).

:meth:`DetectorMixin.sample_detector` runs the shots as the leading axis of
one ``[shots, d^n]`` state on the circuit's device (no vmap): each
measurement takes every shot's marginal and outcome at once, each channel
site every shot's branch from its reduced density matrix.  The outcome rule
is the JAX package's, ``searchsorted(cdf, r + 1e-12, side="left")`` clipped,
so the same ``status``/``statusc`` give the same bits.  Above a memory
budget (:func:`detector_chunk`) the shots go in chunks.

:meth:`DetectorMixin.detector_probabilities_exact` evolves a density matrix
once a detector, its own records measured by the signed kernel
(Zρ + ρZ)/2 and the others dephased: p(fire) = (1 - tr ρ)/2.  A reference
``rec[-k]`` resolves against the records measured before the detector, and
a record named an even number of times drops out of the parity (the JAX
package resolves against the whole program's records and counts a repeat
once: Queue 3 F12 of ``ROADMAP.md``).

A channel item holds the port's operators: a ``unitary_kraus(prob=...)``
item keeps √p_i U_i, so both paths follow the channel it was drawn from.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..backend import backend as K
from ..backend import device_tensor
from ..core import statevec

__all__ = ["DetectorMixin", "detector_chunk"]

#: the tie-break added to each uniform, as in the JAX package's detectors
_TIE = 1e-12

#: states of one shot held at once by a trajectory step (the state, its
#: image, and the einsum's permuted copies)
_STATES_A_SHOT = 4


def detector_chunk(shots: int, dim: int, dtype: torch.dtype, device: torch.device) -> int:
    """The shots a trajectory chunk holds: as many as fit ``_STATES_A_SHOT``
    states a shot in half the free memory of ``device`` (the card's free
    memory, or the host's available physical memory)."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    per_shot = _STATES_A_SHOT * dim * torch.empty((), dtype=dtype).element_size()
    return max(1, min(shots, (free // 2) // per_shot))


def _rows_shape(rows: int, n: int, wires: Sequence[int], d: int) -> Tuple[int, ...]:
    """(rows, A0, d, A1, ..., Ak): a [rows, d^n] state exposing ``wires``."""
    return (rows,) + statevec._exposed_shape(n, sorted(wires), d)


def _rows_apply(psi: torch.Tensor, gate: torch.Tensor, wires: Sequence[int], d: int, n: int) -> torch.Tensor:
    """A k-site gate on ``wires`` of every row of ``psi`` [rows, d^n]: one
    gate ``(d^k, d^k)`` for all rows, or one a row ``(rows, d^k, d^k)``."""
    wires = [int(w) for w in wires]
    k = len(wires)
    per_row = gate.ndim == 3
    g = gate.reshape(((psi.shape[0],) if per_row else ()) + (d,) * (2 * k))
    order = list(np.argsort(wires))
    if order != list(range(k)):
        lead = [0] if per_row else []
        off = len(lead)
        g = g.permute(lead + [off + o for o in order] + [off + k + o for o in order])
    ps = psi.reshape(_rows_shape(psi.shape[0], n, wires, d))
    letters = statevec._LETTERS
    g_out, g_in, seg = letters[:k], letters[k:2 * k], letters[2 * k:3 * k + 1]
    state_sub = "Z" + "".join(seg[i] + g_in[i] for i in range(k)) + seg[k]
    out_sub = "Z" + "".join(seg[i] + g_out[i] for i in range(k)) + seg[k]
    g_sub = ("Z" if per_row else "") + g_out + g_in
    return torch.einsum(f"{g_sub},{state_sub}->{out_sub}", g, ps).reshape(psi.shape)


def _rows_rdm(psi: torch.Tensor, wires: Sequence[int], d: int, n: int) -> torch.Tensor:
    """Each row's (d^k, d^k) reduced density matrix of ``wires``
    (unnormalized), rows and columns in the order of ``wires``."""
    wires = [int(w) for w in wires]
    k = len(wires)
    ps = psi.reshape(_rows_shape(psi.shape[0], n, wires, d))
    letters = statevec._LETTERS
    ket, bra, seg = letters[:k], letters[k:2 * k], letters[2 * k:3 * k + 1]
    sub_ket = "Z" + "".join(seg[i] + ket[i] for i in range(k)) + seg[k]
    sub_bra = "Z" + "".join(seg[i] + bra[i] for i in range(k)) + seg[k]
    rho = torch.einsum(f"{sub_ket},{sub_bra}->Z{ket}{bra}", ps, torch.conj(ps))
    order = list(np.argsort(wires))
    inv = [order.index(i) for i in range(k)]
    if inv != list(range(k)):
        rho = rho.permute([0] + [1 + i for i in inv] + [1 + k + i for i in inv])
    return rho.reshape(psi.shape[0], d**k, d**k)


def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x), 1 where x is 0 (a projection with nothing left)."""
    return torch.rsqrt(torch.where(x > 0, x, torch.ones_like(x)))


def _pick(p: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's branch: the first cdf entry of ``p`` [rows, m] that
    reaches r + 1e-12, held to m-1; each row's distance from r to its
    nearest inner cdf boundary)."""
    cdf = torch.cumsum(p, dim=1)
    u = r.to(cdf.dtype) + _TIE
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u[:, None].contiguous(), side="left")[:, 0],
                      0, p.shape[1] - 1)
    inner = cdf[:, :-1]
    margin = (torch.abs(inner - r.to(cdf.dtype)[:, None]).amin(dim=1) if inner.shape[1]
              else torch.full_like(u, float("inf")))
    return idx, margin


class DetectorMixin:
    """Mixed into ``Circuit``: detector and observable instructions, their
    trajectories and exact firing probabilities."""

    def detector_instruction(self, *records: int) -> None:
        """A detector: the parity of measurement records (negative: counted
        back from the last record before it)."""
        self._extra_qir.append({"name": "detector", "records": tuple(records), "pos": len(self._qir)})

    detector = detector_instruction

    def observable_instruction(self, *records: int) -> None:
        """An observable: the parity of measurement records."""
        self._extra_qir.append({"name": "observable", "records": tuple(records), "pos": len(self._qir)})

    observable = observable_instruction

    def _num_measures(self) -> int:
        return sum(len(e["index"]) for e in self._extra_qir if e["name"] in ("measure", "reset"))

    def _num_channels(self) -> int:
        return sum(1 for item in self._qir if item.get("is_channel"))

    def _sorted_extras(self) -> List[Dict[str, Any]]:
        """The extra instructions in program order (by position, then by
        the order they were recorded in)."""
        order = sorted(range(len(self._extra_qir)), key=lambda i: (self._extra_qir[i]["pos"], i))
        return [self._extra_qir[i] for i in order]

    # ------------------------------------------------------------------
    # trajectories, the shots as the leading axis of one state
    # ------------------------------------------------------------------

    def _apply_rows(self, psi: torch.Tensor, item: Dict[str, Any]) -> torch.Tensor:
        """A unitary QIR item on every row of ``psi``; a fused item unfolds
        into its gates, and an item without a matrix (a wide ``multicz`` or
        ``rzm``) multiplies by its diagonal."""
        d, n = self._d, self._nqubits
        for it in self._expanded_qir([item]):
            if it.get("gate") is None:
                ones = torch.ones(psi.shape[1], dtype=psi.dtype, device=psi.device)
                psi = psi * self._apply_item(ones, it)[None, :]
                continue
            g = it["gate"].tensor
            dim = d ** len(it["index"])
            g = g.to(device=psi.device, dtype=psi.dtype) if isinstance(g, torch.Tensor) else config.device_constant(
                np.asarray(g), psi.device, psi.dtype)
            psi = _rows_apply(psi, g.reshape(dim, dim), it["index"], d, n)
        return psi

    def _trajectories(
        self, status_m: torch.Tensor, status_c: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One chunk of shots, a row of ``status_m`` [rows, >= measures] and
        ``status_c`` [rows, >= channels] each: (detector bits [rows, n_det],
        observable bits [rows, n_obs], int32; each row's least distance from
        a uniform to an inner cdf boundary it was searched in)."""
        d, n = self._d, self._nqubits
        rows = status_m.shape[0]
        psi = self._initial_state()[None, :].repeat(rows, 1)
        margin = torch.full((rows,), float("inf"), dtype=torch.float64, device=psi.device)
        records: List[torch.Tensor] = []
        detectors: List[torch.Tensor] = []
        observables: List[torch.Tensor] = []
        extras = self._sorted_extras()
        eptr = mi = ci = 0

        def run_extras(pos: int, psi: torch.Tensor) -> torch.Tensor:
            nonlocal eptr, mi, margin
            while eptr < len(extras) and extras[eptr]["pos"] <= pos:
                e = extras[eptr]
                eptr += 1
                if e["name"] in ("measure", "reset"):
                    for q in e["index"]:
                        shape = _rows_shape(rows, n, [q], d)
                        ps = psi.reshape(shape)
                        mass = torch.view_as_real(ps).square().sum(dim=(1, 3, 4))  # (rows, d)
                        outcome, m = _pick(mass / mass.sum(dim=1, keepdim=True), status_m[:, mi])
                        margin = torch.minimum(margin, m.to(margin.dtype))
                        # the projection, renormalized by its outcome's mass
                        scale = _inv_sqrt(torch.gather(mass, 1, outcome[:, None]))
                        sel = torch.nn.functional.one_hot(outcome, d).to(mass.dtype) * scale
                        psi = (ps * sel.to(psi.dtype)[:, None, :, None]).reshape(rows, -1)
                        records.append(outcome)
                        if e["name"] == "reset":
                            flipped = torch.flip(psi.reshape(shape), dims=(2,)).reshape(rows, -1)
                            psi = torch.where((outcome == 1)[:, None], flipped, psi)
                        mi += 1
                elif e["name"] in ("detector", "observable"):
                    par = torch.zeros((rows,), dtype=torch.int64, device=psi.device)
                    for rref in e["records"]:
                        par = par ^ records[rref]
                    (detectors if e["name"] == "detector" else observables).append(par)
            return psi

        for pos, item in enumerate(self._qir):
            psi = run_extras(pos, psi)
            if item.get("is_channel"):
                mats = torch.stack([
                    m.to(device=psi.device, dtype=psi.dtype) if isinstance(m, torch.Tensor)
                    else config.device_constant(np.asarray(m), psi.device, psi.dtype)
                    for m in item["channel_kraus"]])
                dim = mats.shape[-1]
                mats = mats.reshape(-1, dim, dim)
                rho = _rows_rdm(psi, item["index"], d, n)
                # each branch's mass tr(K rho K†); the branch applied
                # renormalized by its mass
                mass = torch.real(torch.einsum("kab,zbc,kac->zk", mats, rho, torch.conj(mats)))
                idx, m = _pick(mass / mass.sum(dim=1, keepdim=True), status_c[:, ci])
                margin = torch.minimum(margin, m.to(margin.dtype))
                scale = _inv_sqrt(torch.gather(mass, 1, idx[:, None]))[:, :, None]
                psi = _rows_apply(psi, mats[idx] * scale.to(psi.dtype), item["index"], d, n)
                ci += 1
            else:
                psi = self._apply_rows(psi, item)
        run_extras(len(self._qir), psi)
        dev = psi.device
        det = torch.stack(detectors, dim=1) if detectors else torch.zeros((rows, 0), dtype=torch.int64, device=dev)
        obs = (torch.stack(observables, dim=1) if observables
               else torch.zeros((rows, 0), dtype=torch.int64, device=dev))
        return det.to(torch.int32), obs.to(torch.int32), margin

    def _detector_statuses(
        self, shots: int, status: Optional[Any], statusc: Optional[Any]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The measurement and channel uniforms on the circuit's device,
        drawn from the backend's implicit generator where not given."""
        nm = max(self._num_measures(), 1)
        nc = max(self._num_channels(), 1)
        dev = self._device
        status = K.implicit_randu([shots, nm], device=dev) if status is None else device_tensor(status, dev)
        statusc = K.implicit_randu([shots, nc], device=dev) if statusc is None else device_tensor(statusc, dev)
        return status, statusc

    def sample_detector(
        self,
        shots: int = 1,
        status: Optional[Any] = None,
        statusc: Optional[Any] = None,
        with_observable: bool = False,
        with_margin: bool = False,
    ) -> Any:
        """Detector parities of ``shots`` trajectories, int32 [shots, n_det]
        on the circuit's device (and the observables [shots, n_obs] with
        ``with_observable``).  ``status``: uniforms [shots, measurements];
        ``statusc``: uniforms [shots, channel sites].  ``with_margin``
        appends each shot's least distance from a uniform to an inner cdf
        boundary it was searched in (float64 [shots])."""
        status, statusc = self._detector_statuses(shots, status, statusc)
        rows = status.shape[0]
        chunk = detector_chunk(rows, self._d**self._nqubits, config.torch_dtype(), self._device)
        parts = [self._trajectories(status[i:i + chunk], statusc[i:i + chunk]) for i in range(0, rows, chunk)]
        det, obs, margin = (torch.cat([p[j] for p in parts]) for j in range(3))
        out = (det, obs) if with_observable else (det,)
        if with_margin:
            out = out + (margin,)
        return out if len(out) > 1 else out[0]

    def detector_probabilities(
        self, shots: int = 4096, status: Optional[Any] = None, statusc: Optional[Any] = None
    ) -> torch.Tensor:
        """Each detector's firing rate over ``shots`` trajectories (float32)."""
        det = self.sample_detector(shots, status=status, statusc=statusc)
        return torch.mean(det.to(torch.float32), dim=0)

    # ------------------------------------------------------------------
    # exact firing probabilities by density-matrix evolution
    # ------------------------------------------------------------------

    def _detector_targets(self) -> List[List[int]]:
        """Each detector's records of odd multiplicity, a reference
        ``rec[-k]`` resolved against the records measured before it."""
        targets: List[List[int]] = []
        count = 0
        for e in self._sorted_extras():
            if e["name"] in ("measure", "reset"):
                count += len(e["index"])
            elif e["name"] == "detector":
                refs = []
                for rref in e["records"]:
                    idx = rref if rref >= 0 else count + rref
                    if not 0 <= idx < count:
                        raise IndexError(f"detector record {rref} out of range: {count} records before it")
                    refs.append(idx)
                targets.append(sorted(i for i, c in Counter(refs).items() if c % 2))
        return targets

    def detector_probabilities_exact(self) -> torch.Tensor:
        """Exact firing probability of each detector, in the real dtype on
        the circuit's device: one density-matrix evolution a detector, the
        measurements of its records by the signed kernel (Zρ + ρZ)/2 and
        the others by dephasing (ρ + ZρZ)/2, channels exact; then
        p = (1 - tr ρ)/2."""
        if self._d != 2:
            raise NotImplementedError("exact detector probabilities are implemented for qubits")
        n = self._nqubits
        extras = self._sorted_extras()
        out = []
        for target in self._detector_targets():
            target = set(target)
            rho = self._dm_initial()
            eptr = rec = 0

            def run_extras(pos: int, rho: torch.Tensor) -> torch.Tensor:
                nonlocal eptr, rec
                while eptr < len(extras) and extras[eptr]["pos"] <= pos:
                    e = extras[eptr]
                    eptr += 1
                    if e["name"] in ("measure", "reset"):
                        for q in e["index"]:
                            rho = _dm_measure_kernel(rho, q, n, rec in target)
                            if e["name"] == "reset":
                                rho = _dm_reset_after_measure(rho, q, n)
                            rec += 1
                return rho

            for pos, item in enumerate(self._qir):
                rho = run_extras(pos, rho)
                rho = self._dm_apply_item(rho, item)
            rho = run_extras(len(self._qir), rho)
            dim = 2**n
            e_val = torch.real(torch.trace(rho.reshape(dim, dim)))
            out.append((1.0 - e_val) / 2.0)
        if not out:
            return torch.zeros((0,), dtype=getattr(torch, config.rdtypestr()), device=self._device)
        return torch.stack(out)

    def _dm_initial(self) -> torch.Tensor:
        psi = self._initial_state()
        return torch.outer(psi, torch.conj(psi)).reshape(-1)

    def _dm_apply_item(self, rho: torch.Tensor, item: Dict[str, Any]) -> torch.Tensor:
        """ρ -> K ρ K† (summed over a channel item's operators), on the flat
        2n-slot ρ (ket slots first)."""
        n, d = self._nqubits, self._d
        if item.get("is_channel"):
            acc = None
            bra = [w + n for w in item["index"]]
            for m in item["channel_kraus"]:
                m = m.to(device=rho.device, dtype=rho.dtype) if isinstance(m, torch.Tensor) else \
                    config.device_constant(np.asarray(m), rho.device, rho.dtype)
                t = statevec.apply_unitary(rho, m, item["index"], d)
                t = statevec.apply_unitary(t, torch.conj(m), bra, d)
                acc = t if acc is None else acc + t
            return acc
        dim = d**n
        for it in self._expanded_qir([item]):
            if it.get("gate") is None:
                ones = torch.ones(dim, dtype=rho.dtype, device=rho.device)
                v = self._apply_item(ones, it)
                rho = (rho.reshape(dim, dim) * v[:, None] * torch.conj(v)[None, :]).reshape(-1)
                continue
            g = it["gate"].tensor
            g = g.to(device=rho.device, dtype=rho.dtype) if isinstance(g, torch.Tensor) else \
                config.device_constant(np.asarray(g), rho.device, rho.dtype)
            rho = statevec.apply_unitary(rho, g, it["index"], d)
            rho = statevec.apply_unitary(rho, torch.conj(g), [w + n for w in it["index"]], d)
        return rho


def _dm_measure_kernel(rho: torch.Tensor, q: int, n: int, signed: bool) -> torch.Tensor:
    """(Zρ + ρZ)/2 (``signed``) or the dephasing (ρ + ZρZ)/2 on qubit q."""
    zdiag = np.array([1.0, -1.0])
    z_ket = statevec.apply_diagonal(rho, zdiag, [q], 2)
    if signed:
        return (z_ket + statevec.apply_diagonal(rho, zdiag, [n + q], 2)) / 2.0
    return (rho + statevec.apply_diagonal(z_ket, zdiag, [n + q], 2)) / 2.0


def _dm_reset_after_measure(rho: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """After a measurement kernel: P0 ρ P0 + X P1 ρ P1 X on qubit q."""
    p0, p1 = np.array([1.0, 0.0]), np.array([0.0, 1.0])
    r0 = statevec.apply_diagonal(statevec.apply_diagonal(rho, p0, [q], 2), p0, [n + q], 2)
    r1 = statevec.apply_diagonal(statevec.apply_diagonal(rho, p1, [q], 2), p1, [n + q], 2)
    return r0 + statevec.flip_slot(statevec.flip_slot(r1, q, 2), n + q, 2)
