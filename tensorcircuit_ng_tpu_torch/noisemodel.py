"""Noise configuration and the noisy estimators.

Counterpart of ``tensorcircuit_ng_tpu/noisemodel.py``: :class:`NoiseConf`
binds Kraus channels to gate names, to qubits of a gate and to predicates
over QIR items; :func:`circuit_with_noise` rebuilds a circuit with the
channels after each matching gate; :func:`expectation_noisfy` and
:func:`sample_expectation_ps_noisfy` give the noisy value, exactly on a
:class:`DMCircuit` (each channel as Σ K ρ K†) and as the mean over
Monte-Carlo trajectories on a :class:`Circuit`, one uniform of ``status``
a channel site choosing each branch.

The trajectories run one at a time (the JAX package ``vmap``\\ s them), so
the peak memory is one trajectory's, and their values are averaged on the
circuit's device.  A status whose last dimension is not the channel count
is a ValueError in both estimators.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backend import backend as K
from .backend import device_tensor

Tensor = Any

__all__ = [
    "NoiseConf",
    "apply_qir_with_noise",
    "circuit_with_noise",
    "expectation_noisfy",
    "sample_expectation_ps_noisfy",
    "channel_count",
]


class NoiseConf:
    """Channel lists keyed by gate name, by qubits of a gate, or by a
    condition on the QIR item.

    ``nc.add_noise("rx", kraus)``: after every rx gate;
    ``nc.add_noise("rx", [k1, k2], [[0], [1]])``: k1 after rx on qubit 0, k2
    after rx on qubit 1; ``nc.add_noise_by_condition(pred, kraus)``: after
    every item for which ``pred(item)`` is true; ``"readout"`` is a
    pseudo-gate whose "channel" is the per-qubit [P(0|0), P(1|1)] rows.
    Adding to a gate again stacks the channels.
    """

    def __init__(self) -> None:
        self.nc: Dict[str, Any] = {}
        self.has_quantum = False
        self.has_readout = False
        self._conditions: List[Tuple[Callable[[Dict[str, Any]], bool], Any]] = []

    def add_noise(self, gate_name: str, kraus: Any, qubit: Optional[Sequence[Sequence[int]]] = None) -> None:
        gate_name = gate_name.lower()
        if gate_name == "readout":
            self.nc["readout"] = kraus
            self.has_readout = True
            return
        entry = self.nc.get(gate_name)
        if not isinstance(entry, dict):
            entry = {}
        if qubit is None:
            entry["any"] = self._as_channels(entry.get("any") or []) + self._as_channels(kraus)
        else:
            for ks, q in zip(kraus, qubit):
                prev = entry.get(tuple(q))
                entry[tuple(q)] = (self._as_channels(prev) if prev is not None else []) + self._as_channels(ks)
        self.nc[gate_name] = entry
        self.has_quantum = True

    def add_noise_by_condition(self, condition: Callable[[Dict[str, Any]], bool], kraus: Any) -> None:
        self._conditions.append((condition, kraus))
        self.has_quantum = True

    @staticmethod
    def _as_channels(ks: Any) -> List[Any]:
        """A list of channels from one channel (a sequence of Gates or
        matrices) or a list of them."""
        if isinstance(ks, (list, tuple)) and not ks:
            return []
        if isinstance(ks, (list, tuple)) and isinstance(ks[0], (list, tuple)):
            return list(ks)
        return [ks]

    def channels_for(self, qir_item: Dict[str, Any]) -> List[Any]:
        """Every channel that follows this QIR item, in order: the gate's,
        its qubits', then the conditions'."""
        out: List[Any] = []
        entry = self.nc.get((qir_item.get("name") or "").lower())
        if isinstance(entry, dict):
            if "any" in entry:
                out.extend(self._as_channels(entry["any"]))
            key = tuple(qir_item["index"])
            if key in entry:
                out.extend(self._as_channels(entry[key]))
        elif entry is not None:
            out.extend(self._as_channels(entry))
        for cond, ks in self._conditions:
            if cond(qir_item):
                out.extend(self._as_channels(ks))
        return out

    def channel_count(self, c: Any) -> int:
        """The channel sites of a noisy run of ``c``: the uniforms a
        trajectory takes."""
        return _mc_channel_count(c, self)


def _channel_sites(ks: Any, index: Sequence[int]) -> int:
    """Sites of one channel after a gate on ``index``: one when the channel
    is as wide as the gate, else one a qubit (a one-qubit channel after a
    20-wire layer is 20 sites and takes 20 uniforms)."""
    first = ks[0].matrix() if hasattr(ks[0], "matrix") else np.asarray(ks[0])
    nsite = int(round(np.log2(first.shape[-1])))
    return 1 if nsite == len(index) else len(index)


def _mc_channel_count(c: Any, noise_conf: NoiseConf) -> int:
    return sum(_channel_sites(ks, item["index"]) for item in c.to_qir() for ks in noise_conf.channels_for(item))


def channel_count(c: Any, noise_conf: Optional[NoiseConf] = None) -> int:
    """The channel items already in ``c``, plus the sites ``noise_conf``
    adds."""
    cnt = sum(1 for item in c.to_qir() if item.get("is_channel"))
    if noise_conf is None:
        return cnt
    return cnt + _mc_channel_count(c, noise_conf)


def _is_mc(c: Any) -> bool:
    from .models.circuit import Circuit

    return isinstance(c, Circuit)


def apply_qir_with_noise(c: Any, qir: List[Dict[str, Any]], noise_conf: NoiseConf, status: Optional[Tensor] = None) -> Any:
    """Replay ``qir`` onto ``c`` with the configured channels after each
    matching item: on a ``Circuit`` one trajectory, ``status[k]`` choosing
    the branch of site k (drawn on the device without it); on a
    ``DMCircuit`` the exact channels.  Returns ``c``."""
    mc = _is_mc(c)
    if mc and status is not None:
        status = device_tensor(status, c.device)
    k = 0
    for item in qir:
        c._apply_qir_item(item)
        for ks in noise_conf.channels_for(item):
            index = item["index"]
            targets = [index] if _channel_sites(ks, index) == 1 else [(q,) for q in index]
            for tgt in targets:
                if mc:
                    st = status[k] if status is not None else None
                    if getattr(ks, "is_unitary", False):
                        c.unitary_kraus(ks, *tgt, status=st)
                    else:
                        c.general_kraus(ks, *tgt, status=st)
                    k += 1
                else:
                    c.apply_general_kraus(ks, *tgt)
    return c


def circuit_with_noise(c: Any, noise_conf: NoiseConf, status: Optional[Tensor] = None) -> Any:
    """A new circuit of ``c``'s type, inputs and device: ``c``'s QIR with
    the channels inserted after the matching gates (one trajectory with
    ``status`` of shape [channel_count] on a ``Circuit``, exact on a
    ``DMCircuit``)."""
    return apply_qir_with_noise(type(c)(**c._copy_params()), c.to_qir(), noise_conf, status=status)


def _statuses(c: Any, status: Optional[Tensor], nmc: int, num: int, what: str) -> torch.Tensor:
    """[nmc, num] uniforms on ``c``'s device: ``status`` checked, else
    drawn from the backend's generator of that device."""
    if status is None:
        if nmc < 1:
            raise ValueError(
                "nmc must be >= 1 for Monte-Carlo noise on a Circuit (an empty trajectory mean is NaN); "
                "for the exact channel evolution run the same QIR on a DMCircuit instead"
            )
        return K.implicit_randu([nmc, num], device=c.device)
    status = device_tensor(status, c.device, what)
    if status.ndim < 1 or status.shape[-1] != num:
        raise ValueError(f"{what} last dim {tuple(status.shape)[-1:]} != channel count {num}")
    return torch.reshape(status, (-1, num))


def _trajectory_mean(c: Any, noise_conf: NoiseConf, status: torch.Tensor, value: Callable[[Any], Tensor]) -> Tensor:
    """The mean of ``value`` over one noisy circuit a row of ``status``,
    built and read one at a time."""
    vals = [torch.real(value(circuit_with_noise(c, noise_conf, status=st))) for st in status]
    return torch.mean(torch.stack(vals))


def expectation_noisfy(
    c: Any,
    *ops: Any,
    noise_conf: Optional[NoiseConf] = None,
    nmc: int = 1000,
    status: Optional[Tensor] = None,
    **kws: Any,
) -> Tensor:
    """The noisy ⟨O_1 O_2 ...⟩: exact on a ``DMCircuit``; on a ``Circuit``
    the mean of the real part over the trajectories of ``status`` [nmc,
    channel_count] (``nmc`` rows drawn on the device without it)."""
    if noise_conf is None:
        noise_conf = NoiseConf()
    if not _is_mc(c):
        return circuit_with_noise(c, noise_conf).expectation(*ops, **kws)
    num = _mc_channel_count(c, noise_conf)
    if num == 0:
        return c.expectation(*ops, **kws)
    status = _statuses(c, status, nmc, num, "status")
    return _trajectory_mean(c, noise_conf, status, lambda cn: cn.expectation(*ops, **kws))


def sample_expectation_ps_noisfy(
    c: Any,
    x: Optional[Sequence[int]] = None,
    y: Optional[Sequence[int]] = None,
    z: Optional[Sequence[int]] = None,
    noise_conf: Optional[NoiseConf] = None,
    nmc: int = 1000,
    shots: Optional[int] = None,
    status: Optional[Tensor] = None,
    statusc: Optional[Tensor] = None,
    **kws: Any,
) -> Tensor:
    """The noisy shot-based ⟨X_x Y_y Z_z⟩, through the readout error of
    ``noise_conf`` (``"readout"``; else a ``readout_error=`` given here):
    exact channels on a ``DMCircuit``; on a ``Circuit`` the mean over the
    trajectories of ``statusc`` [nmc, channel_count], each trajectory
    sampled with the same shot uniforms ``status``."""
    if noise_conf is None:
        noise_conf = NoiseConf()
    readout_error = kws.pop("readout_error", None)
    if noise_conf.has_readout:
        readout_error = noise_conf.nc.get("readout")

    def value(cn: Any) -> Tensor:
        return cn.sample_expectation_ps(x=x, y=y, z=z, shots=shots, readout_error=readout_error, status=status, **kws)

    if not _is_mc(c):
        return value(circuit_with_noise(c, noise_conf))
    num = _mc_channel_count(c, noise_conf)
    if num == 0:
        return value(c)
    statusc = _statuses(c, statusc, nmc, num, "statusc")
    return _trajectory_mean(c, noise_conf, statusc, value)
