"""Execution wrappers over the cloud API.

Counterpart of ``tensorcircuit_ng_tpu/cloud/wrapper.py``:
``batch_expectation_ps`` is the one switch between the exact values of the
port's circuit (on its device) and counts from a device, reduced by the
port's ``results/`` with readout mitigation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..translation import _host
from . import apis
from .abstraction import Device

__all__ = ["batch_submit_template", "batch_expectation_ps", "sample_expectation_ps", "reduce_and_evaluate"]


def batch_submit_template(device: Union[str, Device], **default_kws: Any):
    """Return ``execute(circuits, shots) -> [counts]`` bound to a device.

    The returned callable is what :class:`~..results.readout_mitigation.ReadoutMit`
    consumes.
    """

    def execute(circuits: Sequence[Any], shots: int = 8192) -> List[Dict[str, int]]:
        tasks = apis.submit_task(
            device=device, circuit=list(circuits), shots=shots, **default_kws
        )
        if not isinstance(tasks, list):
            tasks = [tasks]
        return [t.results() for t in tasks]

    return execute


def batch_expectation_ps(
    c: Any,
    pss: Sequence[Sequence[int]],
    device: Union[str, Device, None] = None,
    ws: Optional[Sequence[float]] = None,
    shots: int = 8192,
    with_rem: bool = True,
) -> Any:
    """Batched Pauli-string expectations, locally exact or device-sampled.

    ``device=None`` computes exact values on the simulator; a device routes
    through basis rotation → sampling → (optional) readout mitigation —
    the QPU/simulator switch point of application code.
    """
    if device is None:
        vals = [np.real(np.asarray(_host(c.expectation_ps(ps=list(ps))))) for ps in pss]
        vals = np.asarray(vals)
        if ws is not None:
            return float(np.sum(vals * np.asarray(ws)))
        return vals

    execute = batch_submit_template(device)
    circuits = []
    measure_wires = []
    for ps in pss:
        cc = c.copy()
        wires = []
        for q, v in enumerate(ps):
            if v == 1:
                cc.h(q)
                wires.append(q)
            elif v == 2:
                cc.sd(q)
                cc.h(q)
                wires.append(q)
            elif v == 3:
                wires.append(q)
        circuits.append(cc)
        measure_wires.append(wires)
    counts_list = execute(circuits, shots)
    vals = []
    if with_rem:
        from ..results.readout_mitigation import ReadoutMit

        mit = ReadoutMit(execute)
        mit.cals_from_system(c.nqubits, shots=shots, method="local")
    for cnt, wires in zip(counts_list, measure_wires):
        if with_rem:
            v = mit.expectation(cnt, z=wires, method="inverse")
        else:
            from ..results import counts as counts_mod

            v = counts_mod.expectation(cnt, z=wires)
        vals.append(v)
    vals = np.asarray(vals)
    if ws is not None:
        return float(np.sum(vals * np.asarray(ws)))
    return vals


def sample_expectation_ps(
    c: Any,
    device: Union[str, Device, None] = None,
    shots: int = 8192,
    x: Optional[Sequence[int]] = None,
    y: Optional[Sequence[int]] = None,
    z: Optional[Sequence[int]] = None,
    with_rem: bool = False,
    **kws: Any,
) -> float:
    """One Pauli string's expectation from shots: the circuit's own
    ``sample_expectation_ps`` when ``device`` is None, else the
    basis-rotated circuit's counts from the device."""
    n = c._nqubits
    ps = [0] * n
    for q in x or ():
        ps[q] = 1
    for q in y or ():
        ps[q] = 2
    for q in z or ():
        ps[q] = 3
    if device is None:
        return float(np.real(np.asarray(_host(c.sample_expectation_ps(x=x, y=y, z=z, shots=shots)))))
    out = batch_expectation_ps(c, [ps], device=device, shots=shots, with_rem=with_rem)
    return float(np.asarray(out)[0])


def reduce_and_evaluate(counts: Sequence[Dict[str, int]], weights: Sequence[float]) -> float:
    """Σ_i w_i ⟨Z-parity⟩_i from per-term counts."""
    from ..results import counts as counts_mod

    acc = 0.0
    for cnt, w in zip(counts, weights):
        acc += w * counts_mod.expectation(cnt, z=None)
    return acc
