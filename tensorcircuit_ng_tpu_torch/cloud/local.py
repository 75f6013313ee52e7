"""The local provider: tasks run in this process on the port's dense
``Circuit``, sampled on the circuit's device (the card unless the circuit
was built for the CPU), and return counts.

Counterpart of ``tensorcircuit_ng_tpu/cloud/local.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .abstraction import Device, Task

__all__ = ["submit_task", "list_devices", "get_device_properties"]


def list_devices() -> List[Device]:
    return [Device("default", None), Device("testing", None)]


def get_device_properties(device: Device) -> Dict[str, Any]:
    return {"name": device.name, "qubits": 30, "native_gates": "all", "backend": "statevector"}


def submit_task(
    device: Device,
    circuit: Any = None,
    shots: Union[int, Sequence[int]] = 8192,
    **kws: Any,
) -> Union[Task, List[Task]]:
    """One task a circuit: ``shots`` draws from its state by
    ``Circuit.sample(allow_state=True)``, as bit-string counts.  ``status``
    and ``random_generator`` in ``kws`` go to ``sample`` (for one circuit)."""
    circuits = circuit if isinstance(circuit, (list, tuple)) else [circuit]
    shots_list = shots if isinstance(shots, (list, tuple)) else [shots] * len(circuits)
    tasks = []
    for c, s in zip(circuits, shots_list):
        t = Task(device=device)
        counts = c.sample(
            batch=int(s),
            allow_state=True,
            format="count_dict_bin",
            status=kws.get("status"),
            random_generator=kws.get("random_generator"),
        )
        t._set_results({k: int(v) for k, v in counts.items()})
        tasks.append(t)
    if not isinstance(circuit, (list, tuple)):
        return tasks[0]
    return tasks


def get_task_details(task: Any, **kws: Any) -> Dict[str, Any]:
    """The details of a local task."""
    return task.details() if hasattr(task, "details") else {"id": str(task)}


def list_tasks(**filters: Any) -> List[Any]:
    """The tasks of ``apis``'s registry."""
    from . import apis

    return list(apis._tasks.values())
