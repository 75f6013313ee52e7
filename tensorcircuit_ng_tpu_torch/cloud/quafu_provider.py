"""The Quafu cloud provider, over the ``quafu`` SDK.

Counterpart of ``tensorcircuit_ng_tpu/cloud/quafu_provider.py``.  The SDK
is imported when a call needs it, so the module imports without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .abstraction import Device, Provider, Task

__all__ = [
    "list_devices",
    "list_properties",
    "submit_task",
    "resubmit_task",
    "remove_task",
    "list_tasks",
    "get_task_details",
]


def _user(token: Optional[str] = None) -> Any:
    from quafu import User  # type: ignore

    user = User()
    if token is not None:
        user.save_apitoken(token)
    return user


def list_devices(token: Optional[str] = None, **kws: Any) -> List[Device]:
    user = _user(token)
    provider = Provider("quafu")
    return [Device(name, provider) for name in user.get_available_backends()]


def list_properties(device: Device, token: Optional[str] = None) -> Dict[str, Any]:
    user = _user(token)
    backends = user.get_available_backends()
    info = backends.get(device.name)
    return dict(getattr(info, "__dict__", {"name": device.name}))


def submit_task(
    device: Device,
    circuit: Any = None,
    shots: int = 8192,
    source: Optional[str] = None,
    token: Optional[str] = None,
    compile: bool = True,
    **kws: Any,
) -> Task:
    from quafu import QuantumCircuit as QuafuCircuit  # type: ignore
    from quafu import Task as QuafuTask  # type: ignore

    if source is None:
        source = circuit.to_openqasm()
    qc = QuafuCircuit(circuit._nqubits if circuit is not None else 1)
    qc.from_openqasm(source)
    qtask = QuafuTask()
    qtask.config(backend=device.name, shots=shots, compile=compile)
    res = qtask.send(qc, wait=False)
    t = Task(res.taskid, device)
    t._source = source  # kept for client-side resubmission
    t._shots = shots
    from . import apis

    apis._tasks[t.id_] = t
    return t


def resubmit_task(task: Union[str, Task], token: Optional[str] = None, **kws: Any) -> Task:
    """The quafu API has no server-side resubmission; submit the stored
    source as a fresh task (client-side resubmission)."""
    if not isinstance(task, Task) or getattr(task, "_source", None) is None:
        raise ValueError(
            "quafu resubmission needs the original Task with its stored "
            "source (server-side resubmission is not offered by the API)"
        )
    return submit_task(
        task.device,
        source=task._source,
        shots=getattr(task, "_shots", 8192),
        token=token,
        **kws,
    )


def remove_task(task: Union[str, Task], token: Optional[str] = None) -> None:
    """The quafu API offers no server-side removal; drop the client-side
    handle so it stops appearing in :func:`list_tasks`."""
    from . import apis

    tid = task.id_ if isinstance(task, Task) else task
    apis._tasks.pop(tid, None)


def list_tasks(device: Optional[Device] = None, token: Optional[str] = None, **filters: Any) -> List[Task]:
    """Client-side task registry (the quafu API exposes no listing)."""
    from . import apis

    out = []
    for t in apis._tasks.values():
        prov = getattr(getattr(t, "device", None), "provider", None)
        if prov is not None and prov.name == "quafu":
            if device is None or t.device.name == device.name:
                out.append(t)
    return out


def get_task_details(task: Union[str, Task], token: Optional[str] = None) -> Dict[str, Any]:
    from quafu import Task as QuafuTask  # type: ignore

    tid = task.id_ if isinstance(task, Task) else task
    qtask = QuafuTask()
    res = qtask.retrieve(tid)
    return {
        "id": tid,
        "state": getattr(res, "task_status", "unknown"),
        "counts": dict(getattr(res, "counts", {}) or {}),
    }
