"""Provider, Device and Task handles of the cloud API.

Counterpart of ``tensorcircuit_ng_tpu/cloud/abstraction.py``, with its
exception classes.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

__all__ = ["Provider", "Device", "Task"]


class TCException(Exception):
    """Base exception of the cloud layer."""


class TaskException(TCException):
    """A failure of a task."""


class TaskUnfinished(TaskException):
    """Results asked for before the task completed."""

    def __init__(self, taskid: str, state: str):
        self.taskid = taskid
        self.state = state
        super().__init__(f"Task {taskid} is not completed yet, now in {state} state")


class TaskFailed(TaskException):
    """The task ended in an error state."""

    def __init__(self, taskid: str, state: str = "failed", message: str = ""):
        self.taskid = taskid
        self.state = state
        super().__init__(f"Task {taskid} failed: {message}")


class Provider:
    _registry: Dict[str, "Provider"] = {}

    def __init__(self, name: str, lower: bool = True):
        self.name = name.lower() if lower else name
        Provider._registry[self.name] = self

    @classmethod
    def from_name(cls, name: Union[str, "Provider"]) -> "Provider":
        if isinstance(name, Provider):
            return name
        name = name.lower()
        if name not in cls._registry:
            Provider(name)
        return cls._registry[name]

    def list_devices(self) -> List["Device"]:
        from . import apis

        return apis.list_devices(self)

    def get_device(self, device: Any = None) -> "Device":
        """A device of this provider (the default device when None)."""
        from . import apis

        if device is None:
            return apis.get_device()
        return Device.from_name(device, self)

    def get_token(self) -> Any:
        from . import apis

        return apis.get_token(self)

    def set_token(self, token: Optional[str] = None, **kws: Any) -> Any:
        from . import apis

        return apis.set_token(token, provider=self, **kws)

    def list_tasks(self, **filters: Any) -> Any:
        from . import apis

        return apis.list_tasks(provider=self, **filters)

    def __repr__(self) -> str:
        return f"Provider({self.name!r})"


class Device:
    def __init__(self, name: str, provider: Optional[Provider] = None):
        if "::" in name and provider is None:
            pname, name = name.split("::", 1)
            provider = Provider.from_name(pname)
        self.name = name
        self.provider = provider or Provider.from_name("local")

    @classmethod
    def from_name(cls, name: Union[str, "Device"], provider: Any = None) -> "Device":
        if isinstance(name, Device):
            return name
        return cls(name, Provider.from_name(provider) if provider else None)

    def list_properties(self) -> Dict[str, Any]:
        from . import apis

        return apis.get_device_properties(self)

    def submit_task(self, **kws: Any) -> Any:
        from . import apis

        return apis.submit_task(device=self, **kws)

    def get_task(self, taskid: str) -> "Task":
        from . import apis

        return apis.get_task(taskid)

    def get_token(self) -> Any:
        return self.provider.get_token()

    def set_token(self, token: Optional[str] = None, **kws: Any) -> Any:
        return self.provider.set_token(token, **kws)

    def list_tasks(self, **filters: Any) -> Any:
        from . import apis

        return apis.list_tasks(device=self, **filters)

    def native_gates(self) -> List[str]:
        """The native gate set of the device's properties."""
        props = self.list_properties()
        return list(props.get("native_gates", props.get("basis_gates", [])))

    def topology(self) -> List[List[int]]:
        """The coupling map of the device's properties."""
        props = self.list_properties()
        links = props.get("topology", props.get("coupling_map", []))
        return [list(e) for e in links]

    def topology_graph(self, visualize: bool = False) -> Any:
        """The coupling map as an ``nx.Graph``."""
        import networkx as nx

        g = nx.Graph()
        props = self.list_properties()
        n = int(props.get("nqubits", props.get("n", 0)) or 0)
        g.add_nodes_from(range(n))
        g.add_edges_from(self.topology())
        if visualize:  # pragma: no cover
            nx.draw(g, with_labels=True)
        return g

    def __repr__(self) -> str:
        return f"Device({self.provider.name}::{self.name})"


class Task:
    """A handle of a submitted job: its id, device, state and results."""

    def __init__(self, id_: Optional[str] = None, device: Optional[Device] = None):
        self.id_ = id_ or str(uuid.uuid4())
        self.device = device
        self._state = "pending"
        self._results: Optional[Dict[str, int]] = None
        self._submit_time = time.time()

    def state(self) -> str:
        return self._state

    status = state

    def _set_results(self, counts: Dict[str, int]) -> None:
        self._results = counts
        self._state = "completed"

    def results(self, blocked: bool = True, format: Optional[str] = None, mitigated: bool = False) -> Any:
        if self._results is None:
            raise RuntimeError(f"task {self.id_} has no results (state={self._state})")
        return dict(self._results)

    def details(self) -> Dict[str, Any]:
        return {
            "id": self.id_,
            "device": repr(self.device),
            "state": self._state,
            "submit_time": self._submit_time,
        }

    def add_details(self, **kws: Any) -> Dict[str, Any]:
        """Attach extra metadata to the task record."""
        if not hasattr(self, "_extra_details"):
            self._extra_details = {}
        self._extra_details.update(kws)
        return self._extra_details

    def get_device(self) -> Optional[Device]:
        return self.device

    def get_logical_physical_mapping(self) -> Optional[Dict[int, int]]:
        """The qubit mapping recorded at submission."""
        return getattr(self, "_extra_details", {}).get("logical_physical_mapping")

    def resubmit(self, **kws: Any) -> "Task":
        from . import apis

        return apis.resubmit_task(self, **kws)

    def __repr__(self) -> str:
        return f"Task(id={self.id_!r}, state={self._state!r})"
