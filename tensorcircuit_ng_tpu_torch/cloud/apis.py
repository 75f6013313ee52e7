"""The functional cloud API over the providers.

Counterpart of ``tensorcircuit_ng_tpu/cloud/apis.py``: ``set_provider``,
``set_device`` and ``set_token`` keep the process's defaults (tokens in
memory and, with ``cached=True``, base64 in ``_TOKEN_FILE``), and
``submit_task`` and the task functions go to the provider's module.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

from .abstraction import Device, Provider, Task

__all__ = [
    "set_provider",
    "default_provider",
    "default_device",
    "get_provider",
    "set_device",
    "get_device",
    "set_token",
    "get_token",
    "list_providers",
    "list_devices",
    "get_device_properties",
    "submit_task",
    "resubmit_task",
    "list_tasks",
    "get_task",
    "get_task_details",
]

_default_provider: Provider = Provider.from_name("local")
_default_device: Optional[Device] = None

# module attributes kept in step by set_provider/set_device; get_provider and
# get_device read the values that count
default_provider: Provider = _default_provider
default_device: Optional[Device] = _default_device
_tokens: Dict[str, str] = {}
saved_token: Dict[str, str] = _tokens
avail_providers = ["tencent", "local", "quafu", "tianyan"]
package_name = "tensorcircuit_ng_tpu_torch"
_tasks: Dict[str, Task] = {}

_TOKEN_FILE = os.path.expanduser("~/.tc_tpu.auth.json")


def set_provider(provider: Union[str, Provider] = "local", set_global: bool = True) -> Provider:
    global _default_provider, default_provider
    p = Provider.from_name(provider)
    if set_global:
        _default_provider = p
        default_provider = p
    return p


def get_provider() -> Provider:
    return _default_provider


def set_device(device: Union[str, Device] = "default", set_global: bool = True) -> Device:
    global _default_device, default_device
    d = Device.from_name(device)
    if set_global:
        _default_device = d
        default_device = d
    return d


def get_device() -> Device:
    if _default_device is None:
        return Device("default")
    return _default_device


def set_token(token: Optional[str] = None, provider: Union[str, Provider] = None, cached: bool = True) -> Dict[str, str]:
    p = Provider.from_name(provider) if provider else get_provider()
    if token is not None:
        _tokens[p.name] = token
        if cached:
            try:
                with open(_TOKEN_FILE, "w") as f:
                    json.dump(
                        {k: base64.b64encode(v.encode()).decode() for k, v in _tokens.items()},
                        f,
                    )
            except OSError:
                pass
    return dict(_tokens)


def get_token(provider: Union[str, Provider] = None) -> Optional[str]:
    p = Provider.from_name(provider) if provider else get_provider()
    if p.name in _tokens:
        return _tokens[p.name]
    try:
        with open(_TOKEN_FILE) as f:
            data = json.load(f)
        return base64.b64decode(data.get(p.name, "")).decode() or None
    except (OSError, ValueError):
        return None


def list_providers() -> List[str]:
    return list(Provider._registry)


def _provider_module(p: Provider) -> Any:
    import importlib

    try:
        return importlib.import_module(f".{p.name}", __package__)
    except ImportError as e:
        raise ValueError(f"provider {p.name!r} has no backend module") from e


def list_devices(provider: Union[str, Provider, None] = None) -> List[Device]:
    p = Provider.from_name(provider) if provider else get_provider()
    return _provider_module(p).list_devices()


def get_device_properties(device: Union[str, Device]) -> Dict[str, Any]:
    d = Device.from_name(device)
    return _provider_module(d.provider).get_device_properties(d)


def submit_task(
    device: Union[str, Device, None] = None,
    provider: Union[str, Provider, None] = None,
    **kws: Any,
) -> Union[Task, List[Task]]:
    d = Device.from_name(device) if device is not None else get_device()
    mod = _provider_module(d.provider)
    t = mod.submit_task(d, **kws)
    for task in t if isinstance(t, list) else [t]:
        _tasks[task.id_] = task
    return t


def _task_provider_module(t: Task) -> Optional[Any]:
    """Provider module owning the task, or None for local/unregistered."""
    provider = getattr(t.device, "provider", None)
    if provider is None or provider.name == "local":
        return None
    try:
        return _provider_module(provider)
    except ValueError:
        return None


def resubmit_task(task: Union[str, Task], **kws: Any) -> Task:
    t = get_task(task)
    mod = _task_provider_module(t)
    if mod is not None and hasattr(mod, "resubmit_task"):
        fresh = mod.resubmit_task(t, **kws)
        _tasks[fresh.id_] = fresh
        return fresh
    return submit_task(device=t.device, **kws)


def get_task(task: Union[str, Task]) -> Task:
    if isinstance(task, Task):
        return task
    return _tasks[task]


def get_task_details(task: Union[str, Task], **kws: Any) -> Dict[str, Any]:
    """Task details, refreshed from the owning provider when it has one."""
    t = get_task(task)
    mod = _task_provider_module(t)
    if mod is not None and hasattr(mod, "get_task_details"):
        return mod.get_task_details(t, **kws)
    return t.details()


def list_tasks(provider: Union[str, Provider, None] = None, **filters: Any) -> List[Task]:
    if provider is not None:
        mod = _provider_module(Provider.from_name(provider))
        if hasattr(mod, "list_tasks"):
            return mod.list_tasks(**filters)
    return list(_tasks.values())


def remove_task(task: Union[str, Task]) -> None:
    t = get_task(task)
    mod = _task_provider_module(t)
    if mod is not None and hasattr(mod, "remove_task"):
        try:
            mod.remove_task(t)
        except NotImplementedError:
            pass
    _tasks.pop(t.id_, None)


def b64encode_s(s: str) -> str:
    """str -> base64 str (the token file's codec)."""
    return base64.b64encode(s.encode("utf-8")).decode("utf-8")


def b64decode_s(s: str) -> str:
    """base64 str -> str."""
    return base64.b64decode(s.encode("utf-8")).decode("utf-8")


def list_properties(device: Union[str, Device, None] = None) -> Dict[str, Any]:
    """The properties of a device (the default device when None)."""
    if device is None:
        device = get_device()
    return get_device_properties(device)
