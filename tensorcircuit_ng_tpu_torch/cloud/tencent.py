"""The Tencent quantum cloud provider.

Counterpart of ``tensorcircuit_ng_tpu/cloud/tencent.py``.  It covers the
vendor's surface: device discovery + property normalization
(links/bits keyed dicts), OpenQASM payload construction with the ``?o=``
QOS option bitmask and dry-run flag, rz->S/T phase-gate folding, batched
submission with per-task error triage, task lifecycle (start/remove/find)
and result/detail parsing with prettified timestamps and circuit
round-trips.  Every request goes through :mod:`.utils` (retries, proxy,
and ``set_transport``, through which a mock serves every endpoint in
tests).
"""

from __future__ import annotations

import logging
import re
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence, Union

from .abstraction import Device, Provider, Task
from .utils import rpost_json

logger = logging.getLogger(__name__)

__all__ = [
    "tencent_headers",
    "error_handling",
    "list_devices",
    "list_properties",
    "get_device_properties",
    "submit_task",
    "resubmit_task",
    "remove_task",
    "list_tasks",
    "get_task_details",
]

_BASE = "https://quantum.tencent.com/qos/api/"

#: the chip's calibrated gate set reported with device properties
_NATIVE_GATES = ["h", "rz", "x", "y", "z", "cz", "cx"]


def tencent_headers(token: Optional[str] = None) -> Dict[str, str]:
    """The auth headers of the Tencent API."""
    if token is None:
        from . import apis

        token = apis.get_token("tencent")
    if token is None:
        raise ValueError("no token set for provider 'tencent' (use apis.set_token)")
    return {"Authorization": f"Bearer {token}", "Content-Type": "application/json"}


def error_handling(payload: Any) -> Dict[str, Any]:
    """The payload, or RuntimeError where it reports an error."""
    if not isinstance(payload, dict):
        raise ValueError(f"malformed provider response: {payload!r}")
    msg = payload.get("err") or payload.get("error")
    if msg:
        raise RuntimeError(f"tencent API error: {msg}")
    return payload


def list_devices(token: Optional[str] = None, **kws: Any) -> List[Device]:
    """Enumerate devices (``device/find``); extra kwargs become find filters."""
    payload = error_handling(
        rpost_json(_BASE + "device/find", body=dict(kws), headers=tencent_headers(token))
    )
    provider = Provider.from_name("tencent")
    return [Device(d["id"], provider) for d in payload.get("devices", [])]


def list_properties(device: Device, token: Optional[str] = None) -> Dict[str, Any]:
    """Device detail (``device/detail``), normalized the way downstream code
    expects: ``links`` keyed by qubit pair,
    ``bits`` keyed by qubit index, ``native_gates`` attached."""
    payload = error_handling(
        rpost_json(
            _BASE + "device/detail",
            body={"id": device.name},
            headers=tencent_headers(token),
        )
    )
    if "device" not in payload:
        raise ValueError(f"no device named {device.name!r} on the tencent provider")
    props = dict(payload["device"])
    if isinstance(props.get("links"), list):
        props["links"] = {(lk["A"], lk["B"]): lk for lk in props["links"]}
    if isinstance(props.get("bits"), list):
        props["bits"] = {b["Qubit"]: b for b in props["bits"]}
    props.setdefault("native_gates", list(_NATIVE_GATES))
    return props


get_device_properties = list_properties

# rz at these multiples of pi folds to a named phase gate (a table and a
# regex, so that equivalent spellings fold too)
_RZ_FOLD = {
    "pi/2": "s", "5*pi/2": "s",
    "-pi/2": "sdg", "3*pi/2": "sdg",
    "pi/4": "t", "-pi/4": "tdg",
}
_RZ_LINE = re.compile(r"^rz\(([^)]+)\)\s+(.*)$")


def _fold_phase_gates(qasm: str) -> str:
    """Rewrite ``rz`` at S/T angles into the named gates the chip calibrates."""
    out = []
    for line in qasm.split("\n"):
        m = _RZ_LINE.match(line)
        folded = m and _RZ_FOLD.get(m.group(1).replace(" ", ""))
        out.append(f"{folded} {m.group(2)}" if folded else line)
    return "\n".join(out)


def _qos_device_string(
    device: Device,
    qubit_mapping: bool,
    gate_decomposition: bool,
    initial_mapping: bool,
    dry_run: bool,
) -> str:
    """Encode QOS pipeline options into the device field.

    The backend reads compilation switches from a query-style suffix: bit 0 =
    insert-swaps mapping, bit 1 = gate decomposition, bit 2 = initial qubit
    placement. A name that
    already carries ``?`` is passed through untouched.
    """
    if "?" in device.name:
        spec = device.name
    else:
        mask = (1 if qubit_mapping else 0) | (2 if gate_decomposition else 0) | (4 if initial_mapping else 0)
        spec = f"{device.name}?o={mask}"
    return spec + "&dry" if dry_run else spec


def submit_task(
    device: Device,
    token: Optional[str] = None,
    lang: str = "OPENQASM",
    shots: Union[int, Sequence[int]] = 1024,
    version: str = "1",
    prior: int = 1,
    circuit: Any = None,
    source: Optional[Union[str, Sequence[str]]] = None,
    remarks: Optional[str] = None,
    group: Optional[str] = None,
    compiling: bool = False,
    compiled_options: Optional[Dict[str, Any]] = None,
    enable_qos_qubit_mapping: bool = True,
    enable_qos_gate_decomposition: bool = True,
    enable_qos_initial_mapping: bool = False,
    qos_dry_run: bool = False,
    **kws: Any,
) -> Union[Task, List[Task]]:
    """Submit OpenQASM job(s) via ``task/submit``.

    Circuits are
    emitted to OpenQASM with S/T folding (optionally through the local
    compiler when ``compiling=True``), QOS options ride the device string,
    a sequence of sources becomes one batched POST with per-circuit shots,
    and per-task submission errors are warned-and-skipped — raising only if
    *every* task failed.
    """
    if source is None:
        if circuit is None:
            raise ValueError("either `circuit` or `source` must be provided")

        def emit(c: Any) -> str:
            if compiling:
                from ..compiler.composed_compiler import default_compile

                c, _info = default_compile(c, compiled_options=compiled_options)
            return _fold_phase_gates(c.to_openqasm())

        batched_in = isinstance(circuit, (list, tuple))
        source = [emit(c) for c in circuit] if batched_in else emit(circuit)
        lang = "OPENQASM"

    device_str = _qos_device_string(
        device,
        enable_qos_qubit_mapping,
        enable_qos_gate_decomposition,
        enable_qos_initial_mapping,
        qos_dry_run,
    )

    def job(src: str, nshots: int) -> Dict[str, Any]:
        return {
            "device": device_str,
            "shots": int(nshots),
            "source": src,
            "version": version,
            "lang": lang,
            "prior": prior,
            "remarks": remarks,
            "group": group,
        }

    batched = not isinstance(source, str)
    if batched:
        sources = list(source)
        shots_list = list(shots) if isinstance(shots, (list, tuple)) else [shots] * len(sources)
        body: Any = [job(s, sh) for s, sh in zip(sources, shots_list)]
    else:
        body = job(source, int(shots))  # type: ignore[arg-type]
    payload = error_handling(
        rpost_json(_BASE + "task/submit", body=body, headers=tencent_headers(token))
    )
    accepted: List[Task] = []
    for item in payload.get("tasks", []):
        if item.get("err") or "id" not in item:
            logger.warning(
                "task submission rejected: %s", item.get("err", f"no id in {item!r}")
            )
            continue
        accepted.append(Task(item["id"], device))
    if not batched:
        if not accepted:
            raise ValueError(f"task submission failed: {payload!r}")
        return accepted[0]
    if not accepted:
        raise ValueError("All tasks submitted failed")
    return accepted


def resubmit_task(task: Union[str, Task], token: Optional[str] = None, **kws: Any) -> Task:
    """Restart a task (``task/start``)."""
    tid = task.id_ if isinstance(task, Task) else task
    payload = error_handling(
        rpost_json(_BASE + "task/start", body={"id": tid}, headers=tencent_headers(token))
    )
    try:
        item = payload["tasks"][0]
        return Task(item["id"], task.device if isinstance(task, Task) else None)
    except (KeyError, IndexError) as e:
        raise ValueError(f"unexpected task/start response: {payload!r}") from e


def remove_task(task: Union[str, Task], token: Optional[str] = None, **kws: Any) -> Any:
    """Cancel a task (``task/remove``)."""
    tid = task.id_ if isinstance(task, Task) else task
    return error_handling(
        rpost_json(_BASE + "task/remove", body={"id": tid}, headers=tencent_headers(token))
    )


def list_tasks(
    device: Optional[Device] = None, token: Optional[str] = None, **filters: Any
) -> List[Task]:
    """Query the task queue (``task/find``) with optional device + filters."""
    body = dict(filters)
    if device is not None:
        body["device"] = device.name
    payload = error_handling(
        rpost_json(_BASE + "task/find?pn=1&npp=50", body=body, headers=tencent_headers(token))
    )
    provider = Provider.from_name("tencent")
    try:
        return [
            Task(t["id"], Device(t["device"].split("?")[0], provider))
            for t in payload["tasks"]
        ]
    except KeyError as e:
        raise ValueError(f"unexpected task/find response: {payload!r}") from e


def _us_timestamp_to_dt(value: Any) -> Any:
    try:
        return datetime.fromtimestamp(float(value) / 1e6)
    except (TypeError, ValueError, OSError):
        return value


def get_task_details(
    task: Union[str, Task],
    device: Optional[Device] = None,
    token: Optional[str] = None,
    prettify: bool = False,
    **kws: Any,
) -> Dict[str, Any]:
    """Task detail (``task/detail``), normalized per the cross-provider
    contract: ``results`` is always the
    counts dict, optimization qubit pairs get int keys, and ``prettify``
    converts microsecond timestamps and reconstructs the submitted circuit."""
    tid = task.id_ if isinstance(task, Task) else task
    payload = error_handling(
        rpost_json(_BASE + "task/detail", body={"id": tid}, headers=tencent_headers(token))
    )
    if "task" not in payload:
        raise ValueError(f"unexpected task/detail response: {payload!r}")
    details = dict(payload["task"])
    result = details.get("result")
    if isinstance(result, dict):
        details["results"] = result.get("counts", result)
    pairs = (details.get("optimization") or {}).get("pairs")
    if isinstance(pairs, dict):
        details["optimization"] = dict(details["optimization"])
        details["optimization"]["pairs"] = {int(k): int(v) for k, v in pairs.items()}
    if isinstance(task, Task) and details.get("state") == "completed" and details.get("results"):
        task._set_results({k: int(v) for k, v in details["results"].items()})
        if isinstance(details.get("optimization"), dict) and "pairs" in details["optimization"]:
            task.add_details(logical_physical_mapping=details["optimization"]["pairs"])
    if not prettify:
        return details
    if "at" in details:
        details["at"] = _us_timestamp_to_dt(details["at"])
    if isinstance(details.get("ts"), dict):
        details["ts"] = {k: _us_timestamp_to_dt(v) for k, v in details["ts"].items()}
    if details.get("source"):
        try:
            from ..translation import qasm2tc

            details["frontend"] = qasm2tc(details["source"])
        except Exception as e:  # unparseable vendor-dialect source: keep raw
            logger.debug("could not rebuild frontend circuit: %s", e)
    return details
