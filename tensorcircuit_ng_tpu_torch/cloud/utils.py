"""The transport of the cloud providers.

Counterpart of ``tensorcircuit_ng_tpu/cloud/utils.py``: GET and POST over
``requests`` with retries, a proxy set by ``set_proxy``, and
``set_transport``, which sends every call to a callable instead (a mock in
tests; nothing then opens a connection).  ``requests`` is imported only
when a call goes to the network.
"""

from __future__ import annotations

import json
import logging
import time
from functools import wraps
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "HttpStatusError",
    "set_proxy",
    "set_transport",
    "reconnect",
    "rget",
    "rpost",
    "rget_json",
    "rpost_json",
]

_PROXY: Optional[Dict[str, str]] = None

#: when set, all cloud HTTP goes through this callable instead of the network:
#: ``handler(method, url, body, headers) -> dict``.  This is the offline-test
#: seam (no egress in this environment); ``set_transport(None)`` restores HTTP.
_TRANSPORT: Optional[Callable[[str, str, Optional[Dict[str, Any]], Optional[Dict[str, str]]], Dict[str, Any]]] = None


def set_transport(
    handler: Optional[Callable[[str, str, Optional[Dict[str, Any]], Optional[Dict[str, str]]], Dict[str, Any]]]
) -> None:
    """Install (or clear with ``None``) a mock transport for cloud calls."""
    global _TRANSPORT
    _TRANSPORT = handler


class HttpStatusError(Exception):
    """Raised on non-2xx responses or malformed JSON payloads."""


def set_proxy(proxy: Optional[str] = None) -> None:
    """Set (or clear with None) the HTTP(S) proxy used by the cloud calls."""
    global _PROXY
    _PROXY = {"http": proxy, "https": proxy} if proxy else None


def reconnect(tries: int = 3, sleep: float = 1.0) -> Callable[..., Any]:
    """A decorator that retries a call on a connection failure (not on an
    ``HttpStatusError``), ``tries`` times with a growing sleep."""

    def deco(f: Callable[..., Any]) -> Callable[..., Any]:
        @wraps(f)
        def wrapper(*args: Any, **kws: Any) -> Any:
            err: Optional[Exception] = None
            for attempt in range(tries):
                try:
                    return f(*args, **kws)
                except HttpStatusError:
                    raise
                except Exception as e:  # connection-level failure: retry
                    err = e
                    logger.warning("cloud call failed (try %d/%d): %s", attempt + 1, tries, e)
                    time.sleep(sleep * (attempt + 1))
            raise err  # type: ignore[misc]

        return wrapper

    return deco


@reconnect()
def rget(url: str, headers: Optional[Dict[str, str]] = None, timeout: float = 30.0, **kws: Any) -> Any:
    """GET returning the raw response, with retries."""
    if _TRANSPORT is not None:
        return _TRANSPORT("GET", url, None, headers)
    import requests

    return requests.get(url, headers=headers, proxies=_PROXY, timeout=timeout, **kws)


@reconnect()
def rpost(
    url: str,
    body: Optional[Dict[str, Any]] = None,
    headers: Optional[Dict[str, str]] = None,
    timeout: float = 30.0,
    **kws: Any,
) -> Any:
    """POST returning the raw response, with retries."""
    if _TRANSPORT is not None:
        return _TRANSPORT("POST", url, body, headers)
    import requests

    return requests.post(url, json=body or {}, headers=headers, proxies=_PROXY, timeout=timeout, **kws)


@reconnect()
def rget_json(url: str, headers: Optional[Dict[str, str]] = None, timeout: float = 30.0) -> Dict[str, Any]:
    """GET returning the parsed JSON, with retries."""
    if _TRANSPORT is not None:
        return _TRANSPORT("GET", url, None, headers)
    import requests

    r = requests.get(url, headers=headers, proxies=_PROXY, timeout=timeout)
    if r.status_code // 100 != 2:
        raise HttpStatusError(f"GET {url} -> {r.status_code}: {r.text[:500]}")
    try:
        return r.json()
    except json.JSONDecodeError as e:
        raise HttpStatusError(f"GET {url}: invalid JSON payload") from e


@reconnect()
def rpost_json(
    url: str,
    body: Optional[Dict[str, Any]] = None,
    headers: Optional[Dict[str, str]] = None,
    timeout: float = 30.0,
) -> Dict[str, Any]:
    """POST returning the parsed JSON, with retries."""
    if _TRANSPORT is not None:
        return _TRANSPORT("POST", url, body, headers)
    import requests

    r = requests.post(url, json=body or {}, headers=headers, proxies=_PROXY, timeout=timeout)
    if r.status_code // 100 != 2:
        raise HttpStatusError(f"POST {url} -> {r.status_code}: {r.text[:500]}")
    try:
        return r.json()
    except json.JSONDecodeError as e:
        raise HttpStatusError(f"POST {url}: invalid JSON payload") from e
