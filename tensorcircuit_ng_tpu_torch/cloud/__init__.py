"""Cloud and QPU access: one API over providers.

Counterpart of ``tensorcircuit_ng_tpu/cloud/``.  A provider is a module of
this package (``local``, ``tencent``, ``tianyan``, ``quafu_provider``); the
``local`` provider samples the port's ``Circuit`` on its device, so code
written against :func:`apis.submit_task` and ``batch_expectation_ps`` runs
without a network.  The remote providers send their requests through
``utils`` (HTTP, or a transport set by ``utils.set_transport``) or an
injected platform object (``tianyan.set_platform``).
"""

from . import apis
from . import abstraction
from . import local
from . import wrapper
from .apis import set_provider, set_device, set_token, list_devices, submit_task
from .wrapper import batch_expectation_ps, batch_submit_template

__all__ = [
    "apis",
    "abstraction",
    "local",
    "wrapper",
    "set_provider",
    "set_device",
    "set_token",
    "list_devices",
    "submit_task",
    "batch_expectation_ps",
    "batch_submit_template",
]
