"""Terminal easter eggs: a banner, a fortune and a message registry.

Counterpart of ``tensorcircuit_ng_tpu/asciiart.py``, with a card in place
of its TPU pod.
"""

from __future__ import annotations

import random
from typing import Any, Optional

__all__ = ["Art", "gpu_art", "lucky"]


class Art:
    def __init__(self, s: str) -> None:
        self.s = s

    def __str__(self) -> str:
        return self.s

    def __repr__(self) -> str:
        return self.s


gpu_art = Art(
    r"""
   +--------------------------+
   | [SM][SM][SM][SM][SM][SM] |   tensorcircuit-ng tpu_torch
   | [SM][SM]  HBM3  [SM][SM] |   ~~~~~~~~~~~~~~~~~~~~~~~~~~
   | [SM][SM][SM][SM][SM][SM] |   flat states | fused layers
   +--||--||--||--||--||--||--+   einsum IR   | hand-written kernels
                                  one card, many shards
"""
)

_FORTUNES = [
    "Your contraction path is optimal (p > 0.97).",
    "A lightcone will trim your network today.",
    "Beware the rank-n tensor; keep your states flat.",
    "The tensor cores favor the well-batched.",
    "Capture once, replay forever.",
    "A wild NaN appears! Use adaware_svd.",
    "Entanglement grows; so does chi. Truncate wisely.",
    "Your gradients check out to 1e-5.",
]


def lucky(seed: Optional[int] = None) -> Any:
    """Draw a quantum fortune (``seed`` for a fixed one)."""
    rng = random.Random(seed)
    return Art(rng.choice(_FORTUNES))


_MESSAGES = {
    "welcome": str(gpu_art),
    "bye": "so long, and thanks for all the qubits",
}
_CURRENT = {"banner": "welcome"}


def set_ascii(b: str = "", conf: Optional[dict] = None) -> None:
    """Register messages (``conf``) and choose the banner (``b``)."""
    if conf:
        _MESSAGES.update(conf)
    if b:
        _CURRENT["banner"] = b


def get_message(key: str) -> str:
    """A registered message by key (the banner for an unknown key)."""
    return _MESSAGES.get(key, _MESSAGES[_CURRENT["banner"]])


visible = False
gallery = ["gpu_art"]
