"""Measurement results processing: counts toolbox + readout mitigation.

Counterpart of ``tensorcircuit_ng_tpu/results/``: host numpy on the
port's circuits (``qem`` holds the error-mitigation methods)."""

from . import qem

from . import counts
from .readout_mitigation import ReadoutMit

__all__ = ["counts", "ReadoutMit"]
