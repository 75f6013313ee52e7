"""The environment report and the citation.

Counterpart of ``tensorcircuit_ng_tpu/about.py``: the report names torch,
its CUDA build and the cards it sees where the JAX package's names JAX.
"""

from __future__ import annotations

import platform
import sys

__all__ = ["about", "cite"]


def about() -> str:
    """Print and return the environment report."""
    lines = [
        f"OS info: {platform.platform(aliased=True)}",
        f"Python version: {sys.version_info[0]}.{sys.version_info[1]}.{sys.version_info[2]}",
    ]
    try:
        import numpy

        lines.append(f"Numpy version: {numpy.__version__}")
    except ImportError:
        pass
    import torch

    lines.append(f"Torch version: {torch.__version__}")
    lines.append(f"Torch CUDA version: {torch.version.cuda}")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        lines.append(f"Torch devices: {names}")
    else:
        lines.append("Torch devices: cpu only")
    for mod in ("scipy", "sympy", "networkx", "opt_einsum"):
        try:
            m = __import__(mod)
            lines.append(f"{mod} version: {getattr(m, '__version__', '?')}")
        except ImportError:
            pass
    from . import __version__

    lines.append(f"tensorcircuit_ng_tpu_torch version: {__version__}")
    report = "\n".join(lines)
    print(report)
    return report


def cite(format: str = "bibtex") -> str:
    """Print and return the citation of the framework's design lineage."""
    bib = """@article{tensorcircuit,
  title = {TensorCircuit: a Quantum Software Framework for the NISQ Era},
  journal = {Quantum},
  volume = {7}, pages = {912}, year = {2023}, doi = {10.22331/q-2023-02-02-912}
}"""
    print(bib)
    return bib
