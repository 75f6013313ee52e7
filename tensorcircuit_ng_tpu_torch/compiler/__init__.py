"""Circuit compilation: numpy passes over the QIR and composed pipelines.

Counterpart of ``tensorcircuit_ng_tpu/compiler/``.
"""

from .simple_compiler import simple_compile, prune_pass, merge_pass, replace_u_pass
from .composed_compiler import Compiler, DefaultCompiler, compose_mapping_info, default_compile, qiskit_compile

__all__ = [
    "simple_compile",
    "prune_pass",
    "merge_pass",
    "replace_u_pass",
    "Compiler",
    "DefaultCompiler",
    "default_compile",
    "compose_mapping_info",
    "qiskit_compile",
]
