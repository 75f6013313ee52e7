"""Quantum error mitigation (self-contained — no mitiq dependency).

Counterpart of reference ``results/qem/`` which delegates ZNE/DD to mitiq
(reference ``qem_methods.py:18-27``); here folding, extrapolation, DD
scheduling, and randomized compiling are implemented in-repo so the module
works offline and with any executor.
"""

from .qem_methods import (
    apply_zne,
    apply_dd,
    apply_rc,
    zne_option,
    dd_option,
    used_qubits,
    prune_ddcircuit,
    add_dd,
    rc_circuit,
    rc_candidates,
    fold_gates_at_random,
    fold_global,
    LinearFactory,
    RichardsonFactory,
    PolyFactory,
    ExpFactory,
)
from .benchmark_circuits import (
    ghz_circuit,
    w_circuit,
    rb_circuit,
    mirror_circuit,
    QAOA_circuit,
)
