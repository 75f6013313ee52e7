"""Templates of the port: graphs and lattices, problem conversions,
Hamiltonians (COO or dense, on the configured device unless ``device=``
says otherwise), circuit blocks and ansätze on the port's ``Circuit``,
expectation templates and data encodings.  Counterpart of
``tensorcircuit_ng_tpu/templates/``."""

from . import ansatz, blocks, chems, conversions, dataset, graphs, hamiltonians, lattice, measurements

__all__ = ["ansatz", "blocks", "chems", "conversions", "dataset", "graphs", "hamiltonians", "lattice", "measurements"]
