"""Circuit building blocks on the port's ``Circuit``: Bell pairs, the QFT,
an example HEA block, a QAOA layer of a graph, a 2D grid entangler, and
``state_centric`` to lift a block into a state -> state function."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Bell_pair_block",
    "qft",
    "example_block",
    "state_centric",
    "QAOA_block",
    "grid_coord",
]


def Bell_pair_block(c: Any, links: Optional[Sequence[Sequence[int]]] = None) -> Any:
    """Entangle each pair into the singlet (|01⟩−|10⟩)/√2 (X·H·CNOT·X)."""
    n = c.nqubits
    if links is None:
        links = [(i, i + 1) for i in range(0, n - 1, 2)]
    for a, b in links:
        c.x(a)
        c.h(a)
        c.cnot(a, b)
        c.x(b)
    return c


def qft(
    c: Any,
    *index: int,
    do_swaps: bool = True,
    inverse: bool = False,
    insert_barriers: bool = False,
    with_swap: Optional[bool] = None,
) -> Any:
    """Quantum Fourier transform on the listed qubits (all by default):
    ``do_swaps`` includes the final bit-reversal swaps, ``inverse`` builds
    the adjoint transform; ``with_swap`` is an old alias of ``do_swaps``.
    """
    if with_swap is not None:
        do_swaps = with_swap
    if not index:
        index = tuple(range(c.nqubits))
    assert len(set(index)) == len(index), "no repeated qubits"
    m = len(index)
    if inverse:
        if do_swaps:
            for i in range(m // 2):
                c.swap(index[i], index[m - 1 - i])
        for i in range(m - 1, -1, -1):
            for j in range(m - 1, i, -1):
                c.cphase(index[j], index[i], theta=-np.pi / (2 ** (j - i)))
            c.h(index[i])
            if insert_barriers:
                c.barrier_instruction(*range(min(index), max(index) + 1))
    else:
        for i in range(m):
            c.h(index[i])
            for j in range(i + 1, m):
                c.cphase(index[j], index[i], theta=np.pi / (2 ** (j - i)))
            if insert_barriers:
                c.barrier_instruction(*range(min(index), max(index) + 1))
        if do_swaps:
            for i in range(m // 2):
                c.swap(index[i], index[m - 1 - i])
    return c


def example_block(c: Any, params: Any, nlayers: int = 2, is_split: bool = False) -> Any:
    """A hardware-efficient block: h on every qubit, then each layer l a
    CNOT ladder and rx(params[l, 0, i]), rz(params[l, 1, i]) on every
    qubit."""
    n = c.nqubits
    if isinstance(params, torch.Tensor):
        params = torch.reshape(params, (nlayers, 2, n))
    else:
        params = np.reshape(np.asarray(params), (nlayers, 2, n))
    for i in range(n):
        c.h(i)
    for l in range(nlayers):
        for i in range(n - 1):
            c.cnot(i, i + 1)
        for i in range(n):
            c.rx(i, theta=params[l, 0, i])
            c.rz(i, theta=params[l, 1, i])
    return c


def QAOA_block(c: Any, g: Any, gamma: Any, beta: Any) -> Any:
    """One QAOA layer for an Ising graph: e^{-i γ H_C} then e^{-i β Σ X}."""
    try:
        edges = list(g.edges(data=True))
        weighted = True
    except TypeError:
        edges = [(a, b, {}) for a, b in g.edges]
        weighted = True
    except AttributeError:
        edges = [(a, b, {}) for a, b in g]
        weighted = False
    for a, b, data in edges:
        w = data.get("weight", 1.0) if isinstance(data, dict) else 1.0
        c.rzz(a, b, theta=2.0 * gamma * w)
    for i in range(c.nqubits):
        c.rx(i, theta=2.0 * beta)
    return c


def state_centric(c_fn):
    """Decorator: lift a circuit->circuit block into a state->state
    function (on the state's device)."""

    def wrapper(state, *args: Any, **kws: Any):
        import math

        from ..models.circuit import Circuit

        n = int(round(math.log2(np.prod(tuple(state.shape)))))
        dev = {"device": state.device} if isinstance(state, torch.Tensor) else {}
        c = Circuit(n, inputs=state, **dev)
        c = c_fn(c, *args, **kws) or c
        return c.state()

    return wrapper


def grid_coord(l1: int, l2: int):
    """Row-major (row, col) <-> flat index helpers for an l1 x l2 grid."""
    coords = [(i, j) for i in range(l1) for j in range(l2)]
    return coords


def Grid2D_entangling(c: Any, coord: Any, unitary: Any, params: Any, **kws: Any) -> Any:
    """exp1 of ``unitary`` on every row, then every column, bond of a 2D
    grid (``coord`` a :class:`~.graphs.Grid2DCoord`), angle ``params[i]``
    for the i-th bond."""
    i = 0
    for a, b in coord.all_rows():
        c.exp1(a, b, unitary=unitary, theta=params[i], **kws)
        i += 1
    for a, b in coord.all_cols():
        c.exp1(a, b, unitary=unitary, theta=params[i], **kws)
        i += 1
    return c
