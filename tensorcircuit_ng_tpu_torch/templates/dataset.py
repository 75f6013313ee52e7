"""Data encodings for QML: amplitude encoding, and a two-class MNIST-style
filter over a caller's loader (nothing is downloaded)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..quantum import _tensor

__all__ = ["amplitude_encoding", "mnist_pair_data"]


def amplitude_encoding(fig: Any, nqubits: int, index: Optional[Any] = None) -> torch.Tensor:
    """One datum flattened, cut to 2^n entries, L2-normalized (a zero datum
    stays zero), zero-padded to 2^n and, with ``index``, gathered in that
    order; on the datum's device.  Batch with ``torch.vmap``."""
    flat = torch.reshape(_tensor(fig), (-1,))
    dim = 2**nqubits
    if flat.shape[0] > dim:
        flat = flat[:dim]
    nrm = torch.linalg.vector_norm(flat)
    flat = flat / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    if flat.shape[0] < dim:
        flat = torch.nn.functional.pad(flat, (0, dim - flat.shape[0]))
    if index is not None:
        flat = flat[torch.as_tensor(index, device=flat.device).to(torch.int64)]
    return flat


def mnist_pair_data(
    a: int = 3, b: int = 6, binarize: bool = False, loader: Optional[Any] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The classes ``a`` (label 0) and ``b`` (label 1) of an MNIST-style
    dataset, pixels / 255 (thresholded at 0.5 with ``binarize``):
    ``loader()`` returns ((x_train, y_train), (x_test, y_test))."""
    if loader is None:
        raise ValueError("provide loader=... returning ((x_train,y_train),(x_test,y_test))")
    (x_train, y_train), (x_test, y_test) = loader()

    def filt(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        keep = (y == a) | (y == b)
        x, y = x[keep], y[keep]
        y = (y == b).astype(np.int64)
        x = x / 255.0
        if binarize:
            x = (x > 0.5).astype(np.float64)
        return x, y

    x_train, y_train = filt(x_train, y_train)
    x_test, y_test = filt(x_test, y_test)
    return x_train, y_train, x_test, y_test
