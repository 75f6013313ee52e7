"""K5's cluster-size rule (``kernels_jacobi._cluster_size``) on the shapes
the wrapper admits, and the CPU route of its wrapper.

The rule needs the card's ``cudaOccupancyMaxActiveClusters``; here it is
given a model of an H100 (132 SMs, one 1,024-thread CTA an SM, clusters
inside a GPC): 132, 66, 32 and 16 clusters of 1, 2, 4 and 8.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``); its plain
version against the JAX package is ``tests/test_torch_tebd.py``.
"""

import numpy as np
import pytest
import torch

from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as KJ

H100 = {1: 132, 2: 66, 4: 32, 8: 16}
#: a card on which fewer than 30 clusters of 4 run at once
SMALL = {1: 132, 2: 66, 4: 28, 8: 14}

SHAPES = {
    "TEBD even bonds": (30, 128, 128),
    "TEBD odd bonds": (29, 128, 128),
    "panel 128x80": (30, 80, 128),
    "16x16": (1, 16, 16),
    "ragged": (5, 96, 100),
    "several waves": (200, 128, 128),
    "no V": (2, 16, 32),
    "largest A, m=256": (1, 112, 256),
    "largest A": (1, 908, 32),
}


def _fits(n, m, with_v, c):
    return KJ._smem_bytes(n, m, with_v, c) <= 232448


@pytest.mark.parametrize("with_v", [True, False])
@pytest.mark.parametrize("label", list(SHAPES))
def test_cluster_rule(label, with_v):
    b, n, m = SHAPES[label]
    assert n % 2 == 0 and m <= 256 and 8 * n * m <= 232448  # the wrapper admits it
    if with_v and label == "largest A":
        # V's 908 x 908 planes exceed 8 CTAs: the SVD never gives n >> m
        with pytest.raises(ValueError, match="unsupported shape"):
            KJ._cluster_size(b, n, m, with_v, H100.__getitem__)
        return
    c = KJ._cluster_size(b, n, m, with_v, H100.__getitem__)
    assert c in (1, 2, 4, 8)
    assert _fits(n, m, with_v, c)
    if any(b <= H100[k] for k in (1, 2, 4, 8) if _fits(n, m, with_v, k)):
        assert b <= H100[c]  # the batch runs in one wave
    else:
        assert c == min(k for k in (1, 2, 4, 8) if _fits(n, m, with_v, k))
    assert all(KJ._cluster_size(b, n, m, with_v, H100.__getitem__) == c for _ in range(3))


@pytest.mark.parametrize(
    "shape,card,want",
    [((30, 128, 128), H100, 4), ((29, 128, 128), H100, 4), ((30, 128, 128), SMALL, 2),
     ((200, 128, 128), H100, 2), ((5, 96, 100), H100, 8)],
)
def test_cluster_rule_picks(shape, card, want):
    """The TEBD batch takes 4 CTAs a matrix (120 CTAs); with fewer than 30
    clusters of 4 the next size down; 200 matrices the smallest that fits."""
    assert KJ._cluster_size(*shape, True, card.__getitem__) == want


def test_smem_bytes_counts_partials_rotations_and_slices():
    # 2 parities x 4 ranks x 64 pairs and 64 rotations of 16 B, two
    # mbarriers, and A's and V's slices of 32 elements a column
    assert KJ._smem_bytes(128, 128, True, 4) == (2 * 4 + 1) * 64 * 16 + 16 + 8 * 128 * (32 + 32)
    # ragged: ceil(100 / 8) = 13 elements a column, kept as 14 (float2
    # rows), and ceil(96 / 8) = 12
    assert KJ._smem_bytes(96, 100, True, 8) == (2 * 8 + 1) * 48 * 16 + 16 + 8 * 96 * (14 + 12)
    assert KJ._smem_bytes(96, 100, False, 8) == (2 * 8 + 1) * 48 * 16 + 16 + 8 * 96 * 14


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(KJ, "_launch_jacobi", no_kernel)
    rng = np.random.default_rng(5)
    xr, xi = (torch.as_tensor(rng.standard_normal((2, 16, 24)), dtype=torch.float32) for _ in range(2))
    before = KJ.jacobi_rotations.launches
    for with_v in (True, False):
        got = KJ.jacobi_rotations(xr, xi, 3, with_v)
        want = KJ.jacobi_rotations_plain(xr, xi, 3, with_v)
        assert len(got) == (4 if with_v else 2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert KJ.jacobi_rotations.launches == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        KJ._launch_jacobi(xr, xi, 3, True)
