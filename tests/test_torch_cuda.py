"""The port's hand-written kernels on a CUDA card.

Every test here needs the card and skips without one.  The file imports
neither JAX nor the JAX package, so that it also runs where only PyTorch is
installed; on the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA inputs, and
the circuit on the card (through the kernels) against the circuit on the CPU
(plain versions).  Tolerance: both sides compute in float32 with sums in
another order; amplitudes are O(2^-n/2), so an absolute 2e-6 on a state of
norm 1; the energy, a sum of ~2n terms of size <= 1, within 2e-5 * n.
"""

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl

pytestmark = pytest.mark.cuda

ATOL = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pairs(n, kind):
    if kind == "chain":
        return tuple((i, (i + 1) % n) for i in range(n))  # wraps around
    if kind == "open":
        return tuple((i, i + 1) for i in range(n - 1))
    return ((0, n - 1), (1, n // 2), (2, 3), (n - 2, 0))


def _inputs(n, nkernel, L, npairs, seed, dev):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    d = 2**n // 128 // 2**nkernel
    arrays = {
        "zz": rng.normal(size=(L, npairs)) * 0.5,
        "th": rng.normal(size=(L, nkernel)) * 0.5,
        # general (non-unitary) matrices: the forward assumes nothing of them
        "mlr": rng.normal(size=(L, 128, 128)) / 11,
        "mli": rng.normal(size=(L, 128, 128)) / 11,
        "mor": rng.normal(size=(L, d, d)) / np.sqrt(d),
        "moi": rng.normal(size=(L, d, d)) / np.sqrt(d),
    }
    t = {k: convert.params(v, dev) for k, v in arrays.items()}
    return convert.planes(psi, dev), t


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane",
    [(10, 1, "chain", False), (11, 3, "long", True), (14, 7, "chain", True), (17, 10, "long", True)],
)
def test_zzrx_fwd_kernel_matches_plain(cuda, n, nkernel, pairs, lane):
    pairs = _pairs(n, pairs)
    (sr, si), t = _inputs(n, nkernel, 1, len(pairs), n, cuda)
    mr, mi = (t["mlr"][0], t["mli"][0]) if lane else (None, None)
    krl.zzrx_fwd.launches = 0
    got = krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr, si, mr, mi)
    torch.cuda.synchronize()
    assert krl.zzrx_fwd.launches == 1
    want = krl.zzrx_fwd_plain(pairs, n, t["zz"][0], t["th"][0], sr, si, mr, mi)
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "n,nkernel,L,pairs", [(10, 1, 2, "chain"), (12, 3, 4, "long"), (18, 10, 4, "chain")]
)
def test_grand_zzrx_fwd_kernel_matches_plain(cuda, n, nkernel, L, pairs):
    pairs = _pairs(n, pairs)
    (sr, si), t = _inputs(n, nkernel, L, len(pairs), n + L, cuda)
    mats = [t[k] for k in ("mor", "moi", "mlr", "mli")]
    kg.grand_zzrx_fwd.launches = 0
    got = kg.grand_zzrx_fwd(pairs, n, t["zz"], t["th"], sr, si, *mats)
    torch.cuda.synchronize()
    assert kg.grand_zzrx_fwd.launches == 1
    want = kg.grand_zzrx_fwd_plain(pairs, n, t["zz"], t["th"], sr, si, *mats)
    # (ksr, ksi, yr, yi)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_kernel_wrappers_check_their_inputs(cuda):
    n, pairs = 10, _pairs(10, "chain")
    (sr, si), t = _inputs(n, 1, 2, len(pairs), 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr.double(), si)
    with pytest.raises(ValueError, match="contiguous"):
        krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], sr.t().contiguous().t(), si)
    with pytest.raises(ValueError, match="zzth shape"):
        krl.zzrx_fwd(pairs, n, t["zz"][0, :-1], t["th"][0], sr, si)
    with pytest.raises(ValueError, match="pair qubits"):
        krl.zzrx_fwd(((0, n),), n, t["zz"][0, :1], t["th"][0], sr, si)
    with pytest.raises(ValueError, match="plane shape"):
        kg.grand_zzrx_fwd(
            pairs, n, t["zz"], t["th"], sr, si,
            t["mor"][:, :1], t["moi"][:, :1], t["mlr"], t["mli"],
        )


@pytest.mark.parametrize(
    "n,L,kernel",
    [(12, 4, "zzrx_fwd"), (18, 3, "zzrx_fwd"), (18, 4, "grand_zzrx_fwd"), (20, 4, "grand_zzrx_fwd")],
)
def test_circuit_on_card_matches_cpu(cuda, n, L, kernel):
    pairs = _pairs(n, "open")
    grid = np.random.default_rng(n * L).normal(size=(L, 2, n)) * 0.1
    counter = {"zzrx_fwd": krl.zzrx_fwd, "grand_zzrx_fwd": kg.grand_zzrx_fwd}[kernel]

    def run(dev):
        p = convert.params(grid, dev)
        c = tct.Circuit(n, device=dev)
        c.h_layer()
        for l in range(L):
            c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
        return c.expectation_zzx_energy(pairs, 0.7, -1.3).item(), convert.to_numpy(c.state())

    counter.launches = 0
    with torch.no_grad():
        e_card, s_card = run(cuda)
    assert counter.launches >= 2  # the energy and the state
    e_cpu, s_cpu = run("cpu")
    assert abs(e_card - e_cpu) <= 2e-5 * n
    assert np.linalg.norm(s_card - s_cpu) <= 2e-6
