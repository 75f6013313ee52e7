"""The port's kernel modules against the JAX package's Pallas kernels.

The plain versions of K1 (``kernels_rowlayer.zzrx_fwd``) and K2
(``kernels_grand.grand_zzrx_fwd``) are held against the JAX Pallas kernels
run in interpret mode on the CPU, on the same numpy-seeded inputs.  The
kernels themselves run only on a CUDA card: ``tests/test_torch_cuda.py``
holds them against their plain versions there and skips without a card
(``chip_smoke.py`` does the same at n=20).  Here a CPU tensor must route
to the plain version and launch nothing.

Tolerance: both sides compute in float32, in another order (the Pallas zz
exponent is a sign-matrix dot, the rx a roll butterfly, the torch side an
elementwise sum and an einsum); amplitudes are O(1/sqrt(2^n)), so an
absolute 2e-6 is ~100 float32 ulps of the largest amplitude.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tensorcircuit_ng_tpu.core import kernels as jkernels
from tensorcircuit_ng_tpu.core import kernels_grand as jkg
from tensorcircuit_ng_tpu.core import kernels_rowlayer as jkrl
from tensorcircuit_ng_tpu.core import kernels_stack as jkst

from tensorcircuit_ng_tpu_torch import convert
from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

ATOL = 2e-6


def _interpret(fn):
    jkernels.set_interpret_mode(True)
    try:
        return fn()
    finally:
        jkernels.set_interpret_mode(False)


def _inputs(n, nkernel, L, pairs, seed, lane=True):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    r = 2**n // 128
    d = r // 2**nkernel
    return {
        "psi": psi,
        "zz": (rng.normal(size=(L, len(pairs))) * 0.5).astype(np.float32),
        "th": (rng.normal(size=(L, nkernel)) * 0.5).astype(np.float32),
        # general (non-unitary) matrices: the forward assumes nothing of them
        "mlr": rng.normal(size=(L, 128, 128)).astype(np.float32) / 11,
        "mli": rng.normal(size=(L, 128, 128)).astype(np.float32) / 11,
        "mor": rng.normal(size=(L, d, d)).astype(np.float32) / float(np.sqrt(d)),
        "moi": rng.normal(size=(L, d, d)).astype(np.float32) / float(np.sqrt(d)),
    }


def _jplanes(psi):
    a = np.asarray(psi).reshape(-1, 128)
    return jnp.asarray(a.real, jnp.float32), jnp.asarray(a.imag, jnp.float32)


def _chain(n):
    return tuple((i, (i + 1) % n) for i in range(n))  # wraps around


def _long_range(n):
    return ((0, n - 1), (1, n // 2), (2, 3), (n - 2, 0))


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane",
    [
        (10, 1, "chain", False),
        (10, 3, "chain", True),
        (11, 2, "long", True),
        (12, 3, "chain", False),
        (12, 5, "long", True),
    ],
)
def test_zzrx_fwd_plain_matches_pallas(n, nkernel, pairs, lane):
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    x = _inputs(n, nkernel, 1, pairs, seed=n + nkernel)
    sr, si = _jplanes(x["psi"])
    jargs = [jnp.asarray(x["zz"][0]), jnp.asarray(x["th"][0]), sr, si]
    if lane:
        jargs += [jnp.asarray(x["mlr"][0]), jnp.asarray(x["mli"][0])]
    want = _interpret(lambda: jkrl._pallas_zzrx_fwd(pairs, n, *jargs))

    tr, ti = convert.planes(x["psi"], "cpu")
    mr = torch.as_tensor(x["mlr"][0]) if lane else None
    mi = torch.as_tensor(x["mli"][0]) if lane else None
    got = krl.zzrx_fwd_plain(
        pairs, n, torch.as_tensor(x["zz"][0]), torch.as_tensor(x["th"][0]), tr, ti, mr, mi
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize(
    "n,nkernel,L,pairs",
    [
        (10, 1, 2, "chain"),  # nrow 3: G = D = 4 blocks of RB = 2 rows
        (12, 3, 4, "chain"),  # nrow 5: G = D = 4 blocks of RB = 8 rows
        (12, 2, 2, "long"),  # nrow 5: G = D = 8
    ],
)
def test_grand_zzrx_fwd_plain_matches_pallas(n, nkernel, L, pairs):
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    x = _inputs(n, nkernel, L, pairs, seed=3 * n + L)
    sr, si = _jplanes(x["psi"])
    names = ("mor", "moi", "mlr", "mli")
    want = _interpret(lambda: jkg.grand_zzrx_fwd(
        pairs, n, jnp.asarray(x["zz"]), jnp.asarray(x["th"]), sr, si,
        *(jnp.asarray(x[k]) for k in names),
    ))
    tr, ti = convert.planes(x["psi"], "cpu")
    got = kg.grand_zzrx_fwd_plain(
        pairs, n, torch.as_tensor(x["zz"]), torch.as_tensor(x["th"]), tr, ti,
        *(torch.as_tensor(x[k]) for k in names),
    )
    # (ksr, ksi, yr, yi) in both
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_cpu_tensors_route_to_plain_versions():
    n, nkernel, L = 10, 1, 2
    pairs = _chain(n)
    x = _inputs(n, nkernel, L, pairs, seed=5)
    tr, ti = convert.planes(x["psi"], "cpu")
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "psi"}
    krl.zzrx_fwd.launches = 0
    kg.grand_zzrx_fwd.launches = 0
    y = krl.zzrx_fwd(pairs, n, t["zz"][0], t["th"][0], tr, ti, t["mlr"][0], t["mli"][0])
    y_plain = krl.zzrx_fwd_plain(pairs, n, t["zz"][0], t["th"][0], tr, ti, t["mlr"][0], t["mli"][0])
    g = kg.grand_zzrx_fwd(pairs, n, t["zz"], t["th"], tr, ti, t["mor"], t["moi"], t["mlr"], t["mli"])
    g_plain = kg.grand_zzrx_fwd_plain(
        pairs, n, t["zz"], t["th"], tr, ti, t["mor"], t["moi"], t["mlr"], t["mli"]
    )
    assert krl.zzrx_fwd.launches == 0 and kg.grand_zzrx_fwd.launches == 0
    for a, b in zip(y + g, y_plain + g_plain):
        assert torch.equal(a, b)


def test_rx_kron_planes_match_jax():
    rng = np.random.default_rng(9)
    th = rng.normal(size=(3, 4)).astype(np.float32)
    mr, mi = kst._rx_kron_planes(torch.as_tensor(th))
    lr, li = kst._lane_kron_planes_T(torch.as_tensor(th))
    for l in range(3):
        jr, ji = jkst._rx_kron_planes(jnp.asarray(th[l]))
        np.testing.assert_allclose(mr[l].numpy(), np.asarray(jr), atol=1e-7)
        np.testing.assert_allclose(mi[l].numpy(), np.asarray(ji), atol=1e-7)
        jr, ji = jkst._lane_kron_planes_T(jnp.asarray(th[l]))
        np.testing.assert_allclose(lr[l].numpy(), np.asarray(jr), atol=1e-7)
        np.testing.assert_allclose(li[l].numpy(), np.asarray(ji), atol=1e-7)

