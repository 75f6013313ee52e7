"""The port's kernel modules against the JAX package's Pallas kernels.

The plain versions of K1 (``kernels_rowlayer.zzrx_fwd``), K2
(``kernels_grand.grand_zzrx_fwd``), K3 (``kernels_rowlayer.zzrx_bwd``) and
K4 (``kernels_grand.grand_zzrx_bwd``) are held against the JAX Pallas
kernels run in interpret mode on the CPU, on the same numpy-seeded inputs;
so are the autograd boundaries of ``kernels_stack`` and
``kernels_rowlayer.zzrx_row_layer`` against the JAX custom VJPs.  The
kernels themselves run only on a CUDA card: ``tests/test_torch_cuda.py``
holds them against their plain versions there and skips without a card
(``chip_smoke.py`` does the same at n=20).  Here a CPU tensor must route
to the plain version and launch nothing.

Tolerance: both sides compute in float32, in another order (the Pallas zz
exponent is a sign-matrix dot, the rx a roll butterfly, the torch side an
elementwise sum and an einsum); amplitudes are O(1/sqrt(2^n)), so an
absolute 2e-6 is ~100 float32 ulps of the largest amplitude.  Gradients are
sums over the whole state in float32, in another order on each side: they
are held within ``GRAD_RTOL`` = 1e-5 of the largest entry of the output
they belong to (about 100 float32 ulps), the JAX package's own gradient
bound at these sizes.
"""

import numpy as np
import pytest
import jax
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
GRAD_RTOL = 1e-5


def _close(got, want, rtol=GRAD_RTOL):
    """Within ``rtol`` of the largest |want| (see the module notes)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


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


def _rx_walked(th, cr, ci, w, nk):
    """rx(th[q]) on walked row bit w (stride 2^w in a block, q = nk-1-w)."""
    q, s = nk - 1 - w, 1 << w
    c, sn = torch.cos(th[q] / 2), torch.sin(th[q] / 2)
    pr, pi = krl._partner(cr, s), krl._partner(ci, s)
    return c * cr + sn * pi, c * ci - sn * pr


def _pass_order(b0, nb):
    """The walked bits of a forward row pass from walked bit b0, in the
    order the card takes them: past 3 bits the thread first holds pass
    bits 3..5 in registers, then 0..2."""
    bits = list(range(b0, b0 + nb))
    return bits[3:] + bits[:3] if nb > 3 else bits


def _grand_fwd_in_stage_order(pairs, n, zzth, th, sr, si, mor, moi, mlr, mli):
    """K2 a layer in the order the card's stages take it, in plain torch:
    the zz pass (the phase, then the low walked bits of
    ``grand_zzrx_fwd_plan``'s "fwd_row_zz"), the other pass (the high
    ones), the product y @ M_l into the residual, the outer pass."""
    L, nk = th.shape
    plan = kg.grand_zzrx_fwd_plan(sr.shape[0], nk, len(pairs), L)
    lo, hi = plan["fwd_row_zz"]["bits"], plan["fwd_row_hi"]["bits"]
    ks_r, ks_i = [], []
    xr, xi = sr, si
    for l in range(L):
        z = krl._zz_phase_dense(torch.complex(xr, xi), pairs, n, zzth[l])
        xr, xi = z.real, z.imag
        for w in _pass_order(0, lo) + _pass_order(lo, hi):
            xr, xi = _rx_walked(th[l], xr, xi, w, nk)
        xr, xi = krl._lane_apply(mlr[l], mli[l], xr, xi)
        ks_r.append(xr)
        ks_i.append(xi)
        xr, xi = krl._outer_apply(mor[l], moi[l], xr, xi)
    return torch.stack(ks_r), torch.stack(ks_i), xr, xi


@pytest.mark.parametrize(
    "n,nkernel,L,pairs",
    [(10, 1, 2, "chain"), (12, 3, 4, "chain"), (12, 2, 2, "long"), (16, 8, 2, "chain")],
)
def test_grand_fwd_stage_order_matches_pallas(n, nkernel, L, pairs):
    """The card's order of K2's stages (phase and the low walked bits, the
    high ones, the product on M, the outer pass), at the shapes above and
    with two row passes (nkernel 8: 6 + 2 bits), against the JAX
    ``grand_zzrx_fwd`` in interpret mode, which takes every rx after the
    phase in one block from the most significant bit: the rx gates act on
    distinct bits and commute, so the residuals and the output agree to
    rounding (``ATOL``)."""
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    x = _inputs(n, nkernel, L, pairs, seed=5 * n + L)
    sr, si = _jplanes(x["psi"])
    names = ("mor", "moi", "mlr", "mli")
    want = _interpret(lambda: jkg.grand_zzrx_fwd(
        pairs, n, jnp.asarray(x["zz"]), jnp.asarray(x["th"]), sr, si,
        *(jnp.asarray(x[k]) for k in names),
    ))
    tr, ti = convert.planes(x["psi"], "cpu")
    got = _grand_fwd_in_stage_order(
        pairs, n, torch.as_tensor(x["zz"]), torch.as_tensor(x["th"]), tr, ti,
        *(torch.as_tensor(x[k]) for k in names),
    )
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _zzrx_fwd_in_stage_order(pairs, n, zzth, th, sr, si, mr=None, mi=None, m7r=None, m7i=None):
    """K1 in the order the card's stages take it, in plain torch: the zz
    pass (the phase, then the low walked bits of ``zzrx_fwd_plan``'s
    "fwd_row_zz"), the other pass (the high ones), K13 (M7 on the top rmx
    row bits) and the product y @ M."""
    nk = th.shape[0]
    rmx = krl._rowm_bits(th, m7r)
    plan = krl.zzrx_fwd_plan(sr.shape[0], nk, len(pairs), mr is not None, rmx)
    lo, hi = plan["fwd_row_zz"]["bits"], plan["fwd_row_hi"]["bits"]
    assert lo + hi == nk - rmx
    z = krl._zz_phase_dense(torch.complex(sr, si), pairs, n, zzth)
    xr, xi = z.real, z.imag
    for w in _pass_order(0, lo) + _pass_order(lo, hi):
        xr, xi = _rx_walked(th, xr, xi, w, nk)
    if rmx:
        x = krl.rowm_apply_plain(torch.complex(m7r, m7i), torch.complex(xr, xi), nk)
        xr, xi = x.real, x.imag
    if mr is not None:
        xr, xi = krl._lane_apply(mr, mi, xr, xi)
    return xr, xi


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane,rmx",
    [(10, 3, "chain", False, 0), (12, 5, "long", True, 0), (16, 8, "chain", True, 0), (16, 8, "long", False, 0),
     (12, 4, "chain", True, 1), (12, 4, "long", False, 2), (12, 4, "chain", True, 3), (12, 4, "long", True, 4)],
)
def test_zzrx_fwd_stage_order_matches_pallas(n, nkernel, pairs, lane, rmx):
    """The card's order of K1's stages (phase and the low walked bits, the
    high ones, K13, the product on M), with and without the lane, one pass
    and two (nkernel 8: 6 + 2 bits), and with an arbitrary (R, R) M7 at
    rmx 1-4 (3, 2, 1 and no walked bit, the last a phase-only pass),
    against the JAX ``_pallas_zzrx_fwd`` in interpret mode, which takes
    every rx after the phase in one block from the most significant bit:
    the rx gates act on distinct bits and commute, so the planes agree to
    rounding (``ATOL``).  The Pallas kernel needs a walked bit (its angle
    block would be empty), so at rmx = nkernel it runs with rmx - 1 and the
    arbitrary M7', and K1 with M7 = M7' (x) rx(th[-1]), the same map."""
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    x = _inputs(n, nkernel, 1, pairs, seed=7 * n + nkernel + rmx)
    th = x["th"][0]
    rng = np.random.default_rng(11 * n + rmx)
    rj = rmx - 1 if rmx == nkernel else rmx
    m7j = rng.normal(size=(2**rj, 2**rj)) + 1j * rng.normal(size=(2**rj, 2**rj))
    m7j /= np.sqrt(2**rj)
    m7 = m7j
    if rj < rmx:
        c, sn = np.cos(th[-1] / 2.0), np.sin(th[-1] / 2.0)
        m7 = np.kron(m7j, np.array([[c, -1j * sn], [-1j * sn, c]]))
    split = lambda m: [m.real.astype(np.float32), m.imag.astype(np.float32)] if rmx else [None, None]  # noqa: E731
    mats = [x["mlr"][0], x["mli"][0]] if lane else [None, None]
    sr, si = _jplanes(x["psi"])
    jopt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = _interpret(lambda: jkrl._pallas_zzrx_fwd(
        pairs, n, jnp.asarray(x["zz"][0]), jnp.asarray(th), sr, si, *map(jopt, mats + split(m7j))))
    tr, ti = convert.planes(x["psi"], "cpu")
    topt = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    got = _zzrx_fwd_in_stage_order(pairs, n, torch.as_tensor(x["zz"][0]), torch.as_tensor(th), tr, ti,
                                   *map(topt, mats + split(m7)))
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



def _rx_krons(n, nkernel, L, rng):
    """Unitary outer and lane rx-kron planes (numpy float32) of seeded
    angles: the backward kernels rebuild states by un-application."""
    nrow = n - 7
    nouter = nrow - nkernel
    th = torch.as_tensor(rng.normal(size=(L, n)) * 0.5, dtype=torch.float32)
    mor, moi = kst._rx_kron_planes(th[:, :nouter])
    mlr, mli = kst._lane_kron_planes_T(th[:, nrow:])
    return [t.numpy() for t in (mor, moi, mlr, mli)]


def _bwd_planes(n, L, rng):
    """Random (non-normalized) residual and cotangent planes."""
    r = 2**n // 128
    draw = lambda *shape: (rng.normal(size=shape) / np.sqrt(2**n)).astype(np.float32)
    return draw(L, r, 128), draw(L, r, 128), draw(r, 128), draw(r, 128)


@pytest.mark.parametrize(
    "n,nkernel,pairs,lane",
    [
        (10, 1, "chain", False),
        (10, 3, "long", True),
        (11, 2, "long", False),
        (12, 3, "chain", True),
        (12, 5, "long", True),
        (13, 6, "chain", True),  # one shared-memory crossing in the card's row stage
        (14, 7, "long", False),  # two row passes on the card
    ],
)
def test_zzrx_bwd_plain_matches_pallas(n, nkernel, pairs, lane):
    """K3's plain version vs ``_pallas_zzrx_bwd`` in interpret mode: ds
    within ATOL, dzz, dth and dM within GRAD_RTOL of their largest entry."""
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    rng = np.random.default_rng(40 + n + nkernel)
    ksr, ksi, ctr, cti = _bwd_planes(n, 1, rng)
    zz = (rng.normal(size=len(pairs)) * 0.5).astype(np.float32)
    th = (rng.normal(size=nkernel) * 0.5).astype(np.float32)
    mats = _rx_krons(n, nkernel, 1, rng)[2:] if lane else []
    jargs = [jnp.asarray(a) for a in (zz, th, ksr[0], ksi[0], ctr, cti, *(m[0] for m in mats))]
    want = _interpret(lambda: jkrl._pallas_zzrx_bwd(pairs, n, *jargs))
    got = krl.zzrx_bwd_plain(pairs, n, *(torch.as_tensor(np.array(a)) for a in jargs))
    assert len(got) == len(want) == (6 if lane else 4)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        else:
            _close(g.numpy(), w)


@pytest.mark.parametrize(
    "n,nkernel,L,pairs",
    [
        (10, 1, 2, "chain"),  # nrow 3: D = 4 blocks of RB = 2 rows
        (10, 1, 3, "long"),
        (12, 3, 2, "long"),  # nrow 5: D = 4 blocks of RB = 8 rows
        (12, 3, 3, "chain"),
        (12, 1, 2, "chain"),  # nrow 5: D = 16 blocks of RB = 2 rows, K4's largest
        (13, 4, 2, "long"),  # nrow 6: D = 4 blocks of RB = 16 rows
    ],
)
def test_grand_zzrx_bwd_plain_matches_pallas(n, nkernel, L, pairs):
    """K4's plain version vs ``kernels_grand.grand_zzrx_bwd`` in interpret
    mode, on rx-kron outer and lane planes: ds within ATOL, every gradient
    within GRAD_RTOL of its largest entry."""
    pairs = _chain(n) if pairs == "chain" else _long_range(n)
    rng = np.random.default_rng(7 * n + L)
    ksr, ksi, ctr, cti = _bwd_planes(n, L, rng)
    zz = (rng.normal(size=(L, len(pairs))) * 0.5).astype(np.float32)
    th = (rng.normal(size=(L, nkernel)) * 0.5).astype(np.float32)
    args = (zz, th, ksr, ksi, ctr, cti, *_rx_krons(n, nkernel, L, rng))
    want = _interpret(lambda: jkg.grand_zzrx_bwd(pairs, n, *(jnp.asarray(a) for a in args)))
    got = kg.grand_zzrx_bwd_plain(pairs, n, *(torch.as_tensor(a) for a in args))
    # (dsr, dsi, dzz, dth, dtho, dmlr, dmli) in both
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        else:
            _close(g.numpy(), w)


def _spec(n, pairs):
    return jkernels.ising_readout_spec(
        n, zz_terms=[(a, b, 0.7) for a, b in pairs], x_terms=[(q, -1.3) for q in range(n)]
    )


@pytest.mark.parametrize("kq,L", [(1, 2), (2, 3)])
def test_theta_boundary_matches_jax(monkeypatch, kq, L):
    """``zzrx_stack_energy_theta`` value and gradients (state, zz, all rx
    angles) on the CPU, which runs the fused topology through the plain
    K1/K2 and K4 as the card does, vs the JAX boundary in interpret mode.
    n=10 with 1 or 2 kernel qubits: nouter 2 or 1; L=2 takes K2 forward,
    L=3 per-layer K1.  Energy within 2e-5 * n, the gradients within
    GRAD_RTOL of their largest entry; the complex state gradient is
    compared as JAX's convention, the conjugate of torch's."""
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    n = 10
    pairs = _chain(n)
    spec = _spec(n, pairs)
    rng = np.random.default_rng(L)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    s2 = (psi / np.linalg.norm(psi)).reshape(-1, 128).astype(np.complex64)
    zz = (rng.normal(size=(L, n)) * 0.4).astype(np.float32)
    rx = (rng.normal(size=(L, n)) * 0.4).astype(np.float32)
    fj = lambda s, z, r: jkst.zzrx_stack_energy_theta(pairs, n, s, z, r, spec)
    vj, gj = _interpret(
        lambda: jax.jit(jax.value_and_grad(fj, argnums=(0, 1, 2)))(
            jnp.asarray(s2), jnp.asarray(zz), jnp.asarray(rx)
        )
    )
    ts, tz, tr = (torch.tensor(a, requires_grad=True) for a in (s2, zz, rx))
    e = kst.zzrx_stack_energy_theta(pairs, n, ts, tz, tr, spec)
    gs, gz, gr = torch.autograd.grad(e, (ts, tz, tr))
    assert abs(e.item() - float(vj)) <= 2e-5 * n
    _close(np.conj(gs.numpy()), gj[0])
    _close(gz.numpy(), gj[1])
    _close(gr.numpy(), gj[2])


def _matrix_inputs(n, nouter, L, npairs, seed):
    """State, angles and general complex outer/lane matrices (the CPU
    branches of both packages assume nothing of them), plus a complex
    weight for the loss Re Σ w·y."""
    rng = np.random.default_rng(seed)
    c = lambda *shape: (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    d = 2**nouter
    return {
        "state": c(2**n // 128, 128) / np.float32(np.sqrt(2**n)),
        "zz": (rng.normal(size=(L, npairs)) * 0.5).astype(np.float32),
        "th": (rng.normal(size=(L, n - 7 - nouter)) * 0.5).astype(np.float32),
        "mout": c(L, d, d) / np.float32(np.sqrt(2 * d)),
        "mlane": c(L, 128, 128) / np.float32(16),
        "w": c(2**n // 128, 128),
    }


@pytest.mark.parametrize("boundary", ["core", "energy"])
@pytest.mark.parametrize("n,kq,L", [(9, 10, 2), (12, 3, 3)])
def test_matrix_boundaries_match_jax(monkeypatch, boundary, n, kq, L):
    """``zzrx_stack_core`` (loss Re Σ w·y) and ``zzrx_stack_energy``:
    gradients in the state, both angle sets and the complex outer and lane
    matrices vs the JAX custom VJPs on their CPU branch.  Every complex
    gradient is held against JAX's as its conjugate (JAX's cotangent of a
    complex leaf is non-conjugating).  n=9: nouter 0 (the (1, 1) outer
    scalar); n=12 with 3 kernel qubits: nouter 2.  Within GRAD_RTOL of the
    largest entry of each gradient."""
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", kq)
    nouter = max(0, n - 7 - kq)
    pairs = _long_range(n)
    x = _matrix_inputs(n, nouter, L, len(pairs), seed=n + L)
    names = ("state", "zz", "th", "mout", "mlane")
    spec = _spec(n, pairs)
    if boundary == "core":
        w = jnp.asarray(x["w"])
        fj = lambda *a: jnp.real(jnp.sum(w * jkst.zzrx_stack_core(pairs, n, *a)))
    else:
        fj = lambda *a: jkst.zzrx_stack_energy(pairs, n, *a, spec)
    vj, gj = jax.jit(jax.value_and_grad(fj, argnums=tuple(range(5))))(*(jnp.asarray(x[k]) for k in names))
    ts = [torch.tensor(x[k], requires_grad=True) for k in names]
    if boundary == "core":
        v = torch.real(torch.sum(torch.as_tensor(x["w"]) * kst.zzrx_stack_core(pairs, n, *ts)))
    else:
        v = kst.zzrx_stack_energy(pairs, n, *ts, spec)
    gt = torch.autograd.grad(v, ts)
    assert abs(v.item() - float(vj)) <= 2e-5 * n
    for k, g, w in zip(names, gt, gj):
        got = g.numpy()
        _close(np.conj(got) if np.iscomplexobj(got) else got, w)


@pytest.mark.parametrize("n,nkernel", [(9, 2), (10, 3)])
def test_zzrx_row_layer_grads_match_jax(n, nkernel):
    """``zzrx_row_layer`` (K1 forward, K3 backward without lane, through
    their plain versions) vs the JAX custom VJP's CPU branch, for the loss
    Re Σ w·y: state gradient (as JAX's conjugate), dzz and dθ within
    GRAD_RTOL of their largest entry."""
    pairs = _long_range(n)
    rng = np.random.default_rng(n * nkernel)
    x = _matrix_inputs(n, 0, 1, len(pairs), seed=n + nkernel)
    th = (rng.normal(size=nkernel) * 0.5).astype(np.float32)
    w = jnp.asarray(x["w"])
    fj = lambda s, z, t: jnp.real(jnp.sum(w * jkrl.zzrx_row_layer(pairs, n, s, z, t)))
    gj = jax.jit(jax.grad(fj, argnums=(0, 1, 2)))(
        jnp.asarray(x["state"]), jnp.asarray(x["zz"][0]), jnp.asarray(th)
    )
    ts = [torch.tensor(a, requires_grad=True) for a in (x["state"], x["zz"][0], th)]
    v = torch.real(torch.sum(torch.as_tensor(x["w"]) * krl.zzrx_row_layer(pairs, n, *ts)))
    gs, gz, gt = torch.autograd.grad(v, ts)
    _close(np.conj(gs.numpy()), gj[0])
    _close(gz.numpy(), gj[1])
    _close(gt.numpy(), gj[2])


def test_cpu_tensors_route_backward_to_plain_versions():
    """On CPU tensors the K3/K4 wrappers run their plain versions, bit for
    bit, and launch nothing."""
    n, nkernel, L = 10, 1, 2
    pairs = _chain(n)
    rng = np.random.default_rng(6)
    ksr, ksi, ctr, cti = (torch.as_tensor(a) for a in _bwd_planes(n, L, rng))
    zz = torch.as_tensor(rng.normal(size=(L, n)), dtype=torch.float32)
    th = torch.as_tensor(rng.normal(size=(L, nkernel)), dtype=torch.float32)
    mats = [torch.as_tensor(a) for a in _rx_krons(n, nkernel, L, rng)]
    krl.zzrx_bwd.launches = 0
    kg.grand_zzrx_bwd.launches = 0
    k3 = krl.zzrx_bwd(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr, cti, mats[2][0], mats[3][0])
    k3_plain = krl.zzrx_bwd_plain(pairs, n, zz[0], th[0], ksr[0], ksi[0], ctr, cti, mats[2][0], mats[3][0])
    k4 = kg.grand_zzrx_bwd(pairs, n, zz, th, ksr, ksi, ctr, cti, *mats)
    k4_plain = kg.grand_zzrx_bwd_plain(pairs, n, zz, th, ksr, ksi, ctr, cti, *mats)
    assert krl.zzrx_bwd.launches == 0 and kg.grand_zzrx_bwd.launches == 0
    for a, b in zip(k3 + k4, k3_plain + k4_plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["fused_zzrx_layer", "fused_zzrx_multilayer"])
def test_fused_entry_points_grads_match_jax(entry):
    """The dispatch entry points differentiate end to end: gradients of the
    loss Re Σ w·ψ in the state and both angle sets vs the JAX package's
    CPU path (n=10: nouter 0, a row layer and the lane kron per layer, or
    the matrix-level stack).  Within GRAD_RTOL of their largest entry."""
    from tensorcircuit_ng_tpu_torch.core import kernels as tk

    n, L = 10, 2
    pairs = _long_range(n)
    rng = np.random.default_rng(17)
    psi = (rng.normal(size=2**n) + 1j * rng.normal(size=2**n)).astype(np.complex64) / np.float32(32)
    w = (rng.normal(size=2**n) + 1j * rng.normal(size=2**n)).astype(np.complex64)
    zz = (rng.normal(size=(L, len(pairs))) * 0.5).astype(np.float32)
    rx = (rng.normal(size=(L, n)) * 0.5).astype(np.float32)
    if entry == "fused_zzrx_layer":
        zz, rx = zz[0], rx[0]
    jw = jnp.asarray(w)
    fj = lambda s, z, r: jnp.real(jnp.sum(jw * getattr(jkernels, entry)(s, pairs, z, r)))
    gj = jax.jit(jax.grad(fj, argnums=(0, 1, 2)))(jnp.asarray(psi), jnp.asarray(zz), jnp.asarray(rx))
    ts = [torch.tensor(a, requires_grad=True) for a in (psi, zz, rx)]
    v = torch.real(torch.sum(torch.as_tensor(w) * getattr(tk, entry)(ts[0], pairs, ts[1], ts[2])))
    gs, gz, gr = torch.autograd.grad(v, ts)
    _close(np.conj(gs.numpy()), gj[0])
    _close(gz.numpy(), gj[1])
    _close(gr.numpy(), gj[2])
