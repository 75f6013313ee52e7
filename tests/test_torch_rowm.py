"""The ``FUSE_ROWM`` branch of the port and the stack's ``FUSE_*`` switches.

- Kernel level: the plain versions of K1/K3 with the row-kron planes M7
  (``zzrx_fwd_plain`` / ``zzrx_bwd_plain`` with ``m7r, m7i``, the stages
  K13/K14 on the card) against the JAX ``_pallas_zzrx_fwd`` /
  ``_pallas_zzrx_bwd`` with ``m7r, m7i`` in interpret mode, with and
  without the lane planes, in two geometries: n=12 with 4 kernel qubits
  (rmx 1, two blocks, so the dM7 sum revisits its output) and n=13 (6
  kernel qubits, rmx 3).  An arbitrary M7 in the forward, a random unitary
  one in the backward (it rebuilds states by un-application).
- The slice: h_layer, L=2 ``zzrx_layer``, ``expectation_zzx_energy`` with
  ``FUSE_ROWM`` under the card's routing (``kernels_stack._stack_mode``
  patched to what it returns on a CUDA state, the CPU image of the JAX
  package's interpret mode), value and grad against the JAX package's CPU
  reference path; a spy shows that the plain K1/K3 took M7.
- The mode rides the autograd node: ``FUSE_ROWM``, then ``FUSE_LANE``,
  flipped between the forward and ``torch.autograd.grad``.
- Every switch setting (``FUSE_GRAND``, ``FUSE_GRAND_BWD``, both, or
  ``FUSE_LANE`` off) gives the default's value and grad, through the
  routing each setting should take.

Tolerances: kernel outputs as ``test_torch_kernels`` (states 2e-6
absolute, gradients 1e-5 of their largest entry: float32 sums in another
order).  Circuit values against the JAX CPU path within 2e-5 and gradients
within 1e-4 (the JAX package's own rowm test allows 2e-4 and 2e-3; both
sides are float32 over 2^12-2^13 amplitudes); the switch settings against
the default within 1e-5 (value) and 1e-5 of the largest gradient.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu.core import kernels as jkernels
from tensorcircuit_ng_tpu.core import kernels_rowlayer as jkrl

from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

ATOL = 2e-6
GRAD_RTOL = 1e-5
E_ATOL = 2e-5
G_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    """The JAX package at complex64 with x64 off, whatever an earlier
    module on this worker left (its ``runtime_dtype`` leaves x64 on)."""
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


def _close(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _interpret(fn):
    jkernels.set_interpret_mode(True)
    try:
        return fn()
    finally:
        jkernels.set_interpret_mode(False)


def _card_mode(n, state2d):
    """``kst._stack_mode`` as it decides on a CUDA state."""
    fused = kst.FUSE_LANE
    return fused, kst._rowm_qubits(kst._shapes(n)[1]) if fused and kst.FUSE_ROWM else 0


def _unitary(rng, d):
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return np.linalg.qr(a)[0]


def _planes32(m):
    return m.real.astype(np.float32), m.imag.astype(np.float32)


@pytest.mark.parametrize("n,max_k", [(12, 4), (13, 10)])
def test_zzrx_rowm_plain_matches_pallas(monkeypatch, n, max_k):
    """Forward (arbitrary M7) and backward (unitary M7), each with and
    without the unitary lane planes, against the Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    nrow, nkernel, nouter, _ = kst._shapes(n)
    rmx = kst._rowm_qubits(nkernel)
    assert rmx == {12: 1, 13: 3}[n] and (nouter >= 1) == (n == 12)
    R = 2**rmx
    pairs = tuple((i, i + 1) for i in range(n - 1)) + ((0, n - 1),)
    rng = np.random.default_rng(60 + n)
    r = 2**nrow
    draw = lambda: (rng.normal(size=(r, 128)) / np.sqrt(2**n)).astype(np.float32)
    sr, si, ctr, cti = draw(), draw(), draw(), draw()
    zz = (rng.normal(size=len(pairs)) * 0.5).astype(np.float32)
    th = (rng.normal(size=nkernel) * 0.5).astype(np.float32)
    m7_any = _planes32((rng.normal(size=(R, R)) + 1j * rng.normal(size=(R, R))) / np.sqrt(2 * R))
    m7_u = _planes32(_unitary(rng, R))
    lane = _planes32(_unitary(rng, 128))
    t = lambda a: torch.as_tensor(np.array(a))
    for with_lane in (False, True):
        ml = list(lane) if with_lane else [None, None]
        jml = [None if m is None else jnp.asarray(m) for m in ml]
        args = (zz, th, sr, si)
        want = _interpret(lambda: jkrl._pallas_zzrx_fwd(
            pairs, n, *(jnp.asarray(a) for a in args), *jml, *(jnp.asarray(m) for m in m7_any)))
        got = krl.zzrx_fwd_plain(pairs, n, *(t(a) for a in args),
                                 *(None if m is None else t(m) for m in ml), *(t(m) for m in m7_any))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)

        # backward from the forward's own output with the unitary M7
        y = krl.zzrx_fwd_plain(pairs, n, *(t(a) for a in args),
                               *(None if m is None else t(m) for m in ml), *(t(m) for m in m7_u))
        bargs = (zz, th, y[0].numpy(), y[1].numpy(), ctr, cti)
        want = _interpret(lambda: jkrl._pallas_zzrx_bwd(
            pairs, n, *(jnp.asarray(a) for a in bargs), *jml, *(jnp.asarray(m) for m in m7_u)))
        want = [w for w in want if w is not None]
        got = krl.zzrx_bwd_plain(pairs, n, *(t(a) for a in bargs),
                                 *(None if m is None else t(m) for m in ml), *(t(m) for m in m7_u))
        # (dsr, dsi, dzz, dth_low, [dmr, dmi,] dm7r, dm7i)
        assert len(got) == len(want) == (8 if with_lane else 6)
        assert got[3].shape == (nkernel - rmx,) and got[-1].shape == (R, R)
        for i, (g, w) in enumerate(zip(got, want)):
            if i < 2:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
            else:
                _close(g.numpy(), w)


@pytest.mark.parametrize("rmx", range(1, 8))
def test_rowm_apply_plain_matches_jax_stage(rmx):
    """Stage K13's plain version (``rowm_apply_plain``) against the JAX
    package's own ``_rowm_fwd_stage`` (a plain jnp function) on one block of
    2^(rmx+3) rows, R = 2^rmx = 2..128, with an arbitrary complex M7:
    float32 sums of R terms in another order, so 1e-5 of the largest
    output."""
    R, rb = 2**rmx, 2 ** (rmx + 3)
    rng = np.random.default_rng(100 + rmx)
    cr, ci = (rng.normal(size=(rb, 128)).astype(np.float32) for _ in range(2))
    m7r, m7i = ((rng.normal(size=(R, R)) / np.sqrt(2 * R)).astype(np.float32) for _ in range(2))
    want = jkrl._rowm_fwd_stage(jnp.asarray(cr), jnp.asarray(ci), jnp.asarray(m7r), jnp.asarray(m7i))
    m7 = torch.complex(torch.as_tensor(m7r), torch.as_tensor(m7i))
    got = krl.rowm_apply_plain(m7, torch.complex(torch.as_tensor(cr), torch.as_tensor(ci)), rmx + 3)
    assert got.shape == (rb, 128)
    _close(got.real.numpy(), want[0])
    _close(got.imag.numpy(), want[1])


def test_rowm_stages_take_aligned_planes():
    """The row-kron stages copy 16-byte chunks: ``_aligned16`` returns an
    aligned plane as it is and copies one that is not."""
    base = torch.arange(130, dtype=torch.float32)
    ok = base[:128]
    off = base[1:129]
    assert krl._aligned16(ok) is ok
    moved = krl._aligned16(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


@pytest.mark.parametrize("n,rmx", [(10, 1), (13, 3), (17, 7)])
def test_rowm_plain_with_rx_kron_equals_butterflies(n, rmx):
    """``zzrx_fwd_plain`` with M7 = kron(rx(th[:rmx])) is the rmx = 0 call,
    and its backward the rmx = 0 backward, with dM7 chained to dθ_top
    through the kron builder (the stack's sign flip of the imaginary
    plane)."""
    nkernel = min(n - 7, 10)
    pairs = tuple((i, i + 1) for i in range(n - 1))
    rng = np.random.default_rng(n)
    r = 2 ** (n - 7)
    sr, si, ctr, cti = (torch.as_tensor(rng.normal(size=(r, 128)) / 2 ** (n / 2), dtype=torch.float32)
                        for _ in range(4))
    zz = torch.as_tensor(rng.normal(size=n - 1) * 0.5, dtype=torch.float32)
    th = torch.as_tensor(rng.normal(size=nkernel) * 0.5, dtype=torch.float32)
    m7r, m7i = (m[0] for m in kst._rx_kron_planes(th[None, :rmx]))
    want = krl.zzrx_fwd_plain(pairs, n, zz, th, sr, si)
    got = krl.zzrx_fwd_plain(pairs, n, zz, th, sr, si, None, None, m7r, m7i)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
    bw = krl.zzrx_bwd_plain(pairs, n, zz, th, *want, ctr, cti)
    bg = krl.zzrx_bwd_plain(pairs, n, zz, th, *want, ctr, cti, None, None, m7r, m7i)
    t7 = th[:rmx].clone().requires_grad_()
    pr, pi = kst._rx_kron_planes(t7[None])
    (dt7,) = torch.autograd.grad((pr, pi), t7, (bg[4][None], -bg[5][None]))
    for i, (g, w) in enumerate(zip(bg[:3] + (torch.cat([dt7, bg[3]]),), bw)):
        if i < 2:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
        else:
            _close(g.detach().numpy(), w.numpy())


def _tfim(mod, n, L, p, **kw):
    pairs = [(i, i + 1) for i in range(n - 1)]
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for l in range(L):
        c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
    return c.expectation_zzx_energy(pairs, 0.7, -1.3)


def _jax_truth(n, L, p0):
    """Value and grad of the TFIM energy on the JAX package's CPU path."""
    return jax.value_and_grad(lambda p: _tfim(tc, n, L, p))(jnp.asarray(p0))


def _port(n, L, p0):
    p = torch.tensor(p0, requires_grad=True)
    e = _tfim(tct, n, L, p, device="cpu")
    (g,) = torch.autograd.grad(e, p)
    return e.item(), g.numpy()


class _Spy:
    """Records which plain kernels a run reached, and with which planes (the
    per-layer calls inside a grand plain version are its own)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.depth = 0
        for mod, name in ((krl, "zzrx_fwd_plain"), (krl, "zzrx_bwd_plain"),
                          (kg, "grand_zzrx_fwd_plain"), (kg, "grand_zzrx_bwd_plain")):
            monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def spy(*args):
            if self.depth:
                return fn(*args)
            if name.startswith("zzrx"):
                # (pairs, n, zzth, th, 2 or 4 planes, mr, mi, m7r, m7i)
                a = args + (None,) * 4
                k = 6 if name == "zzrx_fwd_plain" else 8
                self.calls.append((name, a[k] is not None, a[k + 2] is not None))
                return fn(*args)
            self.calls.append((name, True, False))
            self.depth += 1
            try:
                return fn(*args)
            finally:
                self.depth -= 1

        return spy

    def kinds(self):
        return sorted(set(self.calls))


@pytest.mark.parametrize("n,max_k", [(12, 4), (13, 10)])
def test_rowm_slice_matches_jax(monkeypatch, n, max_k):
    """The TFIM value and grad under ``FUSE_ROWM`` on the card's routing
    (per-layer K1 and K3 with M7 and the lane, the matrix-level boundary)
    against the JAX package's CPU reference path."""
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    L = 2
    p0 = (np.random.default_rng(29 + n).normal(size=(L, 2, n)) * 0.4).astype(np.float32)
    ve, ge = _jax_truth(n, L, p0)
    monkeypatch.setattr(kst, "_stack_mode", _card_mode)
    monkeypatch.setattr(kst, "FUSE_ROWM", True)
    spy = _Spy(monkeypatch)
    e, g = _port(n, L, p0)
    assert spy.kinds() == [("zzrx_bwd_plain", True, True), ("zzrx_fwd_plain", True, True)]
    assert len(spy.calls) == 2 * L
    assert abs(e - float(ve)) <= E_ATOL
    np.testing.assert_allclose(g, np.asarray(ge), atol=G_ATOL)


@pytest.mark.parametrize("flag,at_forward", [("FUSE_ROWM", True), ("FUSE_LANE", False)])
def test_mode_survives_a_flag_flip(monkeypatch, flag, at_forward):
    """A switch flipped between the forward and the backward changes
    nothing: the backward follows the mode the forward took (rowm: K3 with
    M7; FUSE_LANE off: K3 without the lane)."""
    n, L, max_k = 12, 2, 4
    monkeypatch.setattr(jkrl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    p0 = (np.random.default_rng(23).normal(size=(L, 2, n)) * 0.4).astype(np.float32)
    ve, ge = _jax_truth(n, L, p0)
    monkeypatch.setattr(kst, "_stack_mode", _card_mode)
    monkeypatch.setattr(kst, flag, at_forward)
    spy = _Spy(monkeypatch)
    p = torch.tensor(p0, requires_grad=True)
    e = _tfim(tct, n, L, p, device="cpu")
    monkeypatch.setattr(kst, flag, not at_forward)  # flip mid-flight
    (g,) = torch.autograd.grad(e, p)
    want = ("zzrx_bwd_plain", True, True) if flag == "FUSE_ROWM" else ("zzrx_bwd_plain", False, False)
    assert [c for c in spy.calls if c[0] == "zzrx_bwd_plain"] == [want] * L
    assert abs(e.item() - float(ve)) <= E_ATOL
    np.testing.assert_allclose(g.numpy(), np.asarray(ge), atol=G_ATOL)


_ROUTES = {
    # switch settings -> the plain kernels the TFIM step reaches
    (): [("grand_zzrx_bwd_plain", True, False), ("grand_zzrx_fwd_plain", True, False)],
    (("FUSE_GRAND", False),): [("grand_zzrx_bwd_plain", True, False), ("zzrx_fwd_plain", True, False)],
    (("FUSE_GRAND_BWD", False),): [("grand_zzrx_fwd_plain", True, False), ("zzrx_bwd_plain", True, False)],
    (("FUSE_GRAND", False), ("FUSE_GRAND_BWD", False)): [
        ("zzrx_bwd_plain", True, False), ("zzrx_fwd_plain", True, False)],
    (("FUSE_LANE", False),): [("zzrx_bwd_plain", False, False), ("zzrx_fwd_plain", False, False)],
}


@pytest.mark.parametrize("setting", list(_ROUTES), ids=lambda s: "+".join(k for k, _ in s) or "default")
def test_switch_settings_agree(monkeypatch, setting):
    """Each switch setting gives the default's value and grad on the card's
    routing at n=12 (4 kernel qubits, nouter 1, L=2), through the kernels
    that setting should take."""
    n, L, max_k = 12, 2, 4
    monkeypatch.setattr(krl, "MAX_KERNEL_QUBITS_ZZRX", max_k)
    monkeypatch.setattr(kst, "_stack_mode", _card_mode)
    p0 = (np.random.default_rng(31).normal(size=(L, 2, n)) * 0.4).astype(np.float32)
    e0, g0 = _port(n, L, p0)
    for name, value in setting:
        monkeypatch.setattr(kst, name, value)
    spy = _Spy(monkeypatch)
    e, g = _port(n, L, p0)
    assert spy.kinds() == _ROUTES[setting]
    assert abs(e - e0) <= 1e-5
    _close(g, g0)
