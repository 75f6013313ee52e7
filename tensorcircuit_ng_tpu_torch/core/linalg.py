"""AD-safe linear algebra primitives, in plain torch.

Counterpart of ``tensorcircuit_ng_tpu/core/linalg.py``: SVD, QR, RQ and
eigh with gradients that stay finite at degenerate singular values and
repeated eigenvalues (regularized inverse spacings; complex SVD adjoint per
arXiv:1909.02659), the Gram-eigh SVD of the TEBD truncation, an XLA-style
one-sided Jacobi SVD, a static-rank truncated SVD and LOBPCG.

Conjugation: the JAX package's adjoints are derived for the
``dL = Re tr(g^H dA)`` form and conjugate JAX's cotangent in and the result
out to reach it.  Torch's complex gradient already has that form, so each
``backward`` here calls the same body without the two conjugations; a
complex gradient here is the conjugate of the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .transform_rules import front_vmap

__all__ = [
    "adaware_svd",
    "gram_svd",
    "jacobi_svd",
    "adaware_qr",
    "adaware_rq",
    "adaware_eigh",
    "plain_eigh",
    "truncated_svd",
    "lobpcg",
    "USE_GRAM_SVD",
    "uses_gram",
]

_EPS_DEFAULT = 1e-12


def _safe_inverse(x: torch.Tensor, eps: Union[float, torch.Tensor] = _EPS_DEFAULT) -> torch.Tensor:
    return x / (x * x + eps)


def _H(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-1, -2)


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _zeros_if_none(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if g is None else g


# ---------------------------------------------------------------- SVD


def _svd_bwd_conjconv(a, u, s, vh, du, ds, dvh):
    """SVD adjoint in the ``dL = Re tr(g^H dA)`` form (torch's gradient).

    Both regularizations scale with the dtype and with s_max, not with an
    absolute eps: a singular value at the decomposition's rounding floor,
    max(m, n)·eps·s_max (numpy's rank tolerance), is a zero whose vectors
    are arbitrary, so its cotangents are dropped and its 1/s is 0; and
    1/(s_j² − s_i²) is regularized at the rounding of s², eps·s_max².  The
    JAX package's absolute 1e-12 distorts every pair closer than ~1e-6 in
    s², as the kept values near a truncation's cut of a normalized MPS
    centre are: its gradient there is 1e-4-1e-2 off a central difference
    (Queue 3 F9 of ``ROADMAP.md``)."""
    dtype = a.dtype
    m, n = a.shape[-2], a.shape[-1]
    k = s.shape[-1]
    eps = torch.finfo(s.dtype).eps
    s_max = s.amax(dim=-1, keepdim=True)
    live = s > max(m, n) * eps * s_max
    du = torch.where(live[..., None, :], du, torch.zeros_like(du))
    ds = torch.where(live, ds, torch.zeros_like(ds))
    dvh = torch.where(live[..., :, None], dvh, torch.zeros_like(dvh))
    v = _H(vh)
    dv = _H(dvh)

    s_c = s.to(dtype)
    s2 = s * s
    # F[i, j] = 1 / (s_j^2 - s_i^2), zero diagonal (regularized)
    eye_k = _eye(k, a)
    f = _safe_inverse(s2[..., None, :] - s2[..., :, None], ((eps * s_max * s_max) ** 2)[..., None])
    f = f.to(dtype) * (1.0 - eye_k)

    sigma_mat = eye_k * s_c[..., None, :]
    s_inv = torch.where(live, 1.0 / torch.where(live, s, torch.ones_like(s)), torch.zeros_like(s)).to(dtype)
    sigma_inv_mat = eye_k * s_inv[..., None, :]

    da = u @ (eye_k * ds.to(dtype)[..., None, :]) @ vh

    uhdu = _H(u) @ du
    u_term = (f * (uhdu - _H(uhdu))) @ sigma_mat
    if m > k:
        proj_u = _eye(m, a) - u @ _H(u)
        da = da + proj_u @ du @ sigma_inv_mat @ vh
    da = da + u @ u_term @ vh

    vhdv = vh @ dv
    v_term = sigma_mat @ (f * (vhdv - _H(vhdv)))
    if n > k:
        proj_v = _eye(n, a) - v @ _H(v)
        da = da + u @ sigma_inv_mat @ _H(dv) @ proj_v
    da = da + u @ v_term @ vh

    if a.is_complex():
        # diagonal gauge (phase) correction, split symmetrically between U and
        # V (arXiv:1909.02659): i*Im(diag(U^H gU) - diag(V^H gV)) / (2 s)
        gu_diag = torch.diagonal(uhdu, dim1=-2, dim2=-1)
        gv_diag = torch.diagonal(vhdv, dim1=-2, dim2=-1)
        imag_corr = ((gu_diag - gu_diag.conj()) - (gv_diag - gv_diag.conj())) / 4.0 * s_inv
        da = da + u @ (eye_k * imag_corr[..., None, :]) @ vh
    return da


def _orthonormal_columns(u: torch.Tensor) -> torch.Tensor:
    """``u``'s columns made orthonormal in order (QR, each column keeping
    its phase): columns that already are stay as they are."""
    q, r = torch.linalg.qr(u)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    mag = d.abs()
    # a column at the noise floor (r_jj down to denormals) keeps q's phase
    keep = mag > torch.finfo(mag.dtype).eps * mag.amax(dim=-1, keepdim=True)
    phase = torch.where(keep, d / torch.where(keep, mag, torch.ones_like(mag)), torch.ones_like(d))
    return q * phase[..., None, :]


#: the double-precision dtype in which the truncation's Gram route works on
#: a single-precision matrix (through autograd: its adjoint too)
WIDE = {torch.complex64: torch.complex128, torch.float32: torch.float64}


class _SVDAdjoint(torch.autograd.Function):
    """An SVD forward ``impl`` with the degenerate-safe adjoint
    (:func:`_svd_bwd_conjconv`).

    The adjoint needs an SVD's orthonormal vectors.  The Gram-eigh impl
    (:func:`_gram_svd_floored`) returns them with the singular values at
    its noise floor set to zero, and the adjoint drops the cotangents of
    zeros (the JAX package's Gram adjoint takes the divided side's vectors
    as they are, neither unit nor orthogonal at the floor, and its gradient
    of a rank-deficient matrix is wrong: Queue 3 F8 of ``ROADMAP.md``)."""

    @staticmethod
    def forward(a, impl):
        return impl(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], *output)

    @staticmethod
    def backward(ctx, du, ds, dvh):
        a, u, s, vh = ctx.saved_tensors
        da = _svd_bwd_conjconv(
            a, u, s, vh, _zeros_if_none(du, u), _zeros_if_none(ds, s), _zeros_if_none(dvh, vh)
        )
        return da, None

    @staticmethod
    def vmap(info, in_dims, *args):
        return front_vmap(info, in_dims, _SVDAdjoint.apply, args)


def _exact_svd(a):
    return torch.linalg.svd(a, full_matrices=False)


def adaware_svd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduced SVD ``a = u @ diag(s) @ vh`` with degenerate-safe gradients."""
    return _SVDAdjoint.apply(a, _exact_svd)


def _eigh_ftz(g: torch.Tensor):
    """``torch.linalg.eigh`` with denormals flushed to zero on the CPU, as
    XLA computes the JAX package's eigh there: MKL's complex64 eigh fails or
    returns NaN eigenvectors on the Gram matrices of rank-deficient TEBD
    thetas unless it does.  The flag is process state and is set back off
    after the call."""
    if g.device.type != "cpu":
        return torch.linalg.eigh(g)
    torch.set_flush_denormal(True)
    try:
        return torch.linalg.eigh(g)
    finally:
        torch.set_flush_denormal(False)


def _gram_svd_impl(a):
    m, n = a.shape[-2], a.shape[-1]
    eps = 1e-30
    if n <= m:
        evals, v = _eigh_ftz(_H(a) @ a)  # ascending
        evals = torch.flip(evals, (-1,))
        v = torch.flip(v, (-1,))
        s = torch.sqrt(torch.clamp(evals.real, min=0.0))
        u = (a @ v) * _safe_inverse(s + eps)[..., None, :].to(a.dtype)
        return u, s, _H(v).resolve_conj()
    evals, u = _eigh_ftz(a @ _H(a))
    evals = torch.flip(evals, (-1,))
    u = torch.flip(u, (-1,))
    s = torch.sqrt(torch.clamp(evals.real, min=0.0))
    vh = _H((_H(a) @ u) * _safe_inverse(s + eps)[..., None, :].to(a.dtype))
    return u, s, vh.resolve_conj()


def _gram_svd_floored(a):
    """The Gram-eigh SVD with the singular values at its noise floor,
    2·sqrt(eps)·s_max (eigh of the Gram matrix resolves its eigenvalues to
    ~eps·s_max²), set to zero and the side it divides by s orthonormalized,
    so the kept factors are an SVD's (orthonormal vectors, noise directions
    of weight zero).  Without this a truncated MPS's gradient grows without
    bound through the QR sweeps: noise columns of u·s (~sqrt(eps)·s_max,
    not orthogonal to the live ones) make the QR adjoints' triangular
    solves amplify at every site."""
    u, s, vh = _gram_svd_impl(a)
    if a.shape[-1] <= a.shape[-2]:
        u = _orthonormal_columns(u)
    else:
        vh = _H(_orthonormal_columns(_H(vh))).resolve_conj()
    live = s > 2.0 * torch.finfo(s.dtype).eps ** 0.5 * s[..., :1]
    return u, torch.where(live, s, torch.zeros_like(s)), vh


def gram_svd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduced SVD via eigh of the smaller-side Gram matrix, the TEBD and
    MPS truncations' SVD.

    Singular values below ~sqrt(eps)·s_max lose relative accuracy, the tail
    that bond truncation discards: they are set to zero and the side
    divided by s is orthonormalized (:func:`_gram_svd_floored`; the JAX
    package keeps them and its adjoint of a rank-deficient matrix is wrong,
    Queue 3 F8).  The backward is the degenerate-safe SVD adjoint with the
    zeroed values' cotangents dropped.
    """
    return _SVDAdjoint.apply(a, _gram_svd_floored)


#: route truncated_svd through the Gram-eigh SVD (:func:`gram_svd`).
#: None = auto: Gram on a CUDA tensor (as the JAX package takes it on the
#: TPU), exact SVD otherwise.  True/False force.  On the Gram route a
#: single-precision matrix is decomposed in double precision, and so are
#: :func:`adaware_qr` and :func:`adaware_rq` (:func:`_on_gram_route`): in
#: single precision the floor, 2·sqrt(eps)·s_max ~ 7e-4·s_max, would drop
#: the singular value a rotation by less than ~1e-3 creates and its O(1)
#: gradient (phase 16 (b): 0.16 off the dense gradient; PERF.md), and the
#: QR adjoints of an MPS's rank-deficient site tensors amplify their
#: rounding at every site of a sweep.
USE_GRAM_SVD: Optional[bool] = None


def uses_gram(a: torch.Tensor) -> bool:
    """Whether :func:`truncated_svd` takes the Gram route for ``a``."""
    return USE_GRAM_SVD if USE_GRAM_SVD is not None else a.is_cuda


def _on_gram_route(fn, a: torch.Tensor):
    """``fn(a)``; for a single-precision ``a`` on the Gram route computed
    in double precision (through autograd), each factor rounded back."""
    if not (uses_gram(a) and a.dtype in WIDE):
        return fn(a)
    real = a.real.dtype
    return tuple(x.to(a.dtype if x.is_complex() == a.is_complex() else real) for x in fn(a.to(WIDE[a.dtype])))


# ------------------------------------------------------- one-sided Jacobi


def _jacobi_svd_impl(a: torch.Tensor, sweeps: int = 10):
    """Batched one-sided (Hestenes) Jacobi SVD in plain tensor ops.

    Pairs slot i with slot n-1-i (a round-robin tournament, not the
    Brent-Luk pairing of ``kernels_jacobi``); requires n even.  Returns the
    full (u, s, vh) with s descending.
    """
    m, n = a.shape[-2], a.shape[-1]
    if n % 2:
        raise ValueError("jacobi_svd: trailing dimension must be even")
    h = n // 2
    tiny = 1e-30
    x = a
    v = _eye(n, a).expand(a.shape[:-2] + (n, n))
    for _ in range(sweeps * (n - 1)):
        # pair slot i with slot n-1-i: left half vs reversed right half
        xl, xr = x[..., :h], torch.flip(x[..., h:], (-1,))
        vl, vr = v[..., :h], torch.flip(v[..., h:], (-1,))
        app = torch.sum(torch.abs(xl) ** 2, dim=-2)
        aqq = torch.sum(torch.abs(xr) ** 2, dim=-2)
        apq = torch.sum(xl.conj() * xr, dim=-2)
        mod = torch.abs(apq)
        phase = apq / (mod + tiny).to(a.dtype)  # e^{i phi}
        tau = (aqq - app) / (2.0 * mod + tiny)
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = c * t
        # skip negligible rotations (keeps zero columns fixed)
        skip = mod <= 1e-12 * torch.sqrt(app * aqq) + tiny
        c = torch.where(skip, 1.0, c)
        s = torch.where(skip, 0.0, s)
        cc = c[..., None, :].to(a.dtype)
        ss = s[..., None, :].to(a.dtype)
        ph = phase[..., None, :]
        #   p' = c p - s e^{-i phi} q ;  q' = s e^{i phi} p + c q
        xl2 = cc * xl - ss * ph.conj() * xr
        xr2 = ss * ph * xl + cc * xr
        vl2 = cc * vl - ss * ph.conj() * vr
        vr2 = ss * ph * vl + cc * vr
        x = torch.cat([xl2, torch.flip(xr2, (-1,))], dim=-1)
        v = torch.cat([vl2, torch.flip(vr2, (-1,))], dim=-1)
        # round-robin advance: slot 0 fixed, slots 1..n-1 cycle by one
        x = torch.cat([x[..., :1], x[..., -1:], x[..., 1:-1]], dim=-1)
        v = torch.cat([v[..., :1], v[..., -1:], v[..., 1:-1]], dim=-1)
    s = torch.sqrt(torch.sum(torch.abs(x) ** 2, dim=-2))
    order = torch.argsort(-s, dim=-1, stable=True)
    s = torch.take_along_dim(s, order, dim=-1)
    x = torch.take_along_dim(x, order[..., None, :], dim=-1)
    v = torch.take_along_dim(v, order[..., None, :], dim=-1)
    u = x * _safe_inverse(s + tiny)[..., None, :].to(a.dtype)
    return u, s, _H(v).resolve_conj()


def jacobi_svd(a: torch.Tensor, sweeps: int = 10) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-sided Jacobi SVD (see :func:`_jacobi_svd_impl`); SVD adjoint."""
    return _SVDAdjoint.apply(a, lambda x: _jacobi_svd_impl(x, sweeps))


# ---------------------------------------------------------------- QR / RQ


def _copyltu(m: torch.Tensor) -> torch.Tensor:
    """Lower triangle (incl. diag) plus conj-transpose of strictly-lower."""
    return torch.tril(m) + _H(torch.tril(m, -1))


def _tri_solve_rh(x: torch.Tensor, r: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """``x @ r^{-H}`` by a triangular solve (r upper triangular); diagonal
    entries of r below ``eps`` are bumped to ``eps`` so rank-deficient
    inputs keep finite gradients."""
    k = r.shape[-1]
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    bump = torch.where(diag.abs() < eps, torch.full_like(diag, eps), torch.zeros_like(diag))
    r = r + _eye(k, r) * bump[..., None, :]
    # y = x r^{-H}  <=>  r y^H = x^H  with r upper triangular
    yh = torch.linalg.solve_triangular(r, _H(x), upper=True)
    return _H(yh)


def _qr_square_bwd(q, r, dq, dr):
    """QR adjoint for m >= n, in the dL = Re tr(g^H dA) form."""
    qdq = _H(q) @ dq
    qdq_skew = qdq - _H(qdq)
    rdr = r @ _H(dr)
    rdr_skew = rdr - _H(rdr)
    tril = torch.tril(qdq_skew + rdr_skew)
    grad_a = q @ (dr + _tri_solve_rh(tril, r))
    grad_b = _tri_solve_rh(dq - q @ qdq, r)
    ret = grad_a + grad_b
    if q.is_complex():
        # imaginary-diagonal gauge correction (cf. TF's QrGrad complex case)
        m_diag = torch.diagonal(rdr - _H(qdq), dim1=-2, dim2=-1)
        corr = 1j * m_diag.imag
        ret = ret + _tri_solve_rh(q @ (_eye(r.shape[-1], q) * corr.conj()[..., None, :]), r)
    return ret


class _QR(torch.autograd.Function):
    @staticmethod
    def forward(a):
        return torch.linalg.qr(a, mode="reduced")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], *output)

    @staticmethod
    def vmap(info, in_dims, a):
        return front_vmap(info, in_dims, _QR.apply, (a,))

    @staticmethod
    def backward(ctx, dq, dr):
        a, q, r = ctx.saved_tensors
        dq, dr = _zeros_if_none(dq, q), _zeros_if_none(dr, r)
        m, n = a.shape[-2], a.shape[-1]
        if m >= n:
            return _qr_square_bwd(q, r, dq, dr)
        # wide: a = [x | y], x = q u, y = q v
        y = a[..., :, m:]
        u = r[..., :, :m]
        du = dr[..., :, :m]
        dv = dr[..., :, m:]
        dy = q @ dv
        dq_eff = dq + y @ _H(dv)
        dx = _qr_square_bwd(q, u, dq_eff, du)
        return torch.cat([dx, dy], dim=-1)


def adaware_qr(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with gradients defined for tall and wide matrices (in
    double precision on the Gram route, as :data:`USE_GRAM_SVD` says)."""
    return _on_gram_route(_QR.apply, a)


def _rq(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    q, r = _QR.apply(torch.flip(a, (-2, -1)).transpose(-1, -2))
    rr = torch.flip(r.transpose(-1, -2), (-2, -1))
    qq = torch.flip(q.transpose(-1, -2), (-2, -1))
    return rr, qq


def adaware_rq(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ decomposition ``a = r @ q`` built from QR of the flipped matrix
    (in double precision on the Gram route, as :func:`adaware_qr`)."""
    return _on_gram_route(_rq, a)


# ---------------------------------------------------------------- eigh


class _Eigh(torch.autograd.Function):
    """``torch.linalg.eigh`` with the adjoint V (diag(dλ) + F ∘ V^H dV) V^H,
    F[i, j] = 1/(λ_j - λ_i) off the diagonal: regularized at an absolute
    ``eps``, or exact (``eps=None``: inf at an exactly degenerate pair, so
    the gradient is NaN there).
    Unlike torch's own adjoint it does not check that the loss ignores
    the eigenvectors' phases, which rounding breaks."""

    @staticmethod
    def forward(a, eps):
        return torch.linalg.eigh(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)
        ctx.eps = inputs[1]

    @staticmethod
    def vmap(info, in_dims, *args):
        return front_vmap(info, in_dims, _Eigh.apply, args)

    @staticmethod
    def backward(ctx, de, dv):
        e, v = ctx.saved_tensors
        de, dv = _zeros_if_none(de, e), _zeros_if_none(dv, v)
        k = e.shape[-1]
        eye_k = _eye(k, v)
        diff = e[..., None, :] - e[..., :, None]
        if ctx.eps is None:
            f = (1.0 / (diff + eye_k.real) - eye_k.real).to(v.dtype)
        else:
            f = _safe_inverse(diff, ctx.eps).to(v.dtype) * (1.0 - eye_k)
        mid = eye_k * de.to(v.dtype)[..., None, :] + f * (_H(v) @ dv)
        return v @ mid @ _H(v), None


def adaware_eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian eigendecomposition with degenerate-safe gradients."""
    return _Eigh.apply(a, _EPS_DEFAULT)


def plain_eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian eigendecomposition with the plain adjoint, JAX's
    ``jnp.linalg.eigh``'s: exact inverse spacings, a NaN gradient where
    two eigenvalues are equal."""
    return _Eigh.apply(a, None)


class _SqrtmH(torch.autograd.Function):
    """√a of a Hermitian matrix by ``eigh``, √λ of its eigenvalues (clipped
    at 0 with ``psd``, else NaN below 0 as the JAX package's ``sqrtmh``).
    The adjoint is the Daleckii-Krein form V (K ∘ V^H g V) V^H with the
    divided difference of √·, K_ij = 1/(√λ_i + √λ_j), set to 0 where both
    eigenvalues lie below the rounding of the spectrum, eps·λ_max (the
    floor of :func:`gram_svd` and :func:`_svd_bwd_conjconv`): a rank-
    deficient matrix has a finite gradient, its null space held fixed."""

    @staticmethod
    def forward(a, psd):
        e, v = torch.linalg.eigh(a)
        if psd:
            e = torch.clamp(e, min=0.0)
        return (v * torch.sqrt(e).to(v.dtype)[..., None, :]) @ _H(v), e, v

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, e, v = output
        ctx.mark_non_differentiable(e, v)
        ctx.save_for_backward(e, v)

    @staticmethod
    def backward(ctx, g, *_):
        e, v = ctx.saved_tensors
        e = torch.clamp(e, min=0.0)
        floor = torch.finfo(e.dtype).eps * e.amax(dim=-1, keepdim=True)
        root = torch.sqrt(e)
        null = (e <= floor)[..., None, :] & (e <= floor)[..., :, None]
        denom = root[..., None, :] + root[..., :, None]
        k = torch.where(null, torch.zeros_like(denom), 1.0 / torch.where(null, torch.ones_like(denom), denom))
        return v @ (k.to(v.dtype) * (_H(v) @ g @ v)) @ _H(v), None

    @staticmethod
    def vmap(info, in_dims, *args):
        return front_vmap(info, in_dims, _SqrtmH.apply, args)


def sqrtmh(a: torch.Tensor, psd: bool = False) -> torch.Tensor:
    """The Hermitian square root √a (the JAX backend's ``sqrtmh``), with a
    gradient that stays finite where ``a`` is rank-deficient."""
    return _SqrtmH.apply(a, psd)[0]


# ---------------------------------------------------------------- truncation


def truncated_svd(
    a: torch.Tensor,
    max_singular_values: int,
    max_truncation_err: float = 0.0,
    relative: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD with a static output rank: ``(u, s, vh, mask)``, the
    entries past the effective rank zeroed by the boolean ``mask``."""
    u, s, vh = _on_gram_route(gram_svd, a) if uses_gram(a) else adaware_svd(a)
    k = min(max_singular_values, s.shape[-1])
    u = u[..., :, :k]
    s_k = s[..., :k]
    vh = vh[..., :k, :]
    if max_truncation_err > 0.0:
        # discarded weight if we keep indices < i:  sqrt(sum_{j>=i} s_j^2)
        tail = torch.sqrt(torch.flip(torch.cumsum(torch.flip(s * s, (-1,)), dim=-1), (-1,)))
        bound = max_truncation_err * (s[..., :1] if relative else 1.0)
        keep = tail > bound  # keep s_i while the remaining weight is above bound
        keep[..., 0] = True
        mask = keep[..., :k]
    else:
        mask = torch.ones(s_k.shape, dtype=torch.bool, device=s.device)
    s_k = torch.where(mask, s_k, torch.zeros_like(s_k))
    u = torch.where(mask[..., None, :], u, torch.zeros_like(u))
    vh = torch.where(mask[..., :, None], vh, torch.zeros_like(vh))
    return u, s_k, vh, mask


def lobpcg(a: torch.Tensor, k: int = 1, x0=None, maxiter: int = 100, tol: float = 0.0):
    """Smallest-eigenpair LOBPCG on a dense real symmetric matrix:
    ``(eigenvalues (k,), eigenvectors (n, k))``.  Without ``x0`` the start
    block is Gaussian from a fixed seed (not the JAX package's numbers)."""
    n = a.shape[-1]
    if x0 is None:
        gen = torch.Generator(device=a.device).manual_seed(0)
        x0 = torch.randn((n, k), generator=gen, dtype=a.dtype, device=a.device)
    e, v = torch.lobpcg(a, k=k, X=x0, niter=maxiter, tol=tol or None, largest=False)
    return e, v
