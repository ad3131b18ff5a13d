"""Double-float increment preparation: the static-kernel Gram and its
double difference computed in paired-f32 arithmetic.

This is the ``solver="df"`` family's replacement for an f64 preparation
pipeline (reference dataflow: sigkernel/sigkernel.py:217,363 computing
``dsdt k(X_s, Y_t)``). Everything runs in f32 arithmetic:

- forward: squared distances, ``exp``, and the double difference in DF
  (:mod:`.df32`), accurate to ~1e-13 *absolute* at Gram scale -- increment
  errors enter the PDE solve additively, so absolute accuracy at the
  boundary-value scale (G in [0, 1]) is the requirement.
- backward (``custom_vjp``): the exact same math differentiated in plain
  f32. The library's gradients are f32-grade by design (the reference's own
  gradients carry ~1e-7 error from its h=1e-9 finite-difference bump,
  sigkernel.py:314,473); running the prep VJP in emulated f64 was pure
  waste.

Outputs are (hi, lo) f32 pairs consumed by :func:`..ops.solve.solve_df`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import df32
from ..utils import double_difference


def _df_points(P64):
    """(..., L, D) f64 points -> DF, split once at base resolution."""
    return df32.from_f64(P64)


def _sq_norms(p):
    """DF points (..., L, D) -> DF squared norms (..., L)."""
    h, l = p
    D = h.shape[-1]
    acc = df32.sqr_((h[..., 0], l[..., 0]))
    for d in range(1, D):
        acc = df32.add_(acc, df32.sqr_((h[..., d], l[..., d])))
    return acc


def _cross(x, y):
    """DF inner products: x (..., M, 1, D), y (..., 1, N, D) -> (..., M, N).

    Shapes are pre-expanded by the caller so plain broadcasting drives the
    pairing (pairwise or full Gram with the same code).
    """
    xh, xl = x
    yh, yl = y
    D = xh.shape[-1]
    acc = df32.mul_((xh[..., 0], xl[..., 0]), (yh[..., 0], yl[..., 0]))
    for d in range(1, D):
        acc = df32.add_(acc, df32.mul_((xh[..., d], xl[..., d]),
                                       (yh[..., d], yl[..., d])))
    return acc


def _dd(G):
    """DF double difference over the last two axes (accurate adds: the
    cancellation here is the whole point -- increments are ~1e-8 of G)."""
    gh, gl = G
    g11 = (gh[..., 1:, 1:], gl[..., 1:, 1:])
    g00 = (gh[..., :-1, :-1], gl[..., :-1, :-1])
    g10 = (gh[..., 1:, :-1], gl[..., 1:, :-1])
    g01 = (gh[..., :-1, 1:], gl[..., :-1, 1:])
    return df32.add_(df32.add_(g11, g00),
                     df32.neg(df32.add_(g10, g01)))


def _expand_pair(x, y, gram: bool):
    """Insert broadcast axes: pairwise (B,M,D)x(B,N,D) -> (B,M,1,D),(B,1,N,D);
    gram (A,M,D)x(B,N,D) -> (A,1,M,1,D),(1,B,1,N,D)."""
    def ex(p, axis):
        return tuple(jnp.expand_dims(c, axis) for c in p)
    if gram:
        x = ex(ex(x, 1), 3)      # (A,1,M,1,D)
        y = ex(ex(y, 0), 2)      # (1,B,1,N,D)
    else:
        x = ex(x, -2)            # (B,M,1,D)
        y = ex(y, -3)            # (B,1,N,D)
    return x, y


def _rbf_dd_fwd_math(X64, Y64, sigma64, gram: bool):
    """DF forward: dd(exp(-|x_s - y_t|^2 / sigma)) as (hi, lo)."""
    x = _df_points(X64.astype(jnp.float64))
    y = _df_points(Y64.astype(jnp.float64))
    # -1/sigma as a DF scalar: one emulated-f64 division, negligible
    rs = df32.from_f64(-1.0 / sigma64.astype(jnp.float64))
    sx = _sq_norms(x)
    sy = _sq_norms(y)
    if gram:
        sx = tuple(c[:, None, :, None] for c in sx)    # (A,1,M,1)
        sy = tuple(c[None, :, None, :] for c in sy)    # (1,B,1,N)
    else:
        sx = tuple(c[..., :, None] for c in sx)        # (B,M,1)
        sy = tuple(c[..., None, :] for c in sy)        # (B,1,N)
    xe, ye = _expand_pair(x, y, gram)
    cr = _cross(xe, ye)
    d2 = df32.add_(df32.add_(sx, sy), df32.mul_const(cr, -2.0))
    arg = df32.mul_(d2, rs)
    return _dd(df32.exp_(arg))


def _linear_dd_fwd_math(X64, Y64, scale64, gram: bool):
    """DF forward for the linear kernel: dd is exactly
    ``scale^2 <dx_s, dy_t>`` (the Gram grid never exists)."""
    x = _df_points(X64.astype(jnp.float64))
    y = _df_points(Y64.astype(jnp.float64))
    dx = df32.add_(tuple(c[..., 1:, :] for c in x),
                   df32.neg(tuple(c[..., :-1, :] for c in x)))
    dy = df32.add_(tuple(c[..., 1:, :] for c in y),
                   df32.neg(tuple(c[..., :-1, :] for c in y)))
    s2 = df32.sqr_(df32.from_f64(scale64.astype(jnp.float64)))
    xe, ye = _expand_pair(dx, dy, gram)
    return df32.mul_(_cross(xe, ye), s2)


# ---------------------------------------------------------------------------
# f32 reference implementations driving the custom backward
# ---------------------------------------------------------------------------

def _rbf_dd_f32(X32, Y32, sigma32, gram: bool):
    if gram:
        d2 = (jnp.sum(X32 ** 2, -1)[:, None, :, None]
              + jnp.sum(Y32 ** 2, -1)[None, :, None, :]
              - 2.0 * jnp.einsum("amd,bnd->abmn", X32, Y32))
    else:
        d2 = (jnp.sum(X32 ** 2, -1)[..., :, None]
              + jnp.sum(Y32 ** 2, -1)[..., None, :]
              - 2.0 * jnp.einsum("bmd,bnd->bmn", X32, Y32))
    return double_difference(jnp.exp(-d2 / sigma32))


def _linear_dd_f32(X32, Y32, scale32, gram: bool):
    dx = jnp.diff(X32, axis=-2)
    dy = jnp.diff(Y32, axis=-2)
    eq = "amd,bnd->abmn" if gram else "bmd,bnd->bmn"
    return (scale32 ** 2) * jnp.einsum(eq, dx, dy)


# ---------------------------------------------------------------------------
# custom_vjp wrappers
# ---------------------------------------------------------------------------

def _make_increments(fwd_math, f32_ref):
    @functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
    def increments(X, Y, hyper, gram):
        return fwd_math(X, Y, hyper, gram)

    def fwd(X, Y, hyper, gram):
        return fwd_math(X, Y, hyper, gram), (X, Y, hyper)

    def bwd(gram, res, ct):
        X, Y, hyper = res
        cth, ctl = ct
        ct32 = cth + ctl
        x32 = X.astype(jnp.float32)
        y32 = Y.astype(jnp.float32)
        h32 = hyper.astype(jnp.float32)
        _, vjp = jax.vjp(lambda a, b, c: f32_ref(a, b, c, gram),
                         x32, y32, h32)
        gx, gy, gh = vjp(ct32)
        return (gx.astype(X.dtype), gy.astype(Y.dtype),
                gh.astype(hyper.dtype))

    increments.defvjp(fwd, bwd)
    return increments


_rbf_increments = _make_increments(_rbf_dd_fwd_math, _rbf_dd_f32)
_linear_increments = _make_increments(_linear_dd_fwd_math, _linear_dd_f32)


def rbf_increments_df(X, Y, sigma, gram: bool):
    """DF double-difference increments for the RBF kernel.

    ``X``: (A|B, M, D), ``Y``: (A|B, N, D); returns DF of shape
    (B, M-1, N-1) pairwise or (A, B, M-1, N-1) with ``gram=True``.
    Differentiable in X, Y and sigma (f32-grade backward).
    """
    return _rbf_increments(X, Y, jnp.asarray(sigma), gram)


def linear_increments_df(X, Y, scale, gram: bool):
    """DF increments for the linear kernel (``scale^2 <dx, dy>``)."""
    return _linear_increments(X, Y, jnp.asarray(scale), gram)


# ---------------------------------------------------------------------------
# Hand-fused increment-chain VJP (the gen-family gradient tail)
# ---------------------------------------------------------------------------

def rbf_dd_vjp(X, Y, sigma, ct, gram: bool):
    """VJP of ``(sigma, X, Y) -> double_difference(exp(-|x_s-y_t|^2/sigma))``.

    A hand-derived alternative to ``jax.vjp`` of the naive composition,
    which materialises the squared-distance grid, the kernel grid and
    their backward-pass duplicates as separate arrays: this derivation
    produces ONE weight grid ``W`` feeding two contractions and fused
    reductions. No estimator route calls it at present (the increment
    family differentiates the static kernel with JAX AD); it is kept,
    pinned against ``jax.vjp`` by the tests, until a measurement on the
    card decides between the two.

    Math (RBF with the reference's ``/sigma`` convention,
    reference static_kernels.py:56): with ``G = exp(-D/sigma)``,
    ``dG = dd_transpose(ct)``, ``E = dG * G``:

    - ``d sigma = sum(E * D) / sigma^2``
    - ``W = dD = -E / sigma``
    - ``dX_m = 2 * (rowsum(W)_m * x_m - (W @ Y)_m)``
    - ``dY_n = 2 * (colsum(W)_n * y_n - (W^T @ X)_n)``

    Computed in ``X.dtype`` (each route casts inputs to its gradient
    grade before calling). Returns ``(d_sigma, dX, dY)``.
    """
    from ..utils import dd_transpose

    dt = X.dtype
    sig = jnp.asarray(sigma, dt)
    dG = dd_transpose(ct.astype(dt))
    two = jnp.asarray(2.0, dt)
    # explicit HIGHEST: a reduced-precision f32 product (bf16 passes or
    # TF32) loses ~1e-3 relative on the distance grid, amplified by exp
    es = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    if not gram:
        D = (jnp.sum(X * X, -1)[..., :, None]
             + jnp.sum(Y * Y, -1)[..., None, :]
             - two * es("bmd,bnd->bmn", X, Y))
        E = dG * jnp.exp(-D / sig)
        dsig = jnp.sum(E * D) / (sig * sig)
        W = E * (-1.0 / sig)
        dX = two * (jnp.sum(W, -1)[..., None] * X
                    - es("bmn,bnd->bmd", W, Y))
        dY = two * (jnp.sum(W, -2)[..., None] * Y
                    - es("bmn,bmd->bnd", W, X))
    else:
        D = (jnp.sum(X * X, -1)[:, None, :, None]
             + jnp.sum(Y * Y, -1)[None, :, None, :]
             - two * es("amd,bnd->abmn", X, Y))
        E = dG * jnp.exp(-D / sig)
        dsig = jnp.sum(E * D) / (sig * sig)
        W = E * (-1.0 / sig)
        dX = two * (jnp.sum(W, (1, 3))[..., None] * X
                    - es("abmn,bnd->amd", W, Y))
        dY = two * (jnp.sum(W, (0, 2))[..., None] * Y
                    - es("abmn,amd->bnd", W, X))
    return dsig, dX, dY
