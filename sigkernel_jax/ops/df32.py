"""Double-float (paired-f32) arithmetic at the XLA level.

A value is carried as an unevaluated sum ``hi + lo`` of two float32s
(~49-bit mantissa, unit roundoff ~2^-49). This module provides the
XLA-side building blocks of the ``solver="df"`` family: the preparation
pipeline (static-kernel Gram, double difference) in f32 arithmetic with
f64-grade accuracy, for devices without fast f64.

Excess-precision hardening: XLA may constant-fold with wider
intermediates (``--xla_allow_excess_precision``), which silently destroys
error-free transformations involving *literal constants*. Therefore every
constant used inside an EFT here is pre-decomposed in **numpy** f32
(hi/lo parts and Veltkamp splits), so the compiler only ever sees plain
f32 literals, never a foldable ``(c + x) - x`` pattern. EFTs on traced
tensors (two_sum/two_prod of runtime data) are preserved by XLA.

Error model: ``add_`` (accurate renormalising add) and ``mul_`` keep
~2 ulps of the double-float format *relative to the operand magnitudes*;
under catastrophic cancellation the absolute error stays ~2^-49 of the
inputs, which is what the PDE increment pipeline needs (increment errors
enter the solve additively, not relatively).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _f32(x):
    return jnp.asarray(x, jnp.float32)


# ---------------------------------------------------------------------------
# Error-free transformations (traced operands only; constants go through the
# numpy-precomputed paths below)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly (add/sub only)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """Dekker fast two-sum; requires |a| >= |b| (renormalisation step)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Veltkamp split of an f32 into 12+12-bit halves."""
    c = jnp.float32(4097.0) * a  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product: p + e == a * b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# Double-float ops. A DF value is a (hi, lo) tuple of same-shape f32 arrays.
# ---------------------------------------------------------------------------

def from_f64(x64):
    """Split an f64 array into (hi, lo) f32 planes (one emulated-f64 sub)."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def to_f64(d):
    hi, lo = d
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def from_f32(x32):
    return x32, jnp.zeros_like(x32)


def neg(d):
    return -d[0], -d[1]


def add_(x, y):
    """Accurate (IEEE-style) double-float add: both components go through
    exact two-sums, so cancellation costs absolute -- not relative --
    accuracy. ~20 f32 ops."""
    sh, se = two_sum(x[0], y[0])
    tl, te = two_sum(x[1], y[1])
    se = se + tl
    sh, se = quick_two_sum(sh, se)
    se = se + te
    return quick_two_sum(sh, se)


def add_f32(x, b32):
    """DF + plain f32 tensor."""
    sh, se = two_sum(x[0], b32)
    se = se + x[1]
    return quick_two_sum(sh, se)


def mul_(x, y):
    """Double-float multiply (~28 f32 ops)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def mul_f32(x, b32):
    """DF * plain f32 tensor."""
    p, e = two_prod(x[0], b32)
    e = e + x[1] * b32
    return quick_two_sum(p, e)


def prod_f32(a32, b32):
    """Exact product of two plain-f32 tensors as a DF."""
    return two_prod(a32, b32)


def sqr_(x):
    p, e = two_prod(x[0], x[0])
    e = e + 2.0 * (x[0] * x[1])
    return quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# Constant-involving ops: the constant's decomposition (hi/lo and the
# Veltkamp split of hi) is precomputed in numpy f32, so no EFT ever touches
# a traceable/foldable literal.
# ---------------------------------------------------------------------------

def const(c: float):
    """Python float -> DF constant (numpy-precomputed split)."""
    hi = np.float32(c)
    lo = np.float32(c - float(hi))
    return jnp.float32(hi), jnp.float32(lo)


def _const_parts(c: float):
    ch = np.float32(c)
    cl = np.float32(c - float(ch))
    t = np.float32(4097.0) * ch
    chh = np.float32(t - np.float32(t - ch))
    chl = np.float32(ch - chh)
    return ch, cl, chh, chl


def mul_const(x, c: float):
    """DF * python-float constant with numpy-precomputed splits."""
    ch, cl, chh, chl = _const_parts(c)
    p = x[0] * ch
    ah, al = split(x[0])
    err = ((ah * chh - p) + ah * chl + al * chh) + al * chl
    e = err + (x[0] * cl + x[1] * ch)
    return quick_two_sum(p, e)


def add_const(x, c: float):
    """DF + python-float constant.

    The two-sum here is an EFT *involving a literal*, the exact pattern
    XLA's excess-precision simplifier rewrites (``(x + 1) - x -> 1``,
    zeroing the recovered error). The constant is therefore routed through
    ``optimization_barrier`` so the simplifier sees a runtime value.
    """
    from jax import lax

    ch = lax.optimization_barrier(jnp.float32(np.float32(c)))
    cl = jnp.float32(np.float32(c - float(np.float32(c))))
    sh, se = two_sum(x[0], ch)
    se = se + (x[1] + cl)
    return quick_two_sum(sh, se)


# ---------------------------------------------------------------------------
# exp: argument reduction + Taylor series, all in DF
# ---------------------------------------------------------------------------

_LN2 = float(np.log(2.0))
_INV_LN2 = np.float32(1.0 / _LN2)

# Taylor 1/n! coefficients, highest order first, for Horner evaluation.
# Taylor order of the reduced exponential. Order 10 leaves the polynomial a
# ~2.7e-14 relative tail (r^11/11! at |r| <= ln2/2) -- one decade above the
# df32 unit roundoff but two decades inside the solve's 1e-10 end-to-end
# budget (measured transfer: increment error -> final K error is ~200x at
# the benchmark grid; 2.7e-14 -> ~5e-12). Orders beyond 10 buy accuracy the
# PDE accumulation cannot use while each order costs a df multiply-add
# (~48 f32 ops) per grid cell in the increment prep.
_EXP_ORDER = 10


def exp_taylor_(x):
    """Double-float ``exp`` (legacy full-DF Taylor; kept as the accuracy
    yardstick for :func:`exp_`).

    ``exp(x) = 2^k * exp(r)`` with ``r = x - k ln2``, ``|r| <= ln2/2``; the
    reduced exponential is an order-``_EXP_ORDER`` Taylor polynomial
    evaluated by Horner in DF arithmetic. Inputs below f32's exp range
    underflow to 0 (the callers feed RBF exponents; increments that small
    are numerically irrelevant). ~650 f32 ops.
    """
    xh, xl = x
    k = jnp.round(xh * _INV_LN2)
    # r = x - k*ln2: k*ln2 as a DF via the constant-hardened multiply
    r = add_((xh, xl), neg(mul_const(from_f32(k), _LN2)))

    # Horner: p = 1/N! ; p = p*r + 1/n!
    import math
    p = const(1.0 / math.factorial(_EXP_ORDER))
    p = (jnp.broadcast_to(p[0], xh.shape), jnp.broadcast_to(p[1], xh.shape))
    for n in range(_EXP_ORDER - 1, -1, -1):
        p = mul_(p, r)
        p = add_const(p, 1.0 / math.factorial(n))

    # scale by 2^k exactly, per component: assemble the power of two from
    # exponent bits (jnp.exp2 is a ~1e-7 polynomial approximation, not
    # exact). Below f32's range the true value is < 2^-125: flush to zero
    # (a clamped exponent would silently return 2^-126 * exp(r),
    # overestimating deep RBF tails by dozens of orders of magnitude).
    from jax import lax

    ki = jnp.clip(k, -126.0, 127.0).astype(jnp.int32)
    two_k = lax.bitcast_convert_type((ki + 127) << 23, jnp.float32)
    two_k = jnp.where(k < -126.0, jnp.float32(0.0), two_k)
    return p[0] * two_k, p[1] * two_k


# 2^(j/8) for j = 0..7 as numpy-precomputed DF constants (the fine-reduction
# table of exp_); rel error of each entry ~2^-48
_EXP8_TABLE = tuple(
    (np.float32(v), np.float32(v - float(np.float32(v))))
    for v in (float(2.0 ** (j / 8.0)) for j in range(8)))


def exp_(x):
    """Double-float ``exp`` via 8x-fine reduction + hybrid DF/f32 Taylor.

    ``exp(x) = 2^m * 2^(j/8) * exp(r)`` with ``k = round(x * 8/ln2)``,
    ``m = floor(k/8)``, ``j = k - 8m in [0, 8)`` and ``r = x - k ln2/8``,
    ``|r| <= ln2/16 ~ 0.0433``. The reduced exponential runs Taylor order 3
    in DF arithmetic plus an order 4..7 tail in plain f32 (largest tail
    term ``r^4/24 <= 1.5e-7``, so its f32 rounding is ~1e-14 relative --
    inside the ~2.7e-14 budget the legacy order-10 reduction already
    accepted). ~250 f32 ops, 2.6x fewer than :func:`exp_taylor_`; accuracy
    pinned by ``tests/test_df_prep.py::test_df32_exp_accuracy`` and the
    A/B test against the legacy path.
    """
    from jax import lax

    xh, xl = x
    k = jnp.round(xh * np.float32(8.0 / _LN2))
    # r = x - k*(ln2/8): constant-hardened DF multiply, accurate add
    r = add_((xh, xl), neg(mul_const(from_f32(k), _LN2 / 8.0)))

    # DF Horner through order 3: p = 1 + r + r^2/2 + r^3/6
    p = mul_const(r, 1.0 / 6.0)
    p = add_const(p, 0.5)
    p = mul_(p, r)
    p = add_const(p, 1.0)
    p = mul_(p, r)
    p = add_const(p, 1.0)
    # f32 tail, orders 4..7 (magnitudes <= 1.5e-7: f32 rounding is ~1e-14
    # relative to exp(r) ~ 1)
    rt = r[0]
    r2 = rt * rt
    tail = (r2 * r2) * (np.float32(1.0 / 24.0)
                        + rt * (np.float32(1.0 / 120.0)
                                + rt * (np.float32(1.0 / 720.0)
                                        + rt * np.float32(1.0 / 5040.0))))
    p = add_f32(p, tail)

    # 2^(j/8) from the table (j = k - 8m is an exact small-integer f32)
    m = jnp.floor(k * np.float32(0.125))
    j = k - np.float32(8.0) * m
    th = jnp.broadcast_to(_EXP8_TABLE[0][0], xh.shape)
    tl = jnp.broadcast_to(_EXP8_TABLE[0][1], xh.shape)
    for ji in range(1, 8):
        sel = j == np.float32(ji)
        th = jnp.where(sel, _EXP8_TABLE[ji][0], th)
        tl = jnp.where(sel, _EXP8_TABLE[ji][1], tl)
    p = mul_(p, (th, tl))

    # scale by 2^m exactly per component (exponent-bit assembly; jnp.exp2
    # is an inexact polynomial). Below f32 range: flush to zero -- a
    # clamped exponent would overestimate deep RBF tails by orders of
    # magnitude.
    mi = jnp.clip(m, -126.0, 127.0).astype(jnp.int32)
    two_m = lax.bitcast_convert_type((mi + 127) << 23, jnp.float32)
    two_m = jnp.where(m < -126.0, jnp.float32(0.0), two_m)
    return p[0] * two_m, p[1] * two_m


def expm1_(x):
    """Double-float ``exp(x) - 1`` accurate near zero (|x| small).

    For |x| <= ln2/2 uses the Taylor tail directly (no reduction, no
    cancellation); otherwise falls back to ``exp_(x) - 1``.
    """
    import math

    xh, xl = x
    small = jnp.abs(xh) <= jnp.float32(0.35)
    xs = jnp.where(small, xh, jnp.float32(0.0)), \
        jnp.where(small, xl, jnp.float32(0.0))
    # expm1(x)/x = 1 + x/2 (1 + x/3 (1 + ... (1 + x/N)))
    p = (jnp.broadcast_to(jnp.float32(1.0), xh.shape),
         jnp.broadcast_to(jnp.float32(0.0), xh.shape))
    for n in range(_EXP_ORDER, 1, -1):
        p = mul_(p, xs)
        p = mul_const(p, 1.0 / n)
        p = add_const(p, 1.0)
    small_val = mul_(p, xs)
    eh, el = exp_(x)
    big_val = add_const((eh, el), -1.0)
    return (jnp.where(small, small_val[0], big_val[0]),
            jnp.where(small, small_val[1], big_val[1]))
