"""Pure-XLA Goursat PDE solver: a ``lax.scan`` over anti-diagonals.

This is the always-available solver tier (any platform, any dtype incl.
float64)
playing the role the Cython backend plays in the reference
(reference sigkernel/cython_backend.pyx:7-33) while using the wavefront
dataflow of the reference's CUDA/MPS backends
(reference sigkernel/cuda_backend.py:6-49, mps_backend.py:24-49).

Design: the solution grid ``K`` of shape ``(MM+1, NN+1)`` (boundary
``K[0,:] = K[:,0] = 1``) is never materialised during the sweep. Instead the
scan carries the two previous anti-diagonals as fixed-length vectors indexed
by the row coordinate ``i``:

    ``v_p[i] = K[i, p - i]``   for diagonal index ``p = i + j``.

The recurrence for an interior cell reads (with ``u = inc[i-1, j-1]``)::

    v_p[i] = scheme(k00=v_{p-2}[i-1], k01=v_{p-1}[i-1], k10=v_{p-1}[i], u)

so one scan step is a pair of static shifts plus fused element-wise math over
the whole diagonal and all batch dims at once -- no data-dependent control
flow, no in-place updates. Increments are pre-skewed
into diagonal-major layout once so each step consumes a contiguous slice.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Update schemes (the two finite-difference schemes of the reference,
# cython_backend.pyx:27-31).
# ---------------------------------------------------------------------------

def _update_naive(k00, k01, k10, u):
    """First-order scheme: ``(k01+k10)(1 + u/2) - k00``."""
    return (k01 + k10) * (1.0 + 0.5 * u) - k00


def _update_order2(k00, k01, k10, u):
    """Higher-order scheme: ``(k01+k10)(1 + u/2 + u^2/12) - k00(1 - u^2/12)``."""
    u2 = u * u * (1.0 / 12.0)
    return (k01 + k10) * (1.0 + 0.5 * u + u2) - k00 * (1.0 - u2)


def get_scheme(naive: bool):
    return _update_naive if naive else _update_order2


# ---------------------------------------------------------------------------
# Diagonal (skewed) layout helpers
# ---------------------------------------------------------------------------

def shear_rows(x: jnp.ndarray, out_width: Optional[int] = None) -> jnp.ndarray:
    """Shear a grid so anti-diagonals become columns -- WITHOUT a gather.

    ``(..., R, C) -> (..., R, W)`` with ``W >= T = R + C - 1`` and
    ``out[..., a, t] = x[..., a, t - a]`` (zero out of the valid band).

    Implemented as pad + flatten + truncate + reshape: padding each row to
    width ``W + 1`` makes consecutive rows' flat offsets differ by one more
    than the output row stride ``W``, which realises the per-row shift. This
    lowers to plain copies instead of a gather.

    The stride relation holds for ANY ``W >= T``; ``out_width`` lets a
    caller pick an aligned row width for the reshape copy.
    """
    *batch, R, C = x.shape
    T = R + C - 1
    W = T if out_width is None else out_width
    assert W >= T
    W0 = W + 1
    xp = jnp.pad(x, [(0, 0)] * len(batch) + [(0, 0), (0, W0 - C)])
    flat = xp.reshape(*batch, R * W0)[..., : R * W]
    return flat.reshape(*batch, R, W)


def unshear_rows(D: jnp.ndarray, NN: int) -> jnp.ndarray:
    """Inverse shear with the solver's index offset -- no gather.

    ``D``: ``(..., R, T)`` with ``D[..., i, q]`` = diagonal ``q`` at row
    ``i``. Returns ``(..., R, NN+1)`` with
    ``out[..., i, j] = D[..., i, i + j - 2]`` (zeros where out of range).
    Same flat-stride trick as :func:`shear_rows`, with a 2-element prepend
    realising the ``-2`` diagonal offset.
    """
    *batch, R, T = D.shape
    W1 = T + 1
    flat = D.reshape(*batch, R * T)
    flat = jnp.pad(flat, [(0, 0)] * len(batch) + [(2, max(R - 2, 0))])
    flat = flat[..., : R * W1]
    return flat.reshape(*batch, R, W1)[..., : NN + 1]


def skew_increments(inc: jnp.ndarray) -> jnp.ndarray:
    """Re-layout an increment grid into diagonal-major ("skewed") form.

    Input ``inc``: ``(..., MM, NN)``. Output: ``(n_steps, ..., MM+1)`` with
    ``n_steps = MM + NN - 1`` and

        ``out[q, ..., i] = inc[..., i-1, q-i+1]``

    (zero where out of range). The index shift by one aligns entry ``i`` of
    step ``q`` with the increment feeding solution cell ``(i, q+2-i)``.
    """
    S = shear_rows(inc)  # (..., MM, n_steps)
    S = jnp.pad(S, [(0, 0)] * (S.ndim - 2) + [(1, 0), (0, 0)])
    return jnp.moveaxis(S, -1, 0)  # (n_steps, ..., MM+1)


def unskew_grid(diags: jnp.ndarray, MM: int, NN: int) -> jnp.ndarray:
    """Skewed diagonal stack -> full solution grid ``(..., MM+1, NN+1)``.

    ``diags``: ``(n_steps, ..., MM+1)`` holding diagonals ``p = 2 .. MM+NN``
    (scan outputs). Boundary cells (``i == 0`` or ``j == 0``) are filled
    with 1.
    """
    D = jnp.moveaxis(diags, 0, -1)  # (..., MM+1, n_steps)
    K = unshear_rows(D, NN)
    i = jnp.arange(MM + 1)[:, None]
    j = jnp.arange(NN + 1)[None, :]
    one = jnp.ones((), diags.dtype)
    return jnp.where((i == 0) | (j == 0), one, K)


# ---------------------------------------------------------------------------
# Core sweep
# ---------------------------------------------------------------------------

def _sweep(inc: jnp.ndarray, naive: bool, return_grid: bool):
    """Run the anti-diagonal wavefront over ``inc`` (``(..., MM, NN)``).

    Returns ``(final, grid_or_None)`` where ``final`` has the batch shape and
    ``grid`` (if requested) is the full ``(..., MM+1, NN+1)`` solution.
    """
    MM, NN = inc.shape[-2], inc.shape[-1]
    batch_shape = inc.shape[:-2]
    dtype = inc.dtype
    scheme = get_scheme(naive)

    if MM == 0 or NN == 0:
        # degenerate (length-1) path: the solution is the boundary, K == 1
        final = jnp.ones(batch_shape, dtype)
        grid = (jnp.ones(batch_shape + (MM + 1, NN + 1), dtype)
                if return_grid else None)
        return final, grid

    inc_skew = skew_increments(inc)  # (n_steps, ..., MM+1)
    ps = jnp.arange(2, MM + NN + 1)  # diagonal index per step
    ii = jnp.arange(MM + 1)
    one = jnp.ones((), dtype)

    # derive the carry init from `inc` so it inherits the varying-manual-axes
    # type under shard_map (a plain jnp.ones carry would trip the vma check)
    v0 = jnp.zeros_like(inc[..., 0, 0])[..., None] + jnp.ones((MM + 1,), dtype)

    def step(carry, xs):
        vm2, vm1 = carry
        inc_row, p = xs
        k10 = vm1
        k01 = jnp.roll(vm1, 1, axis=-1)
        k00 = jnp.roll(vm2, 1, axis=-1)
        v = scheme(k00, k01, k10, inc_row)
        v = jnp.where((ii == 0) | (ii == p), one, v)
        out = v if return_grid else None
        return (vm1, v), out

    (_, v_last), diags = lax.scan(step, (v0, v0), (inc_skew, ps))
    final = v_last[..., MM]
    grid = unskew_grid(diags, MM, NN) if return_grid else None
    return final, grid


@functools.partial(jax.jit, static_argnames=("naive",))
def solve_final(inc: jnp.ndarray, naive: bool = False) -> jnp.ndarray:
    """Solve the Goursat PDE; return only the final corner ``K[..., -1, -1]``."""
    final, _ = _sweep(inc, naive, return_grid=False)
    return final


@functools.partial(jax.jit, static_argnames=("naive",))
def solve_grid(inc: jnp.ndarray, naive: bool = False) -> jnp.ndarray:
    """Solve the Goursat PDE; return the full ``(..., MM+1, NN+1)`` grid."""
    _, grid = _sweep(inc, naive, return_grid=True)
    return grid


@functools.partial(jax.jit, static_argnames=("naive",))
def solve_stripe(inc: jnp.ndarray, bd: jnp.ndarray,
                 naive: bool = False) -> jnp.ndarray:
    """Sweep one horizontal stripe with a general north boundary.

    The stripe decomposition behind the sequence-parallel sweep of
    :mod:`..parallel.seq_stripes`: the grid rows
    are cut into stripes; each stripe is an ordinary wavefront whose north
    boundary row ``K[0_local, j]`` is the *previous stripe's bottom row*
    instead of the constant 1 (any platform/dtype).

    ``inc``: ``(..., MM_s, NN)`` stripe increments. ``bd``: ``(..., NN+1)``
    north boundary (``bd[..., 0] == 1``, the global west corner). Returns
    the stripe's bottom row ``K[MM_s, :]`` as ``(..., NN+1)`` (entry 0 is
    the west boundary 1); the final stripe's entry ``[..., NN]`` is the
    solve's corner value.
    """
    MM, NN = inc.shape[-2], inc.shape[-1]
    batch_shape = inc.shape[:-2]
    dtype = inc.dtype
    scheme = get_scheme(naive)

    if MM == 0:
        return bd
    if NN == 0:
        return jnp.ones(batch_shape + (1,), dtype)

    inc_skew = skew_increments(inc)          # (n_steps, ..., MM+1)
    n_steps = MM + NN - 1
    ps = jnp.arange(2, MM + NN + 1)
    ii = jnp.arange(MM + 1)
    one = jnp.ones((), dtype)

    # north boundary per diagonal p: K[0, p] = bd[p] (pad past NN: unused)
    bd_pad = jnp.concatenate(
        [bd, jnp.ones(batch_shape + (MM + 1,), dtype)], axis=-1)
    bd_steps = jnp.moveaxis(
        lax.dynamic_slice_in_dim(bd_pad, 2, n_steps, axis=-1), -1, 0)

    v0 = jnp.zeros_like(inc[..., 0, 0])[..., None] + jnp.ones((MM + 1,), dtype)
    vm2 = jnp.where(ii == 0, bd[..., 0:1], v0)
    vm1 = jnp.where(ii == 0, bd_pad[..., 1:2], v0)

    def step(carry, xs):
        vm2, vm1 = carry
        inc_row, p, bd_p = xs
        k10 = vm1
        k01 = jnp.roll(vm1, 1, axis=-1)
        k00 = jnp.roll(vm2, 1, axis=-1)
        v = scheme(k00, k01, k10, inc_row)
        v = jnp.where(ii == p, one, v)          # west boundary K[p, 0] = 1
        v = jnp.where(ii == 0, bd_p[..., None], v)  # north boundary
        return (vm1, v), v[..., MM]

    (_, _), bottom = lax.scan(step, (vm2, vm1), (inc_skew, ps, bd_steps))
    # bottom[q] = K[MM, q + 2 - MM] for q >= MM - 2
    bottom = jnp.moveaxis(bottom, 0, -1)       # (..., n_steps)
    vals = lax.dynamic_slice_in_dim(bottom, MM - 1, NN, axis=-1)
    west = jnp.ones(batch_shape + (1,), dtype)
    return jnp.concatenate([west, vals], axis=-1)


# ---------------------------------------------------------------------------
# Fused triple sweep: kernel + first/second directional derivatives.
# Product-rule recurrences follow the reference spec
# (reference sigkernel/cuda_backend.py:205-220, mps_backend.py:117-129).
# ---------------------------------------------------------------------------

@jax.jit
def solve_derivatives_final(inc: jnp.ndarray,
                            inc_d: jnp.ndarray,
                            inc_dd: jnp.ndarray):
    """Fused wavefront propagating ``(K, K_diff, K_diffdiff)``.

    ``inc`` uses the higher-order scheme for ``K``; the derivative states use
    the coupled product-rule recurrences (f1..f4 / g1..g4). Returns the three
    final corner values, each with the batch shape of ``inc``.
    """
    MM, NN = inc.shape[-2], inc.shape[-1]
    batch_shape = inc.shape[:-2]
    dtype = inc.dtype

    if MM == 0 or NN == 0:
        # degenerate (length-1) path: K == 1 on the boundary, derivatives 0
        one = jnp.ones(batch_shape, dtype)
        zero = jnp.zeros(batch_shape, dtype)
        return one, zero, zero

    xs = (skew_increments(inc), skew_increments(inc_d),
          skew_increments(inc_dd), jnp.arange(2, MM + NN + 1))
    ii = jnp.arange(MM + 1)
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)

    # vma-aware carry inits (see _sweep)
    z0 = jnp.zeros_like(inc[..., 0, 0])[..., None] + jnp.zeros((MM + 1,), dtype)
    v0 = z0 + jnp.ones((MM + 1,), dtype)

    def step(carry, xs):
        (k_m2, k_m1, d_m2, d_m1, s_m2, s_m1) = carry
        u, ud, udd, p = xs
        bnd = (ii == 0) | (ii == p)

        k10, k01, k00 = k_m1, jnp.roll(k_m1, 1, -1), jnp.roll(k_m2, 1, -1)
        d10, d01, d00 = d_m1, jnp.roll(d_m1, 1, -1), jnp.roll(d_m2, 1, -1)
        s10, s01, s00 = s_m1, jnp.roll(s_m1, 1, -1), jnp.roll(s_m2, 1, -1)

        k = _update_order2(k00, k01, k10, u)

        f1 = k00 * ud + d00 * u
        f2 = k01 * ud + d01 * u
        f3 = k10 * ud + d10 * u
        f4 = k * ud + (d01 + d10 - d00 + f1) * u
        d = d01 + d10 - d00 + 0.25 * (f1 + f2 + f3 + f4)

        g1 = k00 * udd + 2.0 * d00 * ud + s00 * u
        g2 = k01 * udd + 2.0 * d01 * ud + s01 * u
        g3 = k10 * udd + 2.0 * d10 * ud + s10 * u
        g4 = k * udd + 2.0 * d * ud + (s01 + s10 - s00 + g1) * u
        s = s01 + s10 - s00 + 0.25 * (g1 + g2 + g3 + g4)

        k = jnp.where(bnd, one, k)
        d = jnp.where(bnd, zero, d)
        s = jnp.where(bnd, zero, s)
        return (k_m1, k, d_m1, d, s_m1, s), None

    (_, k_last, _, d_last, _, s_last), _ = lax.scan(
        step, (v0, v0, z0, z0, z0, z0), xs)
    return k_last[..., MM], d_last[..., MM], s_last[..., MM]
