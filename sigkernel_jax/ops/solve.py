"""Differentiable Goursat solve with an adjoint (second PDE sweep) backward.

The reference implements gradients by solving the *same* PDE on the reversed
increment grid and forming ``KK = K[..., :-1, :-1] * K_rev[..., 1:, 1:]``
(variation of parameters; reference sigkernel/sigkernel.py:256-343, 419-502),
never differentiating through the solver loop. We package exactly that trick
as a ``jax.custom_vjp`` on the map ``increments -> K[..., -1, -1]``:

    d(final) / d(inc[a, b]) = K[a, b] * K_rev_flipped[a + 1, b + 1]

Everything upstream of the increments (static kernel Gram, double difference)
is plain JAX, so the chain rule through the static kernel is handled
*analytically* by JAX AD -- replacing the reference's ``h = 1e-9``
finite-difference bump (reference sigkernel.py:314,473) with the exact
derivative.

Dyadic refinement happens *inside* the solver tiers (``dyadic_order`` is an
argument of :func:`solve`): the CUDA kernel reads the base grid and refines
on the fly; the scan tier refines with a repeat and an exact power-of-two
scale. The backward collapses the refined adjoint back to the base grid
(the VJP of the refinement).

Both the value and the gradient are computed in the dtype of the
increments: f64 increments get f64 forward and adjoint sweeps.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from . import gpu_wavefront, scan_solver
from .routes import resolve_tier
from ..utils import dyadic_refine


def _solve_final(inc, naive, solver, dyadic_order):
    if resolve_tier(solver, inc, dyadic_order) == "cuda":
        return gpu_wavefront.solve_final(inc, naive, dyadic_order)
    return scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                   naive=naive)


def _solve_grid(inc, naive, solver, dyadic_order):
    """Full refined-resolution solution grid."""
    if resolve_tier(solver, inc, dyadic_order) == "cuda":
        return gpu_wavefront.solve_grid(inc, naive, dyadic_order)
    return scan_solver.solve_grid(dyadic_refine(inc, dyadic_order),
                                  naive=naive)


def _adjoint_grids(inc, naive, solver, dyadic_order):
    """``(K, flip(K_rev))``: the grid of ``inc`` and, flipped back, the grid
    of the reversed increments -- the two factors of the backward product."""
    if resolve_tier(solver, inc, dyadic_order) == "cuda":
        both = gpu_wavefront.solve_grid(inc, naive, dyadic_order,
                                        adjoint=True)
        return both[:, 0], both[:, 1]
    # one batched sweep over [inc; flip(inc)]: the scan is sequential in
    # n_steps, so doubling the (vectorised) batch halves backward latency
    inc_rev = jnp.flip(inc, axis=(-2, -1))
    both = scan_solver.solve_grid(
        dyadic_refine(jnp.concatenate([inc, inc_rev], axis=0), dyadic_order),
        naive=naive)
    B = inc.shape[0]
    return both[:B], jnp.flip(both[B:], axis=(-2, -1))


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _solve_flat(inc: jnp.ndarray, naive: bool, solver: str,
                dyadic_order: int):
    """custom_vjp core over a flat ``(B, M-1, N-1)`` batch."""
    return _solve_final(inc, naive, solver, dyadic_order)


def solve(inc: jnp.ndarray, naive: bool = False, solver: str = "auto",
          dyadic_order: int = 0, grad_solver: str = "auto"):
    """Solve the Goursat PDE on the *base* increment grid ``inc``
    (``(..., M-1, N-1)``), refined internally by ``2^dyadic_order``.

    Returns the signature-kernel values ``K[..., -1, -1]`` with the batch
    shape of ``inc``. Differentiable in ``inc`` via the adjoint PDE solve,
    which runs in the dtype of ``inc``. ``grad_solver`` is validated for
    API compatibility; it only changes the backward of the double-float
    family (``solver="df"``, see :mod:`..sigkernel`).

    Batch dims are flattened around the core, so the kernel and the scan
    tier see one pair axis.
    """
    if grad_solver not in ("auto", "f32", "df64"):
        raise ValueError(f"unknown grad_solver {grad_solver!r}; "
                         "expected 'auto', 'f32' or 'df64'")
    batch_shape = inc.shape[:-2]
    # explicit batch size: -1 cannot be inferred when a trailing dim is 0
    # (length-1 paths produce a (..., 0, 0) increment grid)
    flat = inc.reshape((math.prod(batch_shape),) + inc.shape[-2:])
    out = _solve_flat(flat, naive, solver, dyadic_order)
    return out.reshape(batch_shape)


def _collapse_refined(KK, dyadic_order, dtype):
    """VJP of dyadic refinement: sum each ``f x f`` block, scale ``1/f^2``."""
    if dyadic_order == 0:
        return KK.astype(dtype)
    f = 2 ** dyadic_order
    *batch, MM, NN = KK.shape
    KK = KK.reshape(*batch, MM // f, f, NN // f, f)
    return (KK.sum(axis=(-3, -1)) / (f * f)).astype(dtype)


def _grid_route_bwd(inc, g, naive, solver, dyadic_order):
    """Backward: the forward and reversed grid solves and the
    variation-of-parameters product ``KK = K[:-1,:-1] * flip(K_rev)[1:,1:]``
    in the working dtype, collapsed to the base grid."""
    grid, grid_rev = _adjoint_grids(inc, naive, solver, dyadic_order)
    KK = grid[..., :-1, :-1] * grid_rev[..., 1:, 1:]
    KK = g[..., None, None].astype(KK.dtype) * KK
    return (_collapse_refined(KK, dyadic_order, inc.dtype),)


def _solve_fwd(inc, naive, solver, dyadic_order):
    return _solve_final(inc, naive, solver, dyadic_order), inc


def _solve_bwd(naive, solver, dyadic_order, inc, g):
    return _grid_route_bwd(inc, g, naive, solver, dyadic_order)


_solve_flat.defvjp(_solve_fwd, _solve_bwd)


def solve_with_grid(inc: jnp.ndarray, naive: bool = False,
                    solver: str = "auto",
                    dyadic_order: int = 0) -> jnp.ndarray:
    """Non-differentiable full-grid solve (used by tests and diagnostics)."""
    return _solve_grid(inc, naive, solver, dyadic_order)


# ---------------------------------------------------------------------------
# Double-float (paired-f32) increment path
# ---------------------------------------------------------------------------

def _df_combine(dd_df):
    hi, lo = dd_df
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _solve_df_flat(dd_df, naive: bool, dyadic_order: int):
    # the paired-f32 increments combine to f64 and solve at that precision
    return _solve_final(_df_combine(dd_df), naive, "auto", dyadic_order)


def _solve_df_fwd(dd_df, naive, dyadic_order):
    return _solve_df_flat(dd_df, naive, dyadic_order), dd_df


def _solve_df_bwd(naive, dyadic_order, dd_df, g):
    (ct64,) = _grid_route_bwd(_df_combine(dd_df), g, naive, "auto",
                              dyadic_order)
    ct = ct64.astype(jnp.float32)
    # the cotangent is f32-grade by design; its lo plane is identically zero
    return ((ct, jnp.zeros_like(ct)),)


_solve_df_flat.defvjp(_solve_df_fwd, _solve_df_bwd)


def solve_df(dd_df, naive: bool = False, dyadic_order: int = 0):
    """Differentiable Goursat solve on double-float increments.

    ``dd_df``: a ``(hi, lo)`` pair of f32 arrays ``(..., M-1, N-1)`` whose
    unevaluated sum is the f64-grade increment grid (produced by
    :mod:`.df_prep`). Returns f64 ``K[..., -1, -1]``; the backward returns
    an f32 cotangent for ``hi`` (and zeros for ``lo``).
    """
    hi, lo = dd_df
    batch_shape = hi.shape[:-2]
    B = math.prod(batch_shape)
    flat = (hi.reshape((B,) + hi.shape[-2:]),
            lo.reshape((B,) + lo.shape[-2:]))
    out = _solve_df_flat(flat, naive, dyadic_order)
    return out.reshape(batch_shape)
