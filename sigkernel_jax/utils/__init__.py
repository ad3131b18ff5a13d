"""Small shape/grid utilities shared across the library.

Replacements for the reference's grid helpers
(``flip``/``tile`` at reference sigkernel/sigkernel.py:599-613): dyadic
refinement is a plain ``jnp.repeat``; no interleave gymnastics are needed.
"""
from __future__ import annotations

import jax.numpy as jnp


def double_difference(G: jnp.ndarray) -> jnp.ndarray:
    """Second-order mixed finite difference over the last two axes.

    ``dd[..., i, j] = G[i+1,j+1] + G[i,j] - G[i+1,j] - G[i,j+1]``

    This is the discrete ``\\partial_s \\partial_t k(x_s, y_t)`` increment grid
    feeding the Goursat PDE solver (reference sigkernel/sigkernel.py:217,363).
    Input ``(..., M, N)`` -> output ``(..., M-1, N-1)``.
    """
    return (
        G[..., 1:, 1:] + G[..., :-1, :-1] - G[..., 1:, :-1] - G[..., :-1, 1:]
    )


def dd_transpose(ct: jnp.ndarray) -> jnp.ndarray:
    """Transpose (VJP) of :func:`double_difference`.

    A cotangent ``ct`` of shape ``(..., M-1, N-1)`` scatters back onto the
    ``(..., M, N)`` grid with the same +/- stencil; zero-padding ``ct`` by
    one on each side turns the scatter into the forward stencil itself:
    ``dG = double_difference(pad(ct, 1))``.
    """
    pad = [(0, 0)] * (ct.ndim - 2) + [(1, 1), (1, 1)]
    return double_difference(jnp.pad(ct, pad))


def dyadic_refine(dd: jnp.ndarray, dyadic_order: int) -> jnp.ndarray:
    """Dyadic grid refinement of an increment grid.

    Each cell is split into ``2^d x 2^d`` sub-cells, each carrying
    ``1/4^d`` of the original increment (reference sigkernel/sigkernel.py:218,
    364 via ``tile``; here a single ``jnp.repeat`` per axis).
    """
    if dyadic_order == 0:
        return dd
    f = 2 ** dyadic_order
    dd = jnp.repeat(dd, f, axis=-2)
    dd = jnp.repeat(dd, f, axis=-1)
    return dd / jnp.asarray(f * f, dd.dtype)


def increment_grid(G: jnp.ndarray, dyadic_order: int) -> jnp.ndarray:
    """Static-kernel Gram -> dyadically refined PDE increment grid."""
    return dyadic_refine(double_difference(G), dyadic_order)


def refined_size(length: int, dyadic_order: int) -> int:
    """Number of increment cells along one axis: ``2^d * (length - 1)``."""
    return (2 ** dyadic_order) * (length - 1)


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return -(-x // m) * m


def pad_length(X, multiple: int):
    """Pad paths along the length axis by repeating the final point.

    A repeated point produces zero increments, which are exact no-ops for
    both PDE schemes and for any static kernel (the duplicated Gram
    row/column differences away), so bucketing path lengths to shape
    multiples is mathematically free. Cuts jit recompiles across datasets
    of irregular lengths.
    """
    import jax.numpy as jnp

    n = X.shape[-2]
    rem = (-n) % multiple
    if rem == 0:
        return X
    last = X[..., -1:, :]
    reps = [1] * X.ndim
    reps[-2] = rem
    return jnp.concatenate([X, jnp.tile(last, reps)], axis=-2)


def pad_batch(X, multiple: int):
    """Zero-pad the leading axis to a multiple; returns ``(padded, n)``."""
    import jax.numpy as jnp

    n = X.shape[0]
    rem = (-n) % multiple
    if rem:
        X = jnp.concatenate(
            [X, jnp.zeros((rem,) + X.shape[1:], X.dtype)], axis=0)
    return X, n


def flip(x, dim):
    """Reverse along an axis (reference sigkernel.py:599-606, whose MPS
    branch crashes on a bad device getattr; here a plain jnp.flip)."""
    return jnp.flip(x, axis=dim)


def tile(a, dim, n_tile):
    """Interleaved repeat along an axis (reference sigkernel.py:607-613):
    each element appears ``n_tile`` times consecutively."""
    return jnp.repeat(a, n_tile, axis=dim)
