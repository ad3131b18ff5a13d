"""Multi-chip sharded estimators via ``shard_map`` over a device mesh.

Sharding layout (SURVEY.md S5 "distributed communication backend"):

- ``sharded_sig_kernel``: batch axis sharded along ``data``; zero
  communication.
- ``sharded_sig_gram``: Gram *rows* (the ``A`` axis) sharded along ``data``,
  ``Y`` replicated; each chip owns an ``(A/n, B)`` row-block. Collectives
  only when the caller gathers the result.
- ``sharded_sig_mmd``: row-sharded partial sums + ``psum``; the full
  Gram matrix is never materialised on one chip. Differentiable end to end
  (``shard_map`` is transparent to AD), so MMD training steps scale as pure
  data parallelism.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..sigkernel import sig_kernel, sig_gram


from ..utils import pad_batch as _pad_rows  # shared leading-axis padding


def _mesh_solver(mesh: Mesh, solver: str) -> str:
    """Resolve ``auto`` against the *mesh's* devices, not the default
    backend: a CPU mesh on a GPU host must not trace the CUDA kernel for
    its shards."""
    from ..ops.routes import on_gpu

    if solver != "auto":
        return solver
    return "auto" if on_gpu(mesh.devices.flat[0]) else "scan"


def sharded_sig_kernel(static_kernel, X, Y, mesh: Mesh, dyadic_order=0,
                       naive=False, solver="auto", axis="data"):
    """Pairwise kernel with the batch axis sharded across ``mesh[axis]``."""
    solver = _mesh_solver(mesh, solver)
    n = mesh.shape[axis]
    Xp, b = _pad_rows(X, n)
    Yp, _ = _pad_rows(Y, n)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis), P(axis)), out_specs=P(axis))
    def run(x, y):
        return sig_kernel(static_kernel, x, y, dyadic_order=dyadic_order,
                          naive=naive, solver=solver, max_batch=None)

    return run(Xp, Yp)[:b]


def sharded_sig_gram(static_kernel, X, Y, mesh: Mesh, dyadic_order=0,
                     sym=False, naive=False, solver="auto", axis="data",
                     max_batch: Optional[int] = None):
    """Gram matrix with rows sharded across ``mesh[axis]``, ``Y`` replicated."""
    solver = _mesh_solver(mesh, solver)
    n = mesh.shape[axis]
    Xp, bx = _pad_rows(X, n)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis), P()), out_specs=P(axis))
    def run(x, y):
        return sig_gram(static_kernel, x, y, dyadic_order=dyadic_order,
                        sym=False, naive=naive, solver=solver,
                        max_batch=max_batch)

    K = run(Xp, Y)[:bx, :Y.shape[0]]
    if sym:
        K = 0.5 * (K + K.T)
    return K


def sharded_sig_mmd(static_kernel, X, Y, mesh: Mesh, dyadic_order=0,
                    naive=False, solver="auto", axis="data",
                    max_batch: Optional[int] = None):
    """Unbiased MMD^2 with row-sharded Grams and ``psum`` reductions.

    Each chip computes row-blocks of K(X,X), K(Y,Y), K(X,Y) against the
    replicated opposite operand, reduces locally, and ``psum``s the three
    statistics -- the full Gram never exists on one device.
    """
    solver = _mesh_solver(mesh, solver)
    n = mesh.shape[axis]
    m_x, m_y = X.shape[0], Y.shape[0]
    Xp, _ = _pad_rows(X, n)
    Yp, _ = _pad_rows(Y, n)
    rows_x = Xp.shape[0] // n
    rows_y = Yp.shape[0] // n

    kw = dict(dyadic_order=dyadic_order, sym=False, naive=naive,
              solver=solver, max_batch=max_batch)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(), P()), out_specs=P())
    def run(x_loc, y_loc, x_all, y_all):
        idx = lax.axis_index(axis)
        row0_x = idx * rows_x
        row0_y = idx * rows_y

        # valid-row masks for the padded tail
        rx = jnp.arange(rows_x) + row0_x
        ry = jnp.arange(rows_y) + row0_y
        mask_x = (rx < m_x).astype(x_loc.dtype)
        mask_y = (ry < m_y).astype(y_loc.dtype)

        K_xx = sig_gram(static_kernel, x_loc, x_all, **kw)  # (rows_x, m_x)
        K_yy = sig_gram(static_kernel, y_loc, y_all, **kw)  # (rows_y, m_y)
        K_xy = sig_gram(static_kernel, x_loc, y_all, **kw)  # (rows_x, m_y)

        K_xx = K_xx * mask_x[:, None]
        K_yy = K_yy * mask_y[:, None]
        K_xy = K_xy * mask_x[:, None]

        # local diagonal entries of the global Gram
        diag_xx = jnp.sum(K_xx * (jnp.arange(m_x)[None, :] == rx[:, None]))
        diag_yy = jnp.sum(K_yy * (jnp.arange(m_y)[None, :] == ry[:, None]))

        s_xx = lax.psum(jnp.sum(K_xx) - diag_xx, axis)
        s_yy = lax.psum(jnp.sum(K_yy) - diag_yy, axis)
        s_xy = lax.psum(jnp.sum(K_xy), axis)
        return jnp.stack([s_xx, s_yy, s_xy])

    s_xx, s_yy, s_xy = run(Xp, Yp, X, Y)
    return (s_xx / (m_x * (m_x - 1.0))
            + s_yy / (m_y * (m_y - 1.0))
            - 2.0 * s_xy / (m_x * m_y))


def sharded_sig_gram_2d(static_kernel, X, Y, mesh: Mesh, dyadic_order=0,
                        naive=False, solver="auto",
                        axes=("rows", "cols"),
                        max_batch: Optional[int] = None):
    """Gram matrix over a 2-D mesh: the ``(A, B)`` tile grid itself is
    sharded -- rows of X along ``axes[0]``, rows of Y along ``axes[1]`` --
    so each chip owns an ``(A/r, B/c)`` tile and nothing is replicated
    except the opposite operand's shard (the direct analogue of the
    reference CUDA backend's 2-D block grid, cuda_backend.py:124-125,
    across chips instead of SM blocks)."""
    solver = _mesh_solver(mesh, solver)
    ra, ca = axes
    r, c = mesh.shape[ra], mesh.shape[ca]
    Xp, bx = _pad_rows(X, r)
    Yp, by = _pad_rows(Y, c)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(ra), P(ca)), out_specs=P(ra, ca))
    def run(x, y):
        return sig_gram(static_kernel, x, y, dyadic_order=dyadic_order,
                        sym=False, naive=naive, solver=solver,
                        max_batch=max_batch)

    return run(Xp, Yp)[:bx, :by]


def sharded_sig_gram_lincomb(static_kernel, X, Y, W, mesh: Mesh,
                             dyadic_order=0, naive=False, solver="auto",
                             axis="data", grad_solver="auto",
                             pair_chunk: int = 128):
    """Scalar ``sum(W * Gram)`` with rows sharded across ``mesh[axis]``.

    The multi-chip version of the bounded-memory benchmark primitive
    (:func:`..sigkernel.sig_gram_lincomb`): each chip runs its own
    chunked eager-gradient scan over its row-block of the pair grid
    (one chunk's forward stack alive per chip) and the scalar is
    ``psum``-reduced across the mesh. Differentiable end to end: X-row grads
    stay sharded, Y/W grads flow through the replicated operands (AD of
    ``shard_map`` inserts the psum). The full Gram never exists anywhere.
    """
    from ..sigkernel import sig_gram_lincomb

    solver = _mesh_solver(mesh, solver)
    n = mesh.shape[axis]
    Xp, bx = _pad_rows(X, n)
    A_pad = Xp.shape[0]
    # zero weights for padded rows: exact no-ops in the lincomb
    Wp = jnp.zeros((A_pad, W.shape[1]), W.dtype).at[:W.shape[0]].set(W)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis), P(), P(axis)), out_specs=P())
    def run(x_loc, y_all, w_loc):
        s = sig_gram_lincomb(static_kernel, x_loc, y_all, w_loc,
                             dyadic_order=dyadic_order, naive=naive,
                             solver=solver, grad_solver=grad_solver,
                             pair_chunk=pair_chunk)
        return lax.psum(s, axis)

    return run(Xp, Y, Wp)
