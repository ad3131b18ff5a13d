"""Sequence parallelism: one huge PDE grid striped across the mesh.

A refined grid is cut into horizontal stripes; each stripe is an ordinary
wavefront whose north boundary is the previous stripe's bottom solution
row (:func:`..ops.scan_solver.solve_stripe`). This module shards that
stripe sweep across a device mesh: device ``k`` holds only stripe ``k`` of
the increment grid and, when its turn in the wavefront pipeline comes,
sweeps it and sends its bottom boundary row to device ``k+1``
(``lax.ppermute`` halo exchange).

Memory per device is one stripe -- a path-length budget that scales
linearly with the device count. The stages are truly data-dependent
(stripe ``k`` cannot start before ``k-1``'s bottom row arrives), so a
single solve is a pipeline fill. Throughput parallelism comes from
pipelining pair chunks (`chunks > 1`): device ``k`` sweeps chunk ``c``
while device ``k+1`` sweeps chunk ``c-1`` -- the classic pipeline schedule,
efficiency ``chunks / (chunks + n_devices - 1)``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import scan_solver
from ..utils import dyadic_refine


def _stripe_sweep(stripe_inc, bd, naive, dyadic_order):
    """One device's stripe: refine locally, sweep, return the bottom row.

    ``stripe_inc``: (B, Mb_local, Nb) *base* increments of this device's
    stripe. ``bd``: (B, NN + 1) refined north boundary. Returns (B, NN + 1).
    """
    ref = dyadic_refine(stripe_inc, dyadic_order)
    return scan_solver.solve_stripe(ref, bd, naive=naive)


def striped_solve_final(inc, mesh: Mesh, naive: bool = False,
                        dyadic_order: int = 0, axis: str = "data",
                        chunks: int = 1):
    """Solve ``K[..., -1, -1]`` with grid *rows* sharded across ``mesh[axis]``.

    ``inc``: (B, Mb, Nb) base increments; the row axis must be divisible by
    ``n_devices``. ``chunks`` splits the pair axis into pipeline stages so
    all chips do useful work in steady state; B must be divisible by it.

    Matches the single-device scan solve bit-exactly: the stripe
    recurrences are evaluated in the same order with the same inputs.
    """
    n = mesh.shape[axis]
    B, Mb, Nb = inc.shape
    if Mb % n:
        raise ValueError(
            f"striped_solve_final: row axis {Mb} must divide over the "
            f"{n}-device mesh axis {axis!r}")
    if B % chunks:
        raise ValueError(f"pair axis {B} must divide into {chunks} chunks")
    f = 2 ** dyadic_order
    NN = Nb * f
    Bc = B // chunks
    n_stages = chunks + n - 1

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis, None),), out_specs=P())
    def run(inc_local):
        idx = lax.axis_index(axis)

        def stage(carry, s):
            bd_in, acc = carry
            # this chip works on pair chunk c = s - idx (when in range)
            c = s - idx
            live = (c >= 0) & (c < chunks)
            c_idx = jnp.clip(c, 0, chunks - 1)
            chunk = lax.dynamic_slice_in_dim(inc_local, c_idx * Bc, Bc,
                                             axis=0)
            # fresh solves start from the constant-1 north boundary on
            # chip 0; later chips use the ppermuted bottom row
            ones_bd = jnp.ones_like(bd_in)
            bd_use = jnp.where(idx == 0, ones_bd, bd_in)
            bottom = _stripe_sweep(chunk, bd_use, naive, dyadic_order)
            bottom = jnp.where(live, bottom, bd_in)
            # the last chip's live bottom row carries chunk c's answer
            # (jnp.where, not lax.cond: the branches' varying-manual-axes
            # types differ under shard_map)
            done = live & (idx == n - 1)
            upd = lax.dynamic_update_slice_in_dim(
                acc, bottom[:, NN], c_idx * Bc, axis=0)
            acc = jnp.where(done, upd, acc)
            # halo exchange: bottom row k -> chip k+1 (ring; chip 0's
            # incoming value is ignored -- it always restarts from ones)
            bd_next = lax.ppermute(
                bottom, axis, [(i, (i + 1) % n) for i in range(n)])
            return (bd_next, acc), None

        # derive carry inits from inc_local so they inherit the varying
        # manual-axes type under shard_map (see scan_solver._sweep)
        z = jnp.zeros_like(inc_local[0, 0, 0])
        bd0 = z + jnp.ones((Bc, NN + 1), inc_local.dtype)
        acc0 = z + jnp.zeros((B,), inc_local.dtype)
        (_, acc), _ = lax.scan(stage, (bd0, acc0),
                               jnp.arange(n_stages, dtype=jnp.int32))
        # result lives on the last chip; broadcast it
        return lax.psum(jnp.where(idx == n - 1, acc, jnp.zeros_like(acc)),
                        axis)

    return run(inc)
