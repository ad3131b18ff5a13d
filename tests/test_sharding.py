"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk
from sigkernel_jax.parallel import (make_mesh, sharded_sig_kernel,
                                    sharded_sig_gram, sharded_sig_mmd)

from conftest import make_paths


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh()


def test_sharded_kernel_matches_local(rng, mesh):
    X = jnp.asarray(make_paths(rng, 16, 8, 2))
    Y = jnp.asarray(make_paths(rng, 16, 9, 2))
    k = sk.RBFKernel(0.5)
    local = np.asarray(sk.sig_kernel(k, X, Y, dyadic_order=1))
    dist = np.asarray(sharded_sig_kernel(k, X, Y, mesh, dyadic_order=1))
    np.testing.assert_allclose(dist, local, rtol=1e-12)


def test_sharded_kernel_unaligned_batch(rng, mesh):
    X = jnp.asarray(make_paths(rng, 11, 6, 2))  # not divisible by 8
    Y = jnp.asarray(make_paths(rng, 11, 6, 2))
    k = sk.LinearKernel()
    local = np.asarray(sk.sig_kernel(k, X, Y))
    dist = np.asarray(sharded_sig_kernel(k, X, Y, mesh))
    np.testing.assert_allclose(dist, local, rtol=1e-12)


def test_sharded_gram_matches_local(rng, mesh):
    X = jnp.asarray(make_paths(rng, 10, 7, 2))
    Y = jnp.asarray(make_paths(rng, 6, 8, 2))
    k = sk.RBFKernel(1.0)
    local = np.asarray(sk.sig_gram(k, X, Y, dyadic_order=0))
    dist = np.asarray(sharded_sig_gram(k, X, Y, mesh, dyadic_order=0))
    np.testing.assert_allclose(dist, local, rtol=1e-12)


def test_sharded_mmd_matches_local(rng, mesh):
    X = jnp.asarray(make_paths(rng, 9, 7, 2))
    Y = jnp.asarray(make_paths(rng, 13, 7, 2))
    k = sk.RBFKernel(0.5)
    local = float(sk.sig_mmd(k, X, Y, dyadic_order=0))
    dist = float(sharded_sig_mmd(k, X, Y, mesh, dyadic_order=0))
    np.testing.assert_allclose(dist, local, rtol=1e-10)


def test_sharded_mmd_grad(rng, mesh):
    X = jnp.asarray(make_paths(rng, 8, 6, 2))
    Y = jnp.asarray(make_paths(rng, 8, 6, 2))
    k = sk.RBFKernel(0.5)

    g_dist = jax.grad(
        lambda x: sharded_sig_mmd(k, x, Y, mesh, dyadic_order=0))(X)
    g_local = jax.grad(
        lambda x: sk.sig_mmd(k, x, Y, dyadic_order=0, max_batch=None))(X)
    np.testing.assert_allclose(np.asarray(g_dist), np.asarray(g_local),
                               rtol=1e-9, atol=1e-12)


def test_sharded_gram_2d_matches_local(rng):
    from sigkernel_jax.parallel import make_mesh, sharded_sig_gram_2d
    mesh2d = make_mesh(axis_names=("rows", "cols"), shape=(2, 4))
    X = jnp.asarray(make_paths(rng, 6, 7, 2))
    Y = jnp.asarray(make_paths(rng, 10, 8, 2))
    k = sk.RBFKernel(0.5)
    local = np.asarray(sk.sig_gram(k, X, Y, dyadic_order=1))
    dist = np.asarray(sharded_sig_gram_2d(k, X, Y, mesh2d, dyadic_order=1))
    np.testing.assert_allclose(dist, local, rtol=1e-12)


def test_striped_solve_matches_single_device(rng, mesh):
    """Sequence parallelism: grid rows striped across the 8-device mesh,
    bottom boundary rows halo-exchanged chip-to-chip (SURVEY S5's long-path
    mechanism). Must equal the single-device sweep bit-exactly -- the same
    stripe recurrences run in the same order on the same inputs."""
    from sigkernel_jax.parallel import striped_solve_final
    from sigkernel_jax.ops import scan_solver

    inc = jnp.asarray(rng.normal(size=(4, 64, 24)) * 0.05)
    local = np.asarray(scan_solver.solve_final(inc))
    dist = np.asarray(striped_solve_final(inc, mesh=jax.sharding.Mesh(
        jax.devices()[:8], ("data",))))
    np.testing.assert_array_equal(dist, local)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_striped_solve_dyadic_chunks(rng, mesh, chunks):
    """Per-chip lazy dyadic refinement + pair-chunk pipelining: each chip
    holds only its *base* stripe; refined rows exist one stripe at a time.
    The result equals the single-device sweep (scan_solver.solve_stripe
    semantics)."""
    from sigkernel_jax.parallel import striped_solve_final
    from sigkernel_jax.ops import scan_solver
    from sigkernel_jax.utils import dyadic_refine

    inc = jnp.asarray(rng.normal(size=(4, 16, 10)) * 0.1)
    local = np.asarray(scan_solver.solve_final(dyadic_refine(inc, 1)))
    dist = np.asarray(striped_solve_final(inc, mesh=jax.sharding.Mesh(
        jax.devices()[:8], ("data",)), dyadic_order=1, chunks=chunks))
    np.testing.assert_allclose(dist, local, rtol=1e-12)


def test_striped_solve_naive_scheme(rng, mesh):
    from sigkernel_jax.parallel import striped_solve_final
    from sigkernel_jax.ops import scan_solver

    inc = jnp.asarray(rng.normal(size=(2, 32, 12)) * 0.1)
    local = np.asarray(scan_solver.solve_final(inc, naive=True))
    dist = np.asarray(striped_solve_final(inc, mesh=jax.sharding.Mesh(
        jax.devices()[:8], ("data",)), naive=True))
    np.testing.assert_array_equal(dist, local)


def test_sharded_lincomb_matches_single_device(rng, mesh):
    """Row-sharded sig_gram_lincomb == the single-device scalar, and the
    sharded gradient (through shard_map + the per-chip eager chunk scans)
    == the single-device gradient."""
    import sigkernel_jax as sk
    from sigkernel_jax.parallel import sharded_sig_gram_lincomb
    from sigkernel_jax.sigkernel import sig_gram_lincomb

    X = jnp.asarray(make_paths(rng, 11, 6, 2, scale=0.5))  # pads to 16
    Y = jnp.asarray(make_paths(rng, 5, 7, 2, scale=0.5))
    W = jnp.asarray(rng.normal(size=(11, 5)))
    k = sk.RBFKernel(0.9)
    want = sig_gram_lincomb(k, X, Y, W, dyadic_order=1, pair_chunk=4)
    got = sharded_sig_gram_lincomb(k, X, Y, W, mesh, dyadic_order=1,
                                   pair_chunk=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)

    gw = jax.grad(lambda x: sig_gram_lincomb(
        k, x, Y, W, dyadic_order=1, pair_chunk=4))(X)
    gg = jax.grad(lambda x: sharded_sig_gram_lincomb(
        k, x, Y, W, mesh, dyadic_order=1, pair_chunk=4))(X)
    np.testing.assert_allclose(np.asarray(gg), np.asarray(gw), rtol=1e-9,
                               atol=1e-12)


def test_sharded_lincomb_jit_all_grads_match(rng, mesh):
    """Jitted grad of the row-sharded lincomb w.r.t. EVERY operand ==
    single-device. Pins the mixed varying-manual-axes custom_vjp typing
    (X/W sharded, Y and the kernel hyperparameter replicated): the bwd
    must psum replicated-operand cotangents across shards exactly once
    (no per-scan-step collective, no double count), and the sigma
    cotangent must come back with the primal's (invariant) vma."""
    import sigkernel_jax as sk
    from sigkernel_jax.parallel import sharded_sig_gram_lincomb
    from sigkernel_jax.sigkernel import sig_gram_lincomb

    X = jnp.asarray(make_paths(rng, 8, 6, 2, scale=0.5))
    Y = jnp.asarray(make_paths(rng, 5, 7, 2, scale=0.5))
    W = jnp.asarray(rng.normal(size=(8, 5)))

    def sharded(sig, x, y, w):
        return sharded_sig_gram_lincomb(sk.RBFKernel(sig), x, y, w, mesh,
                                        dyadic_order=1, pair_chunk=4)

    def local(sig, x, y, w):
        return sig_gram_lincomb(sk.RBFKernel(sig), x, y, w,
                                dyadic_order=1, pair_chunk=4)

    sig = jnp.asarray(0.9)
    gs = jax.jit(jax.grad(sharded, argnums=(0, 1, 2, 3)))(sig, X, Y, W)
    gl = jax.jit(jax.grad(local, argnums=(0, 1, 2, 3)))(sig, X, Y, W)
    for name, a, b in zip(("dsigma", "dX", "dY", "dW"), gs, gl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
