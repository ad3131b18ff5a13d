"""SigKernel API / estimator tests vs the naive oracles."""
import numpy as np
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk
from sigkernel_jax import naive

from conftest import make_paths


@pytest.fixture
def kernel():
    return sk.RBFKernel(0.5)


@pytest.mark.parametrize("dyadic_order", [0, 1])
@pytest.mark.parametrize("naive_solver", [True, False])
def test_compute_kernel_vs_naive(rng, kernel, dyadic_order, naive_solver):
    X = jnp.asarray(make_paths(rng, 5, 10, 2))
    Y = jnp.asarray(make_paths(rng, 5, 20, 2))
    sig = sk.SigKernel(kernel, dyadic_order, _naive_solver=naive_solver)
    got = np.asarray(sig.compute_kernel(X, Y))
    want = naive.sig_kernel_naive(X, Y, kernel, dyadic_order, naive_solver)
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("lx,ly", [(8, 8), (6, 11)])
def test_compute_gram_vs_naive(rng, kernel, lx, ly):
    X = jnp.asarray(make_paths(rng, 4, lx, 3))
    Y = jnp.asarray(make_paths(rng, 6, ly, 3))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    got = np.asarray(sig.compute_Gram(X, Y))
    want = naive.sig_gram_naive(X, Y, kernel, 0, False)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gram_sym(rng, kernel):
    X = jnp.asarray(make_paths(rng, 5, 8, 2))
    sig = sk.SigKernel(kernel, dyadic_order=1)
    K = np.asarray(sig.compute_Gram(X, X, sym=True))
    np.testing.assert_array_equal(K, K.T)
    K_full = np.asarray(sig.compute_Gram(X, X, sym=False))
    np.testing.assert_allclose(K, K_full, rtol=1e-12)


def test_max_batch_chunking_matches_unchunked(rng, kernel):
    X = jnp.asarray(make_paths(rng, 7, 8, 2))
    Y = jnp.asarray(make_paths(rng, 7, 9, 2))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    full = np.asarray(sig.compute_kernel(X, Y, max_batch=100))
    chunked = np.asarray(sig.compute_kernel(X, Y, max_batch=3))
    np.testing.assert_allclose(chunked, full, rtol=1e-12)

    g_full = np.asarray(sig.compute_Gram(X, Y, max_batch=100))
    g_chunk = np.asarray(sig.compute_Gram(X, Y, max_batch=3))
    np.testing.assert_allclose(g_chunk, g_full, rtol=1e-12)


def test_mmd_vs_naive(rng, kernel):
    X = jnp.asarray(make_paths(rng, 5, 7, 2))
    Y = jnp.asarray(make_paths(rng, 6, 7, 2))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    got = float(sig.compute_mmd(X, Y))
    want = float(naive.sig_mmd_naive(X, Y, kernel, 0, False))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_distance_and_scoring_rules(rng, kernel):
    X = jnp.asarray(make_paths(rng, 4, 7, 2))
    Y = jnp.asarray(make_paths(rng, 4, 7, 2))
    y1 = jnp.asarray(make_paths(rng, 1, 7, 2))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    d = float(sig.compute_distance(X, Y))
    assert np.isfinite(d)
    s = float(sig.compute_scoring_rule(X, y1))
    assert np.isfinite(s)
    es = float(sig.compute_expected_scoring_rule(X, Y))
    assert np.isfinite(es)
    # expected scoring rule with a single y equals the scoring rule
    np.testing.assert_allclose(
        float(sig.compute_expected_scoring_rule(X, y1)), s, rtol=1e-12)


def test_kernel_and_derivatives_gram(rng, kernel):
    X = jnp.asarray(make_paths(rng, 3, 6, 2))
    Y = jnp.asarray(make_paths(rng, 4, 6, 2))
    gamma = jnp.asarray(make_paths(rng, 3, 6, 2))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    K, Kd, Kdd = sig.compute_kernel_and_derivatives_Gram(X, Y, gamma)
    assert K.shape == (3, 4) and Kd.shape == (3, 4) and Kdd.shape == (3, 4)
    # K must agree with the plain Gram computed with the *naive* base scheme?
    # No: the fused solver uses the higher-order scheme for K (reference
    # cuda_backend.py:206). Check against compute_Gram default scheme.
    K_plain = sig.compute_Gram(X, Y)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_plain), rtol=1e-10)

    # analytic (jvp) vs the reference's eps-FD mode
    K2, Kd2, Kdd2 = sig.compute_kernel_and_derivatives_Gram(
        X, Y, gamma, eps=1e-4)
    np.testing.assert_allclose(np.asarray(K2), np.asarray(K), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(Kd2), np.asarray(Kd),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(Kdd2), np.asarray(Kdd),
                               rtol=1e-2, atol=1e-4)


def test_kernel_and_derivatives_gram_max_batch_tiles(rng, kernel):
    """max_batch tiling == the untiled result exactly (replaces the
    reference's recursive quadtree, sigkernel.py:56-88), including ragged
    tile edges on both batch axes."""
    X = jnp.asarray(make_paths(rng, 5, 6, 2))
    Y = jnp.asarray(make_paths(rng, 3, 6, 2))
    gamma = jnp.asarray(make_paths(rng, 5, 6, 2))
    sig = sk.SigKernel(kernel, dyadic_order=1)
    full = sig.compute_kernel_and_derivatives_Gram(X, Y, gamma,
                                                   max_batch=None)
    tiled = sig.compute_kernel_and_derivatives_Gram(X, Y, gamma, max_batch=2)
    for a, b in zip(tiled, full):
        assert a.shape == (5, 3)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_derivatives_match_fd_of_kernel(rng, kernel):
    """First directional derivative ~ FD of the kernel along gamma."""
    X = jnp.asarray(make_paths(rng, 2, 6, 2))
    Y = jnp.asarray(make_paths(rng, 3, 6, 2))
    gamma = jnp.asarray(make_paths(rng, 2, 6, 2))
    sig = sk.SigKernel(kernel, dyadic_order=0)
    _, Kd, Kdd = sig.compute_kernel_and_derivatives_Gram(X, Y, gamma)
    eps = 1e-5
    Kp = np.asarray(sig.compute_Gram(X + eps * gamma, Y))
    Km = np.asarray(sig.compute_Gram(X - eps * gamma, Y))
    K0 = np.asarray(sig.compute_Gram(X, Y))
    fd1 = (Kp - Km) / (2 * eps)
    fd2 = (Kp - 2 * K0 + Km) / (eps * eps)
    np.testing.assert_allclose(np.asarray(Kd), fd1, rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(Kdd), fd2, rtol=5e-2, atol=1e-3)


def test_longpath_stress_config(rng, kernel):
    """BASELINE.json stress shape (scaled down in batch): dyadic_order=2
    exceeds any per-thread grid limit the reference CUDA backend had."""
    X = jnp.asarray(make_paths(rng, 2, 40, 5))
    y = jnp.asarray(make_paths(rng, 1, 40, 5))
    s = sk.sig_scoring_rule(kernel, X, y, dyadic_order=2, max_batch=None)
    assert np.isfinite(float(s))


def test_solver_explicit_scan_matches_auto(rng, kernel):
    X = jnp.asarray(make_paths(rng, 3, 7, 2))
    a = np.asarray(sk.sig_kernel(kernel, X, X, solver="auto"))
    b = np.asarray(sk.sig_kernel(kernel, X, X, solver="scan"))
    np.testing.assert_allclose(a, b, rtol=1e-12)


def test_length_bucketing_is_exact(rng, kernel):
    """Padding by repeating the final point is an exact no-op."""
    X = jnp.asarray(make_paths(rng, 3, 11, 2))
    Y = jnp.asarray(make_paths(rng, 3, 13, 2))
    a = np.asarray(sk.sig_kernel(kernel, X, Y, dyadic_order=1))
    b = np.asarray(sk.sig_kernel(kernel, X, Y, dyadic_order=1,
                                 length_bucket=16))
    np.testing.assert_allclose(b, a, rtol=1e-12)
    ga = np.asarray(sk.sig_gram(kernel, X, Y))
    gb = np.asarray(sk.sig_gram(kernel, X, Y, length_bucket=8))
    np.testing.assert_allclose(gb, ga, rtol=1e-12)


def test_length_one_paths_are_boundary(rng, kernel):
    """Length-1 paths give the degenerate (0, 0) increment grid: K == 1.

    Regression: the solve() batch flattening used an inferred -1, which
    cannot be derived when a trailing dim is zero (ZeroDivisionError).
    """
    X = jnp.asarray(make_paths(rng, 4, 10, 3))
    k = np.asarray(sk.sig_kernel(kernel, X[:, :1, :], X[:, :1, :]))
    np.testing.assert_allclose(k, np.ones(4), rtol=0)
    G = np.asarray(sk.sig_gram(kernel, X[:, :1, :], X[:, :1, :]))
    np.testing.assert_allclose(G, np.ones((4, 4)), rtol=0)


def test_sym_gram_block_triangle_multiblock(rng, kernel):
    """Block-triangle sym Gram == full Gram across block-count regimes,
    and gradients flow through the mirrored blocks."""
    X = jnp.asarray(make_paths(rng, 7, 9, 2))
    full = np.asarray(sk.sig_gram(kernel, X, X, sym=False, max_batch=None))
    for mb in (None, 3, 7, 100):
        got = np.asarray(sk.sig_gram(kernel, X, X, sym=True, max_batch=mb))
        np.testing.assert_allclose(got, 0.5 * (full + full.T), rtol=1e-10)
        np.testing.assert_allclose(got, got.T, rtol=0)
    import jax
    g = jax.grad(lambda x: sk.sig_gram(kernel, x, x, sym=True,
                                       max_batch=3).sum())(X)
    assert np.isfinite(np.asarray(g)).all()
