"""Hypothesis test + SigCHSIC tests."""
import numpy as np
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk

from conftest import make_paths


def test_c_alpha():
    np.testing.assert_allclose(sk.c_alpha(100, 0.99),
                               4.0 * np.sqrt(-np.log(0.99) / 100))


def test_hypothesis_test_same_distribution(rng):
    X = jnp.asarray(make_paths(rng, 10, 8, 2))
    Y = jnp.asarray(make_paths(rng, 10, 8, 2))
    rejected, stat, c = sk.hypothesis_test(X, Y, sk.RBFKernel(1.0),
                                           verbose=False)
    assert not rejected  # same generator, should accept
    assert np.isfinite(float(stat)) and c > 0


def test_hypothesis_test_different_distribution(rng):
    X = jnp.asarray(make_paths(rng, 12, 8, 2, scale=0.2))
    Y = jnp.asarray(make_paths(rng, 12, 8, 2, scale=3.0))
    rejected, stat, c = sk.hypothesis_test(X, Y, sk.RBFKernel(1.0),
                                           verbose=False)
    assert float(stat) > 0


def test_sig_chsic_runs(rng):
    X = jnp.asarray(make_paths(rng, 6, 6, 2))
    Y = jnp.asarray(make_paths(rng, 6, 6, 2))
    Z = jnp.asarray(make_paths(rng, 6, 6, 2))
    v = sk.sig_chsic(X, Y, Z, sk.RBFKernel(1.0), dyadic_order=0)
    assert np.isfinite(float(v))
    # alias parity with the reference name
    v2 = sk.SigCHSIC(X, Y, Z, sk.RBFKernel(1.0), dyadic_order=0)
    np.testing.assert_allclose(float(v), float(v2))


def test_sig_chsic_detects_dependence(rng):
    """CHSIC(X, X-copy | Z) should exceed CHSIC(X, indep | Z)."""
    X = jnp.asarray(make_paths(rng, 8, 6, 2))
    Z = jnp.asarray(make_paths(rng, 8, 6, 2))
    W = jnp.asarray(make_paths(rng, 8, 6, 2))
    k = sk.RBFKernel(1.0)
    dep = float(sk.sig_chsic(X, X, Z, k, dyadic_order=0))
    indep = float(sk.sig_chsic(X, W, Z, k, dyadic_order=0))
    assert dep > indep


def test_stats_accept_sigkernel_wrapper(rng):
    """hypothesis_test/sig_chsic accept a whole SigKernel (unwrapping its
    static kernel + dyadic order) as well as the reference's static-kernel
    signature."""
    import sigkernel_jax as sk

    X = jnp.asarray(rng.normal(size=(4, 6, 2)).cumsum(1) * 0.3)
    Y = jnp.asarray(rng.normal(size=(3, 6, 2)).cumsum(1) * 0.3)
    ker = sk.RBFKernel(0.5)
    s = sk.SigKernel(ker, dyadic_order=1)
    r1 = sk.hypothesis_test(X, Y, ker, dyadic_order=1, verbose=False)
    r2 = sk.hypothesis_test(X, Y, s, verbose=False)
    assert r1[0] == r2[0]
    np.testing.assert_allclose(float(r1[1]), float(r2[1]), rtol=1e-12)
    c1 = sk.sig_chsic(X[:3], Y, Y, ker, dyadic_order=1)
    c2 = sk.sig_chsic(X[:3], Y, Y, s)
    np.testing.assert_allclose(float(c1), float(c2), rtol=1e-12)
