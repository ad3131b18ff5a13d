"""sig_gram_lincomb: chunked eager-gradient Gram linear combination.

Values and every gradient (X, Y, W, kernel hyperparameters) must match the
direct ``sum(W * sig_gram(...))`` formulation at any chunk size; the sym
triangle packing must match the full Gram; the chunked sig_mmd must match
the direct one.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk
from sigkernel_jax.sigkernel import sig_gram_lincomb, sig_gram, sig_mmd

from conftest import make_paths


@pytest.fixture
def data(rng):
    X = jnp.asarray(make_paths(rng, 5, 6, 2, scale=0.6))
    Y = jnp.asarray(make_paths(rng, 4, 7, 2, scale=0.6))
    W = jnp.asarray(rng.normal(size=(5, 4)))
    return X, Y, W


def _direct(kern, x, y, w):
    K = sig_gram(kern, x, y, dyadic_order=1, max_batch=None)
    return jnp.sum(w * K)


@pytest.mark.parametrize("chunk", [3, 20, 128])
def test_lincomb_value_matches_direct(data, chunk):
    X, Y, W = data
    k = sk.RBFKernel(1.0)
    s = sig_gram_lincomb(k, X, Y, W, dyadic_order=1, pair_chunk=chunk)
    np.testing.assert_allclose(float(s), float(_direct(k, X, Y, W)),
                               rtol=1e-12)


def test_lincomb_grads_match_direct(data):
    X, Y, W = data
    k = sk.RBFKernel(1.0)
    ga = jax.grad(lambda x, y, w: sig_gram_lincomb(
        k, x, y, w, dyadic_order=1, pair_chunk=3), argnums=(0, 1, 2))(X, Y, W)
    gd = jax.grad(_direct, argnums=(1, 2, 3))(k, X, Y, W)
    for a, d in zip(ga, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(d), rtol=1e-9,
                                   atol=1e-12)
    # kernel hyperparameter gradient flows through the chunked scan too
    gk = jax.grad(lambda kern: sig_gram_lincomb(
        kern, X, Y, W, dyadic_order=1, pair_chunk=3))(k)
    gkd = jax.grad(lambda kern: _direct(kern, X, Y, W))(k)
    np.testing.assert_allclose(np.asarray(jax.tree.leaves(gk)),
                               np.asarray(jax.tree.leaves(gkd)), rtol=1e-9)


def test_lincomb_sym_triangle(data, rng):
    X, _, _ = data
    k = sk.RBFKernel(1.0)
    Wx = jnp.asarray(rng.normal(size=(X.shape[0], X.shape[0])))
    s_sym = sig_gram_lincomb(k, X, X, Wx, dyadic_order=1, sym=True,
                             pair_chunk=4)
    K = sig_gram(k, X, X, dyadic_order=1, max_batch=None)
    np.testing.assert_allclose(float(s_sym), float(jnp.sum(Wx * K)),
                               rtol=1e-12)
    g_sym = jax.grad(lambda x: sig_gram_lincomb(
        k, x, x, Wx, dyadic_order=1, sym=True, pair_chunk=4))(X)
    g_dir = jax.grad(lambda x: jnp.sum(Wx * sig_gram(
        k, x, x, dyadic_order=1, max_batch=None)))(X)
    np.testing.assert_allclose(np.asarray(g_sym), np.asarray(g_dir),
                               rtol=1e-9, atol=1e-12)
    gW = jax.grad(lambda w: sig_gram_lincomb(
        k, X, X, w, dyadic_order=1, sym=True, pair_chunk=4))(Wx)
    gWd = jax.grad(lambda w: jnp.sum(w * sig_gram(
        k, X, X, dyadic_order=1, max_batch=None)))(Wx)
    np.testing.assert_allclose(np.asarray(gW), np.asarray(gWd), rtol=1e-9,
                               atol=1e-12)


def test_lincomb_sym_shape_mismatch_raises(data):
    X, Y, W = data
    with pytest.raises(ValueError):
        sig_gram_lincomb(sk.RBFKernel(1.0), X, Y, W, sym=True)


def test_mmd_chunked_matches_direct(rng):
    """sig_mmd's lincomb path (batch > max_batch) == the direct path,
    values AND gradients."""
    X = jnp.asarray(make_paths(rng, 6, 6, 2, scale=0.6))
    Y = jnp.asarray(make_paths(rng, 5, 6, 2, scale=0.6))
    k = sk.RBFKernel(0.8)
    kw = dict(dyadic_order=1)
    direct = sig_mmd(k, X, Y, max_batch=100, **kw)
    chunked = sig_mmd(k, X, Y, max_batch=2, pair_chunk=7, **kw)
    np.testing.assert_allclose(float(chunked), float(direct), rtol=1e-12)
    gd = jax.grad(lambda x: sig_mmd(k, x, Y, max_batch=100, **kw))(X)
    gc = jax.grad(lambda x: sig_mmd(k, x, Y, max_batch=2, pair_chunk=7,
                                    **kw))(X)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(gd), rtol=1e-9,
                               atol=1e-12)


def test_lincomb_jits(data):
    X, Y, W = data
    k = sk.RBFKernel(1.0)
    f = jax.jit(lambda x: sig_gram_lincomb(k, x, Y, W, dyadic_order=1,
                                           pair_chunk=6))
    v, g = jax.value_and_grad(f)(X)
    assert np.isfinite(float(v)) and np.all(np.isfinite(np.asarray(g)))


def test_scoring_rules_chunked_match_direct(rng):
    from sigkernel_jax.sigkernel import (sig_scoring_rule,
                                         sig_expected_scoring_rule)

    X = jnp.asarray(make_paths(rng, 6, 6, 2, scale=0.6))
    y = jnp.asarray(make_paths(rng, 4, 6, 2, scale=0.6))
    k = sk.RBFKernel(0.8)
    for fn in (sig_scoring_rule, sig_expected_scoring_rule):
        direct = fn(k, X, y, dyadic_order=1, max_batch=100)
        chunked = fn(k, X, y, dyadic_order=1, max_batch=2, pair_chunk=5)
        np.testing.assert_allclose(float(chunked), float(direct),
                                   rtol=1e-12)
        gd = jax.grad(lambda x: fn(k, x, y, dyadic_order=1,
                                   max_batch=100))(X)
        gc = jax.grad(lambda x: fn(k, x, y, dyadic_order=1, max_batch=2,
                                   pair_chunk=5))(X)
        np.testing.assert_allclose(np.asarray(gc), np.asarray(gd),
                                   rtol=1e-9, atol=1e-12)
