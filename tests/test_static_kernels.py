"""Static kernels vs direct numpy formulas."""
import numpy as np
import jax.numpy as jnp
import pytest

from sigkernel_jax import (LinearKernel, RBFKernel, RBF_CEXP_Kernel,
                           RBF_SQR_Kernel, Linear_ID_Kernel, RBF_ID_Kernel,
                           CEXP)

from conftest import make_paths


def test_linear_batch_and_gram(rng):
    X = make_paths(rng, 3, 5, 4)
    Y = make_paths(rng, 3, 7, 4)
    k = LinearKernel(scale=2.0)
    got_b = np.asarray(k.batch_kernel(jnp.asarray(X), jnp.asarray(Y)))
    want_b = 4.0 * np.einsum("bpk,bqk->bpq", X, Y)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-12)

    got_g = np.asarray(k.Gram_matrix(jnp.asarray(X), jnp.asarray(Y)))
    want_g = 4.0 * np.einsum("ipk,jqk->ijpq", X, Y)
    # NOTE: divergence from reference (static_kernels.py:33 ignores scale in
    # the Gram path); we apply scale^2 consistently.
    np.testing.assert_allclose(got_g, want_g, rtol=1e-12)


def test_rbf_batch_and_gram(rng):
    X = make_paths(rng, 2, 5, 3)
    Y = make_paths(rng, 2, 6, 3)
    sigma = 0.7
    k = RBFKernel(sigma)
    got = np.asarray(k.batch_kernel(jnp.asarray(X), jnp.asarray(Y)))
    want = np.exp(-np.sum(
        (X[:, :, None, :] - Y[:, None, :, :]) ** 2, -1) / sigma)
    np.testing.assert_allclose(got, want, rtol=1e-12)

    got_g = np.asarray(k.Gram_matrix(jnp.asarray(X), jnp.asarray(Y)))
    want_g = np.exp(-np.sum(
        (X[:, None, :, None, :] - Y[None, :, None, :, :]) ** 2, -1) / sigma)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-12)


def test_functional_kernels_shapes(rng):
    # functional data: (batch, length_t, length_x, dim)
    F = rng.normal(size=(2, 6, 8, 3))
    Fj = jnp.asarray(F)
    for k in (RBF_CEXP_Kernel(1.0, 0.5, n_freqs=4),
              RBF_SQR_Kernel(1.0, 2.0),
              Linear_ID_Kernel(),
              RBF_ID_Kernel(0.5)):
        b = k.batch_kernel(Fj, Fj)
        assert b.shape == (2, 6, 6)
        g = k.Gram_matrix(Fj, Fj)
        assert g.shape == (2, 2, 6, 6)
        assert np.all(np.isfinite(np.asarray(b)))
        assert np.all(np.isfinite(np.asarray(g)))


def test_cexp_linear_operator(rng):
    """CEXP is linear in X."""
    F1 = jnp.asarray(rng.normal(size=(1, 3, 10, 2)))
    F2 = jnp.asarray(rng.normal(size=(1, 3, 10, 2)))
    a = np.asarray(CEXP(F1 + F2, n_freqs=3, sigma=1.0))
    b = np.asarray(CEXP(F1, n_freqs=3, sigma=1.0) +
                   CEXP(F2, n_freqs=3, sigma=1.0))
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_rbf_id_equals_rbf_on_flattened(rng):
    F = rng.normal(size=(2, 4, 5, 2))
    flat = F.reshape(2, 4, 10)
    a = np.asarray(RBF_ID_Kernel(0.9).batch_kernel(jnp.asarray(F), jnp.asarray(F)))
    b = np.asarray(RBFKernel(0.9).batch_kernel(jnp.asarray(flat), jnp.asarray(flat)))
    np.testing.assert_allclose(a, b, rtol=1e-12)
