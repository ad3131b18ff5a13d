"""Double-float (paired-f32) increment pipeline vs the f64 oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sigkernel_jax as sk
from sigkernel_jax.ops import df32, df_prep
from sigkernel_jax.utils import double_difference

from conftest import make_paths


def test_df32_exp_accuracy(rng):
    # the pipeline contract: RBF exponents are <= 0, G in [0, 1]; absolute
    # accuracy at that scale (plus ~1e-13 relative everywhere, the order-10
    # Taylor tail) is what the 1e-10 end-to-end budget needs -- see the
    # _EXP_ORDER note in df32.py
    x = jnp.asarray(rng.uniform(-80, 3, size=(4000,)))
    got = np.asarray(df32.to_f64(df32.exp_(df32.from_f64(x))))
    want = np.exp(np.asarray(x))
    neg = np.asarray(x) <= 0
    assert np.abs(got - want)[neg].max() < 1e-12
    m = want > 1e-6
    assert (np.abs(got - want)[m] / want[m]).max() < 5e-13


def test_df32_exp_matches_legacy_taylor(rng):
    # the fast (8x-fine reduction, hybrid DF/f32 tail) exp_ must stay within
    # the legacy full-DF Taylor's accuracy envelope -- both ~1e-13 of f64
    x = jnp.asarray(rng.uniform(-90, 3, size=(5000,)))
    fast = np.asarray(df32.to_f64(df32.exp_(df32.from_f64(x))))
    legacy = np.asarray(df32.to_f64(df32.exp_taylor_(df32.from_f64(x))))
    want = np.exp(np.asarray(x))
    m = want > 1e-6
    assert (np.abs(fast - want)[m] / want[m]).max() < 5e-13
    assert (np.abs(fast - legacy)[m] / want[m]).max() < 1e-12


def test_df32_cancelling_add(rng):
    a = jnp.asarray(rng.normal(size=(1000,)))
    b = -a + 1e-9 * jnp.asarray(rng.normal(size=(1000,)))
    s = np.asarray(df32.to_f64(df32.add_(df32.from_f64(a), df32.from_f64(b))))
    assert np.abs(s - np.asarray(a + b)).max() < 1e-13


@pytest.mark.parametrize("gram", [False, True])
def test_rbf_increments_match_f64(rng, gram):
    X = jnp.asarray(make_paths(rng, 3, 12, 3))
    Y = jnp.asarray(make_paths(rng, 3, 9, 3))
    sigma = 0.8
    got = np.asarray(df32.to_f64(
        df_prep.rbf_increments_df(X, Y, sigma, gram)))
    k = sk.RBFKernel(sigma)
    G = k.Gram_matrix(X, Y) if gram else k.batch_kernel(X, Y)
    want = np.asarray(double_difference(G))
    # increments are ~1e-3 scale here; absolute accuracy is what the solve
    # consumes
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-13, rtol=0)


@pytest.mark.parametrize("gram", [False, True])
def test_linear_increments_match_f64(rng, gram):
    X = jnp.asarray(make_paths(rng, 3, 10, 2))
    Y = jnp.asarray(make_paths(rng, 3, 14, 2))
    got = np.asarray(df32.to_f64(
        df_prep.linear_increments_df(X, Y, 1.3, gram)))
    k = sk.LinearKernel(1.3)
    G = k.Gram_matrix(X, Y) if gram else k.batch_kernel(X, Y)
    want = np.asarray(double_difference(G))
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)


@pytest.mark.parametrize("kernel", [sk.RBFKernel(1.0), sk.LinearKernel(0.9)])
@pytest.mark.parametrize("dyadic_order", [0, 1])
def test_solver_df_matches_scan_f64(rng, kernel, dyadic_order):
    """End-to-end solver='df' == f64 scan tier to ~1e-12 (CPU fallback runs
    the same DF prep, then the scan solve on the combined increments)."""
    X = jnp.asarray(make_paths(rng, 4, 11, 3))
    Y = jnp.asarray(make_paths(rng, 4, 11, 3))
    a = np.asarray(sk.sig_kernel(kernel, X, Y, dyadic_order=dyadic_order,
                                 solver="df"))
    b = np.asarray(sk.sig_kernel(kernel, X, Y, dyadic_order=dyadic_order,
                                 solver="scan"))
    np.testing.assert_allclose(a, b, rtol=1e-11)
    Ga = np.asarray(sk.sig_gram(kernel, X, Y, dyadic_order=dyadic_order,
                                solver="df"))
    Gb = np.asarray(sk.sig_gram(kernel, X, Y, dyadic_order=dyadic_order,
                                solver="scan"))
    np.testing.assert_allclose(Ga, Gb, rtol=1e-11)


def test_solver_df_rejects_unsupported_kernel(rng):
    X = jnp.asarray(make_paths(rng, 2, 6, 2))
    with pytest.raises(ValueError, match="solver='df'"):
        sk.sig_kernel(sk.RBF_ID_Kernel(1.0), X, X, solver="df")


def test_solver_df_gradients_match_scan(rng):
    """f32-grade DF backward vs the exact f64 scan adjoint: the documented
    gradient contract (~1e-6 relative, reference-quality)."""
    X = jnp.asarray(make_paths(rng, 3, 9, 2))
    Y = jnp.asarray(make_paths(rng, 3, 9, 2))
    kernel = sk.RBFKernel(1.0)

    def loss(solver):
        return lambda x: sk.sig_gram(kernel, x, Y, dyadic_order=1,
                                     solver=solver).sum()

    g_df = np.asarray(jax.grad(loss("df"))(X))
    g_scan = np.asarray(jax.grad(loss("scan"))(X))
    scale = np.abs(g_scan).max()
    np.testing.assert_allclose(g_df, g_scan, atol=2e-5 * scale, rtol=0)


def test_solver_df_sigma_gradient(rng):
    """The DF path differentiates the RBF bandwidth too (reference cannot)."""
    X = jnp.asarray(make_paths(rng, 2, 8, 2))
    Y = jnp.asarray(make_paths(rng, 2, 8, 2))

    def loss(sigma, solver):
        return sk.sig_kernel(sk.RBFKernel(sigma), X, Y, dyadic_order=1,
                             solver=solver).sum()

    g_df = float(jax.grad(loss)(jnp.float64(0.9), "df"))
    g_scan = float(jax.grad(loss)(jnp.float64(0.9), "scan"))
    np.testing.assert_allclose(g_df, g_scan, rtol=1e-4)


def test_grad_solver_df64_full_precision(rng):
    """grad_solver='df64' gradients == scan-tier f64 adjoint exactly (the
    same grid route runs underneath on CPU)."""
    X = jnp.asarray(make_paths(rng, 3, 8, 2))
    Y = jnp.asarray(make_paths(rng, 3, 8, 2))
    kernel = sk.RBFKernel(1.0)

    def loss(gs):
        return lambda x: sk.sig_kernel(kernel, x, Y, dyadic_order=1,
                                       solver="scan", grad_solver=gs).sum()

    g_a = np.asarray(jax.grad(loss("auto"))(X))
    g_b = np.asarray(jax.grad(loss("df64"))(X))
    np.testing.assert_allclose(g_a, g_b, rtol=1e-12)


def test_grad_solver_validation(rng):
    X = jnp.asarray(make_paths(rng, 2, 6, 2))
    with pytest.raises(ValueError, match="grad_solver"):
        sk.sig_kernel(sk.RBFKernel(1.0), X, X, grad_solver="bogus")


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.float64])
def test_rbf_dd_vjp_matches_autodiff(rng, gram, dt):
    """The hand-fused increment-chain VJP == jax.vjp of the naive
    composition, at the compute dtype's own grade, for both pair layouts
    and a non-trivial sigma (incl. the sigma cotangent)."""
    from sigkernel_jax.utils import dd_transpose

    B, M, N, d = 3, 8, 9, 2
    X = jnp.asarray(rng.normal(size=(B, M, d)), dt)
    Y = jnp.asarray(rng.normal(size=(B, N, d)), dt)
    sigma = 1.3
    kernel = sk.RBFKernel(sigma)

    def inc_fn(sk_, x_, y_):
        G = (sk_.Gram_matrix(x_, y_) if gram else sk_.batch_kernel(x_, y_))
        return double_difference(G)

    inc, vjp = jax.vjp(inc_fn, kernel, X, Y)
    ct = jnp.asarray(rng.normal(size=inc.shape), dt)
    dk, dx, dy = vjp(ct)
    ds2, dx2, dy2 = df_prep.rbf_dd_vjp(X, Y, sigma, ct, gram)

    tol = 1e-5 if dt == jnp.float32 else 1e-13
    scale = float(jnp.max(jnp.abs(dx))) + 1e-30
    np.testing.assert_allclose(np.asarray(dx2), np.asarray(dx),
                               atol=tol * scale)
    np.testing.assert_allclose(np.asarray(dy2), np.asarray(dy),
                               atol=tol * float(jnp.max(jnp.abs(dy))))
    np.testing.assert_allclose(float(ds2), float(dk.sigma),
                               rtol=1e-4 if dt == jnp.float32 else 1e-12)

    # dd_transpose == the transpose of double_difference
    G = jnp.asarray(rng.normal(size=(B, M, N)), dt)
    ct3 = jnp.asarray(rng.normal(size=(B, M - 1, N - 1)), dt)
    _, ddv = jax.vjp(double_difference, G)
    want = np.asarray(ddv(ct3)[0])
    np.testing.assert_allclose(np.asarray(dd_transpose(ct3)), want,
                               atol=1e-6 * np.abs(want).max())
