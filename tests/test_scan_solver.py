"""Scan solver vs the naive numpy oracle (the semantic spec)."""
import numpy as np
import jax.numpy as jnp
import pytest

from sigkernel_jax.ops import scan_solver
from sigkernel_jax.naive import _solve_np
from sigkernel_jax.utils import increment_grid
from sigkernel_jax.kernels import RBFKernel, LinearKernel

from conftest import make_paths


@pytest.mark.parametrize("naive", [True, False])
@pytest.mark.parametrize("shape", [(3, 9, 9), (3, 10, 15), (2, 15, 10),
                                   (1, 1, 1), (2, 1, 7), (4, 2, 2)])
def test_solve_final_matches_oracle(rng, naive, shape):
    inc = rng.normal(size=shape) * 0.1
    got = np.asarray(scan_solver.solve_final(jnp.asarray(inc), naive=naive))
    want = _solve_np(inc, naive)[..., -1, -1]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("naive", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 8), (2, 7, 12), (2, 12, 7)])
def test_solve_grid_matches_oracle(rng, naive, shape):
    inc = rng.normal(size=shape) * 0.1
    got = np.asarray(scan_solver.solve_grid(jnp.asarray(inc), naive=naive))
    want = _solve_np(inc, naive)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_gram_shaped_batch_dims(rng):
    """Solver must handle arbitrary leading batch dims (A, B, MM, NN)."""
    inc = rng.normal(size=(2, 3, 6, 9)) * 0.1
    got = np.asarray(scan_solver.solve_final(jnp.asarray(inc)))
    want = _solve_np(inc, False)[..., -1, -1]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_skew_unskew_roundtrip(rng):
    MM, NN = 7, 11
    inc = rng.normal(size=(2, MM, NN))
    sk = scan_solver.skew_increments(jnp.asarray(inc))
    assert sk.shape == (MM + NN - 1, 2, MM + 1)
    # every increment appears exactly once in the skewed layout
    assert np.isclose(np.abs(np.asarray(sk)).sum(),
                      np.abs(inc).sum())


def test_zero_increments_give_one(rng):
    """Zero increment is an exact no-op for both schemes (padding safety)."""
    inc = jnp.zeros((2, 5, 8))
    for naive in (True, False):
        out = np.asarray(scan_solver.solve_final(inc, naive=naive))
        np.testing.assert_array_equal(out, np.ones((2,)))


def test_transpose_covariance(rng):
    """K(inc^T) == K(inc)^T exactly (used by the sym=True Gram path)."""
    inc = rng.normal(size=(4, 9, 6)) * 0.2
    a = np.asarray(scan_solver.solve_grid(jnp.asarray(inc)))
    b = np.asarray(scan_solver.solve_grid(jnp.asarray(inc).transpose(0, 2, 1)))
    np.testing.assert_array_equal(a, b.transpose(0, 2, 1))


@pytest.mark.parametrize("dyadic_order", [0, 1, 2])
def test_increment_grid_refinement(rng, dyadic_order):
    """Refined solve equals oracle on the refined grid, and converges."""
    X = make_paths(rng, 2, 6, 3)
    Y = make_paths(rng, 2, 9, 3)
    G = RBFKernel(0.5).batch_kernel(jnp.asarray(X), jnp.asarray(Y))
    inc = increment_grid(G, dyadic_order)
    f = 2 ** dyadic_order
    assert inc.shape == (2, f * 5, f * 8)
    got = np.asarray(scan_solver.solve_final(inc))
    want = _solve_np(np.asarray(inc), False)[..., -1, -1]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_dyadic_convergence(rng):
    """Higher dyadic order converges towards a limit (sanity)."""
    X = make_paths(rng, 2, 8, 2)
    G = LinearKernel().batch_kernel(jnp.asarray(X), jnp.asarray(X))
    vals = []
    for d in range(4):
        inc = increment_grid(G, d)
        vals.append(np.asarray(scan_solver.solve_final(inc)))
    d01 = np.abs(vals[1] - vals[0]).max()
    d23 = np.abs(vals[3] - vals[2]).max()
    assert d23 < d01


def test_sig_loss_naive_matches_distance():
    """SigLoss_naive oracle == sig_distance on the same inputs."""
    import jax.numpy as jnp
    from conftest import make_paths
    import sigkernel_jax as sk
    from sigkernel_jax import naive

    rng = np.random.default_rng(7)
    X = make_paths(rng, 3, 8, 2)
    Y = make_paths(rng, 3, 8, 2)
    kernel = sk.RBFKernel(1.0)
    want = float(sk.sig_distance(kernel, jnp.asarray(X), jnp.asarray(Y),
                                 dyadic_order=1))
    got = float(naive.SigLoss_naive(kernel, dyadic_order=1)(X, Y))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_reference_name_shims():
    """Every public reference symbol resolves to a working counterpart."""
    import jax.numpy as jnp
    from conftest import make_paths
    import sigkernel_jax as sk
    from sigkernel_jax import naive, utils

    rng = np.random.default_rng(3)
    X = make_paths(rng, 2, 7, 2)
    Y = make_paths(rng, 2, 7, 2)
    kernel = sk.RBFKernel(1.0)

    # naive family, reference argument order
    k1 = naive.SigKernel_naive(X, Y, kernel, 1)
    np.testing.assert_allclose(k1, naive.sig_kernel_naive(X, Y, kernel, 1))
    G = naive.SigKernelGramMat_naive(X, Y, kernel)
    assert G.shape == (2, 2)
    m = naive.SigMMD_naive(kernel, dyadic_order=1)(X, Y)
    np.testing.assert_allclose(float(m),
                               float(naive.sig_mmd_naive(X, Y, kernel, 1)))

    # k_kgrad, reference argument order + FD default
    K, Kd, Kdd = sk.k_kgrad(jnp.asarray(X), jnp.asarray(Y),
                            jnp.asarray(0.1 * X), 1, kernel)
    assert K.shape == (2, 2)

    # grid utils
    a = jnp.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(np.asarray(utils.flip(a, 1)),
                                  np.asarray(a)[:, ::-1])
    t = utils.tile(a, 1, 2)
    np.testing.assert_array_equal(np.asarray(t)[0], [0, 0, 1, 1, 2, 2])
