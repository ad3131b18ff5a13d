"""Adjoint (custom_vjp) gradient checks.

Two layers of validation:
1. Exact: the custom_vjp must reproduce the variation-of-parameters formula
   ``dK/dinc[a,b] = K[a,b] * K_rev_flipped[a+1,b+1]`` computed independently
   with the numpy oracle (this is the reference's backward spec,
   reference sigkernel/sigkernel.py:256-343).
2. Approximate: against finite differences of the full discrete pipeline.
   The adjoint is the *continuous* gradient, so agreement improves with grid
   refinement; we check a loose tolerance and monotone improvement.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sigkernel_jax.ops.solve import solve
from sigkernel_jax.naive import _solve_np
from sigkernel_jax import RBFKernel, LinearKernel, sig_kernel, sig_mmd

from conftest import make_paths


def _adjoint_oracle(inc, naive):
    K = _solve_np(inc, naive)
    Kr = _solve_np(inc[..., ::-1, ::-1], naive)
    Krf = Kr[..., ::-1, ::-1]
    return K[..., :-1, :-1] * Krf[..., 1:, 1:]


@pytest.mark.parametrize("naive", [True, False])
def test_vjp_matches_adjoint_oracle(rng, naive):
    inc = rng.normal(size=(3, 7, 10)) * 0.1
    g = jax.grad(lambda u: solve(u, naive, "scan").sum())(jnp.asarray(inc))
    want = _adjoint_oracle(inc, naive)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-12, atol=1e-12)


def test_grad_flows_to_both_paths(rng):
    """Unlike the reference (X only), grads flow to X and Y."""
    X = jnp.asarray(make_paths(rng, 2, 6, 3))
    Y = jnp.asarray(make_paths(rng, 2, 8, 3))
    k = RBFKernel(1.0)

    def loss(x, y):
        return sig_kernel(k, x, y, dyadic_order=0).sum()

    gx, gy = jax.grad(loss, argnums=(0, 1))(X, Y)
    assert np.all(np.isfinite(gx)) and np.all(np.isfinite(gy))
    assert np.abs(gx).max() > 0 and np.abs(gy).max() > 0


def _fd_grad(f, X, eps=1e-6):
    g = np.zeros_like(X)
    it = np.nditer(X, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        Xp = X.copy(); Xp[idx] += eps
        Xm = X.copy(); Xm[idx] -= eps
        g[idx] = (f(Xp) - f(Xm)) / (2 * eps)
        it.iternext()
    return g


def test_grad_vs_finite_differences_converges(rng):
    X = make_paths(rng, 2, 5, 2, scale=0.5)
    Y = make_paths(rng, 2, 5, 2, scale=0.5)
    k = LinearKernel()

    errs = []
    for d in (0, 2):
        def loss(x):
            return float(sig_kernel(k, jnp.asarray(x), jnp.asarray(Y),
                                    dyadic_order=d).sum())

        g_ad = np.asarray(jax.grad(
            lambda x: sig_kernel(k, x, jnp.asarray(Y), dyadic_order=d).sum()
        )(jnp.asarray(X)))
        g_fd = _fd_grad(loss, X)
        errs.append(np.abs(g_ad - g_fd).max() / np.abs(g_fd).max())

    # adjoint == continuous gradient: discrete FD agreement improves with
    # refinement, and is already decent at dyadic_order=2
    assert errs[1] < errs[0]
    assert errs[1] < 2e-2


# ---------------------------------------------------------------------------
# FD checks on the PRODUCTION routes: the double-float families (solver="df"
# with the f32-grade and the f64-grade backward), and, on a GPU, the CUDA
# wavefront tier. Ground truth is central finite differences of each route's
# own forward; agreement with the adjoint improves with dyadic refinement.
# ---------------------------------------------------------------------------

def _fd_convergence(X64, Y, dtype, d_orders, **kw):
    k = RBFKernel(1.0)
    errs = []
    for d in d_orders:
        f = jax.jit(lambda x: sig_kernel(
            k, x.astype(dtype), Y, dyadic_order=d, max_batch=None,
            **kw).sum())
        g_ad = np.asarray(jax.grad(f)(jnp.asarray(X64)), np.float64)
        eps = 3e-4 if dtype == jnp.float32 else 1e-6
        g_fd = _fd_grad(lambda x: float(f(jnp.asarray(x))), X64, eps=eps)
        errs.append(np.abs(g_ad - g_fd).max() / np.abs(g_fd).max())
    return errs


@pytest.mark.parametrize("family,grad_solver,tol", [
    ("df", "f32", 8e-2),
    ("df_hybrid", "auto", 8e-2),
])
def test_fd_grad_production_routes(rng, family, grad_solver, tol):
    from sigkernel_jax.ops.routes import resolve_family

    assert resolve_family("df", grad_solver) == family
    X64 = make_paths(rng, 1, 4, 2, scale=0.5)
    Y = jnp.asarray(make_paths(rng, 1, 5, 2, scale=0.5))
    errs = _fd_convergence(X64, Y, jnp.float64, (1, 2), solver="df",
                           grad_solver=grad_solver)

    # the adjoint is the continuous gradient: at these very coarse grids
    # the FD gap is discretisation-dominated (~5e-2), so the check is
    # CONVERGENCE with refinement plus a coarse bound -- route bugs (sign,
    # scaling, indexing) produce O(1) errors, which this catches; tight
    # route equivalence lives in tests/test_routes.py
    assert errs[1] < tol, errs
    assert errs[1] < errs[0], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_fd_grad_cuda_route(rng, dtype):
    """The CUDA wavefront tier's value and adjoint against finite
    differences (needs the card: the kernel has no CPU mode)."""
    X64 = make_paths(rng, 1, 4, 2, scale=0.5)
    Y = jnp.asarray(make_paths(rng, 1, 5, 2, scale=0.5), dtype)
    errs = _fd_convergence(X64, Y, dtype, (1, 2), solver="cuda")
    assert errs[1] < 8e-2, errs
    assert errs[1] < errs[0], errs


def test_mmd_grad_finite(rng):
    X = jnp.asarray(make_paths(rng, 4, 6, 2))
    Y = jnp.asarray(make_paths(rng, 5, 6, 2))
    k = RBFKernel(0.5)
    g = jax.grad(lambda x: sig_mmd(k, x, Y, dyadic_order=1))(X)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.abs(np.asarray(g)).max() > 0
