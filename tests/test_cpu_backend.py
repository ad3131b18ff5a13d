"""Native C++ OpenMP solver vs the numpy/scan oracles."""
import numpy as np
import jax.numpy as jnp
import pytest

from sigkernel_jax.ops import cpu_backend, scan_solver
from sigkernel_jax.naive import _solve_np

pytestmark = pytest.mark.skipif(
    not cpu_backend.available(),
    reason="native solver not built (python setup.py build_native)")


@pytest.mark.parametrize("naive", [True, False])
@pytest.mark.parametrize("shape", [(3, 12, 17), (2, 1, 1), (4, 30, 8)])
def test_native_matches_numpy_oracle(rng, naive, shape):
    inc = rng.normal(size=shape) * 0.1
    got = cpu_backend.solve_grid_np(inc, naive)
    want = _solve_np(inc, naive)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_native_f32(rng):
    inc = (rng.normal(size=(2, 20, 20)) * 0.1).astype(np.float32)
    got = cpu_backend.solve_grid_np(inc)
    assert got.dtype == np.float32
    want = _solve_np(inc.astype(np.float64), False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_native_derivatives(rng):
    inc = rng.normal(size=(3, 15, 22)) * 0.1
    inc_d = rng.normal(size=(3, 15, 22)) * 0.1
    inc_dd = rng.normal(size=(3, 15, 22)) * 0.1
    k, d, s = cpu_backend.solve_derivatives_final_np(inc, inc_d, inc_dd)
    k2, d2, s2 = scan_solver.solve_derivatives_final(
        jnp.asarray(inc), jnp.asarray(inc_d), jnp.asarray(inc_dd))
    np.testing.assert_allclose(k, np.asarray(k2), rtol=1e-12)
    np.testing.assert_allclose(d, np.asarray(d2), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(s, np.asarray(s2), rtol=1e-11, atol=1e-12)


def test_native_callback_under_jit(rng):
    import jax
    inc = jnp.asarray(rng.normal(size=(2, 9, 9)) * 0.1)
    out = jax.jit(lambda x: cpu_backend.solve_grid_callback(x))(inc)
    want = _solve_np(np.asarray(inc), False)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-13)
