"""Route-resolution matrix: one resolver, every route enumerated.

Part A pins ``ops.routes``: the platform predicate, the tier choice
(``"cuda"`` / ``"scan"``) under a stubbed platform, and the estimator
family choice. Part B runs the ``"cuda"`` tier's Python end to end on the
CPU with the FFI call replaced by the scan tier, which checks the custom
VJP's gradient rule and the layout of the adjoint launch's output against
the scan tier's own backward.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk
from sigkernel_jax.ops import gpu_wavefront, routes, scan_solver
from sigkernel_jax.ops import solve as solve_mod
from sigkernel_jax.utils import dyadic_refine


def _probe(rows, dtype, cols=5):
    return jax.ShapeDtypeStruct((2, rows, cols), dtype)


# ---------------------------------------------------------------------------
# Part A: the resolver mapping, enumerated
# ---------------------------------------------------------------------------

_F64_MAX = 232448 // 24 - 1           # three f64 diagonals of MM + 1 rows
_F32_MAX = min(232448 // 12 - 1, 32 * gpu_wavefront.MAX_THREADS)

_TIER_MATRIX = [
    # (on a GPU, solver, dtype, base rows, dyadic order, expected tier)
    (True, "auto", jnp.float64, 8, 1, "cuda"),
    (True, "auto", jnp.float32, 8, 1, "cuda"),
    (True, "auto", jnp.float64, _F64_MAX, 0, "cuda"),
    (True, "auto", jnp.float64, _F64_MAX + 1, 0, "scan"),
    (True, "auto", jnp.float64, _F64_MAX // 2 + 1, 1, "scan"),
    (True, "auto", jnp.float32, _F32_MAX, 0, "cuda"),
    (True, "auto", jnp.float32, _F32_MAX + 1, 0, "scan"),
    (True, "auto", jnp.float16, 8, 1, "scan"),
    (False, "auto", jnp.float64, 8, 1, "scan"),
    (False, "auto", jnp.float32, 8, 1, "scan"),
    (True, "scan", jnp.float64, 8, 1, "scan"),
    (True, "cuda", jnp.float64, 8, 1, "cuda"),
    (True, "cuda", jnp.float32, 8, 2, "cuda"),
]


@pytest.mark.parametrize("gpu,solver,dtype,rows,d,want", _TIER_MATRIX)
def test_tier_matrix(monkeypatch, gpu, solver, dtype, rows, d, want):
    monkeypatch.setattr(routes, "on_gpu", lambda device=None: gpu)
    assert routes.resolve_tier(solver, _probe(rows, dtype), d) == want


@pytest.mark.parametrize("gpu,solver,dtype,rows", [
    (False, "cuda", jnp.float64, 8),             # no GPU
    (True, "cuda", jnp.float64, _F64_MAX + 1),   # beyond shared memory
    (True, "cuda", jnp.float16, 8),              # dtype the kernel lacks
    (True, "pallas", jnp.float32, 8),            # removed tiers
    (True, "fused", jnp.float32, 8),
    (False, "bogus", jnp.float64, 8),
])
def test_tier_errors(monkeypatch, gpu, solver, dtype, rows):
    monkeypatch.setattr(routes, "on_gpu", lambda device=None: gpu)
    with pytest.raises(ValueError):
        routes.resolve_tier(solver, _probe(rows, dtype), 0)


def test_on_gpu_reads_the_platform():
    assert routes.on_gpu(types.SimpleNamespace(platform="gpu"))
    assert not routes.on_gpu(types.SimpleNamespace(platform="cpu"))
    assert not routes.on_gpu()          # the test process runs on the CPU


def test_mesh_solver_follows_the_mesh_devices():
    from sigkernel_jax.parallel.sharded import _mesh_solver

    cpu_mesh = types.SimpleNamespace(
        devices=np.array([types.SimpleNamespace(platform="cpu")]))
    gpu_mesh = types.SimpleNamespace(
        devices=np.array([types.SimpleNamespace(platform="gpu")]))
    assert _mesh_solver(cpu_mesh, "auto") == "scan"
    assert _mesh_solver(gpu_mesh, "auto") == "auto"
    assert _mesh_solver(cpu_mesh, "cuda") == "cuda"


@pytest.mark.parametrize("solver,grad_solver,want", [
    ("auto", "auto", "inc"),
    ("auto", "f32", "inc"),
    ("scan", "df64", "inc"),
    ("cuda", "auto", "inc"),
    ("df", "f32", "df"),
    ("df", "auto", "df_hybrid"),
    ("df", "df64", "df_hybrid"),
])
def test_family_matrix(solver, grad_solver, want):
    assert routes.resolve_family(solver, grad_solver) == want


def test_df_family_needs_a_df_kernel(rng):
    x = jnp.asarray(rng.normal(size=(2, 6, 2)))
    with pytest.raises(ValueError, match="LinearKernel and RBFKernel"):
        sk.sig_kernel(sk.RBF_SQR_Kernel(1.0, 1.0), x, x, solver="df")


# ---------------------------------------------------------------------------
# Part B: the cuda tier's Python, with the FFI call replaced by the scan tier
# ---------------------------------------------------------------------------

def _fake_kernel(monkeypatch, calls):
    """Stub the platform as a GPU and the kernel entry points by the scan
    tier, keeping their contracts (base increments in, refinement inside,
    adjoint output ``(..., 2, MM+1, NN+1)``)."""

    def final(inc, naive=False, dyadic_order=0):
        calls.append("final")
        return scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                       naive=naive)

    def grid(inc, naive=False, dyadic_order=0, adjoint=False):
        calls.append("adjoint" if adjoint else "grid")
        g = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order),
                                   naive=naive)
        if not adjoint:
            return g
        rev = jnp.flip(scan_solver.solve_grid(
            dyadic_refine(jnp.flip(inc, (-2, -1)), dyadic_order),
            naive=naive), (-2, -1))
        return jnp.stack([g, rev], axis=-3)

    monkeypatch.setattr(routes, "on_gpu", lambda device=None: True)
    monkeypatch.setattr(gpu_wavefront, "solve_final", final)
    monkeypatch.setattr(gpu_wavefront, "solve_grid", grid)


def _scan_value_and_grad(inc, dyadic, naive):
    return jax.value_and_grad(lambda i: solve_mod.solve(
        i, naive=naive, solver="scan", dyadic_order=dyadic).sum())(inc)


@pytest.mark.parametrize("dyadic,naive", [(0, False), (1, False), (2, True)])
def test_cuda_route_gradient_rule(rng, monkeypatch, dyadic, naive):
    inc = jnp.asarray(rng.normal(size=(3, 6, 5)) * 0.1)
    v0, g0 = _scan_value_and_grad(inc, dyadic, naive)
    calls = []
    _fake_kernel(monkeypatch, calls)
    v, g = jax.value_and_grad(lambda i: solve_mod.solve(
        i, naive=naive, solver="auto", dyadic_order=dyadic).sum())(inc)
    assert calls == ["final", "adjoint"]
    np.testing.assert_allclose(float(v), float(v0), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0), rtol=1e-12,
                               atol=1e-14)


def test_cuda_route_estimators_match_scan(rng, monkeypatch):
    """sig_kernel / sig_gram / lincomb gradients through the stubbed kernel
    path equal the scan tier's (asymmetric lengths 10 and 20)."""
    X = jnp.asarray(rng.normal(size=(3, 10, 2)).cumsum(1) * 0.1)
    Y = jnp.asarray(rng.normal(size=(3, 20, 2)).cumsum(1) * 0.1)
    W = jnp.asarray(rng.normal(size=(3, 3)))
    kern = sk.RBFKernel(0.5)

    def losses(solver):
        def f(x):
            return (sk.sig_kernel(kern, x, Y, 1, solver=solver).sum()
                    + sk.sig_gram(kern, x, Y, 1, solver=solver).sum()
                    + sk.sig_gram_lincomb(kern, x, Y, W, 1, solver=solver,
                                          pair_chunk=4))
        return jax.value_and_grad(f)(X)

    v0, g0 = losses("scan")
    calls = []
    _fake_kernel(monkeypatch, calls)
    v, g = losses("auto")
    assert "adjoint" in calls
    np.testing.assert_allclose(float(v), float(v0), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0), rtol=1e-11,
                               atol=1e-14)


def test_df_family_backward_on_cuda_tier(rng, monkeypatch):
    """solver='df' with the f64-grade backward recomputes through the
    'auto' tier, so on a GPU it reaches the kernel's adjoint."""
    X = jnp.asarray(rng.normal(size=(2, 6, 2)).cumsum(1) * 0.2)
    Y = jnp.asarray(rng.normal(size=(2, 7, 2)).cumsum(1) * 0.2)
    kern = sk.RBFKernel(1.0)

    def grad():
        return jax.grad(lambda x: sk.sig_kernel(
            kern, x, Y, 1, solver="df").sum())(X)

    g0 = grad()
    calls = []
    _fake_kernel(monkeypatch, calls)
    g = grad()
    assert "adjoint" in calls
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0), rtol=1e-12,
                               atol=1e-15)
