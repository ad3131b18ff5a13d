"""The CUDA wavefront tier (``ops/gpu_wavefront.py``).

The kernel has no CPU mode, so the CPU tests cover what surrounds it: the
shapes and batching of the FFI call (checked by lowering for the CUDA
platform, which needs no card), the degenerate length-1 grid, the build
key, and the traced types under ``shard_map``. Tests marked ``gpu`` run
the kernel itself against the scan tier on the card.
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

import sigkernel_jax as sk
from sigkernel_jax.ops import gpu_wavefront, routes, scan_solver
from sigkernel_jax.ops import solve as solve_mod
from sigkernel_jax.utils import dyadic_refine


@pytest.fixture
def no_build(monkeypatch):
    """Lowering needs no library: keep the build out of the CPU tests."""
    monkeypatch.setattr(gpu_wavefront, "load", lambda: None)


def _lower_cuda(fn, *avals):
    return jax.jit(fn).trace(*avals).lower(lowering_platforms=("cuda",))


def _custom_calls(lowered):
    return [l for l in lowered.as_text().splitlines()
            if "custom_call @" + gpu_wavefront.TARGET in l]


@pytest.mark.parametrize("mode,adjoint,d,shape,want", [
    ("final", False, 1, (4, 9, 19), (4,)),
    ("grid", False, 1, (4, 9, 19), (4, 19, 39)),
    ("grid", True, 2, (3, 5, 7), (3, 2, 21, 29)),
    ("final", False, 0, (2, 3, 4, 6), (2, 3)),
])
def test_ffi_call_shapes(no_build, mode, adjoint, d, shape, want):
    aval = jax.ShapeDtypeStruct(shape, jnp.float64)
    if mode == "final":
        fn = functools.partial(gpu_wavefront.solve_final, dyadic_order=d)
    else:
        fn = functools.partial(gpu_wavefront.solve_grid, dyadic_order=d,
                               adjoint=adjoint)
    assert jax.eval_shape(fn, aval).shape == want
    calls = _custom_calls(_lower_cuda(fn, aval))
    assert len(calls) == 1
    assert f"dyadic_order = {d} : i32" in calls[0]
    assert f"mode = {0 if mode == 'final' else 2 if adjoint else 1}" in calls[0]


def test_ffi_call_batches_under_vmap(no_build):
    """vmap folds into the call's leading (batch) dimensions: one launch."""
    aval = jax.ShapeDtypeStruct((5, 3, 6, 8), jnp.float32)
    fn = jax.vmap(lambda i: gpu_wavefront.solve_grid(i, False, 1,
                                                     adjoint=True))
    assert jax.eval_shape(fn, aval).shape == (5, 3, 2, 13, 17)
    calls = _custom_calls(_lower_cuda(fn, aval))
    assert len(calls) == 1 and "tensor<5x3x6x8xf32>" in calls[0]


def test_degenerate_length_one_grid_needs_no_kernel(monkeypatch):
    def fail():
        raise AssertionError("the kernel must not be launched")

    monkeypatch.setattr(gpu_wavefront, "load", fail)
    inc = jnp.zeros((3, 0, 4))
    np.testing.assert_array_equal(gpu_wavefront.solve_final(inc), np.ones(3))
    g = gpu_wavefront.solve_grid(inc, dyadic_order=1, adjoint=True)
    assert g.shape == (3, 2, 1, 9)
    np.testing.assert_array_equal(g, 1.0)


def test_solve_on_cuda_tier_lowers_one_launch_each_way(no_build,
                                                        monkeypatch):
    """The custom VJP on the cuda tier: the forward is one final-value
    launch and the backward one adjoint launch (both sweeps), with no
    scan left in the program."""
    monkeypatch.setattr(routes, "on_gpu", lambda device=None: True)
    aval = jax.ShapeDtypeStruct((4, 7, 9), jnp.float64)

    def vg(i):
        return jax.value_and_grad(lambda j: solve_mod.solve(
            j, dyadic_order=1).sum())(i)

    out = jax.eval_shape(vg, aval)
    assert out[1].shape == aval.shape
    lowered = _lower_cuda(vg, aval)
    calls = _custom_calls(lowered)
    assert sorted(c.split("mode = ")[1][0] for c in calls) == ["0", "2"]
    assert "stablehlo.while" not in lowered.as_text()


def test_cuda_tier_traces_under_shard_map(no_build, monkeypatch):
    """The FFI result carries its input's varying manual axes, so the
    sharded lincomb's custom VJPs type-check on the cuda tier."""
    from sigkernel_jax.parallel import make_mesh, sharded_sig_gram_lincomb

    monkeypatch.setattr(routes, "on_gpu", lambda device=None: True)
    mesh = make_mesh(devices=jax.devices()[:4])
    X = jax.ShapeDtypeStruct((8, 6, 2), jnp.float64)
    Y = jnp.zeros((4, 7, 2))
    W = jnp.ones((8, 4))
    kern = sk.RBFKernel(1.0)
    jaxpr = jax.make_jaxpr(jax.value_and_grad(
        lambda x: sharded_sig_gram_lincomb(kern, x, Y, W, mesh,
                                           dyadic_order=1, solver="cuda",
                                           pair_chunk=4)))(X)
    assert "ffi_call" in str(jaxpr)


def test_library_path_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(gpu_wavefront, "SOURCE", str(src))
    monkeypatch.setattr(gpu_wavefront, "BUILD_DIR", str(tmp_path / "build"))
    a = gpu_wavefront.library_path()
    assert os.path.dirname(a) == str(tmp_path / "build")
    src.write_text("// b\n")
    b = gpu_wavefront.library_path()
    monkeypatch.setattr(gpu_wavefront, "NVCC_FLAGS",
                        gpu_wavefront.NVCC_FLAGS + ("-lineinfo",))
    c = gpu_wavefront.library_path()
    assert len({a, b, c}) == 3


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(gpu_wavefront, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        gpu_wavefront.build()
    assert os.listdir(tmp_path) == []      # nothing half-written


def test_committed_source_is_packaged():
    assert os.path.exists(gpu_wavefront.SOURCE)
    with open(gpu_wavefront.SOURCE) as f:
        assert "XLA_FFI_DEFINE_HANDLER_SYMBOL(SigWavefront" in f.read()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("d,naive,shape", [
    (0, False, (3, 7, 12)), (1, True, (3, 12, 7)), (2, False, (2, 1, 9)),
])
def test_kernel_matches_scan_bitwise(rng, dtype, d, naive, shape):
    inc = jnp.asarray(rng.normal(size=shape) * 0.2, dtype)
    ref = scan_solver.solve_grid(dyadic_refine(inc, d), naive=naive)
    rev = jnp.flip(scan_solver.solve_grid(
        dyadic_refine(jnp.flip(inc, (-2, -1)), d), naive=naive), (-2, -1))
    both = gpu_wavefront.solve_grid(inc, naive, d, adjoint=True)
    np.testing.assert_array_equal(gpu_wavefront.solve_final(inc, naive, d),
                                  ref[:, -1, -1])
    np.testing.assert_array_equal(gpu_wavefront.solve_grid(inc, naive, d),
                                  ref)
    np.testing.assert_array_equal(both[:, 0], ref)
    np.testing.assert_array_equal(both[:, 1], rev)


@pytest.mark.gpu
def test_kernel_gradient_matches_scan(rng):
    inc = jnp.asarray(rng.normal(size=(4, 9, 13)) * 0.1)

    def vg(solver):
        return jax.value_and_grad(lambda i: solve_mod.solve(
            i, solver=solver, dyadic_order=1).sum())(inc)

    (v, g), (v0, g0) = vg("cuda"), vg("scan")
    np.testing.assert_allclose(float(v), float(v0), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0), rtol=1e-12)
