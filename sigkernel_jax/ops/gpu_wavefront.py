"""CUDA wavefront solver (``csrc/wavefront.cu``) called through ``jax.ffi``.

The kernel is the GPU tier of the Goursat solve: one thread block per path
pair, the three live anti-diagonals in shared memory, dyadic refinement
read on the fly from the *base* increment grid. It serves the forward value
(:func:`solve_final`) and the full solution grid (:func:`solve_grid`); with
``adjoint=True`` one launch also sweeps the reversed increments and writes
that grid flipped back, which is what the variation-of-parameters backward
in :mod:`.solve` multiplies.

The shared library is compiled from the committed source with ``nvcc`` on
first use into ``<repo>/build/``, keyed by a hash of the source and flags,
and registered as the FFI target ``sigkernel_wavefront`` for the CUDA
platform. A failed build or load raises: callers never fall back silently.
A CUDA kernel has no interpret mode, so off the GPU only the Python around
it (shapes, batching, the shared-memory bound, the route choice) runs; the
arithmetic is checked on the card against :mod:`.scan_solver`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

TARGET = "sigkernel_wavefront"
SHARED_BYTES = 232448   # one block's shared memory on Hopper
MAX_THREADS = 1024      # threads per block; rows per thread fill the rest
_MAX_RPT = 32           # rows per thread the library is compiled for

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "wavefront.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
# -fmad=false: no multiply-add contraction, so the kernel evaluates each
# scheme in the scan tier's operation order and agrees with it bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# seconds the last build took in this process (0.0 when the keyed library
# already existed); set by :func:`build`
build_seconds = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA wavefront kernel needs "
                           "the CUDA toolkit to build")
    return path


def library_path() -> str:
    """Build artefact path, keyed by the source and the compiler flags."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsigwavefront-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless the keyed artefact exists."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        build_seconds = 0.0
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
           SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("building the CUDA wavefront kernel failed:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=1)
def load() -> str:
    """Build (if needed), load and register the FFI target once per process.
    Returns the library path."""
    path = build()
    lib = ctypes.cdll.LoadLibrary(path)
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SigWavefront),
                                platform="CUDA")
    return path


def refined_rows(inc_shape, dyadic_order: int) -> int:
    return inc_shape[-2] * 2 ** dyadic_order


def supported(inc, dyadic_order: int) -> bool:
    """Does the kernel take these increments? f32/f64, and three diagonals
    of the refined grid within one block's shared memory (9,684 refined
    rows in f64, 19,369 in f32); longer grids take the scan tier."""
    dtype = jnp.dtype(inc.dtype)
    if dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        return False
    MM = refined_rows(inc.shape, dyadic_order)
    return (3 * (MM + 1) * dtype.itemsize <= SHARED_BYTES
            and MM <= _MAX_RPT * MAX_THREADS)


def _call(inc, out_shape, naive, dyadic_order, mode):
    load()
    out = jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct(out_shape, inc.dtype),
        vmap_method="broadcast_all")(
            inc, dyadic_order=np.int32(dyadic_order),
            naive=np.int32(bool(naive)), mode=np.int32(mode),
            max_threads=np.int32(MAX_THREADS))
    # under shard_map the result varies over the same mesh axes as `inc`
    vma = tuple(sorted(getattr(jax.typeof(inc), "vma", ()) or ()))
    return jax.lax.pcast(out, vma, to="varying") if vma else out


def solve_final(inc, naive: bool = False, dyadic_order: int = 0):
    """``K[..., -1, -1]`` for base increments ``inc`` of shape
    ``(..., Mb, Nb)``, refined by ``2^dyadic_order`` in the kernel."""
    batch = inc.shape[:-2]
    if inc.shape[-2] == 0 or inc.shape[-1] == 0:
        return jnp.ones(batch, inc.dtype)   # length-1 path: K is the boundary
    return _call(inc, batch, naive, dyadic_order, 0)


def solve_grid(inc, naive: bool = False, dyadic_order: int = 0,
               adjoint: bool = False):
    """Refined solution grid ``(..., MM + 1, NN + 1)``.

    With ``adjoint`` the result is ``(..., 2, MM + 1, NN + 1)``: index 0 is
    the grid of ``inc``, index 1 is ``flip(solve(flip(inc)))``, the reverse
    sweep of the adjoint, both from one launch.
    """
    batch = inc.shape[:-2]
    f = 2 ** dyadic_order
    grid = (inc.shape[-2] * f + 1, inc.shape[-1] * f + 1)
    shape = batch + ((2,) if adjoint else ()) + grid
    if inc.shape[-2] == 0 or inc.shape[-1] == 0:
        return jnp.ones(shape, inc.dtype)
    return _call(inc, shape, naive, dyadic_order, 2 if adjoint else 1)
