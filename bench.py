"""Benchmark: Gram path-pairs/s, forward + backward, on one NVIDIA GPU.

Headline configuration: a 100 x 100 Gram (10,000 path pairs) of length-1024,
3-dimensional paths, dyadic order 1 (refined grid 2046 x 2046), RBF sigma
1, through ``sig_gram_lincomb`` under ``jax.value_and_grad``: pairs solve
128 at a time under one scan and each chunk's adjoint runs inside its own
iteration. Two cells: float64 inputs (the headline) and float32 inputs.
Gradients run in the input dtype.

Each cell is timed in steady state: compile and one warm step first, then
three steps, each ending in ``block_until_ready``. Each cell prints
one JSON line that names the device (platform, ``device_kind``, count) and
the solver tier. The script fails when JAX finds no GPU.

    python bench.py [--cells f64 f32]
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_ENABLE_X64", "true")

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sigkernel_jax as sk  # noqa: E402
from sigkernel_jax.ops.routes import resolve_tier  # noqa: E402
from sigkernel_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

HEADLINE = dict(pairs=100, length=1024, dim=3, dyadic_order=1, sigma=1.0,
                pair_chunk=128)
CELLS = {"f64": jnp.float64, "f32": jnp.float32}


def device_info() -> dict:
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def measure(dtype, pairs, length, dim, dyadic_order, sigma, pair_chunk,
            iters=3) -> dict:
    """Steady-state timing of one ``value_and_grad`` step of the lincomb."""
    rng = np.random.default_rng(0)

    def paths():
        x = rng.normal(size=(pairs, length, dim)).cumsum(axis=1)
        return jnp.asarray(x / np.sqrt(length), dtype)

    X, Y = paths(), paths()
    W = jnp.full((pairs, pairs), 1.0 / (pairs * pairs), dtype)
    kern = sk.RBFKernel(sigma)

    def loss(x):
        return sk.sig_gram_lincomb(kern, x, Y, W, dyadic_order=dyadic_order,
                                   pair_chunk=pair_chunk)

    t0 = time.perf_counter()
    step = jax.jit(jax.value_and_grad(loss)).lower(X).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(step(X))                   # warm
    times = []
    for i in range(iters):
        Xi = X * (1.0 + 1e-6 * (i + 1))
        jax.block_until_ready(Xi)
        t0 = time.perf_counter()
        jax.block_until_ready(step(Xi))
        times.append(time.perf_counter() - t0)
    probe = jax.ShapeDtypeStruct((pair_chunk, length - 1, length - 1), dtype)
    mem = jax.devices()[0].memory_stats() or {}
    return {"pairs_per_s": pairs * pairs / min(times), "step_s": times,
            "compile_s": compile_s,
            "tier": resolve_tier("auto", probe, dyadic_order),
            "peak_bytes_in_use": mem.get("peak_bytes_in_use")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", choices=list(CELLS),
                    default=list(CELLS))
    args = ap.parse_args(argv)

    dev = device_info()
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py: JAX found no GPU (platform "
                         f"{dev['platform']!r}); nothing was measured")
    enable_compile_cache()
    h = HEADLINE
    for cell in args.cells:
        r = measure(CELLS[cell], h["pairs"], h["length"], h["dim"],
                    h["dyadic_order"], h["sigma"], h["pair_chunk"])
        print(json.dumps({
            "metric": (f"gram_pairs_per_sec_fwd_bwd_len{h['length']}_"
                       f"dyadic{h['dyadic_order']}_{cell}"),
            "value": r["pairs_per_s"], "unit": "path-pairs/s",
            "device": dev, "tier": r["tier"], "step_s": r["step_s"],
            "compile_s": r["compile_s"],
            "peak_bytes_in_use": r["peak_bytes_in_use"]}), flush=True)


if __name__ == "__main__":
    main()
