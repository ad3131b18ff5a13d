"""Benchmark harness over the BASELINE.json config suite, on one GPU.

Each configuration is compiled and run once warm, then timed in steady
state with every call ending in ``jax.block_until_ready`` (inputs varied
per iteration). Emits one JSON line per config naming the device; fails
when JAX finds no GPU.

    python benchmarks/run_benchmarks.py            # all configs
    python benchmarks/run_benchmarks.py readme mmd # subset
    python benchmarks/run_benchmarks.py --json     # also write results/
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_ENABLE_X64", "true")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sigkernel_jax as sk  # noqa: E402
from sigkernel_jax.utils.compile_cache import enable_compile_cache  # noqa: E402


def _timed(fn, make_args, iters=3):
    out = fn(*make_args(0))
    jax.block_until_ready(out)
    ts = []
    for i in range(iters):
        args = make_args(i + 1)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _paths(rng, b, l, d, dtype):
    x = rng.normal(size=(b, l, d)).cumsum(axis=1) / np.sqrt(l)
    return jnp.asarray(x, dtype)


def bench_readme(report):
    """README synthetic config: batch 5, len 10/20, dim 2, RBF 0.5, f64."""
    rng = np.random.default_rng(0)
    kernel = sk.RBFKernel(0.5)
    X0 = _paths(rng, 5, 10, 2, jnp.float64)
    Y0 = _paths(rng, 5, 20, 2, jnp.float64)
    fn = jax.jit(lambda x, y: sk.sig_kernel(kernel, x, y, dyadic_order=0,
                                            max_batch=None))
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i), Y0))
    report("readme_compute_kernel_b5", 5 / dt, "paths/s")


def bench_gram_sym(report):
    """Gram sym=True, LinearKernel, batch 50, len 100."""
    rng = np.random.default_rng(1)
    kernel = sk.LinearKernel()
    X0 = _paths(rng, 50, 100, 2, jnp.float64)
    fn = jax.jit(lambda x: sk.sig_gram(kernel, x, x, sym=True,
                                       max_batch=None))
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i),))
    report("gram_sym_b50_len100", 50 * 51 / 2 / dt, "pairs/s")


def bench_mmd_grad(report):
    """MMD + gradient: dyadic 1, batch 32, len 200."""
    rng = np.random.default_rng(2)
    kernel = sk.RBFKernel(1.0)
    X0 = _paths(rng, 32, 200, 3, jnp.float64)
    Y0 = _paths(rng, 32, 200, 3, jnp.float64)
    fn = jax.jit(jax.value_and_grad(
        lambda x, y: sk.sig_mmd(kernel, x, y, dyadic_order=1,
                                max_batch=None)))
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i), Y0))
    pairs = 32 * 32 + 32 * 33  # XY + two sym triangles
    report("mmd_fwd_bwd_b32_len200_dyadic1", pairs / dt, "pairs/s")


def bench_longpath(report):
    """Long-path stress: scoring rule at len 1024, dyadic 2, dim 5."""
    rng = np.random.default_rng(3)
    kernel = sk.RBFKernel(1.0)
    X0 = _paths(rng, 4, 1024, 5, jnp.float64)
    y0 = _paths(rng, 1, 1024, 5, jnp.float64)
    fn = jax.jit(lambda x, y: sk.sig_scoring_rule(kernel, x, y,
                                                  dyadic_order=2,
                                                  max_batch=None))
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i), y0), iters=2)
    pairs = 4 * 5 / 2 + 4
    report("scoring_rule_len1024_dyadic2_dim5", pairs / dt, "pairs/s")


def bench_chsic(report):
    """SigCHSIC at the long-path stress config (len 1024, dyadic 2, dim 5):
    three sym Grams + the conditional-HSIC trace algebra, f64."""
    from sigkernel_jax import stats

    rng = np.random.default_rng(4)
    kernel = sk.RBFKernel(1.0)
    m = 4
    X0 = _paths(rng, m, 1024, 5, jnp.float64)
    Y0 = _paths(rng, m, 1024, 5, jnp.float64)
    Z0 = _paths(rng, m, 1024, 5, jnp.float64)
    fn = jax.jit(lambda x, y, z: stats.sig_chsic(x, y, z, kernel,
                                                 dyadic_order=2,
                                                 max_batch=None))
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i), Y0, Z0), iters=2)
    pairs = 3 * (m * (m + 1) / 2)  # three sym Grams
    report("chsic_len1024_dyadic2_dim5", pairs / dt, "pairs/s")


def bench_derivatives_gram(report):
    """k_kgrad triple solve with max_batch tiling (len 256, dyadic 1)."""
    rng = np.random.default_rng(5)
    kernel = sk.RBFKernel(1.0)
    X0 = _paths(rng, 6, 256, 3, jnp.float64)
    Y0 = _paths(rng, 6, 256, 3, jnp.float64)
    g0 = _paths(rng, 6, 256, 3, jnp.float64)
    fn = jax.jit(lambda x, y, g: sk.sig_kernel_and_derivatives_gram(
        kernel, x, y, g, dyadic_order=1, max_batch=4)[2])
    dt = _timed(fn, lambda i: (X0 * (1 + 1e-9 * i), Y0, g0), iters=2)
    report("derivatives_gram_b6x6_len256_dyadic1", 36 / dt, "pairs/s")


BENCHES = {
    "readme": bench_readme,
    "gram": bench_gram_sym,
    "mmd": bench_mmd_grad,
    "longpath": bench_longpath,
    "chsic": bench_chsic,
    "derivatives": bench_derivatives_gram,
}


RESULTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "results", "baseline_suite.json")


def device_info() -> dict:
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def run(names, write_json=False):
    """Run the named configs; with ``write_json`` the results file is
    rewritten after every config, so a crash keeps the earlier ones."""
    dev = device_info()
    results = {"device": dev, "suite": {}}

    def report(metric, value, unit):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "device": dev}), flush=True)
        results["suite"][metric] = {"value": value, "unit": unit}
        if write_json:
            os.makedirs(os.path.dirname(RESULTS_PATH), exist_ok=True)
            tmp = RESULTS_PATH + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, RESULTS_PATH)

    for n in names:
        try:
            BENCHES[n](report)
        except Exception as e:  # machine-readable trace, never silence
            report(n + "_error", 0.0, f"{type(e).__name__}: {e}"[:200])
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("-")] or list(BENCHES)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("run_benchmarks.py: JAX found no GPU; nothing was "
                         "measured")
    enable_compile_cache()
    run(names, write_json="--json" in argv)


if __name__ == "__main__":
    main()
