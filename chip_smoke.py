"""Smoke run of the signature-kernel library on one NVIDIA GPU.

Drives the library's main path through its public API at the full width of
the headline configuration -- ``sig_gram_lincomb`` under
``jax.value_and_grad`` over a 100 x 100 Gram (10,000 path pairs) of
length-1024, 3-dimensional paths, dyadic order 1, float64, RBF sigma 1 --
after checking the CUDA wavefront kernel against the portable scan tier and
the naive oracles, and times the kernel against the scan tier:

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # only the sharded paths, four cards

Phases: a. device, b. kernel build, c. the canonical user flow,
d. kernel against the scan tier at real widths, e. the headline step,
f. kernel against scan timing (g. with ``--four-cards``: the sharded paths
against one card). Any failed check raises. The last line of standard
output is one JSON object naming the device; it is printed only when every
phase passed. Without a GPU the script exits non-zero before any phase.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_ENABLE_X64", "true")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sigkernel_jax as sk  # noqa: E402
from sigkernel_jax import naive, stats  # noqa: E402
from sigkernel_jax.models.mmd_flow import MMDFlow  # noqa: E402
from sigkernel_jax.ops import gpu_wavefront, routes, scan_solver  # noqa: E402
from sigkernel_jax.ops.solve import solve  # noqa: E402
from sigkernel_jax.utils import double_difference, dyadic_refine  # noqa: E402
from sigkernel_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

HEADLINE = dict(pairs=100, length=1024, dim=3, dyadic_order=1, sigma=1.0,
                pair_chunk=128)


class SmokeFailure(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise SmokeFailure("non-finite values")
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


def check(name: str, got, want, tol: float) -> float:
    err = rel_err(got, want)
    log(f"  {name}: max rel err {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise SmokeFailure(f"{name}: relative error {err:.3e} > {tol:.0e}")
    return err


def make_paths(rng, batch, length, dim, dtype=jnp.float64):
    x = rng.normal(size=(batch, length, dim)).cumsum(axis=1) / np.sqrt(length)
    return jnp.asarray(x, dtype)


def route(pairs, len_x, len_y, dyadic_order, dtype=jnp.float64,
          solver="auto"):
    """The solver tier a tile of ``pairs`` path pairs takes."""
    probe = jax.ShapeDtypeStruct((pairs, len_x - 1, len_y - 1), dtype)
    return routes.resolve_tier(solver, probe, dyadic_order)


# ---------------------------------------------------------------------------
# a. device, b. build
# ---------------------------------------------------------------------------

def phase_device(require_gpu: bool = True):
    devices = jax.devices()
    d0 = devices[0]
    if require_gpu and d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{d0.platform!r}); nothing was measured")
    log(f"a. device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devices)}")
    return devices


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi (not from JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    path = gpu_wavefront.load()
    total = time.perf_counter() - t0
    built = (f"nvcc {gpu_wavefront.build_seconds:.1f} s"
             if gpu_wavefront.build_seconds else "library already built")
    log(f"b. build: {os.path.basename(path)} ({built}; build and load "
        f"{total:.1f} s, set-up)")


# ---------------------------------------------------------------------------
# c. canonical flow
# ---------------------------------------------------------------------------

def _chsic_from_grams(K_X, K_Y, K_Z, eps):
    """The CHSIC trace algebra in numpy, on oracle Grams."""
    m = K_X.shape[0]
    H = np.eye(m) - np.full((m, m), 1.0 / m)
    Kx, Ky, Kz = H @ K_X @ H, H @ K_Y @ H, H @ K_Z @ H
    inv = np.linalg.inv(Kz + m * eps * np.eye(m))
    A = Kz @ inv @ inv @ Kz
    B = Kx @ A @ Ky
    return (np.trace(Kx @ Ky) - 2.0 * np.trace(B) + np.trace(B @ A)) / m ** 2


def phase_canonical(batch=5, len_x=10, len_y=20, dim=2, dyadic_order=1,
                    flow_steps=3):
    """The README quick start and the estimators a user calls next, each
    against the f64 scan tier and the naive oracles."""
    d = dyadic_order
    log(f"c. canonical flow: batch {batch}, lengths {len_x}/{len_y}, dim "
        f"{dim}, dyadic order {d}, f64; route "
        f"{route(batch, len_x, len_y, d)} (scan tier and naive loop as "
        "references)")
    static = sk.RBFKernel(sigma=0.5)
    sig = sk.SigKernel(static, dyadic_order=d)
    ref = sk.SigKernel(static, dyadic_order=d, solver="scan")
    key, key2, key3, key4 = jax.random.split(jax.random.key(0), 4)
    X = jnp.cumsum(0.1 * jax.random.normal(key, (batch, len_x, dim)), axis=1)
    Y = jnp.cumsum(0.1 * jax.random.normal(key2, (batch, len_y, dim)),
                   axis=1)
    Z = jnp.cumsum(0.1 * jax.random.normal(key3, (batch, len_x, dim)),
                   axis=1)

    k = sig.compute_kernel(X, Y)
    check("compute_kernel vs scan", k, ref.compute_kernel(X, Y), 1e-12)
    check("compute_kernel vs naive", k,
          naive.sig_kernel_naive(X, Y, static, d), 1e-12)

    G = sig.compute_Gram(X, X, sym=True)
    check("compute_Gram(sym=True) vs scan", G,
          ref.compute_Gram(X, X, sym=True), 1e-12)
    G_naive = naive.sig_gram_naive(X, X, static, d)
    check("compute_Gram(sym=True) vs naive", G, G_naive, 1e-12)

    mmd = sig.compute_mmd(X, Y)
    check("compute_mmd vs scan", mmd, ref.compute_mmd(X, Y), 1e-12)
    check("compute_mmd vs naive", mmd, naive.sig_mmd_naive(X, Y, static, d),
          1e-11)
    grad = jax.grad(lambda x: sig.compute_mmd(x, Y))(X)
    check("grad compute_mmd vs scan", grad,
          jax.grad(lambda x: ref.compute_mmd(x, Y))(X), 1e-10)

    gamma = jnp.cumsum(0.1 * jax.random.normal(key4, (batch, len_x, dim)),
                       axis=1)
    K, K1, K2 = sig.compute_kernel_and_derivatives_Gram(X, Y, gamma)
    log("  compute_kernel_and_derivatives_Gram route: scan (triple "
        "wavefront)")
    check("derivatives Gram K vs naive", K, naive.sig_gram_naive(X, Y, static,
                                                                 d), 1e-12)
    # the triple wavefront propagates the reference's product-rule
    # recurrence, a discretisation of dK of the same order as the scheme's,
    # not the exact derivative of the discrete scheme: hence the tolerance
    h = 1e-5
    fd = (naive.sig_gram_naive(X + h * gamma, Y, static, d)
          - naive.sig_gram_naive(X - h * gamma, Y, static, d)) / (2 * h)
    check("derivatives Gram dK vs naive central difference", K1, fd, 5e-3)
    if not np.all(np.isfinite(np.asarray(K2))):
        raise SmokeFailure("derivatives Gram d2K: non-finite")

    rejected, TU, c = stats.hypothesis_test(X, Y, static, dyadic_order=d,
                                            verbose=False)
    check("hypothesis_test statistic vs naive", TU,
          naive.sig_mmd_naive(X, Y, static, d), 1e-11)
    log(f"  hypothesis_test: rejected={rejected} threshold={c:.4f}")

    chsic = stats.sig_chsic(X, Y, Z, static, dyadic_order=d)
    want = _chsic_from_grams(G_naive, naive.sig_gram_naive(Y, Y, static, d),
                             naive.sig_gram_naive(Z, Z, static, d), 0.1)
    check("sig_chsic vs naive Grams", chsic, want, 1e-9)

    Xf, hist = MMDFlow(static, dyadic_order=d, lr=0.05).fit(X, Y, flow_steps)
    Xs, hist_s = MMDFlow(static, dyadic_order=d, lr=0.05,
                         solver="scan").fit(X, Y, flow_steps)
    check(f"mmd_flow {flow_steps} steps: particles vs scan", Xf, Xs, 1e-10)
    check(f"mmd_flow {flow_steps} steps: MMD history vs scan", hist, hist_s,
          1e-10)
    if not hist[-1] < hist[0]:
        raise SmokeFailure(f"mmd_flow did not descend: {hist}")


# ---------------------------------------------------------------------------
# d. kernel against the scan tier at real widths
# ---------------------------------------------------------------------------

def phase_kernel_vs_scan(pairs=16, length=1024, dim=3, dyadic_order=1,
                         solver="cuda"):
    """The kernel and the scan tier on identical increments."""
    d = dyadic_order
    rng = np.random.default_rng(1)
    X = make_paths(rng, pairs, length, dim)
    Y = make_paths(rng, pairs, length, dim)
    inc = double_difference(sk.RBFKernel(1.0).batch_kernel(X, Y))
    log(f"d. kernel vs scan: {pairs} pairs, length {length}, dyadic order "
        f"{d}, identical increments; route "
        f"{route(pairs, length, length, d, solver=solver)}")

    def value(s):
        return jax.jit(lambda i: solve(i, solver=s, dyadic_order=d))

    def grad(s):
        return jax.jit(jax.grad(
            lambda i: solve(i, solver=s, dyadic_order=d).sum()))

    check("f64 values", value(solver)(inc), value("scan")(inc), 1e-12)
    inc32 = inc.astype(jnp.float32)
    check("f32 values", value(solver)(inc32), value("scan")(inc32), 1e-5)
    check("f64 grid-route gradient", grad(solver)(inc), grad("scan")(inc),
          1e-10)


# ---------------------------------------------------------------------------
# e. headline step, f. timing
# ---------------------------------------------------------------------------

def headline_step(X, Y, W, solver, pair_chunk, dyadic_order, sigma):
    kern = sk.RBFKernel(sigma)

    def loss(x):
        return sk.sig_gram_lincomb(kern, x, Y, W, dyadic_order=dyadic_order,
                                   solver=solver, pair_chunk=pair_chunk)

    return jax.jit(jax.value_and_grad(loss)).lower(X).compile()


def _timed(step, X, i):
    Xi = X * (1.0 + 1e-6 * (i + 1))
    jax.block_until_ready(Xi)
    t0 = time.perf_counter()
    v, g = step(Xi)
    jax.block_until_ready((v, g))
    return time.perf_counter() - t0, v, g


def _memory(compiled, device):
    ma = compiled.memory_analysis()
    parts = []
    if ma is not None:
        parts = [f"{n} {getattr(ma, n + '_size_in_bytes') / 2**30:.2f} GiB"
                 for n in ("argument", "output", "temp")]
    stats_ = device.memory_stats() or {}
    peak = stats_.get("peak_bytes_in_use")
    parts.append("peak_bytes_in_use " + (f"{peak / 2**30:.2f} GiB"
                                         if peak is not None
                                         else "not reported"))
    return ", ".join(parts)


def phase_headline(pairs, length, dim, dyadic_order, sigma, pair_chunk,
                   solver="auto", steps=3):
    """The main path at full width: compile, report memory, run warm steps,
    check the value and gradient."""
    rng = np.random.default_rng(0)
    X = make_paths(rng, pairs, length, dim)
    Y = make_paths(rng, pairs, length, dim)
    W = jnp.full((pairs, pairs), 1.0 / (pairs * pairs), jnp.float64)
    tier = route(pair_chunk, length, length, dyadic_order, solver=solver)
    log(f"e. headline: sig_gram_lincomb value_and_grad, {pairs}x{pairs} "
        f"pairs, length {length}, dim {dim}, dyadic order {dyadic_order}, "
        f"f64, pair_chunk {pair_chunk}; route {tier}")
    t0 = time.perf_counter()
    step = headline_step(X, Y, W, solver, pair_chunk, dyadic_order, sigma)
    log(f"  compile {time.perf_counter() - t0:.1f} s (set-up)")
    dts = []
    for i in range(steps):
        dt, v, g = _timed(step, X, i)
        dts.append(dt)
    if not (np.isfinite(float(v)) and bool(jnp.all(jnp.isfinite(g)))):
        raise SmokeFailure("headline value or gradient not finite")
    if g.shape != X.shape:
        raise SmokeFailure(f"gradient shape {g.shape} != {X.shape}")
    log(f"  memory: {_memory(step, jax.devices()[0])}")
    log(f"  value {float(v):.12g}, |grad|_max "
        f"{float(jnp.max(jnp.abs(g))):.6g}, step times "
        + ", ".join(f"{t:.3f} s" for t in dts))
    return step, X, Y, W, float(v), g


def phase_compare(kernel_step, X, pairs, card, scan_chunk, dyadic_order,
                  sigma, Y, W):
    """Kernel against the scan tier at the headline, in turns
    (scan, kernel, kernel, scan), one process, one card."""
    log(f"f. kernel vs scan timing at the headline ({card}); scan tier at "
        f"pair_chunk {scan_chunk}")
    t0 = time.perf_counter()
    scan_step = headline_step(X, Y, W, "scan", scan_chunk, dyadic_order,
                              sigma)
    _timed(scan_step, X, 0)          # warm
    log(f"  scan compile and warm step {time.perf_counter() - t0:.1f} s; "
        f"memory: {_memory(scan_step, jax.devices()[0])}")
    times = {"scan": [], "kernel": []}
    out = {}
    for name in ("scan", "kernel", "kernel", "scan"):
        step = scan_step if name == "scan" else kernel_step
        dt, v, g = _timed(step, X, 7)
        times[name].append(dt)
        out[name] = (v, g)
    check("headline value, kernel vs scan", out["kernel"][0],
          out["scan"][0], 1e-12)
    check("headline gradient, kernel vs scan", out["kernel"][1],
          out["scan"][1], 1e-10)
    rates = {k: pairs / min(v) for k, v in times.items()}
    for k in ("scan", "kernel"):
        log(f"  {k}: step " + ", ".join(f"{t:.3f} s" for t in times[k])
            + f" -> {rates[k]:.1f} pairs/s ({card})")
    log(f"  kernel / scan: {rates['kernel'] / rates['scan']:.2f}x")
    return rates


# ---------------------------------------------------------------------------
# g. four cards
# ---------------------------------------------------------------------------

def phase_four_cards(devices, pairs, length, dim, dyadic_order, sigma,
                     pair_chunk, mmd_max_batch=20, stripe_pairs=16,
                     stripe_rows=256):
    """The sharded paths on a 1-D mesh over four cards against card 0."""
    from sigkernel_jax.parallel import (make_mesh, sharded_sig_gram_lincomb,
                                        sharded_sig_mmd, striped_solve_final)

    if len(devices) != 4:
        raise SmokeFailure(f"--four-cards needs 4 devices, found "
                           f"{len(devices)}")
    mesh = make_mesh(devices=devices)
    d = dyadic_order
    kern = sk.RBFKernel(sigma)
    rng = np.random.default_rng(0)
    X = make_paths(rng, pairs, length, dim)
    Y = make_paths(rng, pairs, length, dim)
    W = jnp.full((pairs, pairs), 1.0 / (pairs * pairs), jnp.float64)
    log(f"g. four cards: mesh {dict(mesh.shape)}, {pairs}x{pairs} pairs, "
        f"length {length}, dyadic order {d}, f64; route "
        f"{route(pair_chunk, length, length, d)}")

    def on_card0(x):
        return jax.device_put(x, devices[0])

    sharded = jax.jit(jax.value_and_grad(lambda x: sharded_sig_gram_lincomb(
        kern, x, Y, W, mesh, dyadic_order=d, pair_chunk=pair_chunk)))
    local = jax.jit(jax.value_and_grad(lambda x, y, w: sk.sig_gram_lincomb(
        kern, x, y, w, dyadic_order=d, pair_chunk=pair_chunk)))
    t0 = time.perf_counter()
    v4, g4 = jax.block_until_ready(sharded(X))
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    v1, g1 = jax.block_until_ready(local(on_card0(X), on_card0(Y),
                                         on_card0(W)))
    t1 = time.perf_counter() - t0
    log(f"  sharded_sig_gram_lincomb first call {t4:.1f} s, card 0 "
        f"{t1:.1f} s (compile included)")
    check("sharded_sig_gram_lincomb value vs card 0", v4, v1, 1e-10)
    check("sharded_sig_gram_lincomb gradient vs card 0", g4, g1, 1e-10)

    m4 = jax.jit(lambda x, y: sharded_sig_mmd(
        kern, x, y, mesh, dyadic_order=d, max_batch=mmd_max_batch))(X, Y)
    m1 = jax.jit(lambda x, y: sk.sig_mmd(
        kern, x, y, dyadic_order=d, max_batch=mmd_max_batch,
        pair_chunk=pair_chunk))(on_card0(X), on_card0(Y))
    check("sharded_sig_mmd vs card 0", m4, m1, 1e-10)

    n = len(devices)
    inc = double_difference(kern.batch_kernel(
        make_paths(rng, stripe_pairs, stripe_rows * n + 1, dim),
        make_paths(rng, stripe_pairs, stripe_rows * n + 1, dim)))
    s4 = jax.jit(lambda i: striped_solve_final(
        i, mesh, dyadic_order=d, chunks=n))(inc)
    s1 = jax.jit(lambda i: scan_solver.solve_final(dyadic_refine(i, d)))(
        on_card0(inc))
    check(f"striped_solve_final ({stripe_pairs} pairs, {inc.shape[-2]} "
          "base rows) vs scan_solver.solve_final", s4, s1, 1e-10)


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    devices = phase_device()
    card = card_line()
    log(f"a. card: {card}")
    cache = enable_compile_cache()
    log(f"   compilation cache: {cache}")
    phase_build()
    h = HEADLINE
    if args.four_cards:
        phase_four_cards(devices, h["pairs"], h["length"], h["dim"],
                         h["dyadic_order"], h["sigma"], h["pair_chunk"])
    else:
        phase_canonical()
        phase_kernel_vs_scan()
        step, X, Y, W, _, _ = phase_headline(
            h["pairs"], h["length"], h["dim"], h["dyadic_order"], h["sigma"],
            h["pair_chunk"])
        rates = phase_compare(step, X, h["pairs"] ** 2, card,
                              h["pair_chunk"], h["dyadic_order"], h["sigma"],
                              Y, W)
        # the kernel stays only while it beats the plain XLA tier end to end
        if not rates["kernel"] > rates["scan"]:
            raise SmokeFailure("the CUDA kernel is not faster than the scan "
                               "tier end to end")
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
