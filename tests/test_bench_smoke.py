"""Smoke-test the measurement scripts on the CPU at tiny configs.

The scripts refuse to measure without a GPU, so the CPU tests call their
measurement functions directly and check that the scripts themselves exit
non-zero, printing no result, here.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_env():
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    return env


@pytest.mark.parametrize("script", ["bench.py",
                                    "benchmarks/run_benchmarks.py"])
def test_scripts_refuse_the_cpu(script):
    out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert "no GPU" in out.stderr


def test_bench_inner_runs_on_cpu():
    import jax.numpy as jnp

    bench = _load("bench.py", "bench")
    rec = bench.measure(jnp.float64, pairs=2, length=12, dim=3,
                        dyadic_order=0, sigma=1.0, pair_chunk=4, iters=2)
    assert rec["pairs_per_s"] > 0 and len(rec["step_s"]) == 2
    assert rec["tier"] == "scan"
    assert bench.device_info() == {"platform": "cpu", "kind": "cpu",
                                   "count": len(__import__("jax").devices())}


def test_baseline_suite_banks_incrementally(tmp_path, monkeypatch):
    """run_benchmarks.run(write_json=True) rewrites the results file after
    EVERY config (a crash mid-suite keeps earlier entries) and records
    per-config failures as machine-readable error entries."""
    rb = _load("benchmarks/run_benchmarks.py", "run_benchmarks")
    monkeypatch.setattr(rb, "RESULTS_PATH", str(tmp_path / "r" / "s.json"))
    monkeypatch.setitem(rb.BENCHES, "nosuch", lambda report: (
        _ for _ in ()).throw(RuntimeError("boom")))
    rb.run(["readme", "nosuch"], write_json=True)
    rec = json.loads((tmp_path / "r" / "s.json").read_text())
    assert rec["device"]["platform"] == "cpu"
    assert rec["suite"]["readme_compute_kernel_b5"]["value"] > 0
    assert "boom" in rec["suite"]["nosuch_error"]["unit"]
