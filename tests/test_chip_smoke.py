"""``chip_smoke.py`` phases at tiny sizes on the CPU, the device check
bypassed, plus the compile-cache placement shared by the measurement
scripts. On the CPU every phase resolves to the scan tier, so these tests
pin the phases' control flow and references, not the kernel."""
import importlib.util
import os
import subprocess
import sys

import jax
import pytest

from sigkernel_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_phase_refuses_the_cpu(smoke):
    with pytest.raises(SystemExit):
        smoke.phase_device()
    assert smoke.phase_device(require_gpu=False)[0].platform == "cpu"


def test_canonical_flow_phase(smoke, capsys):
    smoke.phase_canonical(batch=3, len_x=5, len_y=8, flow_steps=2)
    out = capsys.readouterr().out
    assert "route scan" in out
    for name in ("compute_kernel vs naive", "sig_chsic vs naive Grams",
                 "hypothesis_test statistic vs naive",
                 "mmd_flow 2 steps: particles vs scan"):
        assert name in out


def test_kernel_vs_scan_phase(smoke, capsys):
    smoke.phase_kernel_vs_scan(pairs=2, length=9, solver="auto")
    out = capsys.readouterr().out
    assert out.count("tolerance") == 3


def test_headline_and_compare_phases(smoke, capsys):
    step, X, Y, W, v, g = smoke.phase_headline(4, 8, 3, 1, 1.0, 4, steps=1)
    assert g.shape == X.shape
    rates = smoke.phase_compare(step, X, 16, "cpu", 4, 1, 1.0, Y, W)
    assert set(rates) == {"scan", "kernel"}
    assert "peak_bytes_in_use" in capsys.readouterr().out


def test_four_card_phase_on_virtual_devices(smoke, capsys):
    smoke.phase_four_cards(jax.devices()[:4], 8, 9, 2, 1, 1.0, 4,
                           mmd_max_batch=3, stripe_pairs=4, stripe_rows=2)
    out = capsys.readouterr().out
    assert "sharded_sig_mmd vs card 0" in out


def test_check_raises_past_tolerance(smoke):
    smoke.check("same", [1.0, 2.0], [1.0, 2.0], 0.0)
    with pytest.raises(smoke.SmokeFailure):
        smoke.check("off", [1.0, 2.1], [1.0, 2.0], 1e-3)
    with pytest.raises(smoke.SmokeFailure):
        smoke.check("nan", [float("nan")], [1.0], 1.0)


def test_script_alone_exits_nonzero(tmp_path):
    """Outside the checkout, and without a GPU, no result line appears."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_honours_the_environment(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
