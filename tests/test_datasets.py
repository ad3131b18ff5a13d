"""Zero-dep UEA .ts parser."""
import numpy as np

from sigkernel_jax.datasets import load_ts_file, load_uea_dataset

TS = """#comment line
@problemName Toy
@timeStamps false
@univariate false
@dimension 2
@classLabel true walk run
@data
1.0,2.0,3.0:10.0,20.0,30.0:walk
4.0,5.0:40.0,?:run
"""


def _write(tmp_path, name, split, text):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    p = d / f"{name}_{split}.ts"
    p.write_text(text)
    return p


def test_parse_ts(tmp_path):
    p = _write(tmp_path, "Toy", "TRAIN", TS)
    X, y = load_ts_file(str(p))
    assert X.shape == (2, 3, 2)
    np.testing.assert_array_equal(X[0, :, 0], [1, 2, 3])
    np.testing.assert_array_equal(X[0, :, 1], [10, 20, 30])
    # variable length: padded by repeating the final point (exact)
    np.testing.assert_array_equal(X[1, :, 0], [4, 5, 5])
    assert np.isnan(X[1, 1, 1])
    assert list(y) == ["walk", "run"]


def test_load_uea_dataset_pair(tmp_path):
    _write(tmp_path, "Toy", "TRAIN", TS)
    _write(tmp_path, "Toy", "TEST", TS)
    xtr, ytr, xte, yte = load_uea_dataset("Toy", str(tmp_path))
    assert xtr.shape == xte.shape == (2, 3, 2)
    assert list(ytr) == list(yte) == ["walk", "run"]


def test_classification_example_runs_on_ts_data(tmp_path):
    """End-to-end: the UEA example pipeline on .ts data via --data-dir."""
    import subprocess
    import sys
    import os
    import pickle

    rng = np.random.default_rng(0)
    lines = ["@problemName Gen", "@classLabel true a b", "@data"]
    for i in range(16):
        cls = "a" if i % 2 == 0 else "b"
        drift = 1.0 if cls == "a" else -1.0
        dims = []
        for d in range(2):
            v = np.cumsum(rng.normal(size=12) * 0.1
                          + drift * 0.3 * (d + 1))
            dims.append(",".join(f"{x:.4f}" for x in v))
        lines.append(":".join(dims) + ":" + cls)
    text = "\n".join(lines) + "\n"
    _write(tmp_path, "Gen", "TRAIN", text)
    _write(tmp_path, "Gen", "TEST", text)

    out = tmp_path / "res.pkl"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import runpy, sys;"
        f"sys.argv=['x','--train','--datasets','Gen','--data-dir',{str(tmp_path)!r},"
        f"'--sigmas','0.5','--out',{str(out)!r}];"
        f"runpy.run_path({os.path.join(repo, 'examples', 'time_series_classification.py')!r},"
        "run_name='__main__')"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert out.exists(), r.stderr[-800:]
    res = pickle.load(open(out, "rb"))
    (acc, sigma, at, ll) = res[("Gen", "signature pde")]
    assert acc == 1.0, (acc, r.stdout[-500:])  # trivially separable classes
