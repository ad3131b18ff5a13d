"""Model-layer tests: precomputed-Gram SVC and the MMD particle flow."""
import numpy as np
import jax.numpy as jnp
import pytest

import sigkernel_jax as sk
from sigkernel_jax.models import SigKernelSVC, MMDFlow, mmd_flow_step

from conftest import make_paths


def _class_data(rng, n_per_class=8, length=12, dim=2):
    dirs = np.array([[1.0, 0.0], [-1.0, 0.5]])
    X, y = [], []
    for k in range(2):
        noise = rng.normal(size=(n_per_class, length, dim)) * 0.2
        drift = np.linspace(0, 1, length)[None, :, None] * dirs[k]
        X.append(np.cumsum(noise, 1) / np.sqrt(length) + drift)
        y += [k] * n_per_class
    return np.concatenate(X), np.array(y)


def test_svc_fit_predict(rng):
    X, y = _class_data(rng)
    model = SigKernelSVC(sk.RBFKernel(0.5), dyadic_order=0,
                         svc_parameters={"C": [1.0, 10.0]}, cv=2)
    model.fit(jnp.asarray(X), y)
    acc = model.score(jnp.asarray(X), y)
    assert acc > 0.9  # easily separable training data

    X2, y2 = _class_data(rng)
    acc2 = model.score(jnp.asarray(X2), y2)
    assert acc2 > 0.7


def test_svc_predict_before_fit_raises(rng):
    model = SigKernelSVC(sk.RBFKernel(0.5))
    with pytest.raises(RuntimeError):
        model.predict(jnp.zeros((2, 5, 2)))


def test_mmd_flow_decreases_loss(rng):
    Y = jnp.asarray(make_paths(rng, 8, 8, 2, scale=1.0))
    X0 = jnp.asarray(make_paths(rng, 8, 8, 2, scale=0.2))
    flow = MMDFlow(sk.RBFKernel(0.5), dyadic_order=0, lr=0.2)
    X1, history = flow.fit(X0, Y, n_steps=8)
    assert np.isfinite(history).all()
    assert history[-1] < history[0]  # flow reduces MMD^2


def test_mmd_flow_step_jits(rng):
    Y = jnp.asarray(make_paths(rng, 4, 6, 2))
    X = jnp.asarray(make_paths(rng, 4, 6, 2))
    X1, v = mmd_flow_step(sk.RBFKernel(1.0), X, Y, lr=0.1)
    assert X1.shape == X.shape
    assert np.isfinite(float(v))


def test_mmd_flow_checkpoint_resume(rng, tmp_path):
    Y = jnp.asarray(make_paths(rng, 6, 6, 2, scale=1.0))
    X0 = jnp.asarray(make_paths(rng, 6, 6, 2, scale=0.2))
    kern = sk.RBFKernel(0.5)

    full = MMDFlow(kern, lr=0.1)
    X_full, h_full = full.fit(X0, Y, n_steps=6)

    ckdir = str(tmp_path / "flow_ckpt")
    flow = MMDFlow(kern, lr=0.1, checkpoint_dir=ckdir, checkpoint_every=2)
    flow.fit(X0, Y, n_steps=3)          # partial run, checkpoints at 2, 3
    X_res, h_res = flow.fit(X0, Y, n_steps=6)   # resumes, finishes

    np.testing.assert_allclose(np.asarray(X_res), np.asarray(X_full),
                               rtol=1e-10)
    np.testing.assert_allclose(h_res, h_full, rtol=1e-10)


def test_structured_logging_events(tmp_path, monkeypatch):
    """log_event appends JSON lines to SIGKERNEL_LOG_FILE and MMDFlow.fit
    emits per-step events."""
    import json
    from sigkernel_jax.utils.logging import log_event

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("SIGKERNEL_LOG_FILE", str(log))
    rec = log_event("unit.test", foo=1, bar="x")
    assert rec["event"] == "unit.test" and rec["foo"] == 1

    import numpy as np
    import jax.numpy as jnp
    import sigkernel_jax as sk
    from sigkernel_jax.models import MMDFlow

    rng = np.random.default_rng(0)
    X0 = jnp.asarray(rng.normal(size=(4, 6, 2)).cumsum(axis=1) * 0.2)
    Y = jnp.asarray(rng.normal(size=(4, 6, 2)).cumsum(axis=1) * 0.2)
    MMDFlow(sk.RBFKernel(1.0), lr=0.01).fit(X0, Y, n_steps=2)

    lines = [json.loads(l) for l in log.read_text().splitlines()]
    events = [l["event"] for l in lines]
    assert events.count("mmd_flow.step") == 2
    assert all("t" in l for l in lines)
