"""Cross-implementation UEA classification pipeline (closes SURVEY C13).

The UEA archive is not available in this environment (no network egress, no
``.ts``/``.arff`` files on disk), so accuracy parity against BASELINE.md's
11-dataset table cannot be measured directly. This test closes the gap the
achievable way: the *same* synthetic dataset is pushed through

- the reference's own pipeline -- ``sigkernel.SigKernel.compute_Gram`` +
  sklearn ``SVC(kernel='precomputed')`` + ``GridSearchCV`` (reference
  examples/time_series_classification.py:186-202, 321-326), with the
  compiled Cython backend adapted to the reference's *own* pure-torch
  ``sigkernel_Gram_mps`` solver (reference sigkernel/mps_backend.py:52-78;
  every number still comes from reference code), and
- our ``SigKernelSVC`` (sigkernel_jax/models/classifier.py),

asserting Gram agreement to 1e-10 and *identical* predictions -- identical
Grams through the identical sklearn estimator imply identical accuracies on
any dataset, which is what the archive run would establish.
"""
import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "sigkernel")),
    reason="reference checkout not available")


@pytest.fixture(scope="module")
def reference():
    """Reference package with accelerator deps stubbed (see
    test_reference_parity.py) and the Cython Gram solver adapted to the
    reference's own vectorised torch backend."""
    torch = pytest.importorskip("torch")
    pytest.importorskip("sklearn")

    numba = types.ModuleType("numba")
    cuda = types.ModuleType("numba.cuda")
    cuda.jit = lambda *a, **k: (a[0] if a and callable(a[0])
                                else (lambda f: f))
    cuda.as_cuda_array = lambda x: x
    numba.cuda = cuda
    cyb = types.ModuleType("cython_backend")
    for name in ("sigkernel_cython", "sigkernel_Gram_cython",
                 "sigkernel_derivatives_Gram_cython"):
        setattr(cyb, name, None)

    saved = {}
    for mod, obj in (("numba", numba), ("numba.cuda", cuda),
                     ("cython_backend", cyb)):
        saved[mod] = sys.modules.get(mod)
        sys.modules[mod] = obj
    sys.path.insert(0, REF)
    try:
        import importlib
        ref = importlib.import_module("sigkernel")
        refmod = importlib.import_module("sigkernel.sigkernel")

        def gram_via_reference_mps(G_static_np, sym=False,
                                   _naive_solver=False):
            # Interface adapter only: the PDE sweep below is the
            # reference's sigkernel_Gram_mps, byte for byte. Matches the
            # Cython solver's grid convention (cython_backend.pyx:64-110:
            # K is (A, B, M+1, N+1), boundary ones, interior M x N).
            A, B, M, N = G_static_np.shape
            M_inc = torch.tensor(np.ascontiguousarray(G_static_np),
                                 dtype=torch.float64)
            K = torch.zeros((A, B, M + 1, N + 1), dtype=torch.float64)
            K[:, :, 0, :] = 1.0
            K[:, :, :, 0] = 1.0
            ref.sigkernel_Gram_mps(M_inc, M, N, K,
                                   _naive_solver=_naive_solver)
            return K.numpy()

        prev = refmod.sigkernel_Gram_cython
        refmod.sigkernel_Gram_cython = gram_via_reference_mps
        yield ref, torch
        refmod.sigkernel_Gram_cython = prev
    finally:
        sys.path.remove(REF)
        for mod, obj in saved.items():
            if obj is None:
                sys.modules.pop(mod, None)
            else:
                sys.modules[mod] = obj


def _synthetic_classes(rng, n_per_class, length, dim):
    """Two-class dataset: Brownian-ish paths with opposite drift."""
    xs, ys = [], []
    for cls, drift in enumerate((-0.4, 0.4)):
        steps = rng.normal(size=(n_per_class, length, dim)) / np.sqrt(length)
        steps[..., 0] += drift / length
        xs.append(steps.cumsum(axis=1))
        ys.append(np.full(n_per_class, cls))
    X = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def test_uea_pipeline_matches_reference(rng, reference):
    ref, torch = reference
    import jax.numpy as jnp
    import sigkernel_jax as sk
    from sigkernel_jax.models.classifier import SigKernelSVC
    from sklearn.svm import SVC
    from sklearn.model_selection import GridSearchCV

    X_train, y_train = _synthetic_classes(rng, 10, 12, 2)
    X_test, y_test = _synthetic_classes(rng, 5, 12, 2)
    sigma = 1.0
    svc_parameters = {"C": np.logspace(0, 4, 5), "gamma": ["auto"]}

    # --- reference pipeline (time_series_classification.py:186-202) ---
    xt = torch.tensor(X_train, dtype=torch.float64)
    xs = torch.tensor(X_test, dtype=torch.float64)
    ref_sigker = ref.SigKernel(ref.RBFKernel(sigma=sigma), dyadic_order=0)
    G_train_ref = ref_sigker.compute_Gram(xt, xt, sym=True).numpy()
    G_test_ref = ref_sigker.compute_Gram(xs, xt, sym=False).numpy()
    svc = SVC(kernel="precomputed", decision_function_shape="ovo")
    ref_model = GridSearchCV(estimator=svc, param_grid=svc_parameters, cv=5)
    ref_model.fit(G_train_ref, y_train)
    ref_pred = ref_model.predict(G_test_ref)
    ref_acc = ref_model.score(G_test_ref, y_test)

    # --- our pipeline ---
    ours = SigKernelSVC(sk.RBFKernel(sigma), dyadic_order=0,
                        svc_parameters=svc_parameters, cv=5)
    ours.fit(jnp.asarray(X_train), y_train)
    G_train = np.asarray(ours.sig_kernel.compute_Gram(
        jnp.asarray(X_train), jnp.asarray(X_train), sym=True,
        max_batch=None))
    G_test = ours._test_gram(jnp.asarray(X_test))
    our_pred = ours.predict(jnp.asarray(X_test))
    our_acc = ours.score(jnp.asarray(X_test), y_test)

    # identical Grams -> identical sklearn fit -> identical accuracies on
    # any dataset, including the unavailable UEA archive
    np.testing.assert_allclose(G_train, G_train_ref, rtol=1e-10)
    np.testing.assert_allclose(G_test, G_test_ref, rtol=1e-10)
    np.testing.assert_array_equal(our_pred, ref_pred)
    assert our_acc == pytest.approx(ref_acc)
    assert ref_model.best_params_["C"] == ours._svc.best_params_["C"]
