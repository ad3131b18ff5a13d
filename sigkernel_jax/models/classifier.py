"""Precomputed-Gram SVC for time-series classification.

Packages the workflow of the reference UEA example
(reference examples/time_series_classification.py:186-202, 321-326):
signature-kernel Gram matrices fed to an sklearn SVC with
``kernel='precomputed'``, so GridSearchCV / SVC hyper-parameters reuse the
same Gram.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..sigkernel import SigKernel


class SigKernelSVC:
    """SVC on a precomputed signature-kernel Gram.

    Parameters mirror the reference example: a static kernel, the dyadic
    order, and the SVC hyper-parameter grid. The expensive part (the Gram)
    runs once on the accelerator; sklearn's quadratic program runs on host.
    """

    def __init__(self, static_kernel, dyadic_order=0, svc_parameters=None,
                 cv=5, max_batch: Optional[int] = 100, solver="auto"):
        self.sig_kernel = SigKernel(static_kernel, dyadic_order,
                                    solver=solver)
        self.svc_parameters = svc_parameters or {
            "C": np.logspace(0, 4, 5), "gamma": ["auto"]}
        self.cv = cv
        self.max_batch = max_batch
        self._svc = None
        self._X_train = None

    def fit(self, X, y):
        from sklearn.svm import SVC
        from sklearn.model_selection import GridSearchCV

        X = jnp.asarray(X)
        self._X_train = X
        G = np.asarray(self.sig_kernel.compute_Gram(
            X, X, sym=True, max_batch=self.max_batch))
        svc = SVC(kernel="precomputed", decision_function_shape="ovo")
        self._svc = GridSearchCV(estimator=svc,
                                 param_grid=self.svc_parameters, cv=self.cv)
        self._svc.fit(G, np.asarray(y))
        return self

    def _test_gram(self, X):
        X = jnp.asarray(X)
        return np.asarray(self.sig_kernel.compute_Gram(
            X, self._X_train, sym=False, max_batch=self.max_batch))

    def predict(self, X):
        if self._svc is None:
            raise RuntimeError("fit() must be called before predict()")
        return self._svc.predict(self._test_gram(X))

    def score(self, X, y):
        if self._svc is None:
            raise RuntimeError("fit() must be called before score()")
        return self._svc.score(self._test_gram(X), np.asarray(y))
