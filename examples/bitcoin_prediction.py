"""Bitcoin price regression with the signature-PDE kernel.

Script counterpart of the reference's notebook
(reference examples/bitcoin_predictions.ipynb): rolling windows of daily BTC
close prices, SVR with precomputed kernels, comparing the signature-PDE
kernel against an RBF baseline and the truncated signature kernel; metric is
the MAPE of the predicted mean of the next two days.

Pass ``--data <csv>`` with a Gemini-format daily CSV (columns incl. Date and
Close, two header rows); with ``--synthetic`` a GBM-like price series is
simulated so the pipeline runs without the dataset.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402
import sigkernel_jax as sk  # noqa: E402

WINDOW = 36
HORIZON = 2


def load_close_prices(path):
    import csv
    closes = []
    with open(path) as f:
        rows = list(csv.reader(f))
    header_idx = next(i for i, r in enumerate(rows)
                      if any("close" == c.strip().lower() for c in r))
    header = [c.strip().lower() for c in rows[header_idx]]
    ci = header.index("close")
    for r in rows[header_idx + 1:]:
        try:
            closes.append(float(r[ci]))
        except (ValueError, IndexError):
            continue
    return np.array(closes[::-1])  # file is newest-first


def synthetic_prices(n=600, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0005, 0.03, n)
    return 8000.0 * np.exp(np.cumsum(r))


def make_windows(prices):
    X, y = [], []
    for i in range(len(prices) - WINDOW - HORIZON):
        w = prices[i:i + WINDOW]
        X.append(w / w[-1])  # normalise each window by its last price
        y.append(prices[i + WINDOW:i + WINDOW + HORIZON].mean() / w[-1])
    return np.array(X), np.array(y)


def mape(y_true, y_pred):
    return 100.0 * np.mean(np.abs((y_true - y_pred) / y_true))


def cosine_normalise(G_tr, G_te, d_te):
    """Scale precomputed kernels to unit diagonal:
    K(a,b)/sqrt(K(a,a) K(b,b)). Keeps libsvm's QP well conditioned (raw
    signature/truncated-sig values span many orders of magnitude and stall
    the solver). ``d_te`` are the test self-kernels K(te, te)."""
    d = np.sqrt(np.clip(np.diag(G_tr), 1e-12, None))
    dte = np.sqrt(np.clip(d_te, 1e-12, None))
    return G_tr / np.outer(d, d), G_te / np.outer(dte, d)


def _gak_log_gram(Xa, Xb, sigma, chunk=4096):
    """Log-space global-alignment-kernel Gram (Cuturi 2011), numpy.

    The reference notebook's GAK column uses ``tslearn.metrics.cdist_gak``
    (reference examples/bitcoin_predictions.ipynb, gak cells); this is the
    same DP -- ``M[i,j] = kappa(i,j) (M[i-1,j] + M[i,j-1] + M[i-1,j-1])``
    with the half-Gaussian local kernel ``kappa = k/(2-k)`` -- run in log
    space and vectorised over path pairs, so the column exists without the
    tslearn dependency. Returns ``log K`` of shape ``(A, B)``.
    """
    A, B = len(Xa), len(Xb)
    L = Xa.shape[1]
    ii, jj = np.meshgrid(np.arange(A), np.arange(B), indexing="ij")
    pairs = np.stack([ii.ravel(), jj.ravel()], axis=1)
    out = np.empty(A * B)
    for s in range(0, len(pairs), chunk):
        pa, pb = pairs[s:s + chunk, 0], pairs[s:s + chunk, 1]
        d2 = (Xa[pa][:, :, None] - Xb[pb][:, None, :]) ** 2  # (P, L, L)
        logk = -d2 / (2.0 * sigma ** 2)
        logkap = logk - np.log(2.0 - np.exp(logk))
        P = len(pa)
        prev2 = np.full((P, L + 1), -np.inf)  # row i-1 of the DP table
        prev2[:, 0] = 0.0                     # virtual start M[0,0] = 1
        for i in range(1, L + 1):
            cur = np.full((P, L + 1), -np.inf)
            for j in range(1, L + 1):
                m = np.logaddexp(np.logaddexp(prev2[:, j], cur[:, j - 1]),
                                 prev2[:, j - 1])
                cur[:, j] = logkap[:, i - 1, j - 1] + m
            prev2 = cur
        out[s:s + chunk] = prev2[:, L]
    return out.reshape(A, B)


def gak_grams(X_tr, X_te, sigma):
    """Unit-diagonal GAK train/test Grams (tslearn if present, else numpy)."""
    try:
        from tslearn.metrics import cdist_gak

        # cdist_gak returns unit-diagonal (normalised) Grams already
        G_tr = cdist_gak(X_tr[:, :, None], sigma=sigma)
        G_te = cdist_gak(X_te[:, :, None], X_tr[:, :, None], sigma=sigma)
        return G_tr, G_te
    except ImportError:
        lg_tr = _gak_log_gram(X_tr, X_tr, sigma)
        lg_te = _gak_log_gram(X_te, X_tr, sigma)
        lg_dte = np.diag(_gak_log_gram(X_te, X_te, sigma))
        d_tr = np.diag(lg_tr)
        G_tr = np.exp(lg_tr - 0.5 * (d_tr[:, None] + d_tr[None, :]))
        G_te = np.exp(lg_te - 0.5 * (lg_dte[:, None] + d_tr[None, :]))
        return G_tr, G_te


def main():
    from sklearn.svm import SVR
    from sklearn.model_selection import GridSearchCV

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--sigmas", nargs="*", type=float,
                default=[0.1, 0.25, 0.5, 1.0])
    ap.add_argument("--dyadic-order", type=int, default=0)
    ap.add_argument("--train-frac", type=float, default=0.8)
    ap.add_argument("--limit", type=int, default=400,
                    help="max number of windows (keeps the demo fast)")
    args = ap.parse_args()

    if args.data:
        prices = load_close_prices(args.data)
    else:
        if not args.synthetic:
            print("no --data given; using --synthetic prices")
        prices = synthetic_prices()

    X, y = make_windows(prices)
    if len(X) > args.limit:
        X, y = X[-args.limit:], y[-args.limit:]
    cut = int(args.train_frac * len(X))
    X_tr, X_te = X[:cut], X[cut:]
    y_tr, y_te = y[:cut], y[cut:]

    # paths for the signature kernel: add-time + scaled closes
    paths_tr = sk.transform(X_tr[:, :, None], at=True, scale=1.0)
    paths_te = sk.transform(X_te[:, :, None], at=True, scale=1.0)

    svr_grid = {"C": np.logspace(0, 4, 5), "epsilon": [1e-3, 1e-2]}
    results = {}

    # --- signature-PDE kernel (small sigma grid, selected by CV score) ------
    best = None
    for sigma in args.sigmas:
        sig = sk.SigKernel(sk.RBFKernel(sigma), args.dyadic_order)
        G_tr = np.asarray(sig.compute_Gram(jnp.asarray(paths_tr),
                                           jnp.asarray(paths_tr), sym=True))
        G_te = np.asarray(sig.compute_Gram(jnp.asarray(paths_te),
                                           jnp.asarray(paths_tr)))
        d_te = np.asarray(sig.compute_kernel(jnp.asarray(paths_te),
                                             jnp.asarray(paths_te)))
        Gn_tr, Gn_te = cosine_normalise(G_tr, G_te, d_te)
        m = GridSearchCV(SVR(kernel="precomputed"), svr_grid, cv=3)
        m.fit(Gn_tr, y_tr)
        if best is None or m.best_score_ > best[0]:
            best = (m.best_score_, m, Gn_te, sigma)
    _, m, Gn_te, sigma = best
    results["signature pde"] = mape(y_te, m.predict(Gn_te))
    print(f"sig-pde selected sigma={sigma:g}")

    # --- RBF baseline on flattened windows ----------------------------------
    from sklearn.metrics.pairwise import rbf_kernel
    K_tr = rbf_kernel(X_tr, X_tr)
    K_te = rbf_kernel(X_te, X_tr)
    m = GridSearchCV(SVR(kernel="precomputed"), svr_grid, cv=3)
    m.fit(K_tr, y_tr)
    results["rbf"] = mape(y_te, m.predict(K_te))

    # --- global alignment kernel (reference notebook's gak column) ----------
    # sigma grid around the Cuturi heuristic (data scale * sqrt(L))
    s0 = max(np.std(X_tr) * np.sqrt(X_tr.shape[1]), 1e-3)
    best = None
    for gsig in [0.1 * s0, s0, 5.0 * s0]:
        K_tr, K_te = gak_grams(X_tr, X_te, sigma=gsig)
        m = GridSearchCV(SVR(kernel="precomputed"), svr_grid, cv=3)
        m.fit(K_tr, y_tr)
        if best is None or m.best_score_ > best[0]:
            best = (m.best_score_, m, K_te, gsig)
    _, m, K_te, gsig = best
    results["gak"] = mape(y_te, m.predict(K_te))
    print(f"gak selected sigma={gsig:g}")

    # --- truncated signature kernel ------------------------------------------
    T_tr = sk.truncated_sig_kernel(paths_tr, paths_tr, num_levels=4)
    T_te = sk.truncated_sig_kernel(paths_te, paths_tr, num_levels=4)
    T_dte = np.diag(sk.truncated_sig_kernel(paths_te, paths_te,
                                            num_levels=4))
    T_tr, T_te = cosine_normalise(T_tr, T_te, T_dte)
    m = GridSearchCV(SVR(kernel="precomputed"), svr_grid, cv=3)
    m.fit(T_tr, y_tr)
    results["truncated sig"] = mape(y_te, m.predict(T_te))

    print("\nMAPE of mean price over next 2 days (lower is better):")
    for k, v in sorted(results.items(), key=lambda kv: kv[1]):
        print(f"  {k:15s} {v:7.3f}%")


if __name__ == "__main__":
    main()
