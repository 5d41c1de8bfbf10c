"""10-fold random cross-validation harness (paper §4.1.3): accuracy, precision,
recall, error + wall time, per algorithm.  Every fold's model fits and scores
on ``device`` (CUDA unless told otherwise)."""

from __future__ import annotations

import time

import numpy as np

from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.models import ALL_MODELS


def metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    tn = float(((y_pred == 0) & (y_true == 0)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    tot = max(tp + tn + fp + fn, 1.0)
    return {
        "accuracy": (tp + tn) / tot,
        "precision": tp / max(tp + fp, 1.0),
        "recall": tp / max(tp + fn, 1.0),
        "error": (fp + fn) / tot,
    }


def cross_validate(model_name: str, X: np.ndarray, y: np.ndarray, *,
                   k: int = 10, seed: int = 0, max_n: int | None = 12000,
                   device=None) -> dict:
    """Random k-fold CV.  Returns mean metrics + total wall time (ms, host
    clock: on the card it includes waiting for each fold's results)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if max_n is not None and X.shape[0] > max_n:
        idx = rng.choice(X.shape[0], max_n, replace=False)
        X, y = X[idx], y[idx]
    N = X.shape[0]
    perm = rng.permutation(N)
    folds = np.array_split(perm, k)
    agg = {"accuracy": [], "precision": [], "recall": [], "error": []}
    t0 = time.perf_counter()
    for i in range(k):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        model = ALL_MODELS[model_name](device=dev)
        model.fit(X[train], y[train])
        pred = model.predict(X[test])
        m = metrics(y[test], pred)
        for kk in agg:
            agg[kk].append(m[kk])
    elapsed_ms = (time.perf_counter() - t0) * 1000.0
    out = {kk: float(np.mean(v)) for kk, v in agg.items()}
    out["time_ms"] = elapsed_ms
    out["n"] = N
    return out
