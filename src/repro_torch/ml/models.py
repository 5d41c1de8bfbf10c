"""The forest family of the paper's predictive-learning algorithms (§4.1.3):

  Tree    single oblivious decision tree (variance/Gini criterion)
  CTree   conditional-inference-style tree (t-statistic-normalised gain)
  R.F.    random forest of oblivious trees (bagging), mean vote
  Boost   gradient boosting (logistic loss, depth-3 oblivious trees)

All expose fit(X, y) / predict_proba(X) with numpy in/out; fitting and
scoring run on the model's ``device`` (CUDA unless told otherwise).  GLM and
the MLP of the JAX package (``repro/ml/models.py``) are not ported yet, so
``ALL_MODELS`` holds the four forest-family keys."""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import (ForestParams, fit_oblivious_forest,
                                   forest_predict)


class BaseModel:
    name = "base"

    def __init__(self, *, device=None):
        self.device = resolve_device(device)

    def fit(self, X, y):
        raise NotImplementedError

    def predict_proba(self, X):
        raise NotImplementedError

    def predict(self, X, threshold=0.5):
        return (self.predict_proba(X) >= threshold).astype(np.float32)


class Tree(BaseModel):
    name = "Tree"
    criterion = "var"
    depth = 6

    def fit(self, X, y):
        self.params = fit_oblivious_forest(
            X, y, n_trees=1, depth=self.depth, n_bins=16, bootstrap=False,
            criterion=self.criterion, device=self.device)
        return self

    def predict_proba(self, X):
        return np.clip(forest_predict(self.params, X, device=self.device),
                       0.0, 1.0)


class CTree(Tree):
    name = "CTree"
    criterion = "ctree"


class RandomForest(BaseModel):
    name = "R.F."

    def __init__(self, n_trees=24, depth=5, n_bins=8, seed=0, *, device=None):
        super().__init__(device=device)
        self.n_trees, self.depth, self.n_bins, self.seed = \
            n_trees, depth, n_bins, seed

    def fit(self, X, y):
        self.params = fit_oblivious_forest(
            X, y, n_trees=self.n_trees, depth=self.depth, n_bins=self.n_bins,
            bootstrap=True, seed=self.seed, device=self.device)
        return self

    def predict_proba(self, X):
        return np.clip(forest_predict(self.params, X, device=self.device),
                       0.0, 1.0)


class Boost(BaseModel):
    """Gradient boosting with logistic loss and shallow oblivious trees."""
    name = "Boost"

    def __init__(self, rounds=20, depth=3, lr=0.3, n_bins=8, *, device=None):
        super().__init__(device=device)
        self.rounds, self.depth, self.lr, self.n_bins = rounds, depth, lr, n_bins

    def fit(self, X, y):
        N = X.shape[0]
        score = np.zeros(N, np.float32)
        self.stages: list[ForestParams] = []
        prior = float(np.clip(y.mean(), 1e-3, 1 - 1e-3))
        self.bias = float(np.log(prior / (1 - prior)))
        score += self.bias
        for r in range(self.rounds):
            p = 1.0 / (1.0 + np.exp(-score))
            resid = (y - p).astype(np.float32)       # negative gradient
            hess = np.maximum(p * (1 - p), 1e-3).astype(np.float32)
            # weighted least squares on resid/hess with weight hess:
            stage = fit_oblivious_forest(
                X, resid / hess, n_trees=1, depth=self.depth, n_bins=self.n_bins,
                bootstrap=False, sample_weight=hess, seed=r, device=self.device)
            self.stages.append(stage)
            score += self.lr * forest_predict(stage, X, device=self.device)
        return self

    def predict_proba(self, X):
        score = np.full(X.shape[0], self.bias, np.float32)
        for stage in self.stages:
            score += self.lr * forest_predict(stage, X, device=self.device)
        return 1.0 / (1.0 + np.exp(-score))


ALL_MODELS = {
    "Tree": Tree, "Boost": Boost, "CTree": CTree, "R.F.": RandomForest,
}
