"""The paper's six predictive-learning algorithms (§4.1.3), in PyTorch:

  GLM     logistic regression (Adam)
  Tree    single oblivious decision tree (variance/Gini criterion)
  CTree   conditional-inference-style tree (t-statistic-normalised gain)
  R.F.    random forest of oblivious trees (bagging), mean vote
  Boost   gradient boosting (logistic loss, depth-3 oblivious trees)
  N.N.    one-hidden-layer MLP (tanh, Adam)

All expose fit(X, y) / predict_proba(X) with numpy in/out; fitting runs on
the model's ``device`` (CUDA unless told otherwise), and so does the forest
family's scoring.  GLM and N.N. fit with an explicit Adam loop in full
float32 (TF32 off) and score on the host in numpy, as the JAX package does,
so given the same weights their probabilities are bitwise the JAX
package's.  Standardisation is folded into fit."""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import (ForestParams, _full_fp32_matmuls,
                                   fit_oblivious_forest, forest_predict)


def _standardize_fit(X):
    mu = X.mean(0)
    sd = X.std(0) + 1e-6
    return mu, sd


def _logistic_loss(z, y):
    """mean(log(1 + e^z) - y z).  ``torch.logaddexp``, not ``F.softplus``,
    which returns z itself above its threshold."""
    return torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)


def _adam(params: dict, loss_fn, steps: int, lr: float) -> dict:
    """``steps`` Adam updates of the tensors in ``params`` on ``loss_fn``,
    with the JAX package's rule: m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g²,
    both bias-corrected, eps 1e-8.  Returns the parameters as numpy."""
    params = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    with _full_fp32_matmuls():
        for t in range(1, steps + 1):
            grads = torch.autograd.grad(loss_fn(params),
                                        list(params.values()))
            # the corrections in float32, as the reference's float32 step
            bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k] = 0.9 * m[k] + 0.1 * g
                    v[k] = 0.999 * v[k] + 0.001 * g * g
                    p -= lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-8)
    return {k: p.detach().cpu().numpy() for k, p in params.items()}


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


# ---------------------------------------------------------------------------
# GLM
# ---------------------------------------------------------------------------

def _glm_fit(X, y, *, steps: int = 200, lr: float = 0.3,
             device=None) -> np.ndarray:
    """Logistic regression weights and bias (F + 1,) on standardised X,
    fitted on ``device`` with L2 1e-4."""
    dev = resolve_device(device)
    Xt = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    Xb = torch.cat([Xt, torch.ones((Xt.shape[0], 1), device=dev)], dim=1)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev)

    def loss(p):
        wb = p["wb"]
        return _logistic_loss(Xb @ wb, yt) + 1e-4 * torch.sum(wb * wb)

    wb0 = torch.zeros(Xb.shape[1], device=dev)
    return _adam({"wb": wb0}, loss, steps, lr)["wb"]


class GLM(BaseModel):
    name = "Glm"

    def fit(self, X, y):
        self.mu, self.sd = _standardize_fit(X)
        self.wb = _glm_fit((X - self.mu) / self.sd, y, device=self.device)
        return self

    def predict_proba(self, X):
        Xs = (X - self.mu) / self.sd
        z = Xs @ self.wb[:-1] + float(self.wb[-1])
        return 1.0 / (1.0 + np.exp(-z))


# ---------------------------------------------------------------------------
# Trees / forest
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Neural network
# ---------------------------------------------------------------------------

def _nn_init(F: int, hidden: int) -> dict:
    """The MLP's initial weights, drawn on the CPU from a ``torch.Generator``
    seeded 0 (the JAX package draws from ``PRNGKey(0)``, which torch cannot
    reproduce), so every device starts from the same draw."""
    g = torch.Generator().manual_seed(0)
    return {"w1": (torch.randn((F, hidden), generator=g)
                   / math.sqrt(F)).numpy(),
            "b1": np.zeros(hidden, np.float32),
            "w2": (torch.randn((hidden, 1), generator=g)
                   / math.sqrt(hidden)).numpy(),
            "b2": np.zeros(1, np.float32)}


def _nn_fit(X, y, *, steps: int = 400, hidden: int = 32, lr: float = 3e-3,
            init: dict | None = None, device=None) -> dict:
    """The MLP's parameters {w1, b1, w2, b2} (numpy), fitted on ``device``
    from ``init`` (arrays of those names; default ``_nn_init``)."""
    dev = resolve_device(device)
    Xt = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    if init is None:
        init = _nn_init(Xt.shape[1], hidden)
    params = {k: torch.tensor(np.asarray(init[k], np.float32), device=dev)
              for k in ("w1", "b1", "w2", "b2")}

    def loss(p):
        h = torch.tanh(Xt @ p["w1"] + p["b1"])
        return _logistic_loss((h @ p["w2"] + p["b2"])[:, 0], yt)

    return _adam(params, loss, steps, lr)


class NeuralNet(BaseModel):
    name = "N.N."

    def fit(self, X, y):
        self.mu, self.sd = _standardize_fit(X)
        self.params = _nn_fit((X - self.mu) / self.sd, y, device=self.device)
        return self

    def predict_proba(self, X):
        Xs = (X - self.mu) / self.sd
        p = self.params
        h = np.tanh(Xs @ p["w1"] + p["b1"])
        z = (h @ p["w2"] + p["b2"])[:, 0]
        return 1.0 / (1.0 + np.exp(-z))


ALL_MODELS = {
    "Tree": Tree, "Boost": Boost, "Glm": GLM, "CTree": CTree,
    "R.F.": RandomForest, "N.N.": NeuralNet,
}
