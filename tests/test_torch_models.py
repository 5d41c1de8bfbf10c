"""The port's six predictive models and CV harness (repro_torch.ml.models,
repro_torch.ml.cv) against the JAX package on the CPU.

GLM and N.N. fit with the reference's Adam rule and constants, so the
weights agree to float rounding: GLM within 1e-5, N.N.'s parameters within
1e-3 and its probabilities within 1e-4 when it starts from the reference's
``PRNGKey(0)`` draw (torch cannot reproduce JAX's generator, so the draw is
injected).  Given the same weights ``predict_proba`` is numpy in both
packages and bitwise equal.  The forest family's CV metrics are equal; the
dense models' within 0.005 (a flip of a prediction at 0.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.ml.forest as jforest
from repro.ml import cv as jcv
from repro.ml import models as jmodels
from repro_torch.convert import glm_from_arrays, neural_net_from_arrays
from repro_torch.ml import cv as tcv
from repro_torch.ml import forest as tforest
from repro_torch.ml import models as tmodels

CPU = "cpu"
FOREST_FAMILY = ("Tree", "CTree", "R.F.", "Boost")
DENSE_CV_TOL = 0.005


def _synthetic(n=2000, seed=0):
    """tests/test_ml_models.py's failure pattern: the outcome depends on a
    few features nonlinearly."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 8).astype(np.float32)
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 1.5 * (X[:, 2] > 0.5) - 0.6
    p = 1 / (1 + np.exp(-logit))
    y = (rs.rand(n) < p).astype(np.float32)
    return X, y


def _jax_nn_init(F, hidden):
    """The reference's initial MLP weights (``ml/models.py:_nn_fit``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"w1": np.asarray(jax.random.normal(k1, (F, hidden)) / jnp.sqrt(F)),
            "b1": np.zeros(hidden, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (hidden, 1))
                             / jnp.sqrt(hidden)),
            "b2": np.zeros(1, np.float32)}


@pytest.fixture(scope="module")
def data():
    return _synthetic(n=3000)


def test_all_models_keys_match_reference():
    assert list(tmodels.ALL_MODELS) == list(jmodels.ALL_MODELS)
    for name, cls in tmodels.ALL_MODELS.items():
        assert cls.name == jmodels.ALL_MODELS[name].name


def test_glm_weights_match_reference(data):
    X, y = data
    j = jmodels.GLM().fit(X, y)
    t = tmodels.GLM(device=CPU).fit(X, y)
    assert np.array_equal(t.mu, j.mu) and np.array_equal(t.sd, j.sd)
    assert t.wb.dtype == np.float32
    np.testing.assert_allclose(t.wb, np.asarray(j.wb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               rtol=0, atol=1e-5)


def test_nn_params_match_reference_from_its_init(data):
    X, y = data
    j = jmodels.NeuralNet().fit(X, y)
    Xs = (X - j.mu) / j.sd
    params = tmodels._nn_fit(Xs, y, init=_jax_nn_init(X.shape[1], 32),
                             device=CPU)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(params[k], np.asarray(j.params[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    t = neural_net_from_arrays(j.mu, j.sd, params, device=CPU)
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               rtol=0, atol=1e-4)


def test_nn_default_init_is_seeded_and_learns(data):
    X, y = data
    a = tmodels.NeuralNet(device=CPU).fit(X[:1500], y[:1500])
    b = tmodels.NeuralNet(device=CPU).fit(X[:1500], y[:1500])
    for k in a.params:
        assert np.array_equal(a.params[k], b.params[k])
    acc = (a.predict(X[1500:]) == y[1500:]).mean()
    base = max(y[1500:].mean(), 1 - y[1500:].mean())
    assert acc > base + 0.02


@pytest.mark.parametrize("algo", ["Glm", "N.N."])
def test_dense_predict_proba_bitwise_given_same_weights(data, algo):
    X, y = data
    Xq = _synthetic(n=200, seed=4)[0]
    if algo == "Glm":
        j = jmodels.GLM().fit(X, y)
        t = glm_from_arrays(j.mu, j.sd, j.wb, device=CPU)
    else:
        j = jmodels.NeuralNet().fit(X, y)
        t = neural_net_from_arrays(j.mu, j.sd, j.params, device=CPU)
    got, want = t.predict_proba(Xq), j.predict_proba(Xq)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(t.predict(Xq), j.predict(Xq))


def test_convert_rejects_mismatched_shapes():
    mu = sd = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="features"):
        glm_from_arrays(mu, sd, np.zeros(3, np.float32), device=CPU)
    params = {"w1": np.zeros((4, 2)), "b1": np.zeros(2), "w2": np.zeros((2, 1)),
              "b2": np.zeros(1)}
    with pytest.raises(ValueError, match="features"):
        neural_net_from_arrays(mu, sd, params, device=CPU)


def test_metrics_match_reference():
    rs = np.random.RandomState(3)
    yt = (rs.rand(101) > 0.4).astype(np.float32)
    yp = (rs.rand(101) > 0.5).astype(np.float32)
    assert tcv.metrics(yt, yp) == jcv.metrics(yt, yp)
    assert tcv.metrics(yt[:0], yp[:0]) == jcv.metrics(yt[:0], yp[:0])


@pytest.fixture(scope="module")
def cv_data():
    return _synthetic(n=300, seed=2)


@pytest.mark.parametrize("algo", list(jmodels.ALL_MODELS))
def test_cross_validate_matches_reference(cv_data, algo, monkeypatch):
    """4-fold CV with max_n below the rows, so the subsample is drawn too;
    equal folds of 60 rows keep the reference to one compiled shape.  N.N.
    starts from the reference's draw."""
    X, y = cv_data
    monkeypatch.setattr(tmodels, "_nn_init", _jax_nn_init)
    j = jcv.cross_validate(algo, X, y, k=4, seed=1, max_n=240)
    t = tcv.cross_validate(algo, X, y, k=4, seed=1, max_n=240, device=CPU)
    assert t["n"] == j["n"] == 240
    assert t["time_ms"] > 0
    for m in ("accuracy", "precision", "recall", "error"):
        if algo in FOREST_FAMILY:
            assert t[m] == j[m], m
        else:
            assert abs(t[m] - j[m]) <= DENSE_CV_TOL, m


def _fold_masks(N, K, seed=1):
    masks = np.ones((K, N), np.float32)
    for i, f in enumerate(np.array_split(
            np.random.RandomState(seed).permutation(N), K)):
        masks[i, f] = 0
    return masks


@pytest.mark.parametrize("bootstrap", [True, False])
def test_fold_mask_fit_matches_reference(bootstrap):
    X, y = _synthetic(n=300, seed=5)
    masks = _fold_masks(300, 3)
    kw = dict(n_trees=8, depth=4, seed=3, bootstrap=bootstrap,
              fold_masks=masks)
    j = jforest.fit_oblivious_forest(X, y, **kw)
    t = tforest.fit_oblivious_forest(X, y, device=CPU, **kw)
    assert t.feat_idx.shape == (24, 4)
    assert np.array_equal(t.feat_idx, j.feat_idx)
    assert np.array_equal(t.thresholds, j.thresholds)
    assert np.array_equal(t.leaves, j.leaves)


def test_fold_major_fit_equals_one_fit_per_fold():
    """Fold k's trees, sliced out, equal a fit on the fold's weights alone
    (bootstrap off: the weights are then the fold mask itself)."""
    X, y = _synthetic(n=300, seed=6)
    masks = _fold_masks(300, 3)
    batch = tforest.fit_oblivious_forest(X, y, n_trees=2, depth=3,
                                         bootstrap=False, fold_masks=masks,
                                         device=CPU)
    for k in range(3):
        one = tforest.fit_oblivious_forest(X, y, n_trees=2, depth=3,
                                           bootstrap=False,
                                           sample_weight=masks[k], device=CPU)
        sl = slice(2 * k, 2 * k + 2)
        assert np.array_equal(batch.feat_idx[sl], one.feat_idx)
        assert np.array_equal(batch.thresholds[sl], one.thresholds)


@pytest.mark.parametrize("sl", [slice(0, 8), slice(8, 16), slice(16, 24),
                                slice(3, 20, 2)])
def test_tree_slice_scoring_bitwise(sl):
    X, y = _synthetic(n=300, seed=7)
    params = tforest.fit_oblivious_forest(X, y, n_trees=8, depth=4, seed=2,
                                          fold_masks=_fold_masks(300, 3),
                                          device=CPU)
    want = tforest.forest_predict_np(params, X, tree_slice=sl)
    assert np.array_equal(
        tforest.forest_predict(params, X, tree_slice=sl, device=CPU), want)
    assert np.array_equal(
        tforest.forest_predict(params, X, tree_slice=sl, impl="numpy"), want)
    ref = jforest.ForestParams(feat_idx=params.feat_idx,
                               thresholds=params.thresholds,
                               leaves=params.leaves)
    assert np.array_equal(jforest.forest_predict_np(ref, X, tree_slice=sl),
                          want)
