"""Carry parameters across from the JAX package.

The JAX package's predictor serialises its trained state as a plain dict
(``TaskPredictor.snapshot()`` in ``repro/core/predictor.py``) whose models are
forest parameter objects with numpy ``feat_idx`` / ``thresholds`` /
``leaves`` attributes.  Its fitted GLM keeps ``mu`` / ``sd`` / ``wb`` and its
MLP ``mu`` / ``sd`` / ``params`` (w1, b1, w2, b2).  Its model zoo's
parameters and train state are nested dicts of arrays.  These functions
read such objects by those attributes and keys alone, so this module
imports nothing from the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictor import TaskPredictor
from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import ForestParams
from repro_torch.ml.models import GLM, NeuralNet
from repro_torch.parallel.axes import tree_map


def forest_params_from_arrays(feat_idx, thresholds, leaves) -> ForestParams:
    """A port ``ForestParams`` from (T, D), (T, D) and (T, 2^D) arrays."""
    fi = np.array(feat_idx, np.int32)
    th = np.array(thresholds, np.float32)
    lv = np.array(leaves, np.float32)
    if fi.ndim != 2 or th.shape != fi.shape \
            or lv.shape != (fi.shape[0], 1 << fi.shape[1]):
        raise ValueError(f"inconsistent forest shapes: feat_idx {fi.shape}, "
                         f"thresholds {th.shape}, leaves {lv.shape}")
    return ForestParams(feat_idx=fi, thresholds=th, leaves=lv)


def glm_from_arrays(mu, sd, wb, *, device=None) -> GLM:
    """A fitted port ``GLM`` from the standardisation (F,), (F,) and the
    weights-and-bias (F + 1,) arrays: it scores bitwise like the model
    they came from (``predict_proba`` is numpy on the host in both)."""
    model = GLM(device=device)
    model.mu, model.sd = np.array(mu, np.float32), np.array(sd, np.float32)
    model.wb = np.array(wb, np.float32)
    if model.wb.shape != (model.mu.shape[0] + 1,):
        raise ValueError(f"GLM weights {model.wb.shape} do not fit "
                         f"{model.mu.shape[0]} features")
    return model


def neural_net_from_arrays(mu, sd, params, *, device=None) -> NeuralNet:
    """A fitted port ``NeuralNet`` from the standardisation arrays and the
    MLP's parameters (a mapping with w1 (F, H), b1 (H,), w2 (H, 1), b2 (1,))."""
    model = NeuralNet(device=device)
    model.mu, model.sd = np.array(mu, np.float32), np.array(sd, np.float32)
    model.params = {k: np.array(params[k], np.float32)
                    for k in ("w1", "b1", "w2", "b2")}
    F, H = model.params["w1"].shape
    if F != model.mu.shape[0] or model.params["w2"].shape != (H, 1):
        raise ValueError(f"MLP shapes do not fit {model.mu.shape[0]} "
                         f"features: w1 {(F, H)}, "
                         f"w2 {model.params['w2'].shape}")
    return model


def predictor_from_snapshot(snap: dict, *, device=None) -> TaskPredictor:
    """A port ``TaskPredictor`` on ``device`` that scores exactly like the
    predictor whose ``snapshot()`` produced ``snap``."""
    if "models" in snap:                      # else load_snapshot says so
        snap = {**snap, "models": {
            kind: None if p is None else forest_params_from_arrays(
                p.feat_idx, p.thresholds, p.leaves)
            for kind, p in snap["models"].items()}}
    return TaskPredictor(device=device).load_snapshot(snap)


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # ml_dtypes: no numpy cast
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)     # a writable copy


def lm_params_from_jax(tree, *, device=None) -> dict:
    """The port's parameter tree, on ``device`` (None: CUDA, under the
    port's device rule), from a JAX model-zoo parameter tree (nested dicts
    of arrays, e.g. ``jax.tree.map(np.asarray, Model.init(key))``).  The
    two packages share paths, shapes and dtypes, so each leaf is copied as
    it is; with the result the port's ``Model`` computes the same function
    as the JAX ``Model`` with ``tree``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def train_state_from_jax(state, *, device=None) -> dict:
    """The port's train state, on ``device``, from the JAX package's
    ``{"params", "opt": {"m", "v", "count"}, "step"}`` (arrays, e.g.
    ``jax.tree.map(np.asarray, state)``): parameters and moments in their
    dtypes (bf16 included), ``count`` and ``step`` as 0-dim int32
    tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), state)
