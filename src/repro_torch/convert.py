"""Carry trained parameters across from the JAX package.

The JAX package's predictor serialises its trained state as a plain dict
(``TaskPredictor.snapshot()`` in ``repro/core/predictor.py``) whose models are
forest parameter objects with numpy ``feat_idx`` / ``thresholds`` /
``leaves`` attributes.  These functions read such objects by those attributes
alone, so this module imports nothing from the JAX package."""

from __future__ import annotations

import numpy as np

from repro_torch.core.predictor import TaskPredictor
from repro_torch.ml.forest import ForestParams


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


def predictor_from_snapshot(snap: dict, *, device=None) -> TaskPredictor:
    """A port ``TaskPredictor`` on ``device`` that scores exactly like the
    predictor whose ``snapshot()`` produced ``snap``."""
    if "models" in snap:                      # else load_snapshot says so
        snap = {**snap, "models": {
            kind: None if p is None else forest_params_from_arrays(
                p.feat_idx, p.thresholds, p.leaves)
            for kind, p in snap["models"].items()}}
    return TaskPredictor(device=device).load_snapshot(snap)
