"""Task-outcome predictor used by ATLAS: two models (map / reduce, as in §4.2),
trained on TelemetryTrace logs and re-trained online every 10 simulated minutes.

The default algorithm is Random Forest (the paper's winner); every probability —
single proposal or candidate batch — flows through one choke point
(``predict_batch``) so the online broker (repro_torch.online.broker) can interpose
batched, memoised scoring without changing a single decision.  ``n_dispatches``
counts actual model invocations: the currency the broker optimises.

Models fit and score on ``device`` (CUDA unless told otherwise): on the card
every forest-family probability goes through the CUDA forest kernel, which
is bitwise equal to the numpy mirror, so decisions match the JAX package's
at every batch size."""

from __future__ import annotations

import numpy as np

from repro_torch.cluster.telemetry import TelemetryTrace, attempt_features
from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import ForestParams, forest_predict
from repro_torch.ml.models import ALL_MODELS


def forest_family_params(model) -> ForestParams | None:
    """The ForestParams of a single-forest model (Tree/CTree/R.F.), else None.
    Boost is multi-stage and GLM/NN are dense — those score via predict_proba."""
    params = getattr(model, "params", None)
    return params if isinstance(params, ForestParams) else None


class TaskPredictor:
    def __init__(self, algo: str = "R.F.", min_samples: int = 150,
                 max_train: int = 20000, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.algo = algo
        self.min_samples = min_samples
        self.max_train = max_train
        self.seed = seed
        self.map_model = None
        self.reduce_model = None
        self.fits = 0
        # dispatch accounting: one dispatch == one model invocation
        self.n_dispatches = 0
        self.n_rows_scored = 0

    # ------------------------------------------------------------------ train
    def fit(self, trace: TelemetryTrace) -> bool:
        return self.fit_datasets(*trace.datasets())

    def fit_datasets(self, map_data, reduce_data) -> bool:
        """Fit from raw (X, y) arrays — the form the fleet sweep ships across
        process boundaries so one training trace serves many cells."""
        (mx, my), (rx, ry) = map_data, reduce_data
        trained = False
        rng = np.random.RandomState(self.seed + self.fits)

        def sub(X, y):
            if X.shape[0] > self.max_train:
                idx = rng.choice(X.shape[0], self.max_train, replace=False)
                return X[idx], y[idx]
            return X, y

        if mx.shape[0] >= self.min_samples and len(np.unique(my)) > 1:
            X, y = sub(mx, my)
            self.map_model = ALL_MODELS[self.algo](device=self.device).fit(X, y)
            trained = True
        if rx.shape[0] >= self.min_samples and len(np.unique(ry)) > 1:
            X, y = sub(rx, ry)
            self.reduce_model = ALL_MODELS[self.algo](device=self.device).fit(X, y)
            trained = True
        self.fits += int(trained)
        if trained:
            self._models_changed()
        return trained

    def adopt(self, other: "TaskPredictor"):
        """Take over another predictor's trained models (drift-refresh promote:
        the candidate was fitted off to the side, evaluated, and won)."""
        self.map_model = other.map_model
        self.reduce_model = other.reduce_model
        self.fits = other.fits
        self._models_changed()

    def _models_changed(self):
        """Hook: the broker invalidates its memo when the models swap."""

    @property
    def ready(self) -> bool:
        return self.map_model is not None or self.reduce_model is not None

    # ------------------------------------------------------------------ infer
    def model_for_kind(self, kind: str):
        return self.map_model if kind == "map" else self.reduce_model

    def _model_for(self, task):
        return self.model_for_kind(task.kind)

    def predict_batch(self, kind: str, X: np.ndarray) -> np.ndarray:
        """Score a feature batch with the map/reduce model — the single choke
        point every probability flows through (and the unit of dispatch).

        Forest-family models score through ``forest_predict`` on the
        predictor's device at every batch size: the CUDA kernel on the card,
        its plain torch version on the CPU.  Both are bitwise equal to the
        numpy mirror, so scheduler decisions do not depend on candidate-set
        size, executor or device (the broker memoises these exact floats)."""
        model = self.model_for_kind(kind)
        if model is None:
            return np.ones(X.shape[0], np.float32)
        self.n_dispatches += 1
        self.n_rows_scored += X.shape[0]
        params = forest_family_params(model)
        if params is not None:
            return np.clip(forest_predict(params, X, device=self.device),
                           0.0, 1.0).astype(np.float32)
        return np.asarray(model.predict_proba(X), np.float32)

    def frame_stats(self) -> dict:
        """Live accounting snapshot for the obs layer (``Scheduler.
        frame_stats()["pred"]``).  The plain predictor has no memo, so the
        memo counters are structurally zero; BrokerPredictor overrides with
        its real accounting plus memo size/eviction fields."""
        return {"dispatches": self.n_dispatches, "rows": self.n_rows_scored,
                "memo_hits": 0, "memo_misses": 0, "demand_rows": 0}

    def begin_tick(self, sim, extra_keys=()):
        """Scheduler-tick hook (no-op here).  The online BrokerPredictor uses
        it to snapshot the pending queue and prime one batched flush."""

    def p_success(self, sim, task, node, speculative=False) -> float:
        if self.model_for_kind(task.kind) is None:
            return 1.0                  # untrained: skip feature construction
        x = attempt_features(sim, task, node, speculative)[None]
        return float(self.predict_batch(task.kind, x)[0])

    def p_success_nodes(self, sim, task, nodes, speculative=False) -> np.ndarray:
        """Batched scoring of candidate placements (one kernel call)."""
        if self.model_for_kind(task.kind) is None or not len(nodes):
            return np.ones(len(nodes), np.float32)
        X = np.stack([attempt_features(sim, task, n, speculative)
                      for n in nodes])
        return self.predict_batch(task.kind, X)

    # ------------------------------------------------------------------ state
    def snapshot(self) -> dict:
        """Serialisable trained state for the model registry (forest-family
        algos only — their whole model is one ForestParams)."""
        models = {}
        for kind in ("map", "reduce"):
            model = self.model_for_kind(kind)
            if model is None:
                models[kind] = None
                continue
            params = forest_family_params(model)
            if params is None:
                raise ValueError(
                    f"algo {self.algo!r} is not registry-serialisable "
                    "(only single-forest models: Tree, CTree, R.F.)")
            models[kind] = params
        return {"algo": self.algo, "seed": self.seed,
                "min_samples": self.min_samples, "max_train": self.max_train,
                "fits": self.fits, "models": models}

    def load_snapshot(self, snap: dict):
        """Restore trained models from ``snapshot()`` output — bit-identical
        scoring to the predictor that published it.

        This is the broker crash-recovery path (``AsyncBroker.
        from_registry``): a snapshot damaged by the very crash being
        recovered from must fail loudly here, not as a scoring-time
        ``KeyError`` three layers down."""
        missing = [k for k in ("algo", "seed", "min_samples", "max_train",
                               "fits", "models") if k not in snap]
        if missing:
            raise ValueError("malformed predictor snapshot: missing "
                             + ", ".join(missing))
        if snap["algo"] not in ALL_MODELS:
            raise ValueError(f"snapshot algo {snap['algo']!r} unknown; "
                             f"known: {', '.join(sorted(ALL_MODELS))}")
        self.algo = snap["algo"]
        self.seed = snap["seed"]
        self.min_samples = snap["min_samples"]
        self.max_train = snap["max_train"]
        self.fits = snap["fits"]
        for kind in ("map", "reduce"):
            params = snap["models"].get(kind)
            if params is None:
                model = None
            else:
                model = ALL_MODELS[self.algo](device=self.device)
                model.params = params
            if kind == "map":
                self.map_model = model
            else:
                self.reduce_model = model
        self._models_changed()
        return self
