"""Drift monitor + incremental refresher: retrain when the environment moves,
not only when the §5.1 clock says so.

The companion paper (arXiv:1507.03562) shows prediction quality degrades unless
the models track the changing cluster; Google-trace analyses (arXiv:2308.02358)
confirm failure characteristics drift.  ATLAS's fixed 600 s retrain clock is
kept as a *staleness fallback*; on top of it:

* ``DriftMonitor`` keeps a sliding window of launch-time features, outcomes and
  the probabilities the live model served for them, and flags
  - **feature drift**: mean PSI (population stability index) between the
    training-time feature histograms and the window's, and
  - **score drift**: the window Brier score degrading past the training-time
    reference.

* ``OnlineRefresher`` is the control loop ATLAS calls on its (now finer)
  retrain events: ingest new trace rows, check the monitors, and on a trigger
  fit a *candidate* off to the side, evaluate it against the live model on the
  window, then promote (publish to the ``ModelRegistry`` + swap in) or reject
  (archive the candidate, keep serving the old version) — every transition
  recorded.

Both are the JAX package's (``repro/online/drift.py``): numpy statistics on
the host, and a candidate predictor fitted and scored on the live predictor's
device.  With an observer attached (``OnlineRefresher.obs``, an
``obs.SimObserver``) every check records both kinds' drift signals and every
lifecycle event lands in the telemetry frames; recording only reads the
monitors, so no refresh decision moves."""

from __future__ import annotations

from collections import deque

import numpy as np


class DriftMonitor:
    """Sliding-window drift statistics for one model kind (map or reduce)."""

    def __init__(self, window: int = 512, n_hist_bins: int = 8,
                 psi_threshold: float = 0.25, brier_threshold: float = 0.08,
                 min_window: int = 64):
        self.window = window
        self.n_hist_bins = n_hist_bins
        self.psi_threshold = psi_threshold
        self.brier_threshold = brier_threshold
        self.min_window = min_window
        self._rows: deque = deque(maxlen=window)   # (x, y, p)
        self._edges = None                         # (F, bins-1) quantile edges
        self._ref_frac = None                      # (F, bins) reference mass
        self.reference_brier: float | None = None

    # ------------------------------------------------------------ reference
    def set_reference(self, X: np.ndarray, brier: float | None = None):
        """Anchor the monitor to the training distribution (at fit time)."""
        X = np.asarray(X, np.float32)
        qs = np.linspace(0.0, 1.0, self.n_hist_bins + 1)[1:-1]
        self._edges = np.quantile(X, qs, axis=0).T                 # (F, b-1)
        self._ref_frac = self._fractions(X)
        self.reference_brier = brier

    def _fractions(self, X: np.ndarray) -> np.ndarray:
        F = X.shape[1]
        out = np.empty((F, self.n_hist_bins), np.float64)
        for f in range(F):
            idx = np.searchsorted(self._edges[f], X[:, f], side="right")
            out[f] = np.bincount(idx, minlength=self.n_hist_bins) / X.shape[0]
        return out

    # ------------------------------------------------------------ streaming
    def observe(self, X: np.ndarray, y: np.ndarray, p: np.ndarray):
        for row, label, prob in zip(X, y, p):
            self._rows.append((row, float(label), float(prob)))

    def window_arrays(self):
        if not self._rows:
            return (np.zeros((0, 1), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.float32))
        X = np.stack([r[0] for r in self._rows])
        y = np.asarray([r[1] for r in self._rows], np.float32)
        p = np.asarray([r[2] for r in self._rows], np.float32)
        return X, y, p

    # ------------------------------------------------------------ signals
    def feature_psi(self) -> float:
        """Mean PSI over features between reference and window histograms."""
        if self._edges is None or len(self._rows) < self.min_window:
            return 0.0
        X, _, _ = self.window_arrays()
        cur = self._fractions(X)
        eps = 1e-4
        q = np.clip(self._ref_frac, eps, None)
        pfrac = np.clip(cur, eps, None)
        psi = ((pfrac - q) * np.log(pfrac / q)).sum(axis=1)        # per feature
        return float(psi.mean())

    def window_brier(self) -> float | None:
        if len(self._rows) < self.min_window:
            return None
        _, y, p = self.window_arrays()
        return float(np.mean((p - y) ** 2))

    def score_drift(self) -> float:
        wb = self.window_brier()
        if wb is None or self.reference_brier is None:
            return 0.0
        return wb - self.reference_brier

    def signals(self) -> dict:
        """All drift signals in one pass: {psi, brier, score_drift} — what
        the telemetry layer records per check and ``drifted`` thresholds."""
        wb = self.window_brier()
        sd = (0.0 if wb is None or self.reference_brier is None
              else wb - self.reference_brier)
        return {"psi": self.feature_psi(), "brier": wb, "score_drift": sd}

    def drifted(self) -> tuple[bool, str | None]:
        s = self.signals()
        if s["psi"] > self.psi_threshold:
            return True, f"feature_psi={s['psi']:.3f}"
        if s["score_drift"] > self.brier_threshold:
            return True, f"brier_drift={s['score_drift']:.3f}"
        return False, None


class OnlineRefresher:
    """Drift-aware predictor lifecycle: monitor -> candidate -> promote/reject.

    Deterministic given the trace: no wall-clock, no randomness beyond the
    predictor's own seeded subsampling."""

    def __init__(self, *, registry=None, name: str = "online",
                 retrain_every: float = 600.0, check_every: float = 60.0,
                 min_new_rows: int = 16, promote_tolerance: float = 0.02,
                 monitor_kw: dict | None = None):
        self.registry = registry
        self.name = name
        self.retrain_every = retrain_every
        self.check_every = check_every
        self.min_new_rows = min_new_rows
        self.promote_tolerance = promote_tolerance
        self.monitors = {k: DriftMonitor(**(monitor_kw or {}))
                         for k in ("map", "reduce")}
        self.predictor = None
        self.obs = None            # optional obs.SimObserver
        self.events: list[dict] = []
        self.refreshes = 0
        self.promotions = 0
        self.rollbacks = 0
        self._cursor = {"map": 0, "reduce": 0}
        self._last_fit_at = 0.0
        self._baselined = False
        self._now = 0.0

    def bind_predictor(self, predictor):
        self.predictor = predictor

    # ------------------------------------------------------------ ingestion
    def _new_rows(self, trace):
        (mx, my), (rx, ry) = trace.datasets()
        out = {}
        for kind, X, y in (("map", mx, my), ("reduce", rx, ry)):
            c = self._cursor[kind]
            out[kind] = (X[c:], y[c:])
            self._cursor[kind] = X.shape[0]
        return out

    # ------------------------------------------------------------ control
    def step(self, sim) -> bool:
        """Ingest new outcomes, check drift + staleness, maybe refresh.
        Returns True when a retrain was attempted."""
        pred = self.predictor
        self._now = sim.now
        if pred.ready and not self._baselined:
            # pre-fitted predictor (fleet payload / compare()): anchor the
            # reference now, or both drift signals stay inert until the first
            # staleness-clock promotion gets around to rebaselining
            self._rebaseline(sim.trace)
        new = self._new_rows(sim.trace)
        n_new = 0
        for kind, (X, y) in new.items():
            if X.shape[0] == 0 or pred.model_for_kind(kind) is None:
                continue
            p = pred.predict_batch(kind, X)    # one batched dispatch per kind
            self.monitors[kind].observe(X, y, p)
            n_new += X.shape[0]

        stale = sim.now - self._last_fit_at >= self.retrain_every
        reason = "staleness" if stale else None
        for kind, mon in self.monitors.items():
            if self.obs is None and reason is not None:
                break                          # obs-off: the early exit
            s = mon.signals()
            if self.obs is not None:
                self.obs.record_drift(sim.now, kind, s["psi"], s["brier"],
                                      s["score_drift"])
            if reason is None:
                if s["psi"] > mon.psi_threshold:
                    reason = f"{kind}:feature_psi={s['psi']:.3f}"
                elif s["score_drift"] > mon.brier_threshold:
                    reason = f"{kind}:brier_drift={s['score_drift']:.3f}"
        if reason is None:
            return False
        if not pred.ready and n_new == 0 and not stale:
            return False
        return self._refresh(sim, reason)

    def _holdout_datasets(self, trace):
        """Training data for a candidate, with each monitor's sliding window
        (the most recent rows, ingested in trace order) held out — the duel in
        ``_judge`` scores the candidate on those rows, and a candidate that
        trained on them would win on in-sample fit, not on tracking reality."""
        (mx, my), (rx, ry) = trace.datasets()
        out = []
        for kind, X, y in (("map", mx, my), ("reduce", rx, ry)):
            w = len(self.monitors[kind]._rows)
            if w and X.shape[0] > w:
                X, y = X[:-w], y[:-w]
            out.append((X, y))
        return out

    def _refresh(self, sim, reason: str) -> bool:
        from repro_torch.core.predictor import TaskPredictor
        pred = self.predictor
        self._last_fit_at = sim.now
        self.refreshes += 1
        # on the live predictor's device: the default would be CUDA
        candidate = TaskPredictor(algo=pred.algo, min_samples=pred.min_samples,
                                  max_train=pred.max_train, seed=pred.seed,
                                  device=pred.device)
        candidate.fits = pred.fits             # keep the subsample-rng stream
        if not candidate.fit_datasets(*self._holdout_datasets(sim.trace)):
            self._event("skip", reason=reason, detail="not enough samples")
            return True

        verdict, detail = self._judge(candidate)
        if verdict:
            pred.adopt(candidate)
            self.promotions += 1
            version = None
            if self.registry is not None:
                version = self.registry.publish(
                    self.name, pred.snapshot(),
                    meta={"reason": reason, "sim_now": sim.now}, promote=True)
            self._event("promote", reason=reason, detail=detail,
                        version=version)
            self._rebaseline(sim.trace)
        else:
            self.rollbacks += 1
            version = None
            if self.registry is not None:
                version = self.registry.publish(
                    self.name, candidate.snapshot(),
                    meta={"reason": reason, "rejected": True,
                          "sim_now": sim.now}, promote=False)
            self._event("rollback", reason=reason, detail=detail,
                        version=version)
        return True

    def _judge(self, candidate) -> tuple[bool, str]:
        """Hold-out duel on the sliding window: the candidate must not be
        meaningfully worse than the live model on recent reality."""
        pred = self.predictor
        old_b, new_b, n = 0.0, 0.0, 0
        for kind, mon in self.monitors.items():
            X, y, p_old = mon.window_arrays()
            if X.shape[0] < mon.min_window:
                continue
            if candidate.model_for_kind(kind) is None:
                continue
            p_new = candidate.predict_batch(kind, X)
            old_b += float(np.sum((p_old - y) ** 2))
            new_b += float(np.sum((p_new - y) ** 2))
            n += X.shape[0]
        if n == 0:
            return True, "no window evidence; promote"
        old_b, new_b = old_b / n, new_b / n
        ok = new_b <= old_b + self.promote_tolerance
        return ok, f"window_brier old={old_b:.4f} new={new_b:.4f}"

    def _rebaseline(self, trace):
        """Re-anchor the monitors to the live model's training view."""
        (mx, my), (rx, ry) = trace.datasets()
        pred = self.predictor
        for kind, X, y in (("map", mx, my), ("reduce", rx, ry)):
            if X.shape[0] == 0 or pred.model_for_kind(kind) is None:
                continue
            p = pred.predict_batch(kind, X)
            self.monitors[kind].set_reference(
                X, brier=float(np.mean((p - y) ** 2)))
            self._baselined = True

    def _event(self, event: str, **kw):
        self.events.append({"event": event, **kw})
        if self.obs is not None:               # lifecycle marker into frames
            self.obs.record_event(event, self._now, **kw)
