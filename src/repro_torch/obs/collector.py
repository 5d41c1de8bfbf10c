"""TelemetryCollector: the live consumer half of the telemetry wire.

``SimObserver → TransportSink → AsyncBroker → TelemetryCollector``: fleet
cells stream ``{"op": "telemetry"}`` frames over ``inproc://``/``tcp://``
(the ``online.transport`` comms), the broker routes them here, and the
collector folds each frame into rolling columnar aggregates — per-source
:class:`~repro_torch.obs.metrics.MetricsRegistry` clones (counters, gauges,
histograms + windowed ring views) plus a bounded retained-frame window the
live view re-renders from.  The HTTP side lives in
:mod:`repro_torch.obs.live`.

Design rules:

* **Observe, never perturb.**  The collector sits strictly downstream of
  the simulation: it holds no locks the sim path touches, and backpressure
  from a slow ``ingest`` propagates only through the transport's bounded
  channels — SWEEP.json stays byte-identical with the live path on.
* **Deterministic aggregates, wall-clock health.**  ``snapshot()`` splits
  ``"aggregates"`` (a pure fold over the ingested ``(source, frame)``
  sequence — replaying the ``/delta`` log or the post-hoc NDJSON files
  through a fresh collector reproduces it exactly) from ``"health"``
  (wall-clock lag, wire gaps/reconnects, ingest rate — reporting only).
* **Monotonic sequencing.**  Every ingested frame gets one global ``seq``
  from a single counter; ``delta(since)`` returns the contiguous suffix of
  the bounded log after ``since``, or flags ``resync`` when the log has
  evicted past it — a poller that chains ``since = last seq`` sees every
  frame exactly once, gaplessly, or learns it must re-snapshot.

Thread-safety: ``ingest`` runs on the broker's loop thread; ``snapshot`` /
``delta`` / ``frames_for`` run on HTTP handler threads.  One mutex guards
all state — folds are cheap (list appends + a few float stores), so the
critical section stays far below frame interarrival even under load.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from repro_torch.obs.instrument import FLUSH_ROW_EDGES, _OCC_EDGES
from repro_torch.obs.metrics import MetricsRegistry, percentile_from_hist

# queue depth (requests coalesced per broker flush) buckets
_FLUSH_REQ_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# rolling-window length (ring ticks) used for windowed rates/stats
_WINDOW = 128


def _template(ring_capacity: int) -> tuple[MetricsRegistry, dict]:
    m = MetricsRegistry(ring_capacity=ring_capacity)
    h = {
        "frames": m.counter("live.frames"),
        "sim_frames": m.counter("live.sim_frames"),
        "failures": m.counter("live.failures"),
        "flushes": m.counter("live.broker_flushes"),
        "rows": m.counter("live.broker_rows"),
        "occ": m.gauge("live.occ"),
        "pending": m.gauge("live.pending"),
        "penalty_box": m.gauge("live.penalty_box"),
        "running_jobs": m.gauge("live.running_jobs"),
        "alive": m.gauge("live.alive"),
        "hb_stale_max": m.gauge("live.hb_stale_max"),
        "drift_map_psi": m.gauge("live.drift.map.psi"),
        "drift_reduce_psi": m.gauge("live.drift.reduce.psi"),
        "pred_fallbacks": m.gauge("live.pred_fallbacks"),
        "pred_retries": m.gauge("live.pred_retries"),
        "pred_reconnects": m.gauge("live.pred_reconnects"),
        "occ_hist": m.histogram("live.occupancy_dist", _OCC_EDGES),
        "flush_rows": m.histogram("live.flush_rows", FLUSH_ROW_EDGES),
        "flush_reqs": m.histogram("live.flush_requests", _FLUSH_REQ_EDGES),
    }
    return m.freeze(), h


class _Source:
    """Per-producer fold state: metrics clone + retained frame window."""

    __slots__ = ("metrics", "frames", "meta", "final", "n_frames", "last_t",
                 "last_seq", "last_n", "gaps", "reconnects", "last_wall")

    def __init__(self, metrics: MetricsRegistry, frame_window: int):
        self.metrics = metrics
        self.frames: deque = deque(maxlen=frame_window)
        self.meta: dict | None = None
        self.final: dict | None = None
        self.n_frames = 0          # deterministic: frames folded
        self.last_t = 0.0          # deterministic: sim time of last frame
        self.last_seq = 0          # deterministic: global seq of last frame
        self.last_n = 0            # wire: producer's 1-based emit counter
        self.gaps = 0              # wire: frames the producer emitted
        #                            that never arrived (n jumped)
        self.reconnects = 0        # wire: producer counter restarted
        self.last_wall: float | None = None


class TelemetryCollector:
    """Folds a multi-producer telemetry stream into live aggregates.

    Parameters
    ----------
    delta_capacity:
        Bounded ``/delta`` log length (global, across sources).  A poller
        further behind than this gets ``resync: True``.
    frame_window:
        Retained frames per source for live rendering (plus meta/final).
    ring_capacity:
        Per-source metrics ring length (windowed rates/stats).
    """

    def __init__(self, *, delta_capacity: int = 8192,
                 frame_window: int = 512, ring_capacity: int = 256):
        self._lock = threading.Lock()
        self._template, self._h = _template(ring_capacity)
        self._frame_window = frame_window
        self._seq = 0
        self._log: deque = deque(maxlen=delta_capacity)
        self._evicted = 0          # delta-log entries dropped so far
        self.sources: dict[str, _Source] = {}
        self._wall_first: float | None = None
        self._wall_last: float | None = None

    # ------------------------------------------------------------- ingest
    def ingest(self, frame: dict, *, source: str = "default",
               n: int | None = None) -> int:
        """Fold one frame; returns its global sequence number.

        ``n`` is the producer's own 1-based emit counter (from
        ``TransportSink(source=...)``): jumps count as wire gaps, resets as
        reconnects.  Both are health-side only — the deterministic
        aggregates depend on nothing but the frame sequence itself."""
        now = time.time()
        with self._lock:
            self._seq += 1
            seq = self._seq
            src = self.sources.get(source)
            if src is None:
                src = self.sources[source] = _Source(
                    self._template.clone(), self._frame_window)
            if len(self._log) == self._log.maxlen:
                self._evicted += 1
            self._log.append({"seq": seq, "source": source, "frame": frame})
            if n is not None:
                if n <= src.last_n:
                    src.reconnects += 1
                elif n > src.last_n + 1:
                    src.gaps += n - src.last_n - 1
                src.last_n = n
            self._fold(src, frame)
            src.n_frames += 1
            src.last_seq = seq
            src.last_wall = now
            if self._wall_first is None:
                self._wall_first = now
            self._wall_last = now
            return seq

    def _fold(self, src: _Source, frame: dict):
        m, h = src.metrics, self._h
        m.inc(h["frames"])
        kind = frame.get("type")
        if kind == "frame":
            m.inc(h["sim_frames"])
            fails = sum(frame.get("node_fail", ()))
            if fails:
                m.inc(h["failures"], fails)
            m.set(h["occ"], frame["occ"])
            m.set(h["pending"], frame["pending"])
            m.set(h["penalty_box"], frame["penalty_box"])
            m.set(h["running_jobs"], frame["running_jobs"])
            m.set(h["alive"], frame["alive"])
            m.set(h["hb_stale_max"], frame["hb_stale_max"])
            m.observe(h["occ_hist"], frame["occ"])
            for dkind, sig in (frame.get("drift") or {}).items():
                key = f"drift_{dkind}_psi"
                if key in h and sig and sig.get("psi") is not None:
                    m.set(h[key], sig["psi"])
            pred = frame.get("pred")
            if pred and "fallbacks" in pred:
                m.set(h["pred_fallbacks"], pred["fallbacks"])
                m.set(h["pred_retries"], pred.get("retries", 0))
                m.set(h["pred_reconnects"], pred.get("reconnects", 0))
            src.last_t = float(frame["t"])
            m.tick(src.last_t)
            src.frames.append(frame)
        elif kind == "flush":
            m.inc(h["flushes"])
            rows = int(frame.get("rows", 0))
            m.inc(h["rows"], rows)
            m.observe(h["flush_rows"], rows)
            m.observe(h["flush_reqs"], int(frame.get("requests", 0)))
            src.frames.append(frame)
        elif kind == "meta":
            src.meta = frame
        elif kind == "final":
            src.final = frame

    # -------------------------------------------------------------- reads
    def _aggregate(self, src: _Source) -> dict:
        m, h = src.metrics, self._h
        snap = m.snapshot()
        c, g = snap["counters"], snap["gauges"]
        hists = snap["histograms"]

        def _q(name, q):
            hh = hists[name]
            return percentile_from_hist(np.asarray(hh["edges"]),
                                        np.asarray(hh["counts"]), q)

        agg = {
            "frames": src.n_frames,
            "t_last": src.last_t,
            "last_seq": src.last_seq,
        }
        if c["live.sim_frames"]:
            agg["sim"] = {
                "frames": c["live.sim_frames"],
                "failures": c["live.failures"],
                "failure_rate_w": round(
                    m.counter_rate(h["failures"], _WINDOW), 6),
                "occupancy": {k: round(v, 6) for k, v in
                              m.gauge_window(h["occ"], _WINDOW).items()},
                "occupancy_p50": _q("live.occupancy_dist", 0.50),
                "pending_last": g["live.pending"],
                "penalty_box_last": g["live.penalty_box"],
                "running_jobs_last": g["live.running_jobs"],
                "alive_last": g["live.alive"],
                "hb_stale_max": g["live.hb_stale_max"],
            }
            drift = {k: g[f"live.drift.{k}.psi"] for k in ("map", "reduce")
                     if g[f"live.drift.{k}.psi"]}
            if drift:
                agg["sim"]["drift_psi"] = drift
            # degradation counters surface only when nonzero, so clean-run
            # aggregates (and their replay comparisons) are unchanged
            for name in ("fallbacks", "retries", "reconnects"):
                v = g[f"live.pred_{name}"]
                if v:
                    agg["sim"][f"pred_{name}"] = int(v)
        if c["live.broker_flushes"]:
            agg["broker"] = {
                "flushes": c["live.broker_flushes"],
                "rows": c["live.broker_rows"],
                "flush_rows_p50": _q("live.flush_rows", 0.50),
                "flush_rows_p99": _q("live.flush_rows", 0.99),
                "queue_depth_p50": _q("live.flush_requests", 0.50),
                "queue_depth_p99": _q("live.flush_requests", 0.99),
            }
        if src.meta is not None:
            agg["meta"] = {k: src.meta[k] for k in
                           ("scheduler", "n_nodes", "frame_every")
                           if k in src.meta}
        if src.final is not None:
            agg["done"] = True
        return agg

    def _aggregates_locked(self) -> dict:
        return {name: self._aggregate(self.sources[name])
                for name in sorted(self.sources)}

    def _health_locked(self, now: float) -> dict:
        per = {}
        lag_max = 0.0
        for name in sorted(self.sources):
            src = self.sources[name]
            lag = (now - src.last_wall) if src.last_wall else 0.0
            lag_max = max(lag_max, lag)
            per[name] = {"lag_s": round(lag, 3), "wire_gaps": src.gaps,
                         "reconnects": src.reconnects,
                         "last_n": src.last_n}
        wall = ((self._wall_last - self._wall_first)
                if self._wall_first is not None else 0.0)
        return {
            "sources": per,
            "lag_max_s": round(lag_max, 3),
            "frames": self._seq,
            "wall_s": round(wall, 3),
            "frames_per_s": round(self._seq / wall, 1) if wall > 0 else 0.0,
            "delta_log_evicted": self._evicted,
        }

    def aggregates(self) -> dict:
        """Deterministic per-source roll-up — a pure function of the
        ingested ``(source, frame)`` sequence (replay-stable)."""
        with self._lock:
            return self._aggregates_locked()

    def health(self) -> dict:
        """Wall-clock reporting: per-source lag + wire accounting, global
        ingest rate.  Excluded from replay comparisons by design."""
        now = time.time()
        with self._lock:
            return self._health_locked(now)

    def snapshot(self) -> dict:
        """Full state: global seq + deterministic aggregates + health —
        one consistent cut (single lock acquisition)."""
        now = time.time()
        with self._lock:
            return {"seq": self._seq,
                    "aggregates": self._aggregates_locked(),
                    "health": self._health_locked(now)}

    def delta(self, since: int) -> dict:
        """Entries with ``seq > since``, oldest first, gapless.

        Pollers chain ``since = reply["seq"]``.  If the bounded log has
        already evicted ``since + 1`` the reply carries ``resync: True``
        plus ``dropped`` (count lost to this poller) and everything still
        retained — the client should re-pull ``/snapshot``.  A ``since``
        *ahead* of the current seq gets the same resync treatment: it means
        the poller's chain came from a previous collector incarnation (the
        consumer restarted underneath it), not from this counter — silently
        returning "no news" would wedge the poller forever."""
        with self._lock:
            if since > self._seq:
                return {"seq": self._seq, "resync": True, "dropped": 0,
                        "frames": list(self._log)}
            if since == self._seq:
                return {"seq": self._seq, "frames": []}
            oldest = self._log[0]["seq"] if self._log else self._seq + 1
            if since + 1 < oldest:
                return {"seq": self._seq, "resync": True,
                        "dropped": oldest - since - 1,
                        "frames": list(self._log)}
            out = [e for e in self._log if e["seq"] > since]
            return {"seq": self._seq, "frames": out}

    def frames_for(self, source: str) -> list[dict]:
        """Retained window for one source (meta + frames + final), for the
        live view's incremental re-render."""
        with self._lock:
            src = self.sources.get(source)
            if src is None:
                return []
            out = []
            if src.meta is not None:
                out.append(src.meta)
            out.extend(src.frames)
            if src.final is not None:
                out.append(src.final)
            return out

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def source_names(self) -> list[str]:
        with self._lock:
            return sorted(self.sources)
