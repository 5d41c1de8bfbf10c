"""Instrumentation hooks: observers that turn live simulator / broker state
into metrics-core records and per-tick NDJSON frames.

The contract that keeps SWEEP byte-stability trivial: observers only *read*
simulation state (node counters, queue lengths, predictor accounting) and
never touch the RNG, the event heap, or any decision input — telemetry on
vs off cannot change a single scheduling decision.

``SimObserver`` rides the simulator event loop.  The per-event hot path is
*inlined into the loop itself*: the simulator increments a plain list the
observer owns (``event_counts``) and compares ``now`` against one float
(``next_frame_t``) — no python method call per event, which measures ~10x
cheaper than even a minimal callback.  Everything heavier (per-node
occupancy gather, failure deltas, JSON encoding) runs behind
``maybe_frame()``, reached only when simulated time crosses a frame
boundary (``frame_every`` simulated seconds), and a density gate inside it
skips the frame until at least ``min_events_per_frame`` events accumulated
since the last one.  The gate bounds telemetry to a fixed fraction of
event-processing work even on event-sparse cells (long simulated stretches,
few decisions), so the cost scales with events actually handled, never with
simulated time.  ``benchmarks/obs_overhead.py`` holds this to the <=5%
budget that lets the layer stay always-on.

``BrokerObserver`` hangs off ``PredictionBroker``: per-flush rows, queue
depth and wall latency land in fixed-bucket histograms + a latency ring for
exact p50/p99.  Flush-size/row counts are deterministic under the barrier
policy; wall latencies are not, and stay out of byte-stable artifacts.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry, percentile_from_hist
from repro_torch.obs.sink import EncodedList

# mirrors simulator's event-kind order (EV_SUBMIT..EV_RETRAIN)
EVENT_NAMES = ("submit", "attempt_end", "heartbeat", "chaos", "timeout",
               "node_recover", "retrain")

_OCC_EDGES = tuple(i / 10 for i in range(1, 11))                # 0.1 .. 1.0
FLUSH_ROW_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                   8192)
FLUSH_LATENCY_EDGES = tuple(s / 1e3 for s in                    # seconds
                            (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50,
                             100, 250))


def _round(x: float, nd: int = 4) -> float:
    return round(float(x), nd)


class SimObserver:
    """Streams per-tick fleet telemetry from one Simulator run.

    Frames go to ``sink`` (NDJSON file, memory, or a future transport); a
    deterministic roll-up is available from ``summary()`` after the run.
    """

    # (template registry, handle attribute dict) per ring capacity — built
    # on first use, cloned per observer so per-run init skips registration
    _templates: dict = {}

    @classmethod
    def _template(cls, ring_capacity: int):
        cached = cls._templates.get(ring_capacity)
        if cached is not None:
            return cached
        m = MetricsRegistry(ring_capacity=ring_capacity)
        handles = {"_ev0": m.counter(f"sim.events.{EVENT_NAMES[0]}")}
        for name in EVENT_NAMES[1:]:
            m.counter(f"sim.events.{name}")
        handles["h_frames"] = m.counter("sim.frames")
        handles["h_failures"] = m.counter("sim.failures")
        handles["h_occ"] = m.gauge("sim.occupancy")
        handles["h_pending"] = m.gauge("sim.pending")
        handles["h_penalty"] = m.gauge("sim.penalty_box")
        handles["h_running_jobs"] = m.gauge("sim.running_jobs")
        handles["h_alive"] = m.gauge("sim.nodes_alive")
        handles["h_stale_max"] = m.gauge("sim.hb_stale_max")
        handles["h_stale_mean"] = m.gauge("sim.hb_stale_mean")
        handles["h_memo_rate"] = m.gauge("pred.memo_hit_rate")
        handles["h_memo_size"] = m.gauge("pred.memo_size")
        handles["h_memo_evict"] = m.gauge("pred.memo_evictions")
        handles["h_fallbacks"] = m.gauge("pred.fallbacks")
        handles["h_retries"] = m.gauge("pred.retries")
        handles["h_reconnects"] = m.gauge("pred.reconnects")
        handles["_h_drift"] = {kind: (m.gauge(f"drift.{kind}.psi"),
                                      m.gauge(f"drift.{kind}.brier"))
                               for kind in ("map", "reduce")}
        handles["h_occ_hist"] = m.histogram("sim.occupancy_dist", _OCC_EDGES)
        m.freeze()
        cls._templates[ring_capacity] = (m, handles)
        return m, handles

    def __init__(self, sink=None, frame_every: float = 60.0,
                 min_events_per_frame: int = 192, ring_capacity: int = 256):
        self.sink = sink
        self.frame_every = float(frame_every)
        self.min_events_per_frame = int(min_events_per_frame)
        template, handles = self._template(int(ring_capacity))
        self.__dict__.update(handles)
        self.metrics = template.clone()
        self._drift = {}                 # kind -> latest signal dict
        self._events_pending: list[dict] = []
        # the simulator's inlined hot path: it bumps event_counts[kind] and
        # calls maybe_frame() only once `now` passes next_frame_t.  These
        # are cumulative per-kind counts, folded into the registry's
        # counter column at frame/summary time.
        self.event_counts = [0] * len(EVENT_NAMES)
        self.next_frame_t = self.frame_every
        self._ev_at_frame = 0            # total events at the last frame
        self._n_frames = 0
        self._occ_sum = 0.0
        self._finished = False
        self._summary_cache: dict | None = None

    # ------------------------------------------------------------ lifecycle
    def bind(self, sim):
        n = len(sim.nodes)
        self._slots = [float(s.spec.map_slots + s.spec.reduce_slots)
                       for s in sim.nodes]
        self._total_slots = max(sum(self._slots), 1.0)
        self._prev_fail = [0] * n
        # per-node occupancy lookup: round(r / slots, 3) for every running
        # count r from 0 to twice the node's slots, one shared table per
        # slot count (the same floats as rounding per frame)
        tables: dict[float, dict[int, float]] = {}
        for s in self._slots:
            if s not in tables:
                tables[s] = {r: round(r / s, 3)
                             for r in range(2 * int(s) + 2)}
        self._occ_tables = [tables[s] for s in self._slots]
        # the frame's per-node state, kept between frames: a frame re-reads
        # only the nodes whose running or failed counts (``changed_nodes``)
        # or last heartbeat (``beat_nodes``) may have moved, as the port's
        # simulator names them (every such change goes through its launch,
        # release or heartbeat); a simulator without those sets gets every
        # node re-read at every frame.  node_occ keeps each
        # value's JSON text beside it (float repr, as json writes it), so
        # NDJSONSink joins the texts instead of encoding 1000 floats.
        # Unchanged per-node lists are handed on as the same objects
        # (frames are never mutated after emit)
        self._changed = getattr(sim, "changed_nodes", None)
        self._beat = getattr(sim, "beat_nodes", None)
        self._all_nodes = range(n)
        self._running = [0] * n
        self._running_sum = 0
        self._occ_now = [tables[s][0] for s in self._slots]
        self._occ_text = [repr(v) for v in self._occ_now]
        self._node_occ = self._encoded(self._occ_now, self._occ_text)
        self._zero_fail = self._encoded([0] * n, ["0"] * n)
        self._beats = np.zeros(n, np.float64)
        for fresh in (self._changed, self._beat):
            if fresh is not None:
                fresh.update(self._all_nodes)       # the first frame: all
        if self.sink is not None:
            self.sink.emit({
                "type": "meta", "t": 0.0, "frame_every": self.frame_every,
                "n_nodes": n,
                "node_types": [s.spec.name for s in sim.nodes],
                "node_slots": [int(s) for s in self._slots],
                "scheduler": getattr(sim.scheduler, "name", "?"),
            })

    # ------------------------------------------------------------ hot path
    def after_event(self, sim, kind: int):
        """One simulator event: counter bump + boundary check.  The
        simulator's loop inlines this body directly (a list add + one float
        compare against ``next_frame_t``); this method is the same contract
        for tests and other event loops."""
        self.event_counts[kind] += 1
        if sim.now >= self.next_frame_t:
            self.maybe_frame(sim)

    def maybe_frame(self, sim):
        """Boundary reached: emit a frame unless the density gate says the
        stretch since the last frame was too event-sparse to be worth one
        (the gate keeps telemetry cost a bounded fraction of event work).
        On a sparse stretch the check defers to the *next* grid boundary —
        re-testing the gate on every subsequent event would itself become
        a per-event cost."""
        total = sum(self.event_counts)
        if total - self._ev_at_frame >= self.min_events_per_frame:
            self._emit_frame(sim)
        else:
            self.next_frame_t = (math.floor(sim.now / self.frame_every) + 1) \
                * self.frame_every

    # --------------------------------------------------------- drift/registry
    def record_drift(self, t: float, kind: str, psi: float,
                     brier: float | None, score_drift: float):
        h_psi, h_brier = self._h_drift[kind]
        self.metrics.set(h_psi, psi)
        if brier is not None:
            self.metrics.set(h_brier, brier)
        self._drift[kind] = {"t": _round(t, 2), "psi": _round(psi),
                             "brier": (None if brier is None
                                       else _round(brier)),
                             "score_drift": _round(score_drift)}

    def record_event(self, event: str, t: float, **kw):
        """Promote / rollback / retrain-skip markers (drained into frames)."""
        row = {"event": event, "t": _round(t, 2)}
        row.update({k: v for k, v in kw.items() if v is not None})
        self._events_pending.append(row)

    # ------------------------------------------------------------ frames
    def _emit_frame(self, sim):
        # stamp at the boundary grid, then advance past `now` (several quiet
        # frame periods collapse into one frame — no busywork on idle gaps)
        t = self.next_frame_t
        self.next_frame_t = (math.floor(sim.now / self.frame_every) + 1) \
            * self.frame_every
        m = self.metrics
        self._fold_events()
        self._ev_at_frame = sum(self.event_counts)
        # the JAX package's per-node pass, as values: per-node state re-read
        # where it may have moved, heartbeat staleness in float64 numpy
        # (elementwise the same operations, and a cumulative sum adds left
        # to right as the loop does)
        now = sim.now
        inv_hb = 1.0 / max(sim.heartbeat_interval, 1e-9)
        nodes, prev, running = sim.nodes, self._prev_fail, self._running
        changed, beat = self._changed, self._beat
        if changed is None:
            changed = self._all_nodes
        if beat is None:
            beat = self._all_nodes
        beats = self._beats
        for i in beat:
            beats[i] = nodes[i].last_heartbeat
        fails, occ_moved = {}, False
        for i in changed:
            node = nodes[i]
            r = node.running_maps + node.running_reduces
            if r != running[i]:
                self._running_sum += r - running[i]
                running[i] = r
                v = self._occ_tables[i].get(r)
                if v is None:                    # outside the table
                    v = round(r / self._slots[i], 3)
                self._occ_now[i] = v
                self._occ_text[i] = repr(v)
                occ_moved = True
            f = node.failed_count
            if f != prev[i]:
                fails[i] = f - prev[i]
                prev[i] = f
        if changed is self._changed:
            changed.clear()
        if beat is self._beat:
            beat.clear()
        if occ_moved:
            self._node_occ = self._encoded(self._occ_now, self._occ_text)
        node_occ = self._node_occ
        node_fail = self._zero_fail
        if fails:
            node_fail = list(node_fail)
            for i, d in fails.items():
                node_fail[i] = d
        running_sum, d_fail_sum = self._running_sum, sum(fails.values())
        hb_max = hb_sum = 0.0
        if nodes:
            stale = (now - beats) * inv_hb
            hb_max = float(stale.max())
            if not hb_max > 0.0:
                hb_max = 0.0
            hb_sum = float(np.cumsum(stale)[-1])
        n = max(len(nodes), 1)
        occ = running_sum / self._total_slots

        # direct column writes (the registry hands out plain int handles so
        # exactly this is possible: ~9 method calls per frame add up)
        c, g = m.counters, m.gauges
        c[self.h_frames] += 1
        c[self.h_failures] += d_fail_sum
        g[self.h_occ] = occ
        g[self.h_pending] = float(len(sim.pending))
        # typed scheduler snapshot: the one sanctioned window into
        # scheduler state — no more getattr-ing scheduler internals here
        sched_fs = sim.scheduler.frame_stats()
        pb_len = sched_fs["penalty_box"]
        g[self.h_penalty] = float(pb_len)
        g[self.h_running_jobs] = float(sim.n_running_jobs)
        g[self.h_alive] = float(len(sim._known_alive))
        g[self.h_stale_max] = hb_max
        g[self.h_stale_mean] = hb_sum / n
        m.observe(self.h_occ_hist, occ)
        pred = sched_fs["pred"]
        if pred is not None and pred["demand_rows"]:
            g[self.h_memo_rate] = pred["memo_hits"] / pred["demand_rows"]
        if pred is not None and "memo_size" in pred:
            g[self.h_memo_size] = float(pred["memo_size"])
            g[self.h_memo_evict] = float(pred["memo_evictions"])
        if pred is not None and "fallbacks" in pred:
            g[self.h_fallbacks] = float(pred["fallbacks"])
            g[self.h_retries] = float(pred.get("retries", 0))
            g[self.h_reconnects] = float(pred.get("reconnects", 0))
        m.tick(t)
        self._n_frames += 1
        self._occ_sum += occ

        if self.sink is not None:
            frame = {
                "type": "frame", "i": self._n_frames - 1, "t": _round(t, 2),
                "occ": _round(occ),
                "running": running_sum,
                "pending": len(sim.pending),
                "penalty_box": pb_len,
                "running_jobs": sim.n_running_jobs,
                "alive": len(sim._known_alive),
                "hb_stale_max": _round(hb_max),
                "node_occ": node_occ,
                "node_fail": node_fail,
            }
            if pred is not None:
                frame["pred"] = pred
            if self._drift:
                frame["drift"] = dict(self._drift)
            if self._events_pending:
                frame["events"] = self._events_pending
                self._events_pending = []
            self.sink.emit(frame)

    @staticmethod
    def _encoded(values: list, texts: list) -> EncodedList:
        out = EncodedList(values)
        out.json = "[" + ",".join(texts) + "]"
        return out

    def _fold_events(self):
        """Copy the sim-maintained cumulative event counts into the registry
        counter column (so ring ticks / snapshots see current values)."""
        c, e0 = self.metrics.counters, self._ev0
        for i, v in enumerate(self.event_counts):
            c[e0 + i] = v

    def finish(self, sim):
        """Final frame + job ledger + close — called once at end of run."""
        if self._finished:
            return
        self._finished = True
        self.next_frame_t = sim.now      # stamp the closing frame at run end
        self._emit_frame(sim)
        self._summary_cache = self.summary()
        if self.sink is not None:
            final = {"type": "final", "t": _round(sim.now, 2),
                     "summary": self.summary()}
            trace = getattr(sim, "trace", None)
            jobs = getattr(trace, "jobs", None)
            if jobs:
                final["jobs"] = [jobs[j] for j in sorted(jobs)]
            self.sink.emit(final)
            self.sink.close()

    # ------------------------------------------------------------ roll-up
    def summary(self) -> dict:
        """Deterministic per-run roll-up (no wall-clock, stable key order) —
        safe to stamp into byte-stable artifacts like SWEEP.json.  Computed
        once at ``finish()``; later calls return the cached roll-up."""
        if self._summary_cache is not None:
            return self._summary_cache
        self._fold_events()
        snap = self.metrics.snapshot()
        c, g = snap["counters"], snap["gauges"]
        nf = max(self._n_frames, 1)
        out = {
            "frames": self._n_frames,
            "frame_every": self.frame_every,
            "events": {name: c[f"sim.events.{name}"]
                       for name in EVENT_NAMES},
            "failures": c["sim.failures"],
            "occupancy_mean": _round(self._occ_sum / nf),
            "occupancy_last": _round(g["sim.occupancy"]),
            "memo_hit_rate": _round(g["pred.memo_hit_rate"]),
            "memo_evictions": int(g["pred.memo_evictions"]),
        }
        # fault-tolerance counters appear only when something actually
        # happened, so a clean run's summary (and the byte-stable SWEEP
        # perf.obs block built from it) is unchanged
        for name in ("fallbacks", "retries", "reconnects"):
            v = g[f"pred.{name}"]
            if v:
                out[name] = int(v)
        if self._drift:
            out["drift_last"] = dict(sorted(self._drift.items()))
        return out


class BrokerObserver:
    """Per-flush accounting for a PredictionBroker: queue depth / flush size
    histograms (deterministic under the barrier policy) plus a wall-latency
    ring for p50/p99 (reporting only — never stamped into stable artifacts).
    """

    def __init__(self, sink=None, latency_ring: int = 4096):
        m = MetricsRegistry(ring_capacity=64)
        self.h_flushes = m.counter("broker.flushes")
        self.h_requests = m.counter("broker.requests")
        self.h_rows = m.counter("broker.rows")
        self.h_dispatches = m.counter("broker.dispatches")
        self.h_flush_rows = m.histogram("broker.flush_rows", FLUSH_ROW_EDGES)
        self.h_flush_latency = m.histogram("broker.flush_latency_s",
                                           FLUSH_LATENCY_EDGES)
        self.metrics = m.freeze()
        self.sink = sink
        self._lat = np.zeros(latency_ring, np.float64)
        self._lat_n = 0

    def record_flush(self, rows: int, n_requests: int, n_dispatches: int,
                     latency_s: float):
        m = self.metrics
        m.inc(self.h_flushes)
        m.inc(self.h_requests, n_requests)
        m.inc(self.h_rows, rows)
        m.inc(self.h_dispatches, n_dispatches)
        m.observe(self.h_flush_rows, rows)
        m.observe(self.h_flush_latency, latency_s)
        self._lat[self._lat_n % self._lat.size] = latency_s
        self._lat_n += 1
        if self.sink is not None:
            self.sink.emit({"type": "flush", "i": self._lat_n - 1,
                            "rows": rows, "requests": n_requests,
                            "dispatches": n_dispatches,
                            "latency_ms": _round(latency_s * 1e3)})

    def latency_ms(self) -> dict:
        """Exact percentiles over the retained latency ring."""
        n = min(self._lat_n, self._lat.size)
        if n == 0:
            return {"p50": 0.0, "p99": 0.0}
        lat = np.sort(self._lat[:n]) * 1e3
        return {"p50": _round(lat[int(0.50 * (n - 1))], 3),
                "p99": _round(lat[int(0.99 * (n - 1))], 3)}

    def summary(self, *, deterministic_only: bool = False) -> dict:
        snap = self.metrics.snapshot()
        hist = snap["histograms"]["broker.flush_rows"]
        out = {
            **snap["counters"],
            "flush_rows_hist": {"edges": [int(e) for e in hist["edges"]],
                                "counts": hist["counts"]},
            "flush_rows_p50": percentile_from_hist(
                np.asarray(hist["edges"]), np.asarray(hist["counts"]), 0.5),
        }
        if not deterministic_only:
            lat = snap["histograms"]["broker.flush_latency_s"]
            out["flush_latency_hist_ms"] = {
                "edges": [_round(e * 1e3, 3) for e in lat["edges"]],
                "counts": lat["counts"]}
            out["flush_latency_ms"] = self.latency_ms()
        return out

    def close(self):
        if self.sink is not None:
            self.sink.close()
