"""Columnar metrics core: counters, gauges and fixed-bucket histograms in
preallocated storage, keyed by a *static* registry.  Gauge columns, histogram
banks and the per-tick ring are numpy; the counter column is a plain python
list because a ``list[int] += 1`` beats a numpy scalar add ~5x at hot-path
granularity.

Design constraints (the reason this exists instead of a dict of floats):

* **Integer-index hot path.**  Instruments are registered up front; each
  registration returns a plain ``int`` handle.  Recording is one in-place
  array write (``counters[h] += n``) — no string hashing, no attribute
  lookups, no allocation — cheap enough that the simulator leaves telemetry
  on by default (the overhead budget in ``benchmarks/obs_overhead.py`` is
  the forcing function).
* **Preallocated ring buffers.**  ``tick(t)`` copies the current counter and
  gauge columns into a fixed-capacity ring, so the last K per-tick snapshots
  are always available for windowed queries (rates, deltas) without growing
  memory over arbitrarily long runs.
* **Deterministic snapshots.**  ``snapshot()`` is a pure function of the
  recorded values — no wall-clock, no iteration-order hazards (names are
  sorted at registration) — so frames built from it are reproducible and the
  SWEEP parity guarantee (telemetry on == telemetry off, byte-for-byte)
  reduces to "the obs layer never writes back into the simulation".
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"


class MetricsRegistry:
    """Static instrument registry + columnar storage.

    Usage::

        reg = MetricsRegistry()
        h_fail = reg.counter("sim.failures")
        h_occ = reg.gauge("sim.occupancy")
        h_flush = reg.histogram("broker.flush_rows", (1, 8, 64, 512, 4096))
        reg.freeze()
        reg.inc(h_fail)                 # hot path: one in-place int add
        reg.set(h_occ, 0.7)
        reg.observe(h_flush, 130.0)

    ``freeze()`` allocates the backing arrays; registering after freeze
    raises (the registry is static by design — a dynamic key set would put a
    dict probe back on the hot path).
    """

    def __init__(self, ring_capacity: int = 1024):
        self.ring_capacity = int(ring_capacity)
        self._counter_names: list[str] = []
        self._gauge_names: list[str] = []
        self._hist_names: list[str] = []
        self._hist_edges: list[np.ndarray] = []
        self._hist_edges_l: list[list[float]] = []
        self._frozen = False
        # counter/gauge columns and histogram bucket banks are plain python
        # lists: a list `+= 1` or store is ~5x cheaper than a numpy scalar
        # indexed write, and scalar writes are all the hot path does.
        # Columnar numpy enters at tick() (ring rows) and in observe_many(),
        # where vectorised aggregation actually pays.
        self.counters: list[int] | None = None
        self.gauges: list[float] | None = None
        self.hist_counts: list[list[int]] | None = None

    # ------------------------------------------------------------ registration
    def _register(self, names: list[str], name: str) -> int:
        if self._frozen:
            raise RuntimeError(
                f"registry is frozen; cannot register {name!r}")
        if name in names:
            raise ValueError(f"duplicate instrument name {name!r}")
        names.append(name)
        return len(names) - 1

    def counter(self, name: str) -> int:
        """Monotonic int64 counter; returns its integer handle."""
        return self._register(self._counter_names, name)

    def gauge(self, name: str) -> int:
        """Last-value float64 gauge; returns its integer handle."""
        return self._register(self._gauge_names, name)

    def histogram(self, name: str, edges) -> int:
        """Fixed-bucket histogram.  ``edges`` are the (sorted) upper bucket
        bounds; values land in the first bucket whose edge is >= value, with
        one implicit overflow bucket at the end (``len(edges) + 1`` buckets
        total)."""
        e = np.asarray(edges, np.float64)
        if e.ndim != 1 or e.size == 0 or np.any(np.diff(e) <= 0):
            raise ValueError(f"histogram {name!r}: edges must be a sorted "
                             "1-D sequence")
        h = self._register(self._hist_names, name)
        self._hist_edges.append(e)
        self._hist_edges_l.append(e.tolist())    # bisect wants a list
        return h

    def freeze(self) -> "MetricsRegistry":
        """Allocate backing storage; no further registration."""
        self._frozen = True
        self.counters = [0] * len(self._counter_names)
        self.gauges = [0.0] * len(self._gauge_names)
        self.hist_counts = [[0] * (e.size + 1) for e in self._hist_edges]
        self._ring_t = np.zeros(self.ring_capacity, np.float64)
        self._ring_counters = np.zeros(
            (self.ring_capacity, len(self._counter_names)), np.int64)
        self._ring_gauges = np.zeros(
            (self.ring_capacity, len(self._gauge_names)), np.float64)
        self._ring_head = 0          # next write slot
        self._ring_len = 0
        self.n_ticks = 0
        return self

    def clone(self) -> "MetricsRegistry":
        """Fresh zeroed storage sharing this frozen registry's schema.

        Observers created per simulation run pay registration (name checks,
        f-strings, edge validation) only once for a module-level template;
        every run then clones it — the clone allocates the mutable columns
        and rings but shares the immutable name lists and histogram edges.
        Handles are schema-relative, so they transfer unchanged."""
        if not self._frozen:
            raise RuntimeError("clone() requires a frozen registry")
        c = object.__new__(MetricsRegistry)
        c.ring_capacity = self.ring_capacity
        c._counter_names = self._counter_names      # shared, immutable-by-
        c._gauge_names = self._gauge_names          # convention after freeze
        c._hist_names = self._hist_names
        c._hist_edges = self._hist_edges
        c._hist_edges_l = self._hist_edges_l
        c._frozen = True
        return c.freeze()

    # ------------------------------------------------------------ hot path
    def inc(self, handle: int, n: int = 1):
        self.counters[handle] += n

    def set(self, handle: int, value: float):
        self.gauges[handle] = value

    def observe(self, handle: int, value: float):
        # pure-python bisect: a scalar numpy searchsorted costs ~an order of
        # magnitude more than C bisect + a list add on the frame path
        b = bisect_left(self._hist_edges_l[handle], value)
        self.hist_counts[handle][b] += 1

    def observe_many(self, handle: int, values):
        """Vectorised multi-observation (one searchsorted + bincount)."""
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return
        idx = np.searchsorted(self._hist_edges[handle], v, side="left")
        row = self.hist_counts[handle]
        for b, c in enumerate(np.bincount(idx)):
            row[b] += int(c)

    # ------------------------------------------------------------ ring buffer
    def tick(self, t: float):
        """Snapshot the counter/gauge columns into the ring at time ``t``."""
        i = self._ring_head
        self._ring_t[i] = t
        self._ring_counters[i] = self.counters
        self._ring_gauges[i] = self.gauges
        self._ring_head = (i + 1) % self.ring_capacity
        self._ring_len = min(self._ring_len + 1, self.ring_capacity)
        self.n_ticks += 1

    def ring(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(times, counter rows, gauge rows), oldest first — the retained
        window after any wraparound."""
        n, cap, head = self._ring_len, self.ring_capacity, self._ring_head
        if n < cap:
            sl = slice(0, n)
            return (self._ring_t[sl].copy(), self._ring_counters[sl].copy(),
                    self._ring_gauges[sl].copy())
        order = np.concatenate([np.arange(head, cap), np.arange(0, head)])
        return (self._ring_t[order], self._ring_counters[order],
                self._ring_gauges[order])

    def deltas(self, handle: int) -> np.ndarray:
        """Per-tick increments of one counter over the retained ring window."""
        _, c, _ = self.ring()
        col = c[:, handle]
        return np.diff(col, prepend=col[:1]) if col.size else col

    # ------------------------------------------------------- window views
    # Rolling read-side views over the ring for live consumers (the
    # TelemetryCollector): pure functions of ticked state, no mutation.

    def window(self, n: int | None = None):
        """Last-``n`` ring rows (times, counter rows, gauge rows), oldest
        first; the whole retained window when ``n`` is None."""
        t, c, g = self.ring()
        if n is not None and t.size > n:
            t, c, g = t[-n:], c[-n:], g[-n:]
        return t, c, g

    def counter_rate(self, handle: int, n: int | None = None) -> float:
        """Mean increment of one counter per unit of ring time over the
        last ``n`` ticks (0.0 with fewer than two ticks or zero span)."""
        t, c, _ = self.window(n)
        if t.size < 2:
            return 0.0
        span = float(t[-1] - t[0])
        if span <= 0.0:
            return 0.0
        return float(c[-1, handle] - c[0, handle]) / span

    def gauge_window(self, handle: int, n: int | None = None) -> dict:
        """min/mean/max/last of one gauge over the last ``n`` ring ticks."""
        _, _, g = self.window(n)
        col = g[:, handle]
        if col.size == 0:
            return {"min": 0.0, "mean": 0.0, "max": 0.0, "last": 0.0}
        return {"min": float(col.min()), "mean": float(col.mean()),
                "max": float(col.max()), "last": float(col[-1])}

    # ------------------------------------------------------------ export
    def names(self, kind: str) -> tuple[str, ...]:
        return tuple({COUNTER: self._counter_names, GAUGE: self._gauge_names,
                      HISTOGRAM: self._hist_names}[kind])

    def hist_edges(self, handle: int) -> np.ndarray:
        return self._hist_edges[handle]

    def snapshot(self) -> dict:
        """Current values as plain JSON-able python (deterministic order)."""
        hists = {}
        for i, name in enumerate(self._hist_names):
            hists[name] = {"edges": list(self._hist_edges_l[i]),
                           "counts": list(self.hist_counts[i])}
        return {
            "counters": {n: int(self.counters[i])
                         for i, n in enumerate(self._counter_names)},
            "gauges": {n: float(self.gauges[i])
                       for i, n in enumerate(self._gauge_names)},
            "histograms": hists,
        }


def percentile_from_hist(edges: np.ndarray, counts: np.ndarray,
                         q: float) -> float:
    """Approximate quantile from fixed-bucket counts (upper-edge estimate;
    the overflow bucket reports the last finite edge)."""
    total = int(counts.sum())
    if total == 0:
        return 0.0
    target = q * total
    acc = 0
    for b, c in enumerate(counts):
        acc += int(c)
        if acc >= target:
            return float(edges[min(b, len(edges) - 1)])
    return float(edges[-1])
