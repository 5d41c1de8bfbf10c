"""Batched prediction broker — the serving hot path of the ATLAS predictors.

Two layers, composable:

* ``BrokerPredictor`` (drop-in ``TaskPredictor``): batches *within* a scheduler
  tick.  ``begin_tick`` snapshots the schedulable set; the first request of the
  tick primes one vectorised flush over (pending ∪ penalty-box) tasks x
  free-slot nodes, and every later ``p_success`` / ``p_success_nodes`` in the
  tick is served from an exact-feature memo.  Misses (state moved under the
  tick — e.g. a launch consumed a slot) are flushed as their own small batch.
  Feature rows are written into preallocated columnar buffers in place —
  the per-request plumbing is an (offset, length) pair, not a fresh array.

* ``PredictionBroker``: batches *across* clients.  Requests append their rows
  into per-model columnar buffers under the broker lock; a flush scores each
  model's filled prefix as ONE slice of ONE block-diagonal pass
  (``ml.forest.forest_predict_grouped``) and scatters spans back.  Two flush
  policies:

    policy="barrier"  (default) a request parks until every registered client
                      has one queued (a lock-step round).  Rounds are a pure
                      function of each client's request sequence — no timers —
                      so flush/dispatch counts are deterministic and a
                      brokered sweep reproduces the serial sweep byte-for-byte.
                      When a single client remains (skewed wave: one long cell
                      running solo), the round would contain exactly its own
                      request, so ``submit`` scores it inline and skips the
                      park/notify machinery entirely (identical accounting).
    policy="depth"    queue-depth flush with bounded delay: flush as soon as
                      ``depth`` rows are queued, or ``max_delay`` seconds after
                      the first request of a batch arrived — whichever comes
                      first.  Tail batches stay fat on skewed waves at the
                      price of wall-clock timers (row-level outputs are still
                      bit-identical; flush *counts* become timing-dependent,
                      so the deterministic sweeps keep the barrier).

Exactness: probabilities must not depend on how requests are batched, or
decisions would drift between executors.  Per-row forest arithmetic is
batch-independent by construction (fixed-order tree mean + block-diagonal
segmentation — see ``ml.forest``), and every scoring path (the grouped CUDA
kernel, the single-forest kernel behind ``TaskPredictor.predict_batch``,
their plain torch versions and the numpy mirror) computes the same floats,
so memo hits, primed rows, fused flushes and scalar calls all produce
bit-identical probabilities for the forest family (Tree / CTree / R.F.) on
any fleet size.  Other algos score unfused via their own ``predict_proba``.

``impl`` selects the flush backend: ``None`` (default — by ``device``: the
grouped CUDA kernel on the card, its plain torch version on the CPU),
``"numpy"`` (the block-diagonal numpy pass, no device), or ``"cuda"`` /
``"torch"`` to force a path on ``device``."""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.cluster.telemetry import N_FEATURES, attempt_features
from repro_torch.core.predictor import TaskPredictor, forest_family_params
from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import forest_predict_grouped
from repro_torch.online.faults import PredictorUnavailableError

_EMPTY = np.zeros(0, np.float32)

# ---------------------------------------------------------------------------
# Vectorised feature hashing (the memo key).
#
# The memo used to key on row.tobytes() — a 88-byte allocation + copy per
# probe, per row.  Instead each float32 row is viewed as raw uint32 words and
# folded with TWO independent multiply-sum hashes over deterministic odd
# uint64 constants, vectorised over the whole flush.  Keys are (kind, h1, h2):
# 128 hash bits, so a collision (~2^-128 per pair) is effectively impossible
# and the forest bit-exactness guarantee still holds in practice.  Hashing is
# bit-pattern-based, exactly like tobytes(): equal keys <=> equal rows.
# ---------------------------------------------------------------------------

_HASH_CONSTS: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _hash_consts(width: int) -> tuple[np.ndarray, np.ndarray]:
    c = _HASH_CONSTS.get(width)
    if c is None:
        rng = np.random.default_rng(0xA71A5 + width)   # fixed, per width
        a = rng.integers(1, 2 ** 63, size=(2, width), dtype=np.uint64)
        a = a * np.uint64(2) + np.uint64(1)            # odd => full period
        _HASH_CONSTS[width] = c = (a[0], a[1])
    return c


def feature_hashes(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (h1, h2) uint64 hash pair for a float32 feature matrix —
    one vectorised multiply-sum per hash, no per-row allocation."""
    X = np.ascontiguousarray(X, np.float32)
    u = X.view(np.uint32).astype(np.uint64)
    a1, a2 = _hash_consts(X.shape[1])
    return (u * a1).sum(axis=1), (u * a2).sum(axis=1)


class _Column:
    """Columnar row buffer for one model: a preallocated float32 feature array
    appended in place; a flush reads the filled prefix as one slice."""

    __slots__ = ("params", "buf", "fill")

    def __init__(self, params, width: int, cap: int = 256):
        self.params = params
        self.buf = np.empty((cap, width), np.float32)
        self.fill = 0

    def append(self, X: np.ndarray) -> int:
        """Copy X into the buffer; returns the start offset of the span."""
        b = X.shape[0]
        need = self.fill + b
        if need > self.buf.shape[0]:
            new = np.empty((max(need, 2 * self.buf.shape[0]),
                            self.buf.shape[1]), np.float32)
            new[:self.fill] = self.buf[:self.fill]
            self.buf = new
        self.buf[self.fill:need] = X
        start, self.fill = self.fill, need
        return start

    def view(self) -> np.ndarray:
        return self.buf[:self.fill]

    def reset(self):
        self.fill = 0


def score_groups(groups, impl: str | None = None,
                 device=None) -> tuple[list, int]:
    """Score ``[(model, X)]`` -> ``([probs], n_dispatches)``.

    Forest-family requests are appended into per-model columnar buffers and
    scored as ONE block-diagonal pass (then sliced back apart — per-row
    arithmetic, so bit-identical to scoring each request alone).  Other models
    each cost one dispatch via their own ``predict_proba``.

    Coalescing happens HERE even though ``forest_predict_grouped`` also
    groups by model: handing it one contiguous column per model costs one
    extra (vectorised, ~µs) row copy but lets the predict_proba clip run once
    per model *block* — clipping per request would put thousands of small
    ``np.clip`` calls right back on the saturated-flush floor this module
    exists to remove."""
    outs: list = [None] * len(groups)
    cols: dict[int, _Column] = {}
    order: list[_Column] = []
    spans: list = []                          # (group idx, column, start, stop)
    n = 0
    for i, (model, X) in enumerate(groups):
        X = np.asarray(X, np.float32)
        if X.shape[0] == 0:
            outs[i] = _EMPTY
            continue
        params = forest_family_params(model)
        if params is None:
            outs[i] = np.asarray(model.predict_proba(X), np.float32)
            n += 1
            continue
        col = cols.get(id(params))
        if col is None:
            col = cols[id(params)] = _Column(params, X.shape[1])
            order.append(col)
        start = col.append(X)
        spans.append((i, col, start, start + X.shape[0]))
    if order:
        raw, passes = forest_predict_grouped(
            [(c.params, c.view()) for c in order], impl=impl, device=device)
        n += passes
        # same clip the forest models apply in predict_proba (elementwise,
        # so clipping the block then slicing == slicing then clipping)
        blocks = {id(c): np.clip(r, 0.0, 1.0).astype(np.float32)
                  for c, r in zip(order, raw)}
        for i, col, s, e in spans:
            outs[i] = blocks[id(col)][s:e]
    return outs, n


class _Pending:
    __slots__ = ("groups", "outs", "error", "done")

    def __init__(self, groups):
        self.groups = groups
        self.outs = None
        self.error = None
        self.done = False


class PredictionBroker:
    """Cross-client batching server with barrier or queue-depth flushes.

    Clients are registered up front (``add_clients``) so barrier-round
    membership never depends on thread start-up timing; each client calls
    ``done()`` (in a ``finally``) when its run completes.  ``submit`` blocks
    until the flush containing the request completes."""

    def __init__(self, impl: str | None = None, device=None,
                 policy: str = "barrier", depth: int = 256,
                 max_delay: float = 0.002):
        if policy not in ("barrier", "depth"):
            raise ValueError(f"unknown flush policy {policy!r}")
        self.impl = impl
        self.device = resolve_device(device)
        self.policy = policy
        self.depth = depth
        self.max_delay = max_delay
        self._cv = threading.Condition()
        self._queue: list[_Pending] = []
        self._queued_rows = 0
        self._clients = 0
        self._timer: threading.Timer | None = None
        self._timer_gen = 0
        # optional obs.BrokerObserver: per-flush rows/requests/latency
        self.obs = None
        # accounting
        self.n_flushes = 0
        self.n_dispatches = 0
        self.n_rows = 0
        self.n_requests = 0
        self.max_flush_rows = 0
        self.n_solo_flushes = 0
        self.n_deadline_flushes = 0

    # ------------------------------------------------------------ lifecycle
    def add_clients(self, n: int = 1):
        with self._cv:
            self._clients += n

    def done(self):
        """A client finished: it will never submit again, so a waiting round
        must not hold the barrier open for it."""
        with self._cv:
            self._clients -= 1
            if self.policy == "barrier" and self._queue \
                    and len(self._queue) >= max(self._clients, 1):
                self._flush_locked()

    # ------------------------------------------------------------ serving
    def submit(self, groups) -> list:
        """Block until this request's flush completes; returns one probability
        array per (model, X) group."""
        if not groups:
            return []
        with self._cv:
            self.n_requests += 1
            if self.policy == "barrier" and self._clients <= 1 \
                    and not self._queue:
                # solo client: a barrier round would contain exactly this one
                # request — score it inline (identical flush accounting)
                # instead of paying the park/notify machinery per request
                self.n_solo_flushes += 1
                return self._score(groups)
            p = _Pending(groups)
            self._queue.append(p)
            self._queued_rows += sum(np.asarray(X).shape[0]
                                     for _, X in groups)
            if self._should_flush():
                self._flush_locked()
            elif self.policy == "depth" and self._timer is None:
                self._arm_timer()
            while not p.done:
                self._cv.wait()
        if p.error is not None:
            raise p.error
        return p.outs

    def _should_flush(self) -> bool:
        if self.policy == "barrier":
            return len(self._queue) >= max(self._clients, 1)
        return self._queued_rows >= self.depth

    # ------------------------------------------------------------ depth timer
    def _arm_timer(self):
        self._timer_gen += 1
        gen = self._timer_gen
        t = threading.Timer(self.max_delay, self._deadline_flush, args=(gen,))
        t.daemon = True
        self._timer = t
        t.start()

    def _deadline_flush(self, gen: int):
        with self._cv:
            if gen != self._timer_gen:
                return                        # a depth flush beat the clock
            self._timer = None
            if self._queue:
                self.n_deadline_flushes += 1
                self._flush_locked()

    # ------------------------------------------------------------ flushing
    def _score(self, groups, n_requests: int = 1) -> list:
        """One flush of ``n_requests`` requests' groups.  The observer's
        wall latency spans the scoring call, which returns host arrays, so
        on the card it includes the kernel and both copies."""
        t0 = time.perf_counter()
        outs, n = score_groups(groups, impl=self.impl, device=self.device)
        rows = sum(np.asarray(X).shape[0] for _, X in groups)
        self.n_flushes += 1
        self.n_dispatches += n
        self.n_rows += rows
        self.max_flush_rows = max(self.max_flush_rows, rows)
        if self.obs is not None:
            self.obs.record_flush(rows, n_requests, n,
                                  time.perf_counter() - t0)
        return outs

    def _flush_locked(self):
        batch = self._queue
        self._queue = []
        self._queued_rows = 0
        self._timer_gen += 1                  # invalidate any pending timer
        self._timer = None
        try:
            outs = self._score([g for p in batch for g in p.groups],
                               len(batch))
            at = 0
            for p in batch:
                p.outs = outs[at:at + len(p.groups)]
                at += len(p.groups)
                p.done = True
        except Exception as e:  # surface in every waiting client
            for p in batch:
                p.error = e
                p.done = True
        finally:
            self._cv.notify_all()

    def stats(self) -> dict:
        # deterministic counters only: whether a given flush fired via the
        # solo bypass or a done()-triggered round (and whether a depth flush
        # beat its deadline timer) depends on thread interleaving, so the
        # cause counters (n_solo_flushes / n_deadline_flushes) stay off the
        # byte-stable SWEEP perf block and are read as attributes instead
        return {"flushes": self.n_flushes, "dispatches": self.n_dispatches,
                "rows": self.n_rows, "requests": self.n_requests,
                "max_flush_rows": self.max_flush_rows,
                "policy": self.policy}


class BrokerPredictor(TaskPredictor):
    """Drop-in ``TaskPredictor`` that serves probabilities through batched
    flushes (tick-primed memo + optional shared cross-cell broker) while
    producing bit-identical decisions to the per-decision path."""

    def __init__(self, *, broker=None, impl: str | None = None,
                 max_prime_rows: int = 4096, memo_cap: int = 65536,
                 fallback_probe_every: int = 64, **kw):
        super().__init__(**kw)
        self.broker = broker
        self.impl = impl
        self.max_prime_rows = max_prime_rows
        # graceful degradation (paper behavior: when the failure predictor
        # is unavailable, schedule anyway — never fail the task).  A broker
        # that stays unreachable past the client's retry budget flips
        # ``degraded``; degraded flushes answer p=1.0 for every row, which
        # is exactly the untrained-model semantics: the ATLAS gate passes
        # and the base scheduler's proposed placement goes through
        # deterministically.  Every ``fallback_probe_every``-th degraded
        # flush retries the broker for real (a logical cadence, no wall
        # clock) and a success clears the degradation.  Only
        # ``PredictorUnavailableError`` degrades: a scoring error the broker
        # reports (a kernel that failed to build or launch) stays an error.
        self.fallback_probe_every = int(fallback_probe_every)
        self.degraded = False
        self._probe_countdown = 0
        self.n_fallbacks = 0
        self.n_fallback_rows = 0
        # exact-feature memo bound: the memo clears per tick in fleet runs,
        # but a serving-mode predictor (no ticks — e.g. behind the
        # AsyncBroker on an open-loop stream) would otherwise grow it without
        # limit.  Eviction is insertion-ordered (python dicts iterate oldest
        # first), far above any tick's prime size by default so deterministic
        # sweep accounting never changes; evicted rows simply re-score
        # bit-identically on their next miss.
        self.memo_cap = int(memo_cap)
        self._memo: dict = {}
        self._primed = True          # no tick snapshot yet
        self._tick_sim = None
        self._tick_keys: tuple = ()
        # columnar scratch: per-kind prime buffers + candidate-set buffer,
        # preallocated once and appended in place tick after tick
        self._prime_bufs: dict[str, np.ndarray] = {}
        self._cand_buf = np.empty((64, N_FEATURES), np.float32)
        # demand-side accounting: what the per-decision path would have cost.
        # These depend only on the decision sequence, so they are identical
        # across executors (unlike dispatch counts, which the broker shrinks).
        self.n_demand_calls = 0
        self.n_demand_rows = 0
        self.n_memo_hits = 0
        self.n_memo_misses = 0
        self.n_memo_evictions = 0

    # ------------------------------------------------------------ tick hooks
    def begin_tick(self, sim, extra_keys=()):
        self._memo.clear()
        self._primed = False
        self._tick_sim = sim
        self._tick_keys = tuple(dict.fromkeys(
            tuple(sim.pending) + tuple(extra_keys)))

    def frame_stats(self) -> dict:
        # field order matters: NDJSON frame bytes must match the JAX
        # package's per-frame pred dict exactly (new keys append at the end)
        return {"dispatches": self.n_dispatches, "rows": self.n_rows_scored,
                "memo_hits": self.n_memo_hits,
                "memo_misses": self.n_memo_misses,
                "demand_rows": self.n_demand_rows,
                "memo_size": len(self._memo),
                "memo_evictions": self.n_memo_evictions,
                "fallbacks": self.n_fallbacks,
                "retries": getattr(self.broker, "n_retries", 0),
                "reconnects": getattr(self.broker, "n_reconnects", 0)}

    def _models_changed(self):
        # retrain/promote swaps the models: memoised probabilities are stale
        memo = getattr(self, "_memo", None)
        if memo is not None:
            memo.clear()

    # ------------------------------------------------------------ flushing
    def _flush(self, groups) -> list:
        if self.broker is not None:
            return self._flush_brokered(groups)
        outs, n = score_groups(groups, impl=self.impl, device=self.device)
        self.n_dispatches += n
        self.n_rows_scored += sum(np.asarray(X).shape[0] for _, X in groups)
        return outs

    def _flush_brokered(self, groups) -> list:
        if not self.degraded or self._probe_countdown <= 0:
            try:
                outs = self.broker.submit(groups)
                self.degraded = False
                return outs
            except PredictorUnavailableError:
                self.degraded = True
                self._probe_countdown = self.fallback_probe_every
        else:
            self._probe_countdown -= 1
        return self._fallback(groups)

    def _fallback(self, groups) -> list:
        """Degraded-mode answer: p=1.0 per row (schedule anyway).  Fallback
        rows do land in the tick memo, but the memo clears every
        ``begin_tick``, so stale optimism is bounded to one tick after the
        broker comes back."""
        self.n_fallbacks += 1
        outs = []
        for _, X in groups:
            rows = np.asarray(X).shape[0]
            self.n_fallback_rows += rows
            outs.append(np.ones(rows, np.float32))
        return outs

    def _memoize(self, kind: str, X: np.ndarray, probs: np.ndarray,
                 hashes=None):
        """Store per-row probabilities under vectorised (h1, h2) hash keys —
        one fused hash pass per flush instead of a tobytes() per row."""
        h1, h2 = feature_hashes(X) if hashes is None else hashes
        memo = self._memo
        for a, b, p in zip(h1.tolist(), h2.tolist(), probs):
            memo[(kind, a, b)] = np.float32(p)
        self._evict_memo()

    def _evict_memo(self):
        """Hold the memo at ``memo_cap`` entries, oldest insertions first."""
        memo = self._memo
        n_over = len(memo) - self.memo_cap
        if n_over > 0:
            it = iter(memo)
            for key in [next(it) for _ in range(n_over)]:
                del memo[key]
            self.n_memo_evictions += n_over

    def _prime_rows(self, kind: str, fill: int) -> tuple[np.ndarray, int]:
        """The kind's prime buffer with space for one more row at ``fill``."""
        buf = self._prime_bufs.get(kind)
        if buf is None:
            buf = self._prime_bufs[kind] = np.empty((256, N_FEATURES),
                                                    np.float32)
        if fill >= buf.shape[0]:
            new = np.empty((2 * buf.shape[0], N_FEATURES), np.float32)
            new[:fill] = buf[:fill]
            buf = self._prime_bufs[kind] = new
        return buf, fill

    def _prime(self, sim, extra_rows):
        """One batched flush covering the whole schedulable cross product
        (pending ∪ penalty-box tasks x nodes with a free slot of the right
        kind) plus the rows of the triggering request.  Rows append in place
        into preallocated per-kind columnar buffers."""
        self._primed = True
        fills: dict[str, int] = {}
        for kind, x in extra_rows:
            buf, fill = self._prime_rows(kind, fills.get(kind, 0))
            buf[fill] = x
            fills[kind] = fill + 1
        budget = self.max_prime_rows
        for key in self._tick_keys:
            if budget <= 0:
                break
            task = sim._task_by_key(key)
            if task is None or task.status != "pending":
                continue
            if self.model_for_kind(task.kind) is None:
                continue
            for node in sim.free_nodes(task.kind, liveness="any"):
                buf, fill = self._prime_rows(task.kind,
                                             fills.get(task.kind, 0))
                attempt_features(sim, task, node, False, out=buf[fill])
                fills[task.kind] = fill + 1
                budget -= 1
                if budget <= 0:
                    break
        kinds = [k for k, fill in fills.items()
                 if fill and self.model_for_kind(k) is not None]
        if not kinds:
            return
        groups = [(self.model_for_kind(k), self._prime_bufs[k][:fills[k]])
                  for k in kinds]
        outs = self._flush(groups)
        for k, (_, X), probs in zip(kinds, groups, outs):
            self._memoize(k, X, probs)

    # ------------------------------------------------------------ inference
    def p_success(self, sim, task, node, speculative=False) -> float:
        model = self.model_for_kind(task.kind)
        if model is None:
            return 1.0
        self.n_demand_calls += 1
        self.n_demand_rows += 1
        x = attempt_features(sim, task, node, speculative)
        if not self._primed:
            self._prime(sim, [(task.kind, x)])
        h1, h2 = feature_hashes(x[None])
        key = (task.kind, int(h1[0]), int(h2[0]))
        p = self._memo.get(key)
        if p is None:
            self.n_memo_misses += 1
            (out,) = self._flush([(model, x[None])])
            self._memo[key] = p = np.float32(out[0])
            self._evict_memo()
        else:
            self.n_memo_hits += 1
        return float(p)

    def p_success_nodes(self, sim, task, nodes, speculative=False) -> np.ndarray:
        model = self.model_for_kind(task.kind)
        if model is None or not len(nodes):
            return np.ones(len(nodes), np.float32)
        self.n_demand_calls += 1
        self.n_demand_rows += len(nodes)
        if len(nodes) > self._cand_buf.shape[0]:
            self._cand_buf = np.empty((2 * len(nodes), N_FEATURES),
                                      np.float32)
        X = self._cand_buf[:len(nodes)]
        for i, n in enumerate(nodes):
            attempt_features(sim, task, n, speculative, out=X[i])
        if not self._primed:
            self._prime(sim, [(task.kind, x) for x in X])
        h1, h2 = feature_hashes(X)           # one vectorised pass, all rows
        out = np.empty(len(nodes), np.float32)
        missing = []
        kind, memo = task.kind, self._memo
        for i in range(len(nodes)):
            p = memo.get((kind, int(h1[i]), int(h2[i])))
            if p is None:
                missing.append(i)
            else:
                self.n_memo_hits += 1
                out[i] = p
        if missing:
            self.n_memo_misses += len(missing)
            (scored,) = self._flush([(model, X[missing])])
            self._memoize(kind, X[missing], scored,
                          hashes=(h1[missing], h2[missing]))
            out[missing] = scored
        return out
