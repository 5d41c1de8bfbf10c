"""AsyncBroker — the broker as a service: an asyncio serving loop over the
``repro_torch.online.transport`` comm layer.

``PredictionBroker`` batches across clients with a lock-step barrier (every
registered client parks one request per round) or a wall-clock depth timer.
Both develop a latency tail under open-loop traffic: the barrier makes every
request wait for the slowest client's next submit, and the timer trades tail
batches for 2 ms of deliberate jitter.  Since ATLAS puts a prediction on
every task placement, that tail is scheduler stall time.

``AsyncBroker`` replaces the thread barrier with an event loop and a
*virtual-time* flush policy:

  policy="vt"       requests are admitted in logical arrival order; ``vnow``
                    (the admission counter) is the clock.  A flush fires when
                      - the queued rows reach ``depth``            (depth cap)
                      - the oldest queued request has seen
                        ``vt_window`` admissions since its own     (staleness
                        admission                                   cap)
                      - the loop drains the currently-ready burst  (idle
                        of arrivals                                 drain)
                    The first two are pure functions of the admission
                    sequence — no wall clock anywhere in the steady state, so
                    flush composition is keyed to logical arrival order and
                    batches stay fat exactly when arrivals are dense.  The
                    idle drain is what kills the tail: whatever accumulated
                    while the previous flush was scoring goes out as the next
                    batch immediately (continuous batching), instead of
                    waiting for a timer or a straggler.  A per-request
                    latency budget (``slo_ms``, or ``budget_ms`` on the
                    request) arms one safety-valve timer per batch that
                    force-flushes early when the oldest request is about to
                    blow its SLO — the only wall-clock path, and it only
                    fires when the policy already failed to flush in time.
  policy="barrier"  the PredictionBroker lock-step round rule (flush when
                    every registered live client has a request parked),
                    driven by the loop instead of a condition variable.
                    Rounds — and therefore every stats() counter — are a
                    pure function of each client's request sequence, which is
                    what lets ``fleet --executor async`` reproduce the
                    threaded barrier executor's SWEEP.json byte for byte.

Wire protocol (one msg dict per frame; ndarray-safe over tcp://):

  {"op": "predict",  "id": n, "kind": "map", "X": ndarray,
   "budget_ms": 5.0}                 -> {"id": n, "probs": ndarray}
  {"op": "submit",   "id": n, "groups": [(model, X), ...]}
                                     -> {"id": n, "probs": [ndarray, ...]}
                                        (inproc only: live model objects)
  {"op": "register", "n": 4}         (barrier membership, no reply)
  {"op": "done"}                     (client will not submit again)
  {"op": "telemetry", "frame": {...},
   "source": "cell", "n": 7}         (telemetry frame -> collector +
                                      telemetry_sink; source/n optional:
                                      per-producer id + 1-based emit counter
                                      for gap/reconnect accounting)
  {"op": "telemetry", "source": "cell",
   "frames": [{"frame": {...}, "n": 7}, ...]}
                                     (batched form: TransportSink with
                                      flush_every > 1 ships one message
                                      per flush, per-frame n preserved)
  {"op": "stats"}                    -> deterministic counter dict
  {"op": "ping"}                     -> {"op": "pong"}

Row-level outputs are bit-identical to scalar scoring however requests are
batched (the ``score_groups`` invariant), so every policy serves the same
floats — the policies only move *when* a batch closes.

A flush scores on ``device`` (CUDA unless told otherwise): one pass of the
grouped forest kernel on the card, inline on the loop thread, so a batch
closes exactly where the JAX package's does.  ``start`` readies the loop
thread for that first pass (``ml.forest.warm_up``) before any client can
connect.  A scoring failure (a kernel that does not build or launch) is
replied as an error, which ``BrokerClient`` raises: it never turns into
``PredictorUnavailableError`` and the schedule-anyway fallback.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import os
import threading
import time

import numpy as np

from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.forest import warm_up
from repro_torch.online.broker import score_groups
from repro_torch.online.faults import (FaultInjector,
                                       PredictorUnavailableError,
                                       backoff_delay)
from repro_torch.online.transport import (CommClosedError, SyncComm, connect,
                                          listen)

_SERVE_SEQ = itertools.count()
_CLIENT_SEQ = itertools.count()


class _Req:
    """One admitted request: where to reply + its span of the next flush."""

    __slots__ = ("comm", "req_id", "groups", "rows", "vadmit", "deadline",
                 "client")

    def __init__(self, comm, req_id, groups, rows, vadmit, deadline,
                 client=None):
        self.comm = comm
        self.req_id = req_id
        self.groups = groups
        self.rows = rows
        self.vadmit = vadmit
        self.deadline = deadline
        self.client = client


class AsyncBroker:
    """Event-loop batching server for prediction traffic.

    ``models`` maps kind names ("map"/"reduce") to scoring models for the
    named-model ``predict`` op (the only op that works across tcp://);
    in-process clients may instead ship live model objects via ``submit``.
    The loop runs on a dedicated daemon thread (``start``/``stop``);
    ``serve`` binds any number of transport addresses onto it.  ``impl``
    and ``device`` are ``score_groups``'s: None scores by device, the
    grouped CUDA kernel on the card and its plain version on the CPU."""

    def __init__(self, models: dict | None = None, *,
                 impl: str | None = None, device=None, policy: str = "vt",
                 depth: int = 2048, vt_window: int | None = None,
                 slo_ms: float | None = None, slo_margin: float = 0.5,
                 max_queue_rows: int = 65536, serializer: str = "auto"):
        if policy not in ("vt", "barrier"):
            raise ValueError(f"unknown flush policy {policy!r}")
        self.models = dict(models or {})
        self.impl = impl
        self.device = resolve_device(device)
        self.policy = policy
        self.depth = int(depth)
        self.vt_window = vt_window
        self.slo_ms = slo_ms
        self.slo_margin = float(slo_margin)
        self.max_queue_rows = int(max_queue_rows)
        self.serializer = serializer
        # optional collaborators (duck-typed: anything with
        # ``record_flush`` / ``emit`` / ``ingest``, ``source_names`` and
        # ``sources``)
        self.obs = None                  # obs.BrokerObserver
        self.telemetry_sink = None       # obs Sink for telemetry frames
        self.collector = None            # obs.TelemetryCollector
        # per-source telemetry wire accounting (reporting only)
        self._telemetry_sources: dict[str, dict] = {}
        # idempotent-replay state: one outstanding request per client, so a
        # single slot per client id holds either the in-flight _Req (a
        # retransmit just re-aims its reply comm) or the finished reply (a
        # retransmit gets it resent verbatim — never rescored, never
        # recounted).  This is what makes client retries invisible to the
        # deterministic counters and keeps SWEEP.json byte parity under
        # fault injection.
        self._replay: dict[str, tuple] = {}
        self._done_clients: set[str] = set()
        self._injectors: list[FaultInjector] = []
        # loop state (loop-confined once started)
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._listeners: list = []
        self._queue: list[_Req] = []
        self._queued_rows = 0
        self._clients = 0
        self._vnow = 0
        self._epoch = 0
        self._slo_handle: asyncio.TimerHandle | None = None
        self._slo_at = float("inf")
        self._drain = None               # asyncio.Event, lazily on the loop
        # deterministic accounting (mirrors PredictionBroker.stats())
        self.n_flushes = 0
        self.n_dispatches = 0
        self.n_rows = 0
        self.n_requests = 0
        self.max_flush_rows = 0
        # cause counters (reporting only — depend on arrival timing)
        self.n_depth_flushes = 0
        self.n_vt_flushes = 0
        self.n_idle_flushes = 0
        self.n_deadline_flushes = 0
        self.n_backpressure_waits = 0
        self.n_telemetry_frames = 0
        self.n_replays = 0               # cached replies resent to retries
        self.n_dup_requests = 0          # retransmits of in-flight requests

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AsyncBroker":
        """Spin up the serving loop on its own daemon thread."""
        if self._thread is not None:
            return self
        ready = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self._drain = asyncio.Event()
            ready.set()
            self.loop.run_forever()
            # unwind whatever the stop() cancellation left behind
            pending = asyncio.all_tasks(self.loop)
            for t in pending:
                t.cancel()
            if pending:
                self.loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            self.loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="async-broker")
        self._thread.start()
        ready.wait()
        if self.impl in (None, "cuda"):
            # ready the flushes' thread before any client can connect
            try:
                asyncio.run_coroutine_threadsafe(self._warm(),
                                                 self.loop).result()
            except BaseException:
                self.stop()
                raise
        return self

    async def _warm(self):
        warm_up(self.device)

    def serve(self, address: str = "", *, fault_plan=None, **kw) -> str:
        """Bind a listener; returns the bound address (``tcp://…:0`` resolves
        its ephemeral port, no address picks a fresh inproc name).

        ``fault_plan`` (a ``faults.FaultPlan``) wraps every
        accepted comm in the plan's seeded fault schedule and arms its
        listener-restart events: at each ``restart_after`` threshold the
        listener goes down, every established connection dies abruptly, and
        the same concrete address rebinds — clients ride it out through
        their reconnect/retry path."""
        if not address:
            address = f"inproc://broker-{next(_SERVE_SEQ)}"
        kw.setdefault("serializer", self.serializer)
        handler = self._handle
        injector = None
        if fault_plan is not None:
            injector = FaultInjector(fault_plan)
            handler = injector.wrap_handler(self._handle)
        lst = asyncio.run_coroutine_threadsafe(
            listen(address, handler, **kw), self.loop).result(30)
        self._listeners.append(lst)
        if injector is not None:
            self._injectors.append(injector)
            bound = lst.address

            def trigger():               # fires on the loop thread
                asyncio.ensure_future(
                    self._restart_listener(bound, handler, injector, kw))

            injector.on_restart = trigger
        return lst.address

    async def _restart_listener(self, address, handler, injector, kw):
        """The broker-restart fault: tear the listener down (severing every
        live connection, no clean goodbyes) and rebind the same address."""
        for i, lst in enumerate(self._listeners):
            if lst.address == address:
                await lst.stop()
                await injector.close_active()
                self._listeners[i] = await listen(address, handler, **kw)
                return

    def stop(self):
        if self._thread is None:
            return

        async def shutdown():
            for lst in self._listeners:
                await lst.stop()
            self._listeners.clear()
            if self._queue:              # never strand a parked client
                self._flush("idle")

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    # ------------------------------------------------------------ recovery
    @classmethod
    def from_registry(cls, registry_dir, name: str, *,
                      version: int | None = None, device=None,
                      **kw) -> "AsyncBroker":
        """Rebuild a broker's model state from a ``ModelRegistry`` snapshot.

        This is the crash-recovery path: a replacement broker process owns
        no live model objects, but the registry's versioned snapshot is the
        durable source of truth (the JAX package's layout: a version either
        package published loads here).  Scoring is a pure function of (model
        params, rows), so the rebuilt broker serves bit-identical
        probabilities to the one that died.  The models and the broker live
        on ``device``."""
        from repro_torch.core.predictor import TaskPredictor
        from repro_torch.online.registry import ModelRegistry
        snap = ModelRegistry(registry_dir).load(name, version)
        pred = TaskPredictor(device=device).load_snapshot(snap)
        models = {}
        for kind in ("map", "reduce"):
            model = pred.model_for_kind(kind)
            if model is not None:
                models[kind] = model
        return cls(models, device=device, **kw)

    def resume_collector(self, collector):
        """Attach a telemetry collector after a broker restart, seeding the
        per-source wire accounting from the collector's surviving state so
        producers reconnect gaplessly: the first frame after the restart is
        judged against the last ``n`` actually ingested, not against zero
        (which would count every producer as one bogus reconnect-with-gap)."""
        self.collector = collector
        for name in collector.source_names():
            src = collector.sources[name]
            self._telemetry_sources[name] = {
                "frames": src.n_frames, "last_n": src.last_n,
                "gaps": src.gaps, "reconnects": src.reconnects,
                "ingest_s": 0.0}

    def fault_stats(self) -> dict:
        """Replay/dedup counters + injected-fault totals (reporting only —
        these quantify the chaos absorbed, and stay out of ``stats()`` so
        faulted and clean runs emit identical deterministic counters)."""
        injected = {"events": 0, "drops": 0, "delays": 0, "duplicates": 0,
                    "closes": 0, "restarts": 0, "messages_in": 0}
        for inj in self._injectors:
            for k, v in inj.stats().items():
                injected[k] += v
        return {"replays": self.n_replays,
                "dup_requests": self.n_dup_requests,
                "injected": injected}

    # ------------------------------------------------------------ membership
    def add_clients(self, n: int = 1):
        """Barrier-round membership (thread-safe; PredictionBroker API)."""
        if self.loop is not None and self._thread is not None:
            self.loop.call_soon_threadsafe(self._add_clients, n)
        else:
            self._add_clients(n)

    def _add_clients(self, n: int):
        self._clients += n

    def _client_done(self):
        self._clients -= 1
        if self.policy == "barrier" and self._queue \
                and len(self._queue) >= max(self._clients, 1):
            self._flush("round")

    # ------------------------------------------------------------ serving
    async def _handle(self, comm):
        try:
            while True:
                try:
                    msg = await comm.recv()
                except CommClosedError:
                    return
                try:
                    await self._dispatch(comm, msg)
                except CommClosedError:
                    # the connection died mid-reply (peer vanished, or an
                    # injected abrupt close): the client's retry path owns
                    # recovery — this handler just winds down
                    return
        finally:
            if not comm.closed:
                await comm.close()

    async def _dispatch(self, comm, msg):
        op = msg.get("op")
        if op == "predict" or op == "submit":
            if not self._replay_hit(comm, msg):
                await self._admit(comm, msg, op)
        elif op == "done":
            cid = msg.get("client")
            if cid is None:
                self._client_done()      # legacy fire-and-forget form
            else:
                if cid not in self._done_clients:
                    self._done_clients.add(cid)
                    self._replay.pop(cid, None)
                    self._client_done()
                if msg.get("id") is not None:
                    # acked so the client can retry a lost done
                    # without double-shrinking the barrier
                    await comm.send({"id": msg["id"], "ok": True})
        elif op == "register":
            self._add_clients(int(msg.get("n", 1)))
        elif op == "telemetry":
            self._route_telemetry(msg)
        elif op == "stats":
            await comm.send(self.stats())
        elif op == "ping":
            await comm.send({"op": "pong"})
        else:
            await comm.send({"id": msg.get("id"),
                             "error": f"unknown op {op!r}"})

    def _replay_hit(self, comm, msg) -> bool:
        """Idempotent-replay check for a scoring request.

        Returns True when the message is a retransmit (same client id +
        request id as this client's one outstanding slot): a still-pending
        original just gets its reply re-aimed at the new comm, a finished
        one gets the cached reply resent.  Either way the request is never
        re-admitted — ``n_requests``/flush composition see it exactly once.
        Messages without a ``client`` field (raw-comm callers) bypass
        dedup entirely."""
        cid = msg.get("client")
        if cid is None:
            return False
        entry = self._replay.get(cid)
        if entry is None or entry[0] != msg.get("id"):
            return False
        self.n_dup_requests += 1
        _, state, val = entry
        if state == "pending":
            val.comm = comm              # reply lands on the fresh comm
        else:
            self.n_replays += 1
            self._send_cached(comm, val)
        return True

    def _send_cached(self, comm, msg: dict):
        if comm.closed:
            return
        task = asyncio.ensure_future(comm.send(msg))
        task.add_done_callback(_swallow_closed)

    async def _admit(self, comm, msg, op):
        if op == "predict":
            model = self.models.get(msg.get("kind"))
            if model is None:
                await comm.send({"id": msg.get("id"),
                                 "error": f"unknown kind {msg.get('kind')!r}"})
                return
            groups = [(model, msg["X"])]
        else:
            groups = msg["groups"]
        rows = sum(np.asarray(X).shape[0] for _, X in groups)
        # bounded-queue admission control: a full queue parks THIS comm's
        # read loop until a flush drains — over tcp the stall propagates to
        # the client through the kernel socket buffer (backpressure, not
        # load shedding: every admitted request is eventually served)
        if self.policy == "vt":
            while self._queued_rows >= self.max_queue_rows:
                self.n_backpressure_waits += 1
                self._drain.clear()
                await self._drain.wait()
        self.n_requests += 1
        budget = msg.get("budget_ms", self.slo_ms)
        deadline = (time.perf_counter() + budget * 1e-3 * self.slo_margin
                    if budget else None)
        self._vnow += 1
        req = _Req(comm, msg.get("id"), groups, rows, self._vnow, deadline,
                   msg.get("client"))
        if req.client is not None:
            self._replay[req.client] = (req.req_id, "pending", req)
        first = not self._queue
        self._queue.append(req)
        self._queued_rows += rows
        if self.policy == "barrier":
            if len(self._queue) >= max(self._clients, 1):
                self._flush("round")
            return
        # ---- virtual-time policy ----
        if self._queued_rows >= self.depth:
            self.n_depth_flushes += 1
            self._flush("depth")
            return
        if self.vt_window is not None \
                and self._vnow - self._queue[0].vadmit >= self.vt_window:
            self.n_vt_flushes += 1
            self._flush("vt")
            return
        if first:
            # idle drain: runs after the callbacks already ready this loop
            # iteration, so one dense burst of arrivals lands in one batch
            self.loop.call_soon(self._idle_flush, self._epoch)
        if deadline is not None and deadline < self._slo_at:
            self._arm_slo(deadline)

    # ------------------------------------------------------------ flush paths
    def _idle_flush(self, epoch: int):
        if epoch == self._epoch and self._queue:
            self.n_idle_flushes += 1
            self._flush("idle")

    def _arm_slo(self, deadline: float):
        if self._slo_handle is not None:
            self._slo_handle.cancel()
        self._slo_at = deadline
        delay = max(deadline - time.perf_counter(), 0.0)
        self._slo_handle = self.loop.call_later(
            delay, self._slo_flush, self._epoch)

    def _slo_flush(self, epoch: int):
        self._slo_handle = None
        self._slo_at = float("inf")
        if epoch == self._epoch and self._queue:
            self.n_deadline_flushes += 1
            self._flush("slo")

    def _flush(self, cause: str):
        batch, self._queue = self._queue, []
        rows, self._queued_rows = self._queued_rows, 0
        self._epoch += 1
        if self._slo_handle is not None:
            self._slo_handle.cancel()
            self._slo_handle = None
            self._slo_at = float("inf")
        self._drain.set()
        flat = [g for req in batch for g in req.groups]
        t0 = time.perf_counter()
        try:
            outs, n = score_groups(flat, impl=self.impl, device=self.device)
        except Exception as e:
            for req in batch:
                self._reply(req, {"id": req.req_id, "error": repr(e)})
            return
        self.n_flushes += 1
        self.n_dispatches += n
        self.n_rows += rows
        self.max_flush_rows = max(self.max_flush_rows, rows)
        if self.obs is not None:
            self.obs.record_flush(rows, len(batch), n,
                                  time.perf_counter() - t0)
        at = 0
        for req in batch:
            span = outs[at:at + len(req.groups)]
            at += len(req.groups)
            self._reply(req, {"id": req.req_id, "probs": span})

    def _reply(self, req: _Req, msg: dict):
        if req.client is not None:
            # cache even error replies: scoring is deterministic, so a retry
            # of a failed request deserves the same verdict, not a rescore
            self._replay[req.client] = (req.req_id, "done", msg)
        if req.comm.closed:
            return
        task = asyncio.ensure_future(req.comm.send(msg))
        task.add_done_callback(_swallow_closed)

    # ------------------------------------------------------------ telemetry
    def _route_telemetry(self, msg: dict):
        """Fan telemetry frames to the registered consumers.

        One message carries a single ``frame`` or a batched ``frames`` list
        (each entry ``{"frame": …, "n": …}`` — ``TransportSink`` batches
        like ``NDJSONSink`` does).  Runs on the loop thread inside the
        client's handler coroutine, so a slow ``collector.ingest`` parks
        exactly that producer's channel — backpressure reaches the emitting
        ``TransportSink`` through the transport's bounded buffers instead of
        growing a queue here.  The time spent is accounted per source
        (``ingest_s``) so a wedged collector is visible in
        ``telemetry_stats()``."""
        entries = msg.get("frames")
        if entries is None:
            entries = ({"frame": msg["frame"], "n": msg.get("n")},)
        source = msg.get("source", "default")
        st = self._telemetry_sources.get(source)
        if st is None:
            st = self._telemetry_sources[source] = {
                "frames": 0, "last_n": 0, "gaps": 0, "reconnects": 0,
                "ingest_s": 0.0}
        for entry in entries:
            self.n_telemetry_frames += 1
            st["frames"] += 1
            n = entry.get("n")
            if n is not None:
                if n <= st["last_n"]:
                    st["reconnects"] += 1
                elif n > st["last_n"] + 1:
                    st["gaps"] += n - st["last_n"] - 1
                st["last_n"] = n
            if self.collector is not None:
                t0 = time.perf_counter()
                self.collector.ingest(entry["frame"], source=source, n=n)
                st["ingest_s"] += time.perf_counter() - t0
            if self.telemetry_sink is not None:
                self.telemetry_sink.emit(entry["frame"])

    def telemetry_stats(self) -> dict:
        """Per-source telemetry wire accounting.  Reporting only — values
        depend on arrival order and wall clock, so this stays out of the
        deterministic ``stats()`` dict."""
        return {"frames": self.n_telemetry_frames,
                "sources": {k: {**v, "ingest_s": round(v["ingest_s"], 6)}
                            for k, v in
                            sorted(self._telemetry_sources.items())}}

    # ------------------------------------------------------------ accounting
    def stats(self) -> dict:
        """Deterministic counters, same keys/semantics as
        ``PredictionBroker.stats()`` (cause counters stay off — they depend
        on arrival timing, not on the request streams)."""
        return {"flushes": self.n_flushes, "dispatches": self.n_dispatches,
                "rows": self.n_rows, "requests": self.n_requests,
                "max_flush_rows": self.max_flush_rows,
                "policy": self.policy}


def _swallow_closed(task: asyncio.Task):
    """A reply raced a client disconnect: nothing to do, nobody to tell."""
    if not task.cancelled():
        exc = task.exception()
        if exc is not None and not isinstance(exc, CommClosedError):
            raise exc


class BrokerClient:
    """Synchronous client facade with the ``PredictionBroker`` surface
    (``submit`` / ``done``), so a ``BrokerPredictor`` can serve a fleet cell
    through an ``AsyncBroker`` unchanged.  One outstanding request per client
    (the predictor blocks on each flush), so replies need no demux.

    Every request carries a stable ``client`` id + monotone request id, and
    the request path is a retry loop: on a transport failure or a
    ``request_timeout_s`` expiry the comm is dropped (a timed-out stream can
    no longer be trusted — a late reply would answer the wrong request), the
    client sleeps a deterministic capped-exponential backoff
    (``faults.backoff_delay``), reconnects, and resends the *same* message.
    The broker's replay slot makes the retry idempotent, so transparent
    reconnect never double-scores a flush.  The budget is ``max_retries``
    attempts within ``deadline_s``; past it the client raises
    ``PredictorUnavailableError`` — the graceful-degradation signal.  With
    the default ``request_timeout_s=None`` the client blocks forever like
    the pre-fault-tolerance client (retries then only trigger on explicit
    connection failures)."""

    def __init__(self, address: str, loop: asyncio.AbstractEventLoop, *,
                 client_id: str | None = None,
                 request_timeout_s: float | None = None,
                 deadline_s: float | None = None, max_retries: int = 8,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 1.0,
                 retry_seed: int = 0, **connect_kw):
        self.address = address
        self._loop = loop
        self._connect_kw = connect_kw
        self.client_id = client_id or f"c{os.getpid()}-{next(_CLIENT_SEQ)}"
        self.request_timeout_s = request_timeout_s
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.retry_seed = int(retry_seed)
        self.n_retries = 0
        self.n_reconnects = 0
        # the longest a request waited for its reply, retries included
        # (reporting only: a fault plan's timeout is sized from it)
        self.max_wait_s = 0.0
        self._seq = 0
        self._done_sent = False
        self._comm = None
        self._was_connected = False
        self._comm = self._connect(self._budget_deadline())

    # ------------------------------------------------------------ plumbing
    def _budget_deadline(self) -> float | None:
        return (None if self.deadline_s is None
                else time.monotonic() + self.deadline_s)

    def _remaining(self, deadline: float | None) -> float | None:
        if deadline is None:
            return None
        return max(deadline - time.monotonic(), 0.001)

    def _attempt_timeout(self, deadline: float | None) -> float | None:
        rem = self._remaining(deadline)
        if self.request_timeout_s is None:
            return rem
        return rem if rem is not None and rem < self.request_timeout_s \
            else self.request_timeout_s

    def _backoff(self, attempt: int, deadline: float | None):
        delay = backoff_delay(attempt, base=self.backoff_base_s,
                              cap=self.backoff_cap_s, seed=self.retry_seed)
        rem = self._remaining(deadline)
        if rem is not None:
            delay = min(delay, rem)
        time.sleep(delay)

    def _connect(self, deadline: float | None) -> SyncComm:
        """Connect with retries: a listener mid-restart refuses connections
        for a moment, and that window must look like latency, not failure."""
        attempt = 0
        while True:
            try:
                comm = SyncComm.connect(
                    self.address, self._loop,
                    timeout=self._attempt_timeout(deadline) or 30.0,
                    **self._connect_kw)
                if self._was_connected:
                    self.n_reconnects += 1
                self._was_connected = True
                return comm
            except (CommClosedError, OSError,
                    concurrent.futures.TimeoutError) as e:
                attempt += 1
                out_of_time = (deadline is not None
                               and time.monotonic() >= deadline)
                if attempt > self.max_retries or out_of_time:
                    raise PredictorUnavailableError(
                        f"cannot reach broker at {self.address} "
                        f"after {attempt} attempts: {e!r}") from e
                self._backoff(attempt - 1, deadline)

    def _drop_comm(self):
        if self._comm is not None:
            try:
                self._comm.close(timeout=1.0)
            except Exception:
                pass
            self._comm = None

    def _request(self, msg: dict) -> dict:
        """Send one message and block for its reply, retrying transparently
        across timeouts, dead comms, and broker restarts."""
        deadline = self._budget_deadline()
        attempt = 0
        t0 = time.monotonic()
        while True:
            try:
                if self._comm is None:
                    self._comm = self._connect(deadline)
                t = self._attempt_timeout(deadline)
                self._comm.send(msg, timeout=t)
                while True:
                    reply = self._comm.recv(timeout=t)
                    if reply.get("id") == msg["id"]:
                        self.max_wait_s = max(self.max_wait_s,
                                              time.monotonic() - t0)
                        return reply
                    # a stale duplicate (wire-level dup fault or a late
                    # reply to an already-retried request): discard and
                    # keep waiting for the answer to THIS request
            except (CommClosedError, OSError,
                    concurrent.futures.TimeoutError) as e:
                self._drop_comm()
                attempt += 1
                self.n_retries += 1
                out_of_time = (deadline is not None
                               and time.monotonic() >= deadline)
                if attempt > self.max_retries or out_of_time:
                    raise PredictorUnavailableError(
                        f"broker at {self.address} unreachable after "
                        f"{attempt} attempts: {e!r}") from e
                self._backoff(attempt - 1, deadline)

    # ------------------------------------------------------------ API
    def submit(self, groups) -> list:
        if not groups:
            return []
        self._seq += 1
        reply = self._request({"op": "submit", "id": self._seq,
                               "client": self.client_id, "groups": groups})
        if reply.get("error") is not None:
            # a broker-reported error is an answer, not an outage: no retry
            raise RuntimeError(f"broker error: {reply['error']}")
        return list(reply["probs"])

    def predict(self, kind: str, X, budget_ms: float | None = None):
        """Named-model scoring (the op that works across tcp://)."""
        self._seq += 1
        msg = {"op": "predict", "id": self._seq, "client": self.client_id,
               "kind": kind, "X": X}
        if budget_ms is not None:
            msg["budget_ms"] = budget_ms
        reply = self._request(msg)
        if reply.get("error") is not None:
            raise RuntimeError(f"broker error: {reply['error']}")
        (probs,) = reply["probs"]
        return probs

    def register(self, n: int = 1):
        self._comm.send({"op": "register", "n": n})

    def done(self):
        """Retract this client from the barrier (acked + idempotent: a lost
        ack is retried, the broker dedups by client id)."""
        if self._done_sent:
            return
        self._done_sent = True
        self._seq += 1
        try:
            self._request({"op": "done", "id": self._seq,
                           "client": self.client_id})
        except PredictorUnavailableError:
            pass                         # broker is gone; nothing to retract

    def close(self):
        if self._comm is not None:
            self._comm.close()
