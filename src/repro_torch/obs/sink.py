"""Telemetry sinks: where per-tick frames go.

A frame is one JSON-able dict (see ``instrument.SimObserver.frame``).  The
sink protocol is deliberately tiny — ``emit(frame)`` + ``close()`` — so the
file sink here and the transport sink (frames to a serving ``AsyncBroker``)
are interchangeable: the instrumentation layer never knows whether frames
land on disk, in memory, or on a wire.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

# process-wide event loop shared by TransportSinks (see telemetry_loop())
_shared_loop = None
_shared_loop_lock = threading.Lock()

_SEP = (",", ":")
# NDJSONSink splices an EncodedList's text in where a placeholder string (a
# private-use character and the value's position) was encoded
_MARK = "\ue000"


class EncodedList(list):
    """A list that carries its own compact JSON text (``json``, equal to
    ``json.dumps(list(self), separators=(",", ":"))``), kept by a producer
    that maintains the text as the list changes (``SimObserver``'s per-node
    lists).  ``NDJSONSink`` writes the text instead of encoding the list
    again; everywhere else it is the list."""

    __slots__ = ("json",)


def telemetry_loop():
    """The process-wide daemon event loop for ``tcp://`` TransportSinks.

    Spawning a loop thread per sink is measurable against a short fleet
    cell (thread + selector setup and teardown land inside the telemetry
    overhead budget), so producers that open one sink per run — the fleet's
    ``--obs-live`` path, ``bench --obs-live`` — share one lazily-started
    loop per process instead.  Sinks given a loop never own it, so
    ``TransportSink.close()`` leaves this one running for the next run.
    Not for ``inproc://`` addresses: inproc channels are loop-local, pass
    the broker's own loop for those."""
    global _shared_loop
    import asyncio
    with _shared_loop_lock:
        if _shared_loop is None or _shared_loop.is_closed():
            loop = asyncio.new_event_loop()
            threading.Thread(target=loop.run_forever, daemon=True,
                             name="telemetry-loop").start()
            _shared_loop = loop
        return _shared_loop


class Sink:
    """Protocol: accepts frames one at a time.  Subclasses override both."""

    def emit(self, frame: dict):
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class MemorySink(Sink):
    """Collects frames in a list (tests, in-process dashboard rendering)."""

    def __init__(self):
        self.frames: list[dict] = []

    def emit(self, frame: dict):
        self.frames.append(frame)


class NDJSONSink(Sink):
    """One JSON object per line, append-only.  ``emit`` only appends the
    frame to a buffer; serialization AND the write happen together every
    ``flush_every`` frames (and on close).  Batching matters twice over: a
    live reader (``tail -f`` or the dashboard) stays at most ``flush_every``
    frames behind while the sim loop avoids a write syscall per frame, and
    encoding frames back-to-back at flush time runs warm instead of paying
    cold-cache json costs in the middle of the event loop (the overhead
    budget in ``benchmarks/obs_overhead.py`` is the forcing function).
    Pass ``flush_every=1`` for strict frame-at-a-time streaming.  Emitted
    dicts are serialized at flush time, so callers must hand over ownership
    (never mutate a frame after emit).

    A frame value that is an :class:`EncodedList` (``SimObserver``'s
    per-node ``node_occ``, 1000 floats at 1000 nodes) is written from its
    own text; the lines are the bytes ``json.dumps(frame, separators=(",",
    ":"))`` gives."""

    def __init__(self, path, flush_every: int = 32):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("w")
        self.flush_every = max(int(flush_every), 1)
        self.n_frames = 0
        self._buf: list[dict] = []

    def emit(self, frame: dict):
        self._buf.append(frame)
        self.n_frames += 1
        if len(self._buf) >= self.flush_every:
            self._flush()

    def _flush(self):
        # compact separators, insertion order: frames are built with a fixed
        # deterministic key order already, and skipping sort_keys + padding
        # spaces keeps the per-frame encode inside the telemetry budget
        self._f.write("".join(
            [_encode(f) + "\n" for f in self._buf]))
        self._buf.clear()
        self._f.flush()

    def close(self):
        if self._f is not None:
            if self._buf:
                self._flush()
            self._f.close()
            self._f = None


def _encode(frame) -> str:
    """``json.dumps(frame, separators=(",", ":"))``, with each top-level
    EncodedList value written from its own text."""
    dumps = json.dumps
    keys = ([k for k, v in frame.items() if type(v) is EncodedList]
            if type(frame) is dict else None)
    if not keys:
        return dumps(frame, separators=_SEP)
    stub = dict(frame)
    for j, k in enumerate(keys):
        stub[k] = f"{_MARK}{j}"
    text = dumps(stub, separators=_SEP)
    for j, k in enumerate(keys):
        mark = dumps(f"{_MARK}{j}")
        if text.count(mark) != 1:                # the mark occurs elsewhere
            return dumps(frame, separators=_SEP)
        text = text.replace(mark, frame[k].json)
    return text


class TeeSink(Sink):
    """Fan one frame stream out to several sinks (file + memory, say)."""

    def __init__(self, *sinks: Sink):
        self.sinks = sinks

    def emit(self, frame: dict):
        for s in self.sinks:
            s.emit(frame)

    def close(self):
        for s in self.sinks:
            s.close()


class TransportSink(Sink):
    """Streams frames over a ``repro_torch.online.transport`` comm to a serving
    ``AsyncBroker`` (``{"op": "telemetry", "frame": …}``), which forwards
    them to whatever Sink it was configured with — the live-dashboard wire,
    on the same transport the prediction traffic uses.

    ``emit`` blocks until the frame is on the channel, so a slow or wedged
    collector applies backpressure here instead of growing an unbounded
    buffer (inproc: bounded channel; tcp: kernel socket buffer).  Pass the
    broker's own ``loop`` for ``inproc://`` addresses (inproc channels are
    loop-local); tcp addresses may instead let the sink run a private loop
    thread, or share the process-wide :func:`telemetry_loop`.

    ``source`` names this producer on the wire: the message then carries
    ``source`` plus a 1-based per-sink sequence ``n``, which the collector
    side uses to spot gaps and reconnects across cells.  Without a source
    the message is the bare two-key form.

    Like :class:`NDJSONSink`, frames can batch: with ``flush_every > 1``
    emit buffers and every flush ships one ``{"op": "telemetry", "frames":
    [{"frame": …, "n": …}, …]}`` message (a cross-thread send round-trip
    per *batch* instead of per frame — the wire's version of the overhead
    budget).  ``flush_interval_s`` bounds liveness: a flush also triggers
    when that much wall time passed since the last one, so a slow real-time
    producer still reaches the live dashboard promptly.  Per-frame ``n`` is
    assigned at emit time, so gap/reconnect accounting is batch-blind.

    Telemetry must never take the sim down with it: when the consumer dies
    (broker crash, restart window) a failed send marks the comm down,
    frames keep buffering up to ``max_buffer`` (oldest dropped beyond that
    — ``n_dropped`` counts them, and the per-frame ``n`` lets the collector
    see the gap), and each later flush retries the connection behind a
    deterministic capped backoff (``faults.backoff_delay``).  On reconnect
    the whole surviving buffer ships at once and the collector's wire
    accounting records one reconnect.  Set ``reconnect=False`` to restore
    the old raise-on-failure behavior."""

    def __init__(self, address: str, loop=None, source: str | None = None,
                 flush_every: int = 1, flush_interval_s: float = 0.25,
                 reconnect: bool = True, max_buffer: int = 4096,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 1.0,
                 **connect_kw):
        import asyncio

        from repro_torch.online.transport import SyncComm
        self.address = address
        self.source = source
        self.flush_every = max(int(flush_every), 1)
        self.flush_interval_s = flush_interval_s
        self.reconnect = reconnect
        self.max_buffer = max(int(max_buffer), 1)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._own_loop = loop is None
        self._thread = None
        if self._own_loop:
            loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=loop.run_forever, daemon=True, name="transport-sink")
            self._thread.start()
        self._loop = loop
        self._comm = SyncComm.connect(address, loop, **connect_kw)
        self._connect_kw = connect_kw
        self._closed = False
        self.n_frames = 0
        self.n_reconnects = 0
        self.n_dropped = 0
        self.n_send_errors = 0
        self._retry_attempt = 0
        self._retry_at = 0.0
        self._buf: list[tuple[dict, int]] = []
        self._last_flush = time.monotonic()

    def emit(self, frame: dict):
        if self._closed:
            raise RuntimeError(
                f"TransportSink({self.address!r}) is closed")
        n = self.n_frames + 1
        self._buf.append((frame, n))
        self.n_frames = n
        if (len(self._buf) >= self.flush_every
                or time.monotonic() - self._last_flush
                >= self.flush_interval_s):
            self._flush()

    def _build(self, batch) -> dict:
        if len(batch) == 1:
            frame, n = batch[0]
            msg = {"op": "telemetry", "frame": frame}
            if self.source is not None:
                msg["source"] = self.source
                msg["n"] = n
        else:
            msg = {"op": "telemetry",
                   "frames": [{"frame": f, "n": n} for f, n in batch]}
            if self.source is not None:
                msg["source"] = self.source
        return msg

    def _flush(self):
        if not self._buf:
            return
        if self._comm is None and not self._reconnect_now():
            self._trim()
            return
        try:
            self._comm.send(self._build(self._buf))
        except Exception:
            if not self.reconnect:
                raise
            self._mark_down()
            self._trim()
            return
        self._buf = []
        self._last_flush = time.monotonic()
        self._retry_attempt = 0

    # ---------------------------------------------------------- reconnection
    def _mark_down(self):
        self.n_send_errors += 1
        if self._comm is not None:
            try:
                self._comm.close(timeout=1.0)
            except Exception:
                pass
            self._comm = None
        self._arm_backoff()

    def _arm_backoff(self):
        from repro_torch.online.faults import backoff_delay
        self._retry_at = time.monotonic() + backoff_delay(
            min(self._retry_attempt, 16), base=self.backoff_base_s,
            cap=self.backoff_cap_s)
        self._retry_attempt += 1

    def _reconnect_now(self) -> bool:
        """One reconnect attempt, rate-limited by the backoff clock (the
        sim path must never spin on a dead consumer)."""
        if time.monotonic() < self._retry_at:
            return False
        from repro_torch.online.transport import SyncComm
        try:
            self._comm = SyncComm.connect(self.address, self._loop,
                                          timeout=self.backoff_cap_s,
                                          **self._connect_kw)
        except Exception:
            self._arm_backoff()
            return False
        self.n_reconnects += 1
        return True

    def _trim(self):
        n_over = len(self._buf) - self.max_buffer
        if n_over > 0:
            del self._buf[:n_over]
            self.n_dropped += n_over

    def close(self):
        if not self._closed:
            self._closed = True
            if self._buf and (self._comm is not None
                              or self._reconnect_now()):
                try:
                    self._comm.send(self._build(self._buf))
                    self._buf = []
                except Exception:
                    pass                 # consumer already gone: best effort
            if self._comm is not None:
                self._comm.close()
                self._comm = None
            if self._own_loop:
                # stop AND join the private loop thread, then close the
                # loop: a daemon thread left spinning here outlives the
                # sink and leaks an fd + selector per closed sink
                self._loop.call_soon_threadsafe(self._loop.stop)
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                    self._thread = None
                if not self._loop.is_running():
                    self._loop.close()


def read_ndjson(path, *, return_partial: bool = False):
    """Load a frame stream back (skips blank lines).

    A truncated *trailing* line is tolerated: ``NDJSONSink`` batches its
    flushes, so a tail-follow reader (the live view, ``dashboard.py`` mid-
    run) can catch the file between ``write`` and the newline landing.
    Complete frames are returned and the partial tail is counted; corruption
    anywhere *else* in the file still raises.  With ``return_partial=True``
    returns ``(frames, n_partial)`` where ``n_partial`` is 0 or 1."""
    p = pathlib.Path(path)
    if not p.exists():
        return ([], 0) if return_partial else []
    lines = p.read_text().splitlines()
    last = len(lines) - 1
    frames: list[dict] = []
    n_partial = 0
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            frames.append(json.loads(line))
        except json.JSONDecodeError:
            if i == last:
                n_partial = 1
            else:
                raise
    return (frames, n_partial) if return_partial else frames
