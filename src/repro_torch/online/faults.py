"""Fault injection for the serving stack — seeded, deterministic chaos on
the ``repro_torch.online.transport`` wire.

ATLAS's thesis is that schedulers must absorb failures instead of letting one
unforeseen event kill a job; this module points the same discipline at our
own serving path.  A :class:`FaultPlan` is a typed, bounded point in
fault-space (mirroring ``cluster.scenarios.ScenarioSpec``: declared
:class:`~repro_torch.cluster.scenarios.Bound` ranges, ``validate``, exact
``to_dict``/``from_dict`` round-trip, seeded ``sample``) describing a
schedule of message-level faults:

    drop          a sent message silently vanishes
    delay         a sent message is held for a drawn interval first
    duplicate     a sent message arrives twice
    abrupt_close  the connection dies mid-conversation (no clean EOF)
    restart_after the listener itself goes down and rebinds (broker restart)

:class:`FaultInjector` turns a plan into wrapped comms: every fault draw is
keyed to ``(plan.seed, connection index, message index)`` through one
``random.Random`` stream per connection, so inproc and tcp transports —
which share none of their I/O machinery — exercise *identical* fault
schedules, and a failing chaos run replays exactly from its plan.

The client-side half of the contract lives here too: ``backoff_delay`` is
the capped exponential backoff with deterministic jitter that
``BrokerClient`` sleeps between retries (bounded by ``cap``, monotone in the
``min(cap, base * 2**attempt)`` envelope, bit-reproducible for a given
seed, and equal to the JAX package's schedule), and
:class:`PredictorUnavailableError` is what a client raises once its retry
budget is spent — the signal ``BrokerPredictor`` converts into the paper's
graceful degradation (schedule anyway, never fail the task).
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import random
import zlib

from repro_torch.cluster.scenarios import (Bound, _decode_cfg, _encode_cfg,
                                          _r6)
from repro_torch.online.transport import Comm, CommClosedError


class PredictorUnavailableError(RuntimeError):
    """The broker stayed unreachable past the client's retry/deadline budget.

    Deliberately *not* a ``CommClosedError``: transport errors are retried
    transparently; this is the post-retry verdict that triggers graceful
    degradation (``BrokerPredictor`` falls back to the deterministic
    schedule-anyway decision instead of failing the task)."""


# ---------------------------------------------------------------------------
# Deterministic capped exponential backoff
# ---------------------------------------------------------------------------

def backoff_delay(attempt: int, *, base: float = 0.05, cap: float = 1.0,
                  seed: int = 0) -> float:
    """Retry sleep for ``attempt`` (0-based): jittered capped exponential.

    The envelope is ``min(cap, base * 2**attempt)`` and the jitter scales it
    into ``[envelope/2, envelope]`` — so every delay is bounded by ``cap``,
    the envelope is monotone until it saturates, and the value is a pure
    function of ``(seed, attempt)`` (the jitter comes from a CRC32-seeded
    ``random.Random``, never from global RNG state or the clock)."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    envelope = min(float(cap), float(base) * (2.0 ** attempt))
    u = random.Random(
        zlib.crc32(f"backoff|{seed}|{attempt}".encode())).random()
    return envelope * (0.5 + 0.5 * u)


def backoff_schedule(n: int, *, base: float = 0.05, cap: float = 1.0,
                     seed: int = 0) -> list[float]:
    """The first ``n`` retry delays for a seed (tests/docs convenience)."""
    return [backoff_delay(i, base=base, cap=cap, seed=seed)
            for i in range(n)]


# ---------------------------------------------------------------------------
# FaultPlan — the typed, serialisable fault-space point
# ---------------------------------------------------------------------------

# Declared ranges, ScenarioSpec-style.  Probabilities cap at 0.5: above
# that, retry traffic compounds faster than it drains and the plan stops
# describing a degraded service and starts describing a dead one.
FAULT_BOUNDS: dict[str, Bound] = {
    "seed": Bound(0, 2 ** 31 - 1, kind="int"),
    "drop": Bound(0.0, 0.5),
    "delay": Bound(0.0, 0.5),
    "delay_s": Bound(0.0, 0.25),          # injected latency span (seconds)
    "duplicate": Bound(0.0, 0.5),
    "abrupt_close": Bound(0.0, 0.25),
    "max_events": Bound(0, 4096, kind="int"),
    "request_timeout_s": Bound(0.01, 60.0, log=True),
    "deadline_s": Bound(0.1, 600.0, log=True),
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded fault schedule plus the client resilience knobs that make
    it survivable.  Frozen + exactly serialisable: a chaos run is reproduced
    from nothing but its plan dict.

    ``drop``/``delay``/``duplicate``/``abrupt_close`` are per-message
    probabilities (one uniform draw per sent message picks at most one
    fault); ``delay_s`` is the (lo, hi) span injected delays are drawn from;
    ``restart_after`` lists server-side received-message counts at which the
    listener restarts (the broker-restart event); ``max_events`` caps total
    injected faults so retry overhead stays bounded.  ``request_timeout_s``
    and ``deadline_s`` ride along because a faulted run and its clean
    control must share one client configuration surface."""

    seed: int = 0
    drop: float = 0.0
    delay: float = 0.0
    delay_s: tuple = (0.001, 0.01)
    duplicate: float = 0.0
    abrupt_close: float = 0.0
    restart_after: tuple = ()
    max_events: int = 64
    request_timeout_s: float = 0.25
    deadline_s: float = 30.0

    # ------------------------------------------------------------ validation
    def validate(self) -> "FaultPlan":
        for name in ("drop", "delay", "duplicate", "abrupt_close"):
            v = getattr(self, name)
            b = FAULT_BOUNDS[name]
            if not (b.lo <= v <= b.hi):
                raise ValueError(
                    f"{name}={v} outside [{b.lo}, {b.hi}]")
        mass = self.drop + self.delay + self.duplicate + self.abrupt_close
        if mass > 1.0:
            raise ValueError(
                f"fault probabilities sum to {mass} > 1 (one draw per "
                "message picks at most one fault)")
        lo, hi = self.delay_s
        b = FAULT_BOUNDS["delay_s"]
        if not (b.lo <= lo <= hi <= b.hi):
            raise ValueError(f"delay_s span {self.delay_s} invalid "
                             f"(want {b.lo} <= lo <= hi <= {b.hi})")
        if not (FAULT_BOUNDS["seed"].lo <= self.seed
                <= FAULT_BOUNDS["seed"].hi):
            raise ValueError(f"seed {self.seed} out of range")
        if not (FAULT_BOUNDS["max_events"].lo <= self.max_events
                <= FAULT_BOUNDS["max_events"].hi):
            raise ValueError(f"max_events {self.max_events} out of range")
        prev = 0
        for r in self.restart_after:
            if not isinstance(r, int) or r <= prev:
                raise ValueError(
                    f"restart_after must be strictly increasing positive "
                    f"ints, got {self.restart_after}")
            prev = r
        for name in ("request_timeout_s", "deadline_s"):
            v = getattr(self, name)
            b = FAULT_BOUNDS[name]
            if not (b.lo <= v <= b.hi):
                raise ValueError(f"{name}={v} outside [{b.lo}, {b.hi}]")
        return self

    # ------------------------------------------------------------ round trip
    def to_dict(self) -> dict:
        return _encode_cfg(self)

    @classmethod
    def from_dict(cls, payload: dict) -> "FaultPlan":
        plan = _decode_cfg(cls, dict(payload))
        return dataclasses.replace(
            plan,
            delay_s=tuple(float(v) for v in plan.delay_s),
            restart_after=tuple(int(v) for v in plan.restart_after),
        ).validate()

    # ------------------------------------------------------------ sampling
    @classmethod
    def sample(cls, rng: random.Random) -> "FaultPlan":
        """A random valid plan (property tests / chaos search seeds)."""
        probs = {name: _r6(rng.uniform(0.0, FAULT_BOUNDS[name].hi / 2))
                 for name in ("drop", "delay", "duplicate", "abrupt_close")}
        mass = sum(probs.values())
        if mass > 1.0:
            probs = {k: _r6(v / mass) for k, v in probs.items()}
        b = FAULT_BOUNDS["delay_s"]
        lo = _r6(rng.uniform(b.lo, b.hi))
        hi = _r6(rng.uniform(lo, b.hi))
        n_restarts = rng.randint(0, 2)
        at, restarts = 0, []
        for _ in range(n_restarts):
            at += rng.randint(1, 64)
            restarts.append(at)
        return cls(seed=rng.randint(0, 2 ** 31 - 1), delay_s=(lo, hi),
                   restart_after=tuple(restarts),
                   max_events=rng.randint(0, 256), **probs).validate()


# ---------------------------------------------------------------------------
# Injection machinery: plan -> wrapped comms
# ---------------------------------------------------------------------------

_NO_FAULT = "none"


class FaultInjector:
    """Shared schedule state for one plan: per-connection RNG streams, the
    global injected-event budget, the listener-restart trigger, and the
    fault counters a chaos gate asserts on.

    ``wrap(comm)`` returns a :class:`FaultyComm`; ``wrap_handler(handler)``
    produces a listener handler that wraps every accepted server-side comm
    (and counts its received messages toward ``restart_after``).  All
    mutation happens on the owning event loop's thread."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan.validate()
        self._conn_seq = itertools.count()
        self._restarts_pending = list(plan.restart_after)
        self.on_restart = None           # callback set by the server owner
        self.active: set = set()         # live wrapped server-side comms
        # counters (reporting only)
        self.n_events = 0
        self.n_drops = 0
        self.n_delays = 0
        self.n_duplicates = 0
        self.n_closes = 0
        self.n_restarts = 0
        self.n_messages_in = 0           # server-side received messages

    # ------------------------------------------------------------ wrapping
    def _rng_for_conn(self, conn_index: int) -> random.Random:
        return random.Random(zlib.crc32(
            f"faults|{self.plan.seed}|conn{conn_index}".encode()))

    def wrap(self, comm: Comm, *, side: str = "client") -> "FaultyComm":
        return FaultyComm(comm, self, next(self._conn_seq), side=side)

    def wrap_handler(self, handler):
        """Wrap a listener handler so every accepted comm is fault-injected
        and tracked (for abrupt close-all on a listener restart)."""
        async def faulty_handler(comm):
            wrapped = self.wrap(comm, side="server")
            self.active.add(wrapped)
            try:
                await handler(wrapped)
            finally:
                self.active.discard(wrapped)
        return faulty_handler

    # ------------------------------------------------------------ scheduling
    def _budget_left(self) -> bool:
        return self.n_events < self.plan.max_events

    def draw(self, rng: random.Random) -> tuple[str, float]:
        """One fault decision for one outgoing message.  Exactly one
        ``rng.random()`` (plus one more for a delay value) per message, so
        the schedule depends only on the per-connection draw sequence —
        never on which faults actually fire or on transport internals."""
        u = rng.random()
        p = self.plan
        delay_v = 0.0
        if u < p.delay + p.drop + p.duplicate + p.abrupt_close:
            # keep the stream position independent of which branch fires
            lo, hi = p.delay_s
            delay_v = lo + (hi - lo) * rng.random()
        if not self._budget_left():
            return _NO_FAULT, 0.0
        if u < p.drop:
            return "drop", 0.0
        if u < p.drop + p.delay:
            return "delay", delay_v
        if u < p.drop + p.delay + p.duplicate:
            return "duplicate", 0.0
        if u < p.drop + p.delay + p.duplicate + p.abrupt_close:
            return "abrupt_close", 0.0
        return _NO_FAULT, 0.0

    def record(self, fault: str):
        self.n_events += 1
        if fault == "drop":
            self.n_drops += 1
        elif fault == "delay":
            self.n_delays += 1
        elif fault == "duplicate":
            self.n_duplicates += 1
        elif fault == "abrupt_close":
            self.n_closes += 1

    # ------------------------------------------------------------ restarts
    def note_message_in(self):
        """Count one server-side received message; fire a listener restart
        when the count crosses the next ``restart_after`` threshold."""
        self.n_messages_in += 1
        if (self._restarts_pending
                and self.n_messages_in >= self._restarts_pending[0]
                and self.on_restart is not None):
            self._restarts_pending.pop(0)
            self.n_restarts += 1
            self.on_restart()

    async def close_active(self):
        """Abruptly close every live wrapped comm (a restart severs all
        established connections, not just the accept socket)."""
        for wrapped in list(self.active):
            try:
                await wrapped.inner.close()
            except Exception:           # already dying — that's the point
                pass
        self.active.clear()

    def stats(self) -> dict:
        return {"events": self.n_events, "drops": self.n_drops,
                "delays": self.n_delays, "duplicates": self.n_duplicates,
                "closes": self.n_closes, "restarts": self.n_restarts,
                "messages_in": self.n_messages_in}


class FaultyComm(Comm):
    """A ``Comm`` decorator applying the plan's faults on ``send``.

    Receiving passes through untouched (drops/dups/delays are modelled at
    the sender, which covers both directions once both sides wrap), except
    that server-side receives tick the injector's restart trigger.  Faults
    never change message *content* — only whether/when/how often a message
    arrives — so a retried request replays bit-identically."""

    def __init__(self, inner: Comm, injector: FaultInjector,
                 conn_index: int, *, side: str = "client"):
        self.inner = inner
        self.injector = injector
        self.conn_index = conn_index
        self.side = side
        self._rng = injector._rng_for_conn(conn_index)
        self.local_addr = inner.local_addr
        self.peer_addr = inner.peer_addr

    async def send(self, msg) -> None:
        fault, delay_v = self.injector.draw(self._rng)
        if fault != _NO_FAULT:
            self.injector.record(fault)
        if fault == "drop":
            return                       # vanished on the wire
        if fault == "delay":
            await asyncio.sleep(delay_v)
            await self.inner.send(msg)
            return
        if fault == "duplicate":
            await self.inner.send(msg)
            await self.inner.send(msg)
            return
        if fault == "abrupt_close":
            await self.inner.close()
            raise CommClosedError(
                f"fault injection: abrupt close on conn {self.conn_index}")
        await self.inner.send(msg)

    async def recv(self):
        msg = await self.inner.recv()
        if self.side == "server":
            self.injector.note_message_in()
        return msg

    async def close(self) -> None:
        await self.inner.close()

    @property
    def closed(self) -> bool:
        return self.inner.closed
