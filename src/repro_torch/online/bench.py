"""Load generator for the prediction broker: replay fleet decision streams.

Builds a decision stream (the launch-time feature rows a fleet cell actually
raised), trains the predictor on it, then serves the stream three ways:

  scalar     the per-decision path — one model dispatch per request
  broker     closed loop: N concurrent clients through one PredictionBroker —
             lock-step rounds fused into single passes; measures per-request
             latency percentiles and the dispatch reduction
  saturated  open loop: the stream arrives faster than flushes drain, so the
             queue depth fills every flush — the broker's peak batched
             throughput (this is the ≥10x-vs-scalar number)
  open-loop  timed arrivals through the serving ``AsyncBroker`` over the
             transport layer: Poisson and bursty (two-state MMPP)
             schedules on inproc:// and tcp:// backends, latency measured
             from each request's *scheduled* arrival (no coordinated
             omission), p50/p95/p99 + SLO-violation rate per config

Every mode scores on ``--device`` (CUDA unless told otherwise): the scalar
mode through the single-forest kernel (``TaskPredictor.predict_batch``),
the others through the grouped kernel (``score_groups``).  Every path
computes the numpy mirror's floats, so each mode's row-level outputs are
held bit-for-bit to ``forest_predict_np`` on the same rows, whatever
``--impl``: the bench doubles as a live parity check.

  python -m repro_torch.online.bench [--rows 6000] [--clients 12]
      [--workload smoke] [--scenario bursty_tt] [--device cpu]
      [--impl numpy|torch|cuda] [--rate R] [--fleet-sizes 0,100]
      [--policy barrier|depth] [--depth N] [--max-delay S] [--no-open-loop]
      [--open-rate R] [--slo-ms MS] [--open-backends inproc,tcp]
      [--out experiments] [--stamp-sweep [PATH]] [--smoke]

``--rate`` paces each client (requests/s of wall time, 0 = flat out).
``--fleet-sizes`` is the scale axis: each size replays a decision stream from
a fleet of that many nodes (0 = the paper's 13-slave fleet; candidate-set
requests grow with the fleet), and the per-size throughput/latency sections
land in the summary (``ONLINE.json``) and — with ``--stamp-sweep`` —
``SWEEP.json``.  ``--policy depth`` serves the broker section through the
queue-depth flush policy with bounded delay instead of the deterministic
barrier.  Exit status is non-zero when the batched run shows no throughput,
parity breaks, or an open-loop p99 exceeds max(10 x p50, 25 ms).

``--obs`` attaches a ``BrokerObserver`` to the broker mode: per-flush NDJSON
frames under ``<out>/obs/bench_n<size>.ndjson`` and its roll-up (flush-row
and wall-latency histograms, p50/p99) under the broker section.  The port
writes no ``BENCH_*.json``, so where the JAX package also stamps that
roll-up per fleet size into ``BENCH_<pr>.json``, here it lands only in
``ONLINE.json``'s ``per_fleet_size.<size>.broker.obs`` (the primary size's
in ``broker.obs`` too).  ``--obs-live ADDR`` streams the same flush frames
to a live ``TelemetryCollector`` (source ``bench_n<size>``)."""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
import sys
import threading
import time

import numpy as np

import repro_torch
from repro_torch.core.predictor import TaskPredictor, forest_family_params
from repro_torch.ml.forest import forest_predict_np
from repro_torch.online.broker import PredictionBroker, score_groups

# deterministic request-size mix mimicking the scheduler's demand: mostly
# single-proposal p_success rows, periodically a candidate-set p_success_nodes
# (whose size tracks the fleet: every free node is a candidate placement)
REQUEST_SIZES = (1, 1, 1, 2, 1, 1, 13, 1, 1, 4)

# open-loop auto-rate ceilings (requests/s): past these the per-message
# event-loop hop — not forest scoring — is what saturates, and pushing an
# open-loop schedule beyond service capacity just measures queue growth
OPEN_RATE_CAP = 12000.0
TCP_RATE_CAP = 4000.0

# CI tail budget: open-loop p99 must stay under max(10x p50, this floor)
P99_FLOOR_MS = 25.0


def request_sizes(fleet_size: int = 0) -> tuple:
    if not fleet_size:
        return REQUEST_SIZES
    cand = min(fleet_size, 256)
    return tuple(cand if s == 13 else s for s in REQUEST_SIZES)


# ---------------------------------------------------------------------------
# Stream construction
# ---------------------------------------------------------------------------

def build_stream(workload: str = "smoke", scenario: str = "bursty_tt",
                 seed: int = 0, min_rows: int = 2000, fleet_size: int = 0,
                 device=None):
    """(predictor, [(kind, X_request)]) from one base-scheduler fleet cell;
    the predictor fits and scores on ``device``.

    The trace's launch-time feature rows ARE the decision stream ATLAS would
    have scored; they are tiled to ``min_rows`` and cut into requests with the
    ``request_sizes(fleet_size)`` mix.  Falls back to a synthetic stream when
    the cell's trace can't train (tiny workloads with too few outcomes of one
    class)."""
    from repro_torch.cluster.experiment import ExperimentConfig, run_scheduler
    from repro_torch.cluster.fleet import cell_seed
    from repro_torch.cluster.scenarios import make_spec

    env = ((scenario, workload, f"n{fleet_size}", seed) if fleet_size
           else (scenario, workload, seed))
    point = make_spec(scenario, workload)
    cfg = ExperimentConfig(
        workload=point.workload_for_seed(cell_seed("workload", *env)),
        chaos=point.chaos_for_seed(cell_seed("chaos", *env)),
        seed=cell_seed("sim", *env), min_samples=32, fleet_size=fleet_size)
    _, trace, _ = run_scheduler("fifo", cfg, with_trace=True)
    (mx, my), (rx, ry) = trace.datasets()
    predictor = TaskPredictor(algo="R.F.", min_samples=32, seed=0,
                              device=device)
    predictor.fit_datasets((mx, my), (rx, ry))

    rows = [("map", x) for x in mx] + [("reduce", x) for x in rx]
    rows = [(k, x) for k, x in rows
            if predictor.model_for_kind(k) is not None]
    if not rows:  # untrained fallback: synthetic decision stream
        rng = np.random.RandomState(seed)
        X = rng.rand(512, mx.shape[1] if mx.size else 22).astype(np.float32)
        y = (rng.rand(512) < 0.4).astype(np.float32)
        predictor.fit_datasets((X, y), (X, y))
        rows = [("map", x) for x in X]

    while len(rows) < min_rows:
        rows = rows + rows
    rows = rows[:min_rows]

    sizes = request_sizes(fleet_size)
    requests, i, s = [], 0, 0
    while i < len(rows):
        size = sizes[s % len(sizes)]
        chunk = rows[i:i + size]
        i += size
        s += 1
        # a request is single-kind, like p_success_nodes
        kind = chunk[0][0]
        X = np.stack([x for k, x in chunk if k == kind])
        requests.append((kind, X))
        rest = [(k, x) for k, x in chunk if k != kind]
        if rest:
            requests.append((rest[0][0], np.stack([x for _, x in rest])))
    return predictor, requests


# ---------------------------------------------------------------------------
# Serving modes
# ---------------------------------------------------------------------------

def run_scalar(predictor: TaskPredictor, requests) -> dict:
    """The un-brokered baseline, timed at both granularities:

    * per request — today's ``p_success`` / ``p_success_nodes`` call pattern
      (one dispatch per call), and
    * per decision — one dispatch per scored row, the paper's per-decision
      evaluation (each row of a candidate set is one predicted placement).
    """
    d0, r0 = predictor.n_dispatches, predictor.n_rows_scored
    outs = []
    t0 = time.perf_counter()
    for kind, X in requests:
        outs.append(predictor.predict_batch(kind, X))
    dt = time.perf_counter() - t0
    rows = predictor.n_rows_scored - r0
    t0 = time.perf_counter()
    for kind, X in requests:
        for i in range(X.shape[0]):
            predictor.predict_batch(kind, X[i:i + 1])
    dt_rows = time.perf_counter() - t0
    return {"rows": rows, "requests": len(requests), "seconds": dt,
            "rows_per_s": rows / max(dt, 1e-9),
            "per_decision_rows_per_s": rows / max(dt_rows, 1e-9),
            "dispatches": predictor.n_dispatches - d0 - rows,
            "outputs": outs}


def run_broker(predictor: TaskPredictor, requests, *, clients: int = 12,
               impl: str | None = None, device=None, rate: float = 0.0,
               policy: str = "barrier", depth: int = 256,
               max_delay: float = 0.002, obs=None) -> dict:
    """Concurrent clients replaying shards of the stream through one broker
    (flushes recorded by ``obs``, a ``BrokerObserver``, when given)."""
    broker = PredictionBroker(impl=impl, device=device, policy=policy,
                              depth=depth, max_delay=max_delay)
    broker.obs = obs
    shards = [list(range(c, len(requests), clients)) for c in range(clients)]
    shards = [s for s in shards if s]
    broker.add_clients(len(shards))
    outs: list = [None] * len(requests)
    lat: list = []
    lat_lock = threading.Lock()
    errors: list = []

    def client(idxs):
        my_lat = []
        try:
            for qi in idxs:
                kind, X = requests[qi]
                if rate > 0:
                    time.sleep(1.0 / rate)
                model = predictor.model_for_kind(kind)
                t0 = time.perf_counter()
                (out,) = broker.submit([(model, X)])
                my_lat.append(time.perf_counter() - t0)
                outs[qi] = out
        except Exception as e:                       # pragma: no cover
            errors.append(e)
        finally:
            broker.done()
            with lat_lock:
                lat.extend(my_lat)

    threads = [threading.Thread(target=client, args=(sh,))
               for sh in shards]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    lat.sort()

    def pct(q):
        return lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3 if lat else 0.0

    s = broker.stats()
    out = {"rows": s["rows"], "requests": s["requests"], "seconds": dt,
           "rows_per_s": s["rows"] / max(dt, 1e-9),
           "dispatches": s["dispatches"], "flushes": s["flushes"],
           "max_flush_rows": s["max_flush_rows"],
           "clients": len(shards), "impl": impl, "policy": policy,
           "solo_flushes": broker.n_solo_flushes,
           "deadline_flushes": broker.n_deadline_flushes,
           "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                          "p99": pct(0.99)},
           "outputs": outs}
    if obs is not None:
        obs.close()
        # full summary: the flush-latency section is reporting-only (wall
        # clock), as the bench's other latency numbers already are
        out["obs"] = obs.summary()
    return out


def run_saturated(predictor: TaskPredictor, requests,
                  *, impl: str | None = None, device=None,
                  batch_rows: int = 8192) -> dict:
    """Open-loop saturation: requests arrive faster than flushes drain, so
    every flush scores a full queue.  Replays the stream through the broker's
    flush path (``score_groups``) at that depth — peak batched throughput."""
    chunks, cur, rows = [], [], 0
    for kind, X in requests:
        cur.append((predictor.model_for_kind(kind), X))
        rows += X.shape[0]
        if rows >= batch_rows:
            chunks.append(cur)
            cur, rows = [], 0
    if cur:
        chunks.append(cur)
    outs, dispatches, total = [], 0, 0
    t0 = time.perf_counter()
    for chunk in chunks:
        o, n = score_groups(chunk, impl=impl, device=device)
        outs.extend(o)
        dispatches += n
        total += sum(X.shape[0] for _, X in chunk)
    dt = time.perf_counter() - t0
    return {"rows": total, "requests": len(requests), "seconds": dt,
            "rows_per_s": total / max(dt, 1e-9), "dispatches": dispatches,
            "flushes": len(chunks), "batch_rows": batch_rows,
            "outputs": outs}


def _arrival_schedule(n: int, rate_rps: float, kind: str, rng) -> np.ndarray:
    """Cumulative scheduled offsets (seconds) for ``n`` requests.

    "poisson" draws exponential gaps at ``rate_rps``; "bursty" is a two-state
    MMPP — bursts at 4x the base rate, calm stretches at 0.4x, flipping with
    probability 0.05 per arrival — so the mean rate is *approximately* the
    base and the tails come from genuine arrival clumps."""
    rate_rps = max(rate_rps, 1e-6)
    if kind == "poisson":
        gaps = rng.exponential(1.0 / rate_rps, size=n)
    elif kind == "bursty":
        gaps = np.empty(n)
        fast = True
        for i in range(n):
            r = rate_rps * (4.0 if fast else 0.4)
            gaps[i] = rng.exponential(1.0 / r)
            if rng.rand() < 0.05:
                fast = not fast
    else:
        raise ValueError(f"unknown arrival process {kind!r}")
    return np.cumsum(gaps)


async def _open_loop_client(address, requests, idxs, sched, t0, outs, lats,
                            slo_ms, reply_timeout_s: float = 120.0):
    """One open-loop client: fire requests at their scheduled offsets without
    waiting for replies; a reader task demuxes replies by id.  Latency is
    measured from the *scheduled* arrival, so a stalled broker keeps paying
    for the requests it should already have served (no coordinated omission).
    The reader is bounded by ``reply_timeout_s``: a wedged broker turns into
    a clean ``TimeoutError`` instead of hanging the bench (and CI) forever.
    """
    from repro_torch.online.transport import connect
    comm = await connect(address)
    pending: dict = {}
    n = len(idxs)

    async def reader():
        for _ in range(n):
            reply = await comm.recv()
            t_done = time.perf_counter()
            qi, t_sched = pending.pop(reply["id"])
            if reply.get("error") is not None:
                raise RuntimeError(f"broker error: {reply['error']}")
            outs[qi] = reply["probs"][0]
            lats[qi] = max(t_done - t_sched, 0.0)

    rtask = asyncio.ensure_future(reader())
    try:
        for j, qi in enumerate(idxs):
            t_sched = t0 + sched[j]
            delay = t_sched - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            kind, X = requests[qi % len(requests)]
            msg = {"op": "predict", "id": j, "kind": kind, "X": X}
            if slo_ms:
                msg["budget_ms"] = slo_ms
            pending[j] = (qi, t_sched)
            await comm.send(msg)
        await asyncio.wait_for(rtask, reply_timeout_s)
    finally:
        rtask.cancel()
        await comm.close()


def run_open_loop(predictor, requests, *, backend: str = "inproc",
                  arrivals: str = "poisson", clients: int = 8,
                  rate_rps: float = 1000.0, n_requests: int | None = None,
                  slo_ms: float = 25.0, policy: str = "vt", depth: int = 2048,
                  vt_window: int | None = None, impl: str | None = None,
                  device=None, seed: int = 0) -> dict:
    """Open-loop load through a serving AsyncBroker on one transport backend.

    ``rate_rps`` is the *aggregate* arrival rate across all clients; the
    request stream is replayed modulo its length when ``n_requests`` exceeds
    it (outputs stay comparable to the scalar baseline index-wise).  The
    broker scores on ``device``."""
    from repro_torch.online.server import AsyncBroker

    models = {k: predictor.model_for_kind(k) for k in ("map", "reduce")}
    models = {k: v for k, v in models.items() if v is not None}
    server = AsyncBroker(models, impl=impl, device=device, policy=policy,
                         depth=depth, vt_window=vt_window, slo_ms=slo_ms)
    server.start()
    n = n_requests or len(requests)
    shards = [list(range(c, n, clients)) for c in range(clients)]
    shards = [s for s in shards if s]
    rng = np.random.RandomState(seed)
    per_client = rate_rps / max(len(shards), 1)
    scheds = [_arrival_schedule(len(sh), per_client, arrivals, rng)
              for sh in shards]
    outs: list = [None] * n
    lats: list = [None] * n

    async def drive():
        t0 = time.perf_counter() + 0.02     # common epoch for all schedules
        await asyncio.gather(*[
            _open_loop_client(address, requests, sh, sc, t0, outs, lats,
                              slo_ms)
            for sh, sc in zip(shards, scheds)])
        return time.perf_counter() - t0

    try:
        address = server.serve("tcp://127.0.0.1:0" if backend == "tcp"
                               else "")
        if backend == "tcp":
            # tcp clients live on their own loop in this thread; frames
            # cross the real (loopback) socket stack
            dt = asyncio.run(drive())
        else:
            # inproc channels are loop-local: clients run on the server loop
            dt = asyncio.run_coroutine_threadsafe(
                drive(), server.loop).result(600)
        stats = server.stats()
        causes = {"depth": server.n_depth_flushes,
                  "vt": server.n_vt_flushes,
                  "idle": server.n_idle_flushes,
                  "slo": server.n_deadline_flushes}
    finally:
        server.stop()

    lat = sorted(1e3 * v for v in lats if v is not None)

    def pct(q):
        return lat[min(int(q * len(lat)), len(lat) - 1)] if lat else 0.0

    viol = sum(1 for v in lat if v > slo_ms) / max(len(lat), 1)
    return {"backend": backend, "arrivals": arrivals,
            "clients": len(shards), "rate_rps": round(rate_rps, 1),
            "slo_ms": slo_ms, "policy": policy,
            "rows": stats["rows"], "requests": stats["requests"],
            "seconds": dt, "rows_per_s": stats["rows"] / max(dt, 1e-9),
            "flushes": stats["flushes"], "dispatches": stats["dispatches"],
            "max_flush_rows": stats["max_flush_rows"],
            "flush_causes": causes,
            "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                           "p99": pct(0.99)},
            "slo_violation_rate": viol,
            "outputs": outs}


def mirror_outputs(predictor: TaskPredictor, requests) -> list:
    """Each request scored by the numpy mirror: ``forest_predict_np`` on
    the request's rows and its model's parameters, clipped as
    ``predict_batch`` clips (a non-forest model's own ``predict_proba``).
    Every serving path is held to these floats bit for bit."""
    outs = []
    for kind, X in requests:
        model = predictor.model_for_kind(kind)
        params = forest_family_params(model)
        p = (model.predict_proba(X) if params is None
             else np.clip(forest_predict_np(params, X), 0.0, 1.0))
        outs.append(np.asarray(p, np.float32))
    return outs


def _parity(want: dict, *others) -> bool:
    for mode in others:
        for a, b in zip(want["outputs"], mode["outputs"]):
            if b is None or not np.array_equal(a, b):
                return False
    return True


def _parity_mod(scalar_outputs: list, outs: list) -> bool:
    """Open-loop replays the stream modulo its length: outs[i] must equal
    the output for request i % len(stream), bit for bit."""
    m = len(scalar_outputs)
    for i, o in enumerate(outs):
        if o is None or not np.array_equal(scalar_outputs[i % m], o):
            return False
    return True


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def summarize(scalar: dict, broker: dict, saturated: dict,
              parity: bool | None, fleet_size: int = 0,
              open_loop: dict | None = None) -> dict:
    strip = lambda d: {k: v for k, v in d.items() if k != "outputs"}  # noqa: E731
    out = {
        "pr": repro_torch.PR_TAG,
        "fleet_size": fleet_size,
        "scalar": strip(scalar),
        "broker": strip(broker),
        "saturated": strip(saturated),
        "speedup": saturated["rows_per_s"] / max(scalar["rows_per_s"], 1e-9),
        "speedup_vs_per_decision": saturated["rows_per_s"]
        / max(scalar["per_decision_rows_per_s"], 1e-9),
        "dispatch_reduction": scalar["dispatches"]
        / max(broker["dispatches"], 1),
        "parity": parity,
    }
    if open_loop:
        out["open_loop"] = {cfg: strip(r) for cfg, r in open_loop.items()}
    return out


def _size_block(summary: dict) -> dict:
    """The compact per-fleet-size perf record stamped into SWEEP.json."""
    blk = {
        "batched_rows_per_s": round(summary["saturated"]["rows_per_s"], 1),
        "broker_rows_per_s": round(summary["broker"]["rows_per_s"], 1),
        "scalar_rows_per_s": round(summary["scalar"]["rows_per_s"], 1),
        "speedup": round(summary["speedup"], 2),
        "dispatch_reduction": round(summary["dispatch_reduction"], 2),
        "latency_ms": {k: round(v, 3)
                       for k, v in summary["broker"]["latency_ms"].items()},
        "parity": summary["parity"],
    }
    if summary.get("open_loop"):
        blk["open_loop"] = {
            cfg: {
                "rate_rps": r["rate_rps"],
                "rows_per_s": round(r["rows_per_s"], 1),
                "latency_ms": {k: round(v, 3)
                               for k, v in r["latency_ms"].items()},
                "p99_over_p50": round(
                    r["latency_ms"]["p99"]
                    / max(r["latency_ms"]["p50"], 1e-9), 2),
                "slo_ms": r["slo_ms"],
                "slo_violation_rate": round(r["slo_violation_rate"], 4),
                "flush_causes": r["flush_causes"],
                "parity": r["parity"],
            }
            for cfg, r in sorted(summary["open_loop"].items())
        }
    return blk


def stamp_sweep(summary: dict, sweep_json_path) -> bool:
    """Merge the broker numbers into SWEEP.json + SWEEP.md so the perf
    trajectory across PRs lives in one artifact."""
    jp = pathlib.Path(sweep_json_path)
    if not jp.exists():
        return False
    obj = json.loads(jp.read_text())
    perf = obj.setdefault("perf", {})
    perf["online_bench"] = {
        "pr": summary["pr"],
        **_size_block(summary),
        # the fleet-size scale axis: one throughput/latency block per size
        "per_fleet_size": {
            str(size): _size_block(s)
            for size, s in sorted(summary.get("per_fleet_size", {}).items(),
                                  key=lambda kv: int(kv[0]))
        },
    }
    jp.write_text(json.dumps(obj, indent=2, sort_keys=True) + "\n")
    mp = jp.with_name("SWEEP.md")
    if mp.exists():
        b = perf["online_bench"]
        # re-stamping replaces the previous broker section, never appends a
        # second one (the section is always the trailing block we wrote)
        md = mp.read_text()
        cut = md.find("\n## online broker (")
        if cut != -1:
            md = md[:cut]

        def row(label, blk):
            return (f"| {label} | {blk['scalar_rows_per_s']:.0f} "
                    f"| {blk['batched_rows_per_s']:.0f} "
                    f"| {blk['speedup']:.1f}x "
                    f"| {blk['dispatch_reduction']:.1f}x "
                    f"| {blk['latency_ms']['p50']:.2f} "
                    f"| {blk['latency_ms']['p99']:.2f} "
                    f"| {blk['parity']} |")

        lines = [md.rstrip("\n"), "",
                 f"## online broker ({summary['pr']})", "",
                 "| fleet | scalar rows/s | batched rows/s | speedup "
                 "| dispatch reduction | p50 ms | p99 ms | parity |",
                 "|---|---|---|---|---|---|---|---|"]
        sizes = b["per_fleet_size"] or {"0": b}
        for size, blk in sorted(sizes.items(), key=lambda kv: int(kv[0])):
            lines.append(row("paper (13)" if size == "0" else size, blk))
        mp.write_text("\n".join(lines) + "\n")
    return True


def run_bench(*, rows: int = 6000, clients: int = 12, workload: str = "smoke",
              scenario: str = "bursty_tt", impl: str | None = None,
              device=None, rate: float = 0.0, seed: int = 0,
              fleet_size: int = 0, policy: str = "barrier", depth: int = 256,
              max_delay: float = 0.002, obs_dir=None, obs_live=None,
              open_loop: bool = True, open_rate: float = 0.0,
              open_backends: tuple = ("inproc", "tcp"),
              slo_ms: float = 25.0) -> dict:
    predictor, requests = build_stream(workload=workload, scenario=scenario,
                                       seed=seed, min_rows=rows,
                                       fleet_size=fleet_size, device=device)
    obs = None
    if obs_dir is not None or obs_live is not None:
        from repro_torch.obs import (BrokerObserver, NDJSONSink, TeeSink,
                                     TransportSink)
        sinks = []
        if obs_dir is not None:
            d = pathlib.Path(obs_dir)
            d.mkdir(parents=True, exist_ok=True)
            sinks.append(NDJSONSink(d / f"bench_n{fleet_size}.ndjson"))
        if obs_live is not None:
            from repro_torch.obs.sink import telemetry_loop
            loop = (telemetry_loop()
                    if obs_live.startswith("tcp://") else None)
            sinks.append(TransportSink(obs_live, loop=loop,
                                       source=f"bench_n{fleet_size}",
                                       flush_every=8))
        obs = BrokerObserver(
            sink=sinks[0] if len(sinks) == 1 else TeeSink(*sinks))
    mirror = {"outputs": mirror_outputs(predictor, requests)}
    scalar = run_scalar(predictor, requests)
    broker = run_broker(predictor, requests, clients=clients, impl=impl,
                        device=device, rate=rate, policy=policy, depth=depth,
                        max_delay=max_delay, obs=obs)
    saturated = run_saturated(predictor, requests, impl=impl, device=device)
    parity = _parity(mirror, scalar, broker, saturated)
    open_runs = {}
    if open_loop:
        # auto rate: half the saturated row throughput converted to
        # requests/s, capped where per-message event-loop overhead (not
        # scoring) becomes the bottleneck — the point is tail behaviour
        # under heavy-but-feasible load, not a throughput contest
        mean_rows = scalar["rows"] / max(len(requests), 1)
        auto = min(0.5 * saturated["rows_per_s"] / max(mean_rows, 1e-9),
                   OPEN_RATE_CAP)
        configs = [(b, "poisson") for b in open_backends]
        if "inproc" in open_backends:
            configs.append(("inproc", "bursty"))
        for b, arr in configs:
            r = open_rate if open_rate > 0 else (
                auto if b == "inproc" else min(auto, TCP_RATE_CAP))
            # size the run to ~1s of schedule so the tail has enough samples
            n_open = int(min(max(len(requests), r), 60000))
            run = run_open_loop(
                predictor, requests, backend=b, arrivals=arr,
                clients=min(clients, 8), rate_rps=r, n_requests=n_open,
                slo_ms=slo_ms, impl=impl, device=device, seed=seed)
            run["parity"] = _parity_mod(mirror["outputs"], run["outputs"])
            open_runs[f"{b}_{arr}"] = run
    return summarize(scalar, broker, saturated, parity, fleet_size,
                     open_runs)


def run_bench_sizes(fleet_sizes, **kw) -> dict:
    """The full bench at each fleet size; the first size is the primary
    summary, every size lands under ``per_fleet_size``."""
    sizes = list(fleet_sizes) or [0]
    summary = None
    per_size = {}
    for size in sizes:
        s = run_bench(fleet_size=size, **kw)
        per_size[str(size)] = s
        if summary is None:
            summary = dict(s)     # copy: the primary also sits in per_size
    summary["per_fleet_size"] = per_size
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.online.bench",
        description="Broker load generator: replay fleet decision streams")
    ap.add_argument("--rows", type=int, default=6000)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--workload", default="smoke")
    ap.add_argument("--scenario", default="bursty_tt")
    ap.add_argument("--device", default=None,
                    help="where the predictor fits and scores (default: "
                         "cuda, which needs a GPU; 'cpu' for the CPU)")
    ap.add_argument("--impl", default=None,
                    choices=("numpy", "torch", "cuda"),
                    help="the broker flushes' path (default: by device — "
                         "the grouped CUDA kernel on the card, its plain "
                         "torch version on the CPU)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="per-client request rate (req/s, 0 = max)")
    ap.add_argument("--fleet-sizes", default="0",
                    help="comma list of fleet sizes to bench (0 = the "
                         "paper's 13-slave fleet); first is the primary "
                         "summary, all land in per_fleet_size")
    ap.add_argument("--policy", default="barrier",
                    choices=("barrier", "depth"),
                    help="broker flush policy (depth = queue-depth with "
                         "bounded delay; non-deterministic flush counts)")
    ap.add_argument("--depth", type=int, default=256,
                    help="queue-depth flush threshold in rows (policy=depth)")
    ap.add_argument("--max-delay", type=float, default=0.002,
                    help="bounded flush delay in seconds (policy=depth)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-open-loop", action="store_true",
                    help="skip the open-loop AsyncBroker section")
    ap.add_argument("--open-rate", type=float, default=0.0,
                    help="aggregate open-loop arrival rate (req/s; 0 = auto "
                         "from the saturated throughput)")
    ap.add_argument("--open-backends", default="inproc,tcp",
                    help="comma list of transport backends for the "
                         "open-loop section (inproc,tcp)")
    ap.add_argument("--slo-ms", type=float, default=25.0,
                    help="open-loop per-request latency budget (drives the "
                         "broker's early-flush safety valve + the "
                         "violation-rate metric)")
    ap.add_argument("--out", default="experiments",
                    help="directory for ONLINE.json")
    ap.add_argument("--stamp-sweep", nargs="?", const="experiments/SWEEP.json",
                    default=None, metavar="SWEEP_JSON",
                    help="merge the summary into an existing SWEEP.json/.md")
    ap.add_argument("--obs", action="store_true",
                    help="attach a BrokerObserver: per-flush NDJSON frames "
                         "under <out>/obs/ and an obs block in each size's "
                         "broker section of ONLINE.json")
    ap.add_argument("--obs-live", default=None, metavar="ADDR",
                    help="also stream broker flush frames to a live "
                         "TelemetryCollector at this transport address "
                         "(see python -m repro_torch.obs.live)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run (fewer rows/clients)")
    args = ap.parse_args(argv)

    rows, clients = args.rows, args.clients
    if args.smoke:
        rows, clients = min(rows, 2000), min(clients, 12)
    fleet_sizes = [int(s) for s in args.fleet_sizes.split(",")]
    obs_dir = str(pathlib.Path(args.out) / "obs") if args.obs else None
    summary = run_bench_sizes(
        fleet_sizes, rows=rows, clients=clients, workload=args.workload,
        scenario=args.scenario, impl=args.impl, device=args.device,
        rate=args.rate,
        seed=args.seed, policy=args.policy, depth=args.depth,
        max_delay=args.max_delay, obs_dir=obs_dir, obs_live=args.obs_live,
        open_loop=not args.no_open_loop, open_rate=args.open_rate,
        open_backends=tuple(args.open_backends.split(",")),
        slo_ms=args.slo_ms)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ONLINE.json").write_text(
        json.dumps(summary, indent=2, sort_keys=True) + "\n")
    b, s, f = summary["broker"], summary["scalar"], summary["saturated"]
    print(f"[online] scalar    : {s['rows']} rows, {s['dispatches']} "
          f"dispatches, {s['rows_per_s']:,.0f} rows/s "
          f"({s['per_decision_rows_per_s']:,.0f} rows/s per-decision)")
    print(f"[online] broker    : {b['rows']} rows, {b['dispatches']} "
          f"dispatches ({b['flushes']} flushes, max batch "
          f"{b['max_flush_rows']} rows), {b['rows_per_s']:,.0f} rows/s "
          f"[p50 {b['latency_ms']['p50']:.2f} ms, "
          f"p99 {b['latency_ms']['p99']:.2f} ms]")
    print(f"[online] saturated : {f['rows']} rows, {f['dispatches']} "
          f"dispatches ({f['flushes']} flushes), "
          f"{f['rows_per_s']:,.0f} rows/s")
    print(f"[online] batched speedup {summary['speedup']:.1f}x "
          f"({summary['speedup_vs_per_decision']:.1f}x vs per-decision), "
          f"dispatch reduction {summary['dispatch_reduction']:.1f}x, "
          f"parity={summary['parity']}")
    for cfg, r in sorted(summary.get("open_loop", {}).items()):
        lm = r["latency_ms"]
        print(f"[online] open-loop {cfg:>14s}: {r['rate_rps']:,.0f} req/s "
              f"offered, {r['rows_per_s']:,.0f} rows/s served "
              f"[p50 {lm['p50']:.2f} p95 {lm['p95']:.2f} "
              f"p99 {lm['p99']:.2f} ms, "
              f"{100 * r['slo_violation_rate']:.1f}% > {r['slo_ms']:.0f} ms "
              f"SLO], parity={r['parity']}")
    if len(summary["per_fleet_size"]) > 1:
        for size, s_sz in sorted(summary["per_fleet_size"].items(),
                                 key=lambda kv: int(kv[0])):
            blk = _size_block(s_sz)
            label = "paper(13)" if size == "0" else size
            print(f"[online] fleet {label:>9s}: "
                  f"{blk['batched_rows_per_s']:>10,.0f} batched rows/s, "
                  f"broker p50 {blk['latency_ms']['p50']:.2f} ms "
                  f"p99 {blk['latency_ms']['p99']:.2f} ms, "
                  f"parity={blk['parity']}")
    if args.stamp_sweep:
        if stamp_sweep(summary, args.stamp_sweep):
            print(f"[online] stamped perf into {args.stamp_sweep}")
        else:
            print(f"[online] no {args.stamp_sweep} to stamp (run the sweep "
                  "first)")

    bad = any(s_sz["broker"]["rows_per_s"] <= 0
              or s_sz["saturated"]["rows_per_s"] <= 0
              or s_sz["parity"] is False
              for s_sz in summary["per_fleet_size"].values())
    if bad:
        print("[online] FAIL: no batched throughput or parity break",
              file=sys.stderr)
        return 1
    # tail-latency budget: every open-loop config must hold p99 within 10x
    # of its p50 (with an absolute floor so sub-ms p50s don't gate on noise)
    # and keep its outputs bit-identical to the scalar baseline
    for s_sz in summary["per_fleet_size"].values():
        for cfg, r in s_sz.get("open_loop", {}).items():
            lm = r["latency_ms"]
            budget = max(10.0 * lm["p50"], P99_FLOOR_MS)
            if r["parity"] is False or lm["p99"] > budget:
                print(f"[online] FAIL: open-loop {cfg} p99 {lm['p99']:.2f} ms"
                      f" > budget {budget:.2f} ms or parity break"
                      f" (parity={r['parity']})", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
