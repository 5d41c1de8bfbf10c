"""The port's live telemetry wire (repro_torch.obs.collector, obs.live,
obs.sink.TransportSink and the port's AsyncBroker routing) on the CPU.

The collector is held to the JAX package's: both are fed the same
``(source, frame)`` sequence and give equal aggregates, deltas, resync
replies and wire accounting.  The end-to-end paths run on the port alone
(``AsyncBroker(device="cpu")``): the reference's TCP listener cannot stop
on Python 3.12 (ROADMAP section 3), so no reference broker is used here.
Every socket and thread wait is bounded."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from repro import obs as jobs
from repro.obs import render as jrender
from repro_torch import obs as tobs
from repro_torch.cluster import ChaosConfig, WorkloadConfig
from repro_torch.cluster.experiment import ExperimentConfig, run_scheduler
from repro_torch.obs import (LiveServer, SimObserver, TelemetryCollector,
                             TransportSink)
from repro_torch.online.server import AsyncBroker

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sim_frame(i, t, occ=0.5, fails=(0, 0, 0, 0), **extra):
    return {"type": "frame", "i": i, "t": t, "occ": occ, "running": 2,
            "pending": 1, "penalty_box": 0, "running_jobs": 1, "alive": 4,
            "hb_stale_max": 0.5, "node_occ": [occ] * 4,
            "node_fail": list(fails), **extra}


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError("timed out waiting for condition")
        time.sleep(0.01)


def _cfg(**kw):
    """tests/test_obs.py's _cfg."""
    base = dict(seed=3, min_samples=32, max_train=256, obs_frame_every=120.0,
                device=CPU)
    return ExperimentConfig(
        workload=WorkloadConfig(n_single=10, n_chains=2, seed=5),
        chaos=ChaosConfig(intensity=2.0, seed=6), **{**base, **kw})


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A (source, frame, n) sequence: two real fifo runs' frames, broker
    flush frames, drift and degradation fields, and wire gaps/restarts."""
    d = tmp_path_factory.mktemp("stream")
    out = []
    for seed, source in ((3, "cell/a"), (4, "cell/b")):
        path = d / f"{seed}.ndjson"
        run_scheduler("fifo", _cfg(obs_path=str(path), seed=seed))
        out += [(source, f, None) for f in tobs.read_ndjson(path)]
    for i in range(6):
        out.append(("cell/c", _sim_frame(
            i, 60.0 * (i + 1), occ=0.1 * i, fails=(i % 2, 0, 1, 0),
            drift={"map": {"psi": 0.1 * i}, "reduce": None},
            pred={"fallbacks": i, "retries": 2 * i, "reconnects": i // 3}),
            i + 1 if i != 4 else 9))
    for i, rows in enumerate((1, 48, 300, 5000)):
        out.append(("bench", {"type": "flush", "i": i, "rows": rows,
                              "requests": 3 + i, "dispatches": 1,
                              "latency_ms": 0.5}, i + 1))
    out.append(("cell/c", _sim_frame(6, 420.0), 1))      # producer restart
    return out


def _feed(pkg, stream, **kw):
    c = pkg.TelemetryCollector(**kw)
    for source, frame, n in stream:
        c.ingest(frame, source=source, n=n)
    return c


def _wire(c):
    return {name: {k: v for k, v in h.items() if k != "lag_s"}
            for name, h in c.health()["sources"].items()}


# ---------------------------------------------------------------- collector

@pytest.mark.parametrize("capacity", [8192, 5])
def test_collector_matches_reference(stream, capacity):
    t = _feed(tobs, stream, delta_capacity=capacity, frame_window=4,
              ring_capacity=8)
    j = _feed(jobs, stream, delta_capacity=capacity, frame_window=4,
              ring_capacity=8)
    assert t.aggregates() == j.aggregates()
    assert t.seq == j.seq == len(stream)
    assert t.source_names() == j.source_names()
    for since in (0, 3, len(stream) - 2, len(stream), len(stream) + 5):
        assert t.delta(since) == j.delta(since)
    for name in t.source_names():
        assert t.frames_for(name) == j.frames_for(name)
    assert t.frames_for("ghost") == []
    assert _wire(t) == _wire(j)
    assert t.health()["delta_log_evicted"] \
        == j.health()["delta_log_evicted"]
    agg = t.aggregates()
    assert agg["cell/a"]["done"] and agg["cell/a"]["sim"]["frames"] > 0
    assert agg["cell/c"]["sim"]["drift_psi"] == {"map": 0.5}
    assert agg["cell/c"]["sim"]["pred_retries"] == 10
    assert agg["bench"]["broker"]["rows"] == 5349
    wire = _wire(t)["cell/c"]
    assert wire["wire_gaps"] == 4 and wire["reconnects"] == 2


def test_collector_folds_sim_and_broker_streams():
    c = TelemetryCollector()
    c.ingest({"type": "meta", "t": 0.0, "frame_every": 60.0, "n_nodes": 4,
              "scheduler": "fifo"}, source="cell")
    for i in range(4):
        c.ingest(_sim_frame(i, 60.0 * (i + 1), occ=0.4 + 0.1 * i,
                            fails=(1, 0, 0, 0)), source="cell")
    c.ingest({"type": "flush", "i": 0, "rows": 48, "requests": 6,
              "dispatches": 2, "latency_ms": 1.5}, source="cell")
    c.ingest({"type": "final", "t": 300.0, "summary": {}}, source="cell")
    agg = c.aggregates()["cell"]
    assert agg["frames"] == 7 and agg["done"]
    sim = agg["sim"]
    assert sim["frames"] == 4 and sim["failures"] == 4
    assert sim["occupancy"]["last"] == pytest.approx(0.7)
    assert sim["failure_rate_w"] == pytest.approx(3 / 180, abs=1e-6)
    assert agg["broker"]["flush_rows_p50"] == 64.0
    assert agg["broker"]["queue_depth_p50"] == 8.0


def test_collector_delta_chains_resyncs_and_replays(stream):
    c = _feed(tobs, stream)
    seen, since = [], 0
    while True:
        r = c.delta(since)
        assert "resync" not in r
        if not r["frames"]:
            break
        seen.extend(e["seq"] for e in r["frames"])
        since = r["frames"][-1]["seq"]
    assert seen == list(range(1, len(stream) + 1))
    replay = TelemetryCollector()
    for e in c.delta(0)["frames"]:
        replay.ingest(e["frame"], source=e["source"])
    assert replay.aggregates() == c.aggregates()
    small = _feed(tobs, stream[:10], delta_capacity=4)
    r = small.delta(2)
    assert r["resync"] is True and r["dropped"] == 4
    assert [e["seq"] for e in r["frames"]] == [7, 8, 9, 10]
    stale = small.delta(50)                    # a restarted collector
    assert stale["resync"] is True and stale["dropped"] == 0


# ---------------------------------------------------------------- the wire

class _Node:
    def __init__(self):
        self.spec = type("S", (), {"map_slots": 2, "reduce_slots": 2,
                                   "name": "n"})()
        self.running_maps = 1
        self.running_reduces = 0
        self.last_heartbeat = 0.0
        self.failed_count = 0


class _Sim:
    def __init__(self):
        self.nodes = [_Node()]
        self.pending = ()
        self.n_running_jobs = 0
        self.heartbeat_interval = 600.0
        self._known_alive = {0}
        self.scheduler = type("Sch", (), {
            "name": "fifo",
            "frame_stats": lambda self: {"penalty_box": 0, "pred": None},
        })()
        self.now = 0.0


def test_e2e_inproc_simobserver_to_collector():
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        addr = srv.serve()
        sink = TransportSink(addr, loop=srv.loop, source="cellA")
        obs = SimObserver(sink=sink, frame_every=10.0,
                          min_events_per_frame=1)
        sim = _Sim()
        obs.bind(sim)
        for t in (1.0, 12.0, 23.0, 34.0, 45.0):
            sim.now = t
            obs.after_event(sim, 0)
        obs.finish(sim)
        n_sent = sink.n_frames
        assert n_sent >= 3
        _wait(lambda: coll.seq >= n_sent)
        agg = coll.aggregates()["cellA"]
        assert agg["done"] and agg["sim"]["frames"] >= 1
        st = srv.telemetry_stats()["sources"]["cellA"]
        assert st["frames"] == n_sent and st["gaps"] == 0


def test_batched_wire_form_preserves_per_frame_accounting():
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        addr = srv.serve()
        sink = TransportSink(addr, loop=srv.loop, source="cellB",
                             flush_every=4)
        for i in range(6):
            sink.emit(_sim_frame(i, 10.0 * (i + 1)))
        assert sink.n_frames == 6
        _wait(lambda: coll.seq >= 4)
        sink.close()
        _wait(lambda: coll.seq >= 6)
        st = srv.telemetry_stats()["sources"]["cellB"]
        assert st["frames"] == 6 and st["last_n"] == 6
        assert st["gaps"] == 0 and st["reconnects"] == 0


def test_transport_sink_without_source_keeps_bare_wire_format():
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        sink = TransportSink(srv.serve(), loop=srv.loop)
        sink.emit({"type": "meta"})
        sink.close()
        _wait(lambda: coll.seq >= 1)
    assert coll.source_names() == ["default"]
    assert srv.telemetry_stats()["sources"]["default"]["last_n"] == 0


def test_e2e_tcp_run_scheduler_obs_live_does_not_perturb(tmp_path):
    """The live wire and the NDJSON file see the same frames, and the run's
    results do not move: the collector's aggregates equal a replay of the
    file through the JAX package's collector."""
    cfg = _cfg()
    plain, _, _ = run_scheduler("fifo", cfg)
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        addr = srv.serve("tcp://127.0.0.1:0")
        live_cfg = dataclasses.replace(cfg, obs_live_addr=addr,
                                       obs_source="fifo/s3",
                                       obs_path=str(tmp_path / "f.ndjson"))
        live, _, _ = run_scheduler("fifo", live_cfg)
        n_emitted = live["obs"]["frames"] + 2
        _wait(lambda: coll.seq >= n_emitted)
    assert {k: v for k, v in live.items() if k != "obs"} == plain
    assert srv.telemetry_stats()["sources"]["fifo/s3"]["gaps"] == 0
    from_file = jobs.TelemetryCollector()
    for frame in jobs.read_ndjson(tmp_path / "f.ndjson"):
        from_file.ingest(frame, source="fifo/s3")
    assert coll.aggregates() == from_file.aggregates()


def test_e2e_slow_collector_applies_backpressure_without_loss():
    class _Slow(TelemetryCollector):
        def ingest(self, frame, **kw):
            time.sleep(0.002)
            return super().ingest(frame, **kw)

    with AsyncBroker(device=CPU) as srv:
        coll = _Slow()
        srv.collector = coll
        addr = srv.serve(capacity=2)
        sink = TransportSink(addr, loop=srv.loop, source="s")
        frames = [_sim_frame(i, 60.0 * i) for i in range(40)]
        for f in frames:
            sink.emit(f)
        sink.close()
        _wait(lambda: coll.seq >= 40)
    assert [e["frame"] for e in coll.delta(0)["frames"]] == frames
    h = coll.health()["sources"]["s"]
    assert h["wire_gaps"] == 0 and h["reconnects"] == 0


def test_e2e_tcp_mid_stream_disconnect_reconnect():
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        addr = srv.serve("tcp://127.0.0.1:0")
        first = TransportSink(addr, source="cell")
        for i in range(5):
            first.emit(_sim_frame(i, 60.0 * i))
        first.close()
        second = TransportSink(addr, source="cell")
        for i in range(3):
            second.emit(_sim_frame(5 + i, 60.0 * (5 + i)))
        second.close()
        _wait(lambda: coll.seq >= 8)
    assert coll.aggregates()["cell"]["sim"]["frames"] == 8
    h = coll.health()["sources"]["cell"]
    assert h["reconnects"] == 1 and h["last_n"] == 3
    assert srv.telemetry_stats()["sources"]["cell"]["reconnects"] == 1


def test_tcp_consumer_restart_producers_reconnect_gaplessly():
    coll = TelemetryCollector()
    srv = AsyncBroker(device=CPU).start()
    srv.collector = coll
    addr = srv.serve("tcp://127.0.0.1:0")
    sink = TransportSink(addr, source="cell", backoff_base_s=0.01,
                         backoff_cap_s=0.05)
    try:
        for i in range(3):
            sink.emit(_sim_frame(i, 60.0 * i))
        _wait(lambda: coll.seq >= 3)
        srv.stop()                       # the consumer dies mid-run
        for i in range(3, 6):            # the producer must not notice
            sink.emit(_sim_frame(i, 60.0 * i))
        assert sink.n_send_errors >= 1 and sink._comm is None
        srv2 = AsyncBroker(device=CPU).start()
        srv2.resume_collector(coll)
        srv2.serve(addr)                 # the same concrete port
        try:
            deadline = time.time() + 10.0
            i = 6
            while coll.seq < 7:
                assert time.time() < deadline, "sink never reconnected"
                sink.emit(_sim_frame(i, 60.0 * i))
                i += 1
                time.sleep(0.02)
            sink.close()
            _wait(lambda: coll.aggregates()["cell"]["sim"]["frames"] >= 7)
        finally:
            srv2.stop()
    finally:
        sink.close()
        srv.stop()
    assert sink.n_reconnects == 1 and sink.n_dropped == 0
    h = coll.health()["sources"]["cell"]
    assert h["wire_gaps"] == 0 and h["reconnects"] == 0


def test_tcp_transport_sink_lifecycle():
    """close() joins the private loop thread and closes its loop; emit
    after close raises."""
    with AsyncBroker(device=CPU) as srv:
        addr = srv.serve("tcp://127.0.0.1:0")
        sink = TransportSink(addr, source="x")
        thread = sink._thread
        assert thread is not None and thread.is_alive()
        sink.emit({"type": "meta"})
        sink.close()
        assert not thread.is_alive(), "private loop thread not joined"
        assert sink._loop.is_closed()
        sink.close()
        with pytest.raises(RuntimeError, match="closed"):
            sink.emit({"type": "meta"})


# ---------------------------------------------------------------- HTTP

@pytest.fixture()
def live_http():
    c = TelemetryCollector()
    c.ingest({"type": "meta", "t": 0.0, "frame_every": 60.0, "n_nodes": 4,
              "scheduler": "fifo"}, source="cell", n=1)
    for i in range(3):
        c.ingest(_sim_frame(i, 60.0 * (i + 1)), source="cell", n=i + 2)
    c.ingest({"type": "flush", "i": 0, "rows": 16, "requests": 4,
              "dispatches": 1, "latency_ms": 0.9}, source="bench", n=1)
    with LiveServer(c, refresh=1.0) as http:
        yield c, http


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_http_snapshot_and_delta(live_http):
    c, http = live_http
    status, body = _get(http.address + "/snapshot")
    snap = json.loads(body)
    assert status == 200 and snap["seq"] == c.seq
    assert snap["aggregates"] == c.aggregates()
    assert snap["aggregates"]["cell"]["sim"]["frames"] == 3
    _, body = _get(http.address + "/delta?since=2")
    assert json.loads(body) == c.delta(2)
    assert [e["seq"] for e in json.loads(body)["frames"]] == [3, 4, 5]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http.address + "/delta?since=nope")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http.address + "/nope")
    assert e.value.code == 404


def test_http_views_equal_the_reference_render(live_http):
    c, http = live_http
    _, index = _get(http.address + "/")
    assert "repro live telemetry" in index
    assert "cell" in index and "bench" in index
    _, view = _get(http.address + "/view?source=cell")
    frames = c.frames_for("cell")
    assert view == jrender.render_html(frames, title="live · cell",
                                       refresh=1.0)
    c.ingest(_sim_frame(3, 240.0, occ=0.9), source="cell", n=5)
    _, view2 = _get(http.address + "/view?source=cell")
    assert view2 != view
    _, bview = _get(http.address + "/view?source=bench")
    assert bview == jrender.render_broker_html(
        c.frames_for("bench"), title="live · bench", refresh=1.0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http.address + "/view?source=ghost")
    assert e.value.code == 404


def test_live_server_handler_timeout_closes_stalled_connection():
    with LiveServer(TelemetryCollector(), handler_timeout=0.3) as http:
        host, port = http.address[len("http://"):].rsplit(":", 1)
        s = socket.create_connection((host, int(port)))
        try:
            s.sendall(b"GET /snapshot HTTP/1.1\r\nHost: x")
            s.settimeout(10.0)
            t0 = time.time()
            assert s.recv(65536) == b""
            assert time.time() - t0 < 8.0
        finally:
            s.close()
        status, _ = _get(http.address + "/snapshot")
        assert status == 200


def test_live_cli_on_the_cpu_collects_a_tcp_stream():
    """python -m repro_torch.obs.live --device cpu, as a separate process:
    frames streamed to its listener show up on its /snapshot."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.obs.live", "--device", CPU,
         "--listen", "tcp://127.0.0.1:0", "--http", "127.0.0.1:0"],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        addrs = json.loads(proc.stdout.readline())
        sink = TransportSink(addrs["listen"], source="cli",
                             loop=tobs.sink.telemetry_loop())
        for i in range(5):
            sink.emit(_sim_frame(i, 60.0 * (i + 1)))
        sink.close()

        def frames():
            snap = json.loads(_get(addrs["http"] + "/snapshot")[1])
            return snap["aggregates"].get("cli", {}).get("frames", 0)

        _wait(lambda: frames() == 5, timeout=30.0)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
