"""The port's telemetry layer (repro_torch.obs and its hooks in the
simulator, ATLAS, the predictors, the brokers, the drift refresher, the
experiment module, the fleet sweep and the load bench) against the JAX
package's on the CPU.

The obs layer is numpy and the standard library in both packages, and a
frame carries no wall-clock or device value, so the port is held to the
reference byte for byte: registry state, NDJSON files, ``summary()``
roll-ups, ``perf.obs`` blocks and dashboard HTML.  The cells are the
reference's own obs test cell (``tests/test_obs.py:_cfg``), with
``max_train=40`` where ATLAS retrains (the reference refits through one jit
program at that cap), and the kitchen_sink smoke sweep of
``tests/test_torch_fleet.py``."""

import dataclasses
import inspect
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.cluster import experiment as jexp
from repro.cluster import fleet as jfleet
from repro.cluster.chaos import ChaosConfig as JaxChaos
from repro.cluster.scenarios import make_spec
from repro.cluster.workload import WorkloadConfig as JaxWorkload
from repro.core.predictor import TaskPredictor as JaxPredictor
from repro.obs import dashboard as jdash
from repro.obs import render as jrender
from repro.online.broker import BrokerPredictor as JaxBrokerPredictor
from repro_torch import obs as tobs
from repro_torch.cluster import ChaosConfig, WorkloadConfig
from repro_torch.cluster import experiment as texp
from repro_torch.cluster import fleet as tfleet
from repro_torch.convert import predictor_from_snapshot
from repro_torch.obs import dashboard as tdash
from repro_torch.obs import render as trender
from repro_torch.online.broker import BrokerPredictor

CPU = "cpu"
MODULES = ("metrics", "instrument", "sink", "collector", "render",
           "dashboard", "live")


def _quiet(*a, **k):
    pass


# ---------------------------------------------------------------- surface

def test_public_names_match_reference():
    import importlib
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    assert tobs.LiveServer.__name__ == "LiveServer"      # the lazy import
    for name in MODULES:
        j = importlib.import_module(f"repro.obs.{name}")
        t = importlib.import_module(f"repro_torch.obs.{name}")
        public = {n for n, v in vars(j).items() if not n.startswith("_")
                  and (inspect.isfunction(v) or inspect.isclass(v))
                  and v.__module__ == j.__name__}
        assert public <= set(vars(t)), (name, public - set(vars(t)))
    for const in ("EVENT_NAMES", "_OCC_EDGES", "FLUSH_ROW_EDGES",
                  "FLUSH_LATENCY_EDGES"):
        assert getattr(tobs.instrument, const) \
            == getattr(jobs.instrument, const)


# ---------------------------------------------------------------- metrics

def _drive(pkg, ring: int):
    """One seeded sequence of registry writes and reads in ``pkg``."""
    m = pkg.MetricsRegistry(ring_capacity=ring)
    hc, hc2 = m.counter("a.count"), m.counter("b.count")
    hg = m.gauge("a.gauge")
    hh = m.histogram("a.hist", (1, 2, 4, 8))
    m.freeze()
    rng = np.random.default_rng(7)
    for t in range(12):
        m.inc(hc, int(rng.integers(1, 5)))
        m.inc(hc2)
        m.set(hg, float(rng.random()))
        m.observe(hh, float(rng.random() * 10))
        m.observe_many(hh, rng.random(5) * 12)
        m.tick(60.0 * t)
    clone = m.clone()
    times, counters, gauges = m.ring()
    return {"snapshot": m.snapshot(), "times": times.tolist(),
            "counters": counters.tolist(), "gauges": gauges.tolist(),
            "deltas": m.deltas(hc).tolist(), "n_ticks": m.n_ticks,
            "rate": m.counter_rate(hc, 5), "rate_all": m.counter_rate(hc2),
            "gauge_window": m.gauge_window(hg, 3),
            "window": [a.tolist() for a in m.window(2)],
            "names": [m.names(k) for k in ("counter", "gauge", "histogram")],
            "edges": m.hist_edges(hh).tolist(),
            "clone": clone.snapshot()}


@pytest.mark.parametrize("ring", [4, 1024])
def test_registry_matches_reference(ring):
    assert _drive(tobs, ring) == _drive(jobs, ring)


def test_registry_is_static():
    m = tobs.MetricsRegistry()
    m.counter("x")
    with pytest.raises(ValueError):
        m.counter("x")
    with pytest.raises(RuntimeError):
        m.clone()
    with pytest.raises(ValueError):
        m.histogram("h", (2, 1))
    m.freeze()
    with pytest.raises(RuntimeError):
        m.counter("y")


@pytest.mark.parametrize("edges,counts,q", [
    ((1.0, 2.0, 4.0), (10, 0, 0, 0), 0.5),
    ((1.0, 2.0, 4.0), (5, 5, 0, 0), 0.99),
    ((1.0, 2.0, 4.0), (0, 0, 0, 10), 0.5),
    ((1.0, 2.0, 4.0), (0, 0, 0, 0), 0.5),
    ((1, 2, 4, 8, 16), (3, 1, 4, 1, 5, 9), 0.73),
])
def test_percentile_from_hist_matches_reference(edges, counts, q):
    args = (np.asarray(edges), np.asarray(counts), q)
    assert tobs.percentile_from_hist(*args) \
        == jobs.percentile_from_hist(*args)


# ---------------------------------------------------------------- sinks

FRAMES = [{"type": "meta", "t": 0.0, "n": 3},
          {"type": "frame", "t": 1.5, "occ": [0.1, 0.2]},
          {"type": "frame", "t": 2.5, "occ": [0.3, 0.0]},
          {"type": "final", "t": 2.0, "nested": {"a": [1, 2]}}]


def test_ndjson_roundtrip_and_truncated_tail(tmp_path):
    paths = {}
    for name, pkg in (("port", tobs), ("jax", jobs)):
        paths[name] = tmp_path / name / "frames.ndjson"  # parent created
        sink = pkg.NDJSONSink(paths[name], flush_every=3)
        for f in FRAMES:
            sink.emit(f)
        sink.close()
        sink.close()                                    # idempotent
        assert sink.n_frames == len(FRAMES)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert tobs.read_ndjson(paths["port"]) == FRAMES
    assert tobs.read_ndjson(tmp_path / "missing.ndjson") == []
    assert tobs.read_ndjson(tmp_path / "missing.ndjson",
                            return_partial=True) == ([], 0)
    cut = tmp_path / "cut.ndjson"
    cut.write_text(paths["port"].read_text() + '{"i": 3, "tru')
    assert tobs.read_ndjson(cut, return_partial=True) \
        == jobs.read_ndjson(cut, return_partial=True) == (FRAMES, 1)
    bad = tmp_path / "bad.ndjson"
    bad.write_text('{"i": 0}\n{"i": 1, "tru\n{"i": 2}\n')
    with pytest.raises(json.JSONDecodeError):
        tobs.read_ndjson(bad)


def test_ndjson_writes_encoded_lists_as_json_would(tmp_path):
    """An EncodedList value is written from its own text; the line is what
    json.dumps gives, also where the splice's placeholder occurs in a
    string of the frame (then the frame is encoded whole)."""
    from repro_torch.obs.sink import EncodedList

    def encoded(values):
        out = EncodedList(values)
        out.json = json.dumps(values, separators=(",", ":"))
        return out

    occ = encoded([0.0, 0.125, 1.0] * 40)
    frames = [{"type": "frame", "t": 1.0, "node_occ": occ,
               "node_fail": encoded([0, 2] * 60), "tail": {"x": [1, 2]}},
              {"type": "frame", "t": 2.0, "node_occ": occ},
              {"type": "meta", "s": json.loads('"\\ue0000"'),
               "node_occ": occ},
              [1, 2, 3]]
    sink = tobs.NDJSONSink(tmp_path / "f.ndjson", flush_every=2)
    for f in frames:
        sink.emit(f)
    sink.close()
    assert (tmp_path / "f.ndjson").read_text() == "".join(
        json.dumps(f, separators=(",", ":")) + "\n" for f in frames)
    assert tobs.read_ndjson(tmp_path / "f.ndjson") == frames


def test_tee_and_memory_sinks(tmp_path):
    mem = tobs.MemorySink()
    with tobs.TeeSink(mem, tobs.NDJSONSink(tmp_path / "t.ndjson")) as tee:
        for f in FRAMES:
            tee.emit(f)
    assert mem.frames == FRAMES == tobs.read_ndjson(tmp_path / "t.ndjson")
    with pytest.raises(NotImplementedError):
        tobs.Sink().emit({})


# ---------------------------------------------------------------- observers

def _cfgs(**kw):
    """tests/test_obs.py's _cfg in both packages."""
    base = dict(seed=3, min_samples=32, max_train=256, obs_frame_every=120.0)
    base.update(kw)
    jcfg = jexp.ExperimentConfig(
        workload=JaxWorkload(n_single=10, n_chains=2, seed=5),
        chaos=JaxChaos(intensity=2.0, seed=6), **base)
    tcfg = texp.ExperimentConfig(
        workload=WorkloadConfig(n_single=10, n_chains=2, seed=5),
        chaos=ChaosConfig(intensity=2.0, seed=6), device=CPU, **base)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def fifo_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fifo")
    jcfg, tcfg = _cfgs(obs_path=str(d / "jax.ndjson"))
    tcfg = dataclasses.replace(tcfg, obs_path=str(d / "port.ndjson"))
    jm, jtrace, jsim = jexp.run_scheduler("fifo", jcfg)
    tm, ttrace, tsim = texp.run_scheduler("fifo", tcfg)
    return d, (jm, jtrace, jsim), (tm, ttrace, tsim)


def test_fifo_frames_byte_equal_reference(fifo_runs):
    d, (jm, _, jsim), (tm, _, tsim) = fifo_runs
    assert (d / "port.ndjson").read_bytes() == (d / "jax.ndjson").read_bytes()
    assert tm == jm                                  # metrics["obs"] too
    # the registry behind the frames, gauges kept out of them included
    # (the port gathers a frame with comprehensions, the reference with
    # one loop: the same arithmetic in the same order)
    assert tsim.obs.metrics.snapshot() == jsim.obs.metrics.snapshot()
    for t, j in zip(tsim.obs.metrics.ring(), jsim.obs.metrics.ring()):
        assert np.array_equal(t, j)
    frames = tobs.read_ndjson(d / "port.ndjson")
    assert frames[0]["type"] == "meta" and frames[-1]["type"] == "final"
    assert frames[0]["n_nodes"] == len(tsim.nodes)
    body = [f for f in frames if f["type"] == "frame"]
    assert tm["obs"]["frames"] == len(body) > 0
    assert tm["obs"]["events"]["submit"] > 0


def test_obs_never_changes_sim_results(fifo_runs):
    _, _, (tm, _, _) = fifo_runs
    _, tcfg = _cfgs()
    plain, _, _ = texp.run_scheduler("fifo", tcfg)
    assert {k: v for k, v in tm.items() if k != "obs"} == plain


def test_job_ledger_matches_job_table(fifo_runs):
    _, (_, jtrace, _), (_, ttrace, tsim) = fifo_runs
    assert ttrace.jobs == jtrace.jobs
    assert set(ttrace.jobs) == set(tsim.jobs)
    for jid, job in tsim.jobs.items():
        row = ttrace.jobs[jid]
        assert row["submit"] == job.submit_time
        assert row["outcome"] == job.status
        if job.status == "finished":
            assert row["end"] == job.done_time
    assert sorted(ttrace.job_times()) == sorted(
        j.done_time - j.submit_time for j in tsim.jobs.values()
        if j.status == "finished")


@pytest.fixture(scope="module")
def trained():
    """The reference's predictor fitted on the ATLAS cell's fifo trace."""
    jcfg, _ = _cfgs(max_train=40)
    _, trace, _ = jexp.run_scheduler("fifo", jcfg)
    jpred = JaxPredictor(algo=jcfg.algo, seed=jcfg.seed,
                         min_samples=jcfg.min_samples,
                         max_train=jcfg.max_train)
    assert jpred.fit_datasets(*trace.datasets())
    return jpred.snapshot()


@pytest.fixture(scope="module", params=["scalar", "memo"])
def atlas_runs(request, trained, tmp_path_factory):
    """atlas-fifo with telemetry in both packages from the same trained
    parameters: the scalar TaskPredictor, or the tick-primed memo of a
    BrokerPredictor (whose frame_stats carry the memo fields)."""
    d = tmp_path_factory.mktemp(request.param)
    jcfg, tcfg = _cfgs(max_train=40)
    jcfg = dataclasses.replace(jcfg, obs_path=str(d / "jax.ndjson"))
    tcfg = dataclasses.replace(tcfg, obs_path=str(d / "port.ndjson"))
    tsnap = predictor_from_snapshot(trained, device=CPU).snapshot()
    if request.param == "scalar":
        jpred = JaxPredictor().load_snapshot(trained)
        tpred = predictor_from_snapshot(trained, device=CPU)
    else:
        jpred = JaxBrokerPredictor().load_snapshot(trained)
        tpred = BrokerPredictor(device=CPU).load_snapshot(tsnap)
    jm, _, _ = jexp.run_scheduler("atlas-fifo", jcfg, jpred)
    tm, _, _ = texp.run_scheduler("atlas-fifo", tcfg, tpred)
    return d, jm, tm


def test_atlas_frames_byte_equal_reference(atlas_runs):
    d, jm, tm = atlas_runs
    assert (d / "port.ndjson").read_bytes() == (d / "jax.ndjson").read_bytes()
    assert tm == jm
    assert tm["obs"] == jm["obs"]                     # summary() equal
    assert tm["atlas"]["predictions"] > 0 and tm["atlas"]["model_fits"] > 1
    frames = [f for f in tobs.read_ndjson(d / "port.ndjson")
              if f["type"] == "frame"]
    assert all("pred" in f for f in frames)
    assert frames[-1]["pred"]["dispatches"] > 0


@pytest.mark.parametrize("running", [1, 99])
def test_sim_observer_collapses_idle_gaps_like_reference(running):
    """tests/test_obs.py's stub simulator: the same frame grid, density
    gate and frames in both packages, with a running count inside the
    port's occupancy table and one far outside it."""

    class _Node:
        def __init__(self):
            self.spec = type("S", (), {"map_slots": 2, "reduce_slots": 2,
                                       "name": "n"})()
            self.running_maps = running
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

    out = {}
    for name, pkg in (("port", tobs), ("jax", jobs)):
        sink = pkg.MemorySink()
        obs = pkg.SimObserver(sink=sink, frame_every=10.0,
                              min_events_per_frame=1)
        gated = pkg.SimObserver(sink=pkg.MemorySink(), frame_every=10.0,
                                min_events_per_frame=3)
        sim, sim2 = _Sim(), _Sim()
        obs.bind(sim)
        gated.bind(sim2)
        for t in (1.0, 5.0, 12.0, 1000.0, 1001.0, 1015.0):
            sim.now = t
            obs.after_event(sim, 0)
        for t in (15.0, 30.0, 45.0, 60.0, 75.0, 90.0):
            sim2.now = t
            gated.after_event(sim2, 0)
        obs.record_drift(1015.0, "map", 0.25, None, 0.01)
        obs.record_event("promote", 1015.0, version=2, reason=None)
        obs.finish(sim)
        out[name] = (sink.frames, gated._n_frames, obs.summary())
    assert out["port"] == out["jax"]
    frames, n_gated, _ = out["port"]
    assert [f["t"] for f in frames if f["type"] == "frame"] \
        == [10.0, 20.0, 1010.0, 1015.0]
    assert n_gated == 2


def test_broker_observer_matches_reference():
    flushes = [(4, 2, 1, 0.2e-3), (16, 8, 2, 1.1e-3), (4, 2, 1, 0.4e-3),
               (300, 12, 1, 3.0e-3), (9000, 40, 1, 0.3)]
    out = {}
    for name, pkg in (("port", tobs), ("jax", jobs)):
        sink = pkg.MemorySink()
        obs = pkg.BrokerObserver(sink=sink, latency_ring=4)
        for f in flushes:
            obs.record_flush(*f)
        obs.close()
        out[name] = (obs.summary(deterministic_only=True), obs.summary(),
                     obs.latency_ms(), sink.frames)
    assert out["port"] == out["jax"]
    det, full, _, frames = out["port"]
    assert det["broker.flushes"] == 5 and det["broker.rows"] == 9324
    assert "flush_latency_ms" not in det and "flush_latency_ms" in full
    assert [f["rows"] for f in frames] == [f[0] for f in flushes]


# ---------------------------------------------------------------- drift

def _drift_cfgs(tmp_path):
    """tests/test_online_drift.py's end-to-end cell with telemetry."""
    wl = make_spec("baseline", "smoke").workload_for_seed(7)
    kw = dict(min_samples=40, max_train=40, drift=True,
              drift_check_every=60.0)
    jcfg = jexp.ExperimentConfig(workload=wl, **kw,
                                 obs_path=str(tmp_path / "jax.ndjson"))
    tcfg = texp.ExperimentConfig(
        workload=WorkloadConfig(**dataclasses.asdict(wl)), **kw,
        obs_path=str(tmp_path / "port.ndjson"), device=CPU)
    return jcfg, tcfg


def test_drift_on_frames_and_stats_match_reference(tmp_path):
    """With obs on, the refresher records both kinds' drift on every check
    (the monitor loop skips its early exit): frames, lifecycle markers,
    AtlasStats and events equal the reference's, and no refresh decision
    moves against the obs-off run."""
    jcfg, tcfg = _drift_cfgs(tmp_path)
    jm, _, jsim = jexp.run_scheduler("atlas-fifo", jcfg)
    tm, _, tsim = texp.run_scheduler("atlas-fifo", tcfg)
    assert (tmp_path / "port.ndjson").read_bytes() \
        == (tmp_path / "jax.ndjson").read_bytes()
    assert tm == jm
    events = tsim.scheduler.refresher.events
    assert events == jsim.scheduler.refresher.events
    assert tm["atlas"]["refreshes"] >= 1
    frames = tobs.read_ndjson(tmp_path / "port.ndjson")
    assert any(set(f.get("drift", {})) == {"map", "reduce"} for f in frames)
    marked = [e["event"] for f in frames for e in f.get("events", ())]
    assert marked == [e["event"] for e in events]
    assert set(tm["obs"]["drift_last"]) == {"map", "reduce"}
    off, _, off_sim = texp.run_scheduler(
        "atlas-fifo", dataclasses.replace(tcfg, obs_path=None))
    assert {k: v for k, v in tm.items() if k != "obs"} == off
    assert off_sim.scheduler.refresher.events == events


# ---------------------------------------------------------------- sweeps

SPEC = dict(schedulers=("fifo", "atlas-fifo"), seeds=1,
            scenarios=("kitchen_sink",), workloads=("smoke",),
            fleet_sizes=(100,), min_samples=40)


@pytest.fixture(scope="module")
def reference_sweeps(tmp_path_factory):
    """The reference's serial and broker sweeps with telemetry on."""
    out = {}
    for executor in ("serial", "broker"):
        d = tmp_path_factory.mktemp(f"jax_{executor}")
        out[executor] = (d, jfleet.run_sweep(
            jfleet.SweepSpec(**SPEC), executor=executor, obs_dir=str(d),
            log=_quiet))
    return out


@pytest.mark.parametrize("executor", ["serial", "broker", "async"])
def test_sweep_obs_on_vs_off_byte_parity(executor, reference_sweeps,
                                         tmp_path):
    spec = tfleet.SweepSpec(**SPEC)
    off = tfleet.run_sweep(spec, executor=executor, device=CPU, log=_quiet)
    on = tfleet.run_sweep(spec, executor=executor, device=CPU,
                          obs_dir=str(tmp_path), log=_quiet)
    obs_block = on["perf"].pop("obs")
    if not on["perf"]:
        on.pop("perf")
    assert tfleet.sweep_json(on) == tfleet.sweep_json(off)
    assert set(obs_block["cells"]) == {r["cell_id"] for r in off["cells"]}
    ref_dir, ref = reference_sweeps[
        "serial" if executor == "serial" else "broker"]
    assert obs_block == ref["perf"]["obs"]
    for cid in obs_block["cells"]:
        name = cid.replace("/", "__") + ".ndjson"
        assert (tmp_path / name).read_bytes() == (ref_dir / name).read_bytes()
    if executor != "serial":
        broker = obs_block["broker"]
        assert broker["broker.flushes"] \
            == off["perf"]["broker"]["flushes"] > 0
        assert broker["broker.dispatches"] \
            == off["perf"]["broker"]["dispatches"]
        frames = tobs.read_ndjson(tmp_path / "broker.ndjson")
        assert len(frames) == broker["broker.flushes"]
        assert [f["rows"] for f in frames] == [
            f["rows"] for f in jobs.read_ndjson(ref_dir / "broker.ndjson")]


# ---------------------------------------------------------------- dashboard

def test_dashboard_html_byte_equal_reference(atlas_runs, tmp_path):
    d, _, _ = atlas_runs
    frames = tobs.read_ndjson(d / "port.ndjson")
    flushes = [{"type": "flush", "i": i, "rows": r, "requests": q,
                "dispatches": 1, "latency_ms": lat}
               for i, (r, q, lat) in enumerate(
                   [(4, 2, 0.2), (16, 8, 1.1), (300, 12, 3.0)])]
    events = [{"event": "promote", "t": 600.0, "version": 2},
              {"event": "rollback", "t": 1200.0, "version": 1}]
    for kw in ({}, {"broker_frames": flushes},
               {"broker_frames": flushes, "registry_events": events,
                "title": "cell", "refresh": 2.0}):
        doc = trender.render_html(frames, **kw)
        assert doc == jrender.render_html(frames, **kw)
    assert trender.render_broker_html(flushes, refresh=1.0) \
        == jrender.render_broker_html(flushes, refresh=1.0)
    doc = trender.render_html(frames)
    assert doc.lstrip().startswith("<!DOCTYPE html>")
    for needle in ("repro ops dashboard", "Fleet occupancy", "<svg",
                   "viz-root", "prefers-color-scheme: dark", "<details>"):
        assert needle in doc, needle
    assert 'http-equiv="refresh"' not in doc
    with pytest.raises(ValueError):
        trender.render_html([])


def test_dashboard_cli_matches_reference(fifo_runs, tmp_path, capsys):
    d, _, _ = fifo_runs
    broker = tmp_path / "broker.ndjson"
    with tobs.NDJSONSink(broker) as sink:
        obs = tobs.BrokerObserver(sink=sink)
        for rows in (3, 17, 64):
            obs.record_flush(rows, 2, 1, 1e-3)
    for name, main in (("port", tdash.main), ("jax", jdash.main)):
        assert main([str(d / "port.ndjson"), "--broker", str(broker),
                     "-o", str(tmp_path / f"{name}.html")]) == 0
        stat = json.loads(capsys.readouterr().out)
        assert stat["out"] == str(tmp_path / f"{name}.html")
    assert (tmp_path / "port.html").read_bytes() \
        == (tmp_path / "jax.html").read_bytes()
    empty = tmp_path / "empty.ndjson"
    empty.write_text("")
    assert tdash.main([str(empty), "-o", str(tmp_path / "x.html")]) == 2
