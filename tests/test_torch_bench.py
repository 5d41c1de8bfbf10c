"""The port's load generator (repro_torch.online.bench) against the JAX
package's on the CPU: the decision stream and the arrival schedules equal
the reference's, the summary and the per-size perf block have the
reference's keys, every serving mode is held to the numpy mirror, and the
CLI's smoke run exits 0 and writes ONLINE.json (never a BENCH_*.json)."""

import json
import time

import numpy as np
import pytest

from repro.online import bench as jbench
from repro_torch.ml.forest import forest_predict_np
from repro_torch.online import bench as tbench

CPU = "cpu"


@pytest.fixture(scope="module")
def streams():
    """The same stream from both packages: fifo at the paper's fleet under
    bursty_tt, the smoke workload, tiled to 600 rows."""
    kw = dict(workload="smoke", scenario="bursty_tt", seed=0, min_rows=600)
    return jbench.build_stream(**kw), tbench.build_stream(**kw, device=CPU)


def test_request_sizes_match_the_reference():
    for fleet in (0, 13, 100, 1000):
        assert tbench.request_sizes(fleet) == jbench.request_sizes(fleet)
    assert tbench.request_sizes(1000)[6] == 256


def test_build_stream_gives_the_reference_requests(streams):
    (jpred, jreqs), (tpred, treqs) = streams
    assert len(treqs) == len(jreqs) > 0
    for (jk, jX), (tk, tX) in zip(jreqs, treqs):
        assert tk == jk and tX.dtype == jX.dtype == np.float32
        assert np.array_equal(tX, jX)
    for kind in ("map", "reduce"):
        jm, tm = jpred.model_for_kind(kind), tpred.model_for_kind(kind)
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert np.array_equal(tm.params.feat_idx, jm.params.feat_idx)
            assert np.array_equal(tm.params.thresholds, jm.params.thresholds)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_arrival_schedules_match_the_reference(kind):
    for rate in (50.0, 3000.0):
        got = tbench._arrival_schedule(200, rate, kind,
                                       np.random.RandomState(3))
        want = jbench._arrival_schedule(200, rate, kind,
                                        np.random.RandomState(3))
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tbench._arrival_schedule(3, 1.0, "nope", np.random.RandomState(0))


def test_modes_serve_the_numpy_mirror(streams):
    _, (pred, requests) = streams
    mirror = tbench.mirror_outputs(pred, requests)
    for (kind, X), want in zip(requests, mirror):
        params = pred.model_for_kind(kind).params
        assert np.array_equal(
            want, np.clip(forest_predict_np(params, X), 0, 1)
            .astype(np.float32))
    d0 = pred.n_dispatches
    scalar = tbench.run_scalar(pred, requests)
    # the per-request pass plus the per-row pass, one dispatch each
    assert pred.n_dispatches - d0 == scalar["dispatches"] + scalar["rows"]
    assert scalar["dispatches"] == len(requests)
    broker = tbench.run_broker(pred, requests, clients=4, device=CPU)
    depth = tbench.run_broker(pred, requests, clients=4, device=CPU,
                              policy="depth", depth=64)
    saturated = tbench.run_saturated(pred, requests, device=CPU,
                                     batch_rows=256)
    want = {"outputs": mirror}
    assert tbench._parity(want, scalar, broker, depth, saturated)
    assert broker["rows"] == saturated["rows"] == scalar["rows"]
    assert broker["policy"] == "barrier" and depth["policy"] == "depth"
    assert saturated["flushes"] == saturated["dispatches"] > 1
    wrong = [o.copy() for o in mirror]
    wrong[-1][0] += 1e-7
    assert not tbench._parity({"outputs": wrong}, scalar)


def _fake_mode(rows, **extra):
    return {"rows": rows, "requests": 10, "seconds": 0.5,
            "rows_per_s": rows / 0.5, "dispatches": 4, "flushes": 2,
            "max_flush_rows": 9, "per_decision_rows_per_s": rows / 2.0,
            "latency_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0},
            "outputs": [np.zeros(1, np.float32)], **extra}


def _fake_summary(pkg):
    ol = {"inproc_poisson": _fake_mode(
        40, rate_rps=100.0, slo_ms=25.0, slo_violation_rate=0.1,
        flush_causes={"depth": 0, "vt": 0, "idle": 2, "slo": 0},
        parity=True)}
    return pkg.summarize(_fake_mode(40), _fake_mode(40), _fake_mode(40),
                         True, 100, ol)


def test_summary_and_size_block_match_the_reference(tmp_path):
    mine, ref = _fake_summary(tbench), _fake_summary(jbench)
    assert mine.keys() == ref.keys()
    assert mine.pop("pr").startswith("repro_torch-")
    ref.pop("pr")
    assert mine == ref
    assert tbench._size_block(mine) == jbench._size_block(ref)
    (tmp_path / "SWEEP.json").write_text(json.dumps({"cells": []}))
    (tmp_path / "SWEEP.md").write_text("# Fleet sweep\n")
    summary = dict(_fake_summary(tbench), per_fleet_size={
        "100": _fake_summary(tbench)})
    assert tbench.stamp_sweep(summary, tmp_path / "SWEEP.json")
    perf = json.loads((tmp_path / "SWEEP.json").read_text())["perf"]
    assert set(perf["online_bench"]["per_fleet_size"]) == {"100"}
    assert "## online broker (repro_torch-" \
        in (tmp_path / "SWEEP.md").read_text()
    assert not tbench.stamp_sweep(summary, tmp_path / "missing.json")


def test_cli_smoke_exits_zero_and_writes_online_json(tmp_path, capsys):
    out = tmp_path / "out"
    assert tbench.main(["--smoke", "--device", "cpu", "--no-open-loop",
                        "--rows", "600", "--out", str(out)]) == 0
    summary = json.loads((out / "ONLINE.json").read_text())
    assert summary["parity"] is True
    assert summary["pr"].startswith("repro_torch-")
    assert summary["broker"]["rows_per_s"] > 0
    assert summary["saturated"]["rows_per_s"] > 0
    assert [p.name for p in out.iterdir()] == ["ONLINE.json"]
    assert "parity=True" in capsys.readouterr().out


def test_cli_telemetry_options_write_their_block(tmp_path):
    """--obs writes the broker's per-flush frames and its roll-up into each
    size's broker section of ONLINE.json; --obs-live streams the same flush
    frames to a live collector over tcp."""
    from repro_torch.obs import TelemetryCollector, read_ndjson
    from repro_torch.online.server import AsyncBroker
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        addr = srv.serve("tcp://127.0.0.1:0")
        assert tbench.main(["--smoke", "--device", "cpu", "--no-open-loop",
                            "--rows", "100", "--out", str(tmp_path),
                            "--obs", "--obs-live", addr]) == 0
        summary = json.loads((tmp_path / "ONLINE.json").read_text())
        obs = summary["per_fleet_size"]["0"]["broker"]["obs"]
        assert summary["broker"]["obs"] == obs
        flushes = summary["broker"]["flushes"]
        assert obs["broker.flushes"] == flushes > 0
        assert obs["broker.rows"] == summary["broker"]["rows"]
        assert set(obs["flush_latency_ms"]) == {"p50", "p99"}
        frames = read_ndjson(tmp_path / "obs" / "bench_n0.ndjson")
        assert [f["type"] for f in frames] == ["flush"] * flushes
        deadline = time.time() + 10
        while coll.seq < flushes and time.time() < deadline:
            time.sleep(0.01)
    assert coll.aggregates()["bench_n0"]["broker"]["flushes"] == flushes
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ONLINE.json",
                                                          "obs"]
