"""The port's model registry and drift-aware refresh (repro_torch.online.
registry, repro_torch.online.drift, ATLASScheduler(refresher=)) against the
JAX package on the CPU.

The registry keeps the reference's on-disk layout and digests, so a version
published by either package loads in the other and scores bitwise equal.
The drift monitor is numpy in both packages and its signals are equal on
the same stream; a drift-on ATLAS run of the reference's own test cell
gives equal metrics, refresher trio and lifecycle events."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.cluster import experiment as jexp
from repro.cluster.scenarios import make_spec
from repro.core.predictor import TaskPredictor as JaxPredictor
from repro.online import drift as jdrift
from repro.online.registry import ModelRegistry as JaxRegistry
from repro_torch.cluster import WorkloadConfig
from repro_torch.cluster import experiment as texp
from repro_torch.core.predictor import TaskPredictor
from repro_torch.online import drift as tdrift
from repro_torch.online.registry import ModelRegistry

CPU = "cpu"


def _data(n=400, seed=0, shift=0.0):
    rng = np.random.RandomState(seed)
    X = (rng.rand(n, 6) + shift).astype(np.float32)
    y = (X[:, 0] % 1.0 > 0.5).astype(np.float32)
    return X, y


# ---------------------------------------------------------------- registry

def _trained(cls, seed=0, **kw):
    rng = np.random.RandomState(seed)
    X = rng.rand(300, 8).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    pred = cls(algo="R.F.", min_samples=50, seed=seed, **kw)
    pred.fit_datasets((X, y), (X, 1 - y))
    return pred, X


def _same_scores(a, b, X):
    for kind in ("map", "reduce"):
        pa, pb = a.predict_batch(kind, X), b.predict_batch(kind, X)
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb), kind


def test_version_published_by_the_port_loads_in_the_reference(tmp_path):
    pred, X = _trained(TaskPredictor, device=CPU)
    v = ModelRegistry(tmp_path).publish("fifo/baseline/smoke/s0",
                                        pred.snapshot(), meta={"role": "t"})
    snap = JaxRegistry(tmp_path).load("fifo/baseline/smoke/s0", v)
    _same_scores(pred, JaxPredictor().load_snapshot(snap), X)
    assert (tmp_path / "fifo/baseline/smoke/s0/v_000001/params.npz").exists()
    assert (tmp_path / "fifo/baseline/smoke/s0/HEAD").read_text() == "1"


def test_version_published_by_the_reference_loads_in_the_port(tmp_path):
    pred, X = _trained(JaxPredictor, seed=3)
    jreg = JaxRegistry(tmp_path)
    jreg.publish("m", pred.snapshot())
    jreg.publish("m", _trained(JaxPredictor, seed=4)[0].snapshot(),
                 promote=False)
    reg = ModelRegistry(tmp_path)
    assert reg.versions("m") == [1, 2] and reg.head("m") == 1
    port = TaskPredictor(device=CPU).load_snapshot(reg.load("m"))
    _same_scores(pred, port, X)
    # the same digests: the port's own publish of the loaded version
    ModelRegistry(tmp_path / "p").publish("m", port.snapshot())

    def digests(root):
        return json.loads(
            (root / "m" / "v_000001" / "meta.json").read_text())["digests"]
    assert digests(tmp_path / "p") == digests(tmp_path)
    # HEAD moves made by one package are read by the other
    reg.promote("m", 2)
    assert jreg.head("m") == 2
    assert jreg.rollback("m") == 1 and reg.head("m") == 1
    assert [e["event"] for e in reg.history("m")] == [
        "publish", "publish", "promote", "rollback"]


def test_registry_detects_corruption(tmp_path):
    pred, _ = _trained(TaskPredictor, device=CPU)
    reg = ModelRegistry(tmp_path)
    reg.publish("m", pred.snapshot())
    path = tmp_path / "m" / "v_000001" / "params.npz"
    data = dict(np.load(path))
    data["map__leaves"] = data["map__leaves"] + 1.0
    np.savez(path, **data)
    with pytest.raises(IOError, match="digest"):
        reg.load("m")


# ---------------------------------------------------------------- monitor

def _stream():
    X, y = _data()
    Xs, ys = _data(seed=1, shift=0.7)
    p = np.clip(0.8 * ys + 0.1 + 0.05 * np.sin(np.arange(len(ys))), 0, 1)
    return X, (Xs, ys, p.astype(np.float32))


@pytest.mark.parametrize("kw", [dict(), dict(window=100, n_hist_bins=5),
                                dict(min_window=500)])
def test_monitor_signals_match_reference(kw):
    X, (Xs, ys, p) = _stream()
    j, t = jdrift.DriftMonitor(**kw), tdrift.DriftMonitor(**kw)
    for mon in (j, t):
        mon.set_reference(X, brier=0.05)
    for lo in range(0, len(ys), 90):
        sl = slice(lo, lo + 90)
        j.observe(Xs[sl], ys[sl], p[sl])
        t.observe(Xs[sl], ys[sl], p[sl])
        assert t.signals() == j.signals()
        assert t.drifted() == j.drifted()
    for a, b in zip(t.window_arrays(), j.window_arrays()):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- refresher

def _stub_sim(X, y, now):
    trace = types.SimpleNamespace(
        datasets=lambda: ((X, y), (np.zeros((0, X.shape[1]), np.float32),
                                   np.zeros(0, np.float32))))
    return types.SimpleNamespace(trace=trace, now=now)


def test_refresher_lifecycle_matches_reference(tmp_path):
    """Staleness fit, quiet check, drift refresh and a poisoned candidate's
    rollback: the same decisions and events, the same registry history."""
    X, y = _data()
    Xs, ys = _data(seed=3, shift=2.0)
    X2, y2 = np.concatenate([X, Xs]), np.concatenate([y, ys])
    steps = [(X, y, 700.0), (X, y, 720.0), (X2, y2, 760.0)]
    out = {}
    for name, pcls, rcls, reg_cls, kw in (
            ("jax", JaxPredictor, jdrift.OnlineRefresher, JaxRegistry, {}),
            ("port", TaskPredictor, tdrift.OnlineRefresher, ModelRegistry,
             dict(device=CPU))):
        reg = reg_cls(tmp_path / name)
        pred = pcls(algo="R.F.", min_samples=50, **kw)
        ref = rcls(registry=reg, name="cell", retrain_every=600.0,
                   check_every=60.0)
        ref.bind_predictor(pred)
        done = [ref.step(_stub_sim(a, b, now)) for a, b, now in steps]
        ref.monitors["map"].observe(Xs, ys, pred.predict_batch("map", Xs))
        done.append(ref._refresh(_stub_sim(X2, 1 - y2, 1400.0), "test"))
        out[name] = (done, ref.events, ref.refreshes, ref.promotions,
                     ref.rollbacks, [e["event"] for e in reg.history("cell")],
                     reg.head("cell"), pred.predict_batch("map", X2))
    j, t = out["jax"], out["port"]
    assert t[:7] == j[:7]
    assert np.array_equal(t[7], j[7])
    assert t[4] == 1


def _drift_config(fleet_size: int):
    """tests/test_online_drift.py's end-to-end cell, both packages."""
    jcfg = jexp.ExperimentConfig(
        workload=make_spec("baseline", "smoke").workload_for_seed(7),
        min_samples=40, max_train=40, drift=True, drift_check_every=60.0,
        fleet_size=fleet_size)
    tcfg = texp.ExperimentConfig(
        workload=WorkloadConfig(**dataclasses.asdict(jcfg.workload)),
        min_samples=40, max_train=40, drift=True, drift_check_every=60.0,
        fleet_size=fleet_size, device=CPU)
    return jcfg, tcfg


@pytest.mark.parametrize("fleet_size", [0, 100])
def test_drift_aware_atlas_run_matches_reference(fleet_size):
    jcfg, tcfg = _drift_config(fleet_size)
    jm, _, jsim = jexp.run_scheduler("atlas-fifo", jcfg)
    tm, _, tsim = texp.run_scheduler("atlas-fifo", tcfg)
    assert tm == jm
    stats = tm["sched_stats"]
    assert stats["refreshes"] >= 1 and "promotions" in stats \
        and "rollbacks" in stats
    assert tsim.scheduler.refresher.events == jsim.scheduler.refresher.events


def test_drift_off_stats_omit_the_trio():
    _, tcfg = _drift_config(0)
    tm, _, _ = texp.run_scheduler("atlas-fifo",
                                  dataclasses.replace(tcfg, drift=False))
    assert not {"refreshes", "promotions", "rollbacks"} & set(tm["atlas"])


def test_refresh_candidate_fits_on_the_live_predictors_device(monkeypatch):
    """With no GPU, a CPU predictor's refresh must not build its candidate
    with the default (CUDA) device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _drift_config(0)
    tm, _, _ = texp.run_scheduler("atlas-fifo", tcfg)
    assert tm["atlas"]["promotions"] >= 1
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.run_scheduler("atlas-fifo",
                           dataclasses.replace(tcfg, device=None))
