"""The ported ATLAS decision loop against the JAX package's, on the CPU.

The smoke cell of tests/test_online_broker.py (baseline chaos, the smoke
workload, min_samples=40, max_train=40, seed index 0) runs through both
packages' ``run_scheduler`` and ``compare``.  Every metric of a run depends
on every decision, so ``==`` on the whole metrics dict holds the port's
simulator, scheduler, predictor fitting, online retraining and scoring to
the reference at once."""

import dataclasses
import threading

import numpy as np
import pytest

from repro.cluster import experiment as jexp
from repro.cluster.fleet import CellSpec, SweepSpec, cell_config
from repro.core.predictor import TaskPredictor as JaxPredictor
from repro_torch.cluster import ChaosConfig, WorkloadConfig
from repro_torch.cluster import experiment as texp
from repro_torch.convert import predictor_from_snapshot
from repro_torch.core.predictor import TaskPredictor
from repro_torch.kernels import ops
from repro_torch.online.broker import BrokerPredictor, PredictionBroker

CPU = "cpu"


def _port_config(jcfg) -> texp.ExperimentConfig:
    """The port's ExperimentConfig with the same values as the JAX one,
    telemetry knobs (obs_path, obs_frame_every, obs_live_addr, obs_source)
    included."""
    ported = {f.name for f in dataclasses.fields(texp.ExperimentConfig)}
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name in ported}
    fields["workload"] = WorkloadConfig(**dataclasses.asdict(jcfg.workload))
    fields["chaos"] = ChaosConfig(**dataclasses.asdict(jcfg.chaos))
    return texp.ExperimentConfig(**fields, device=CPU)


@pytest.fixture(scope="module")
def cell():
    spec = SweepSpec(schedulers=("fifo", "atlas-fifo"), seeds=1,
                     scenarios=("baseline",), workloads=("smoke",),
                     min_samples=40, max_train=40)
    jcfg = cell_config(spec, CellSpec("atlas-fifo", "baseline", "smoke", 0))
    tcfg = _port_config(jcfg)
    jm, jtrace, _ = jexp.run_scheduler("fifo", jcfg, with_trace=True)
    tm, ttrace, _ = texp.run_scheduler("fifo", tcfg, with_trace=True)
    return jcfg, tcfg, (jm, jtrace.datasets()), (tm, ttrace.datasets())


def _kw(cfg):
    return dict(algo=cfg.algo, seed=cfg.seed, min_samples=cfg.min_samples,
                max_train=cfg.max_train)


def test_baseline_run_and_trace_match(cell):
    _, _, (jm, jdata), (tm, tdata) = cell
    assert tm == jm
    for (jX, jy), (tX, ty) in zip(jdata, tdata):
        assert np.array_equal(jX, tX) and np.array_equal(jy, ty)


def test_atlas_with_carried_parameters_matches(cell):
    """(a) The JAX predictor's trained parameters, carried across by
    predictor_from_snapshot, drive both runs (online refits included)."""
    jcfg, tcfg, (_, jdata), _ = cell
    jpred = JaxPredictor(**_kw(jcfg))
    jpred.fit_datasets(*jdata)
    tpred = predictor_from_snapshot(jpred.snapshot(), device=CPU)
    assert tpred.fits == jpred.fits == 1
    tm, _, _ = texp.run_scheduler("atlas-fifo", tcfg, tpred)
    jm, _, _ = jexp.run_scheduler("atlas-fifo", jcfg, jpred)
    assert tm == jm
    assert tm["atlas"]["model_fits"] > 1          # online retraining ran


def test_atlas_with_independent_fits_matches(cell):
    """(b) Each package fits its own predictor from the same trace."""
    jcfg, tcfg, (_, jdata), (_, tdata) = cell
    jpred = JaxPredictor(**_kw(jcfg))
    jpred.fit_datasets(*jdata)
    tpred = TaskPredictor(**_kw(tcfg), device=CPU)
    tpred.fit_datasets(*tdata)
    jm, _, _ = jexp.run_scheduler("atlas-fifo", jcfg, jpred)
    tm, _, _ = texp.run_scheduler("atlas-fifo", tcfg, tpred)
    assert tm == jm


def test_broker_predictor_matches_task_predictor(cell):
    """(c) Tick-primed batched flushes decide exactly like per-decision
    scoring, and count no kernel launches on the CPU."""
    _, tcfg, _, (_, tdata) = cell
    scalar = TaskPredictor(**_kw(tcfg), device=CPU)
    scalar.fit_datasets(*tdata)
    ops.reset_launch_counts()
    m_scalar, _, _ = texp.run_scheduler("atlas-fifo", tcfg, scalar)
    brokered = BrokerPredictor(**_kw(tcfg), device=CPU)
    brokered.fit_datasets(*tdata)
    m_broker, _, _ = texp.run_scheduler("atlas-fifo", tcfg, brokered)
    assert m_scalar == m_broker
    assert brokered.n_demand_calls == scalar.n_dispatches
    assert brokered.n_dispatches < scalar.n_dispatches
    assert brokered.n_memo_hits > 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_shared_broker_clients_match_task_predictor(cell):
    """(c') Two ATLAS runs behind one shared PredictionBroker, each on its
    own thread: barrier rounds fuse their flushes, and each run decides
    exactly like per-decision scoring."""
    _, tcfg, _, (_, tdata) = cell
    scalar = TaskPredictor(**_kw(tcfg), device=CPU)
    scalar.fit_datasets(*tdata)
    want, _, _ = texp.run_scheduler("atlas-fifo", tcfg, scalar)
    shared = PredictionBroker(device=CPU)
    n_clients = 2
    shared.add_clients(n_clients)
    got = [None] * n_clients

    def client(i):
        try:
            pred = BrokerPredictor(broker=shared, **_kw(tcfg), device=CPU)
            pred.fit_datasets(*tdata)
            got[i], _, _ = texp.run_scheduler("atlas-fifo", tcfg, pred)
        finally:
            shared.done()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "shared broker deadlocked"
    assert got == [want] * n_clients
    assert shared.n_requests > shared.n_flushes > 0


def test_compare_deltas_match(cell):
    """(d) The full §5 protocol: base run, fit, ATLAS run, deltas."""
    jcfg, tcfg, _, _ = cell
    want = jexp.compare("fifo", jcfg)
    got = texp.compare("fifo", tcfg)
    assert got["deltas"] == want["deltas"]
    assert got["base"] == want["base"] and got["atlas"] == want["atlas"]
