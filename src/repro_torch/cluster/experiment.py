"""Experiment driver reproducing the paper's §5 protocol:

  1. run the base scheduler on a workload with chaos injection, collecting logs
     (the training run — the paper built per-scheduler models from such logs);
  2. fit the failure predictor on those logs;
  3. re-run the *same* workload/chaos seeds under the base scheduler and under
     ATLAS-<base> (pre-trained predictor + 10-min online retraining);
  4. compare metrics (Figures 4-12, Table 4).

The predictor fits and scores on ``ExperimentConfig.device`` (CUDA unless
told otherwise).  Live telemetry (``obs_path`` / ``obs_live_addr``) streams
the same per-tick frames as the JAX package's, on any device: observers read
simulator state only, so results are equal with telemetry on or off.
"""

from __future__ import annotations

import dataclasses

from repro_torch.cluster.chaos import ChaosConfig, ChaosInjector
from repro_torch.cluster.simulator import Simulator, make_fleet
from repro_torch.cluster.telemetry import TelemetryTrace
from repro_torch.cluster.workload import WorkloadConfig, install, make_workload
from repro_torch.core.atlas import ATLASScheduler
from repro_torch.core.predictor import TaskPredictor
from repro_torch.sched.base import BASELINES


@dataclasses.dataclass
class ExperimentConfig:
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    seed: int = 0
    heartbeat_interval: float = 600.0
    algo: str = "R.F."
    threshold: float = 0.5
    n_speculative: int = 2
    retrain_every: float = 600.0
    hazard_noise: float = 0.55
    min_samples: int = 150
    # training-set cap: rows per fit, subsampled from the trace
    max_train: int = 20000
    # drift-aware refresh (repro_torch.online.drift) instead of the fixed clock
    drift: bool = False
    drift_check_every: float = 60.0
    # fleet-size scale axis: 0 = the paper's 13-slave EMR fleet, N = an
    # N-node fleet cycling the same machine mix (simulator.make_fleet)
    fleet_size: int = 0
    # live telemetry (repro_torch.obs): when obs_path is set each run streams
    # per-tick NDJSON frames there and metrics gain a deterministic "obs"
    # roll-up.  Observers only read sim state, so results are byte-identical
    # with telemetry on or off.
    obs_path: str | None = None
    obs_frame_every: float = 60.0
    # live telemetry wire: stream the same frames to a serving AsyncBroker /
    # TelemetryCollector over inproc:// or tcp:// (obs.TransportSink).
    # obs_source names this run on the wire (fleet uses the cell id).  The
    # live path observes, never perturbs: results stay byte-identical.
    obs_live_addr: str | None = None
    obs_source: str | None = None
    # per-tick invariant checking (cluster.invariants): violations are
    # recorded (never raised) and surface in metrics["invariant_violations"];
    # the checker only reads sim state, so decisions are unchanged
    check_invariants: bool = False
    # where the predictor fits and scores: None = CUDA (raises without a
    # GPU), "cpu" for the plain torch path
    device: str | None = None


def _fleet_for(cfg: "ExperimentConfig"):
    return make_fleet(cfg.fleet_size) if cfg.fleet_size else None


def _make_obs(cfg: ExperimentConfig):
    if not cfg.obs_path and not cfg.obs_live_addr:
        return None
    from repro_torch.obs import NDJSONSink, SimObserver, TeeSink, TransportSink
    from repro_torch.obs.sink import telemetry_loop
    sinks = []
    if cfg.obs_path:
        sinks.append(NDJSONSink(cfg.obs_path))
    if cfg.obs_live_addr:
        # tcp sinks share the process loop and batch frames per send:
        # per-run thread churn and per-frame send round-trips would both
        # land inside the telemetry overhead budget.  reconnect=True: a
        # collector crash/restart mid-run must read as a telemetry gap
        # (bounded buffer + backoff re-dial), never as a failed simulation
        loop = (telemetry_loop()
                if cfg.obs_live_addr.startswith("tcp://") else None)
        sinks.append(TransportSink(cfg.obs_live_addr, loop=loop,
                                   source=cfg.obs_source, flush_every=8,
                                   reconnect=True, max_buffer=4096))
    return SimObserver(sink=sinks[0] if len(sinks) == 1 else TeeSink(*sinks),
                       frame_every=cfg.obs_frame_every)


def _new_sim(scheduler, cfg: ExperimentConfig, trace) -> Simulator:
    invariants = None
    if cfg.check_invariants:
        from repro_torch.cluster.invariants import InvariantChecker
        invariants = InvariantChecker()
    sim = Simulator(scheduler, fleet=_fleet_for(cfg), seed=cfg.seed,
                    heartbeat_interval=cfg.heartbeat_interval,
                    chaos=ChaosInjector(cfg.chaos), trace=trace,
                    hazard_noise=cfg.hazard_noise, obs=_make_obs(cfg),
                    invariants=invariants)
    install(sim, make_workload(cfg.workload))
    return sim


def run_baseline(name: str, cfg: ExperimentConfig, *, with_trace=True):
    trace = TelemetryTrace() if with_trace else None
    sim = _new_sim(BASELINES[name](), cfg, trace)
    metrics = sim.run()
    if sim.obs is not None:
        metrics["obs"] = sim.obs.summary()
    return metrics, trace, sim


def run_atlas(name: str, cfg: ExperimentConfig,
              predictor: TaskPredictor | None = None):
    trace = TelemetryTrace()
    refresher = None
    if cfg.drift:
        from repro_torch.online.drift import OnlineRefresher
        refresher = OnlineRefresher(retrain_every=cfg.retrain_every,
                                    check_every=cfg.drift_check_every)
    sched = ATLASScheduler(
        BASELINES[name](),
        predictor=predictor or TaskPredictor(algo=cfg.algo,
                                             min_samples=cfg.min_samples,
                                             max_train=cfg.max_train,
                                             device=cfg.device),
        threshold=cfg.threshold, n_speculative=cfg.n_speculative,
        retrain_every=cfg.retrain_every, refresher=refresher)
    sim = _new_sim(sched, cfg, trace)
    if refresher is not None and sim.obs is not None:
        refresher.obs = sim.obs        # drift/lifecycle markers into frames
    metrics = sim.run()
    metrics["atlas"] = sched.stats().to_dict()
    if sim.obs is not None:
        metrics["obs"] = sim.obs.summary()
    return metrics, trace, sim


def atlas_base_name(name: str) -> str | None:
    """'atlas-fifo' -> 'fifo'; None for a plain baseline name."""
    if name.startswith("atlas-"):
        base = name[len("atlas-"):]
        if base not in BASELINES:
            raise KeyError(f"unknown ATLAS base scheduler {base!r}")
        return base
    if name not in BASELINES:
        raise KeyError(f"unknown scheduler {name!r}")
    return None


def run_scheduler(name: str, cfg: ExperimentConfig,
                  predictor: TaskPredictor | None = None, *, with_trace=True):
    """One simulator run as a *pure function* of (scheduler name, config,
    optional pre-trained predictor) — the unit the fleet sweep fans out.

    For 'atlas-<base>' names a predictor trained on a prior base-scheduler run
    should be passed in; the fleet reuses one training trace per (scenario,
    workload, seed) across every ATLAS variant instead of re-training per cell.
    Returns (metrics, trace, sim); metrics['sched_stats'] carries the
    scheduler's per-run counters uniformly for every policy.
    """
    base = atlas_base_name(name)
    if base is None:
        metrics, trace, sim = run_baseline(name, cfg, with_trace=with_trace)
    else:
        metrics, trace, sim = run_atlas(base, cfg, predictor)
    metrics["sched_stats"] = sim.scheduler.stats().to_dict()
    return metrics, trace, sim


def _finished_times(sim) -> dict:
    """jid -> exec time for finished jobs, read from the telemetry job ledger
    when one was recorded (the ledger rows close at exactly job.done_time, so
    this equals the sim.jobs rescan bit-for-bit) and recomputed otherwise."""
    trace = getattr(sim, "trace", None)
    rows = getattr(trace, "jobs", None)
    if rows:
        return {r["job"]: r["end"] - r["submit"] for r in rows.values()
                if r["outcome"] == "finished"}
    return {j.jid: j.done_time - j.submit_time for j in sim.jobs.values()
            if j.status == "finished"}


def _matched_job_times(sim_a, sim_b):
    """Mean exec time over jobs finished under BOTH runs (same jids) — removes the
    survivor bias of comparing different finished-job populations."""
    fa = _finished_times(sim_a)
    fb = _finished_times(sim_b)
    common = sorted(set(fa) & set(fb))
    if not common:
        return 0.0, 0.0
    return (sum(fa[j] for j in common) / len(common),
            sum(fb[j] for j in common) / len(common))


def _matched_long_job_times(sim_a, sim_b, quantile: float = 0.75):
    """Same, restricted to LONG jobs (top quartile of baseline exec time) — the
    paper reports its biggest win (up to 54%) on 40-50-minute jobs."""
    fa = _finished_times(sim_a)
    fb = _finished_times(sim_b)
    common = sorted(set(fa) & set(fb))
    if len(common) < 4:
        return 0.0, 0.0
    cutoff = sorted(fa[j] for j in common)[int(len(common) * quantile)]
    longs = [j for j in common if fa[j] >= cutoff]
    if not longs:
        return 0.0, 0.0
    return (sum(fa[j] for j in longs) / len(longs),
            sum(fb[j] for j in longs) / len(longs))


def compare(name: str, cfg: ExperimentConfig) -> dict:
    """Full §5 protocol for one base scheduler.  Returns {base, atlas, deltas}."""
    base_cfg, atlas_cfg = cfg, cfg
    if cfg.obs_path:                 # two runs: split the frame streams
        import pathlib
        p = pathlib.Path(cfg.obs_path)
        suffix = p.suffix or ".ndjson"
        base_cfg = dataclasses.replace(
            cfg, obs_path=str(p.with_name(f"{p.stem}__base{suffix}")))
        atlas_cfg = dataclasses.replace(
            cfg, obs_path=str(p.with_name(f"{p.stem}__atlas{suffix}")))
    if cfg.obs_live_addr:            # distinct wire sources per run too
        src = cfg.obs_source or name
        base_cfg = dataclasses.replace(base_cfg, obs_source=f"{src}__base")
        atlas_cfg = dataclasses.replace(atlas_cfg,
                                        obs_source=f"{src}__atlas")
    base_metrics, train_trace, base_sim = run_baseline(name, base_cfg)
    predictor = TaskPredictor(algo=cfg.algo, seed=cfg.seed,
                              min_samples=cfg.min_samples,
                              max_train=cfg.max_train, device=cfg.device)
    predictor.fit(train_trace)
    atlas_metrics, _, atlas_sim = run_atlas(name, atlas_cfg, predictor)
    mt_base, mt_atlas = _matched_job_times(base_sim, atlas_sim)
    base_metrics["job_exec_time_matched"] = mt_base
    atlas_metrics["job_exec_time_matched"] = mt_atlas
    lt_base, lt_atlas = _matched_long_job_times(base_sim, atlas_sim)
    base_metrics["long_job_exec_time"] = lt_base
    atlas_metrics["long_job_exec_time"] = lt_atlas

    def pct_drop(a, b):  # reduction from base a to atlas b
        return 100.0 * (a - b) / a if a else 0.0

    # the paper reports *percentages* of failed jobs/tasks (the workloads differ
    # slightly between runs because finished chains release more successor jobs)
    deltas = {
        "failed_tasks_drop_pct": pct_drop(base_metrics["pct_tasks_failed"],
                                          atlas_metrics["pct_tasks_failed"]),
        "failed_jobs_drop_pct": pct_drop(base_metrics["pct_jobs_failed"],
                                         atlas_metrics["pct_jobs_failed"]),
        "finished_tasks_gain_pct": -pct_drop(
            100.0 * base_metrics["tasks_finished"]
            / max(base_metrics["tasks_total"], 1),
            100.0 * atlas_metrics["tasks_finished"]
            / max(atlas_metrics["tasks_total"], 1)),
        "finished_jobs_gain_pct": -pct_drop(
            100.0 * base_metrics["jobs_finished"]
            / max(base_metrics["jobs_total"], 1),
            100.0 * atlas_metrics["jobs_finished"]
            / max(atlas_metrics["jobs_total"], 1)),
        "job_time_drop_pct": pct_drop(base_metrics["job_exec_time"],
                                      atlas_metrics["job_exec_time"]),
        "job_time_matched_drop_pct": pct_drop(mt_base, mt_atlas),
        "long_job_time_drop_pct": pct_drop(lt_base, lt_atlas),
        "direct_failed_tasks_drop_pct": pct_drop(
            base_metrics["tasks_failed_direct"],
            atlas_metrics["tasks_failed_direct"]),
    }
    return {"base": base_metrics, "atlas": atlas_metrics, "deltas": deltas}
