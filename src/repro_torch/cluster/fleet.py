"""Fleet sweep engine: declarative (schedulers x seeds x scenarios x workloads)
run matrices, executed in parallel with per-run isolation and reduced into the
paper's Figures 4-12 aggregates.

The paper's §5 evaluation is a cross-scheduler, cross-failure-regime comparison;
``repro_torch.cluster.experiment`` runs exactly one (scheduler, seed, chaos)
triple.  This module is the scale layer on top of it:

  SweepSpec ──expand──> [CellSpec...] ──fan-out──> per-cell metrics ──reduce──>
      aggregates (mean / 95% CI of failed-job %, failed-task %, exec times)
      + SWEEP.json (machine-readable) + SWEEP.md (ranking tables)

Design points:

* **Pure cells.**  Every cell is a pure function of its ``CellSpec`` via
  ``experiment.run_scheduler``; cell seeds derive from a stable CRC32 of the
  (scenario, workload, seed-index) coordinates, so the same spec always expands
  to the same runs and the same ``SWEEP.json`` bytes — regardless of executor
  kind, worker count, completion order or device.
* **Scheduler-matched conditions.**  Workload/chaos/hazard seeds deliberately
  exclude the scheduler name: every scheduler in a sweep faces the identical
  failure storm, as in the paper's protocol.
* **Train-trace reuse.**  ATLAS cells need a predictor trained on a base-
  scheduler trace.  The fleet runs one training wave per (base, scenario,
  workload, seed) — reusing requested base cells as training runs when the base
  matches — and ships the trace *datasets* (plain arrays) to the ATLAS wave,
  instead of re-running the training simulation once per ATLAS cell.
* **Process isolation.**  Cells run in a spawn-context process pool (a fresh
  torch runtime and CUDA context per worker); ``thread`` and ``serial``
  executors exist for tests and debugging.
* **Online serving.**  ``--executor broker`` runs every ATLAS cell as a client
  of one ``repro_torch.online`` PredictionBroker: all p_success traffic is
  flushed in deterministic lock-step rounds as single fused passes of the
  grouped forest kernel — identical SWEEP cells, far fewer predictor
  dispatches (reported under ``perf.broker``).  ``--registry DIR`` publishes
  each training wave's models to a versioned ``ModelRegistry`` and ships
  *version ids* to the ATLAS wave instead of raw trace arrays.
* **Async serving.**  ``--executor async`` serves the ATLAS wave through one
  ``repro_torch.online.server.AsyncBroker`` over the transport layer
  (policy="barrier"), reproducing the broker executor's SWEEP.json byte for
  byte, ``perf.broker`` included.  ``--faults FILE`` injects a seeded
  ``FaultPlan`` into that serving path (drops, delays, duplicates, abrupt
  closes, listener restarts); clients retry, the broker replays, and the
  SWEEP bytes still match a fault-free run.  The retry/replay/fallback
  counters land in ``<out>/FAULTS.json``.
* **Device.**  Every cell's predictor fits and scores on ``device`` (CUDA
  unless told otherwise; ``--device cpu`` on the CPU).  The device is not a
  ``SweepSpec`` field: the spec is written into ``SWEEP.json``, whose bytes
  do not depend on it.
* **Live telemetry.**  ``--obs`` streams per-cell NDJSON frame files
  (``repro_torch.obs``) under ``<out>/obs/`` and stamps each cell's
  deterministic telemetry roll-up into ``SWEEP.json`` under ``perf.obs``
  (with the broker and async executors, the serving broker's flush
  roll-up too, and its per-flush frames in ``<out>/obs/broker.ndjson``).
  ``--obs-live ADDR`` streams every cell's frames to a live
  ``TelemetryCollector`` (``python -m repro_torch.obs.live``).  Simulation
  results stay byte-identical with telemetry on or off: observers only read
  sim state and the roll-ups carry no wall-clock.

CLI:

  python -m repro_torch.cluster.fleet \
      --schedulers fifo,atlas-fifo --seeds 4 \
      --scenarios baseline,bursty_tt,dn_loss [--workloads default] \
      [--executor process|thread|serial|broker|async] [--workers N] \
      [--hazard cluster|per-node] [--registry DIR] [--faults PLAN.json] \
      [--obs] [--obs-live ADDR] [--device cpu] [--out experiments]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import pathlib
import sys
import time
import zlib

from repro_torch.cluster.experiment import (ExperimentConfig, atlas_base_name,
                                            run_scheduler)
from repro_torch.cluster.scenarios import SCENARIOS, WORKLOAD_SHAPES, make_spec
from repro_torch.core.predictor import TaskPredictor
from repro_torch.kernels.ops import resolve_device

# metrics reported in the ranking tables (subset of Simulator.metrics keys)
TABLE_METRICS = ("pct_tasks_failed", "pct_jobs_failed", "job_exec_time",
                 "sim_time")
EXECUTORS = ("process", "thread", "serial", "broker", "async")


# ---------------------------------------------------------------------------
# Spec + matrix expansion
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One run of the matrix: a scheduler at a (scenario, workload,
    fleet-size, seed).  ``fleet_size`` 0 is the paper's 13-slave fleet and is
    omitted from ids/keys, as the JAX package's sweeps do."""
    scheduler: str
    scenario: str
    workload: str
    seed_index: int
    fleet_size: int = 0

    @property
    def env_key(self) -> tuple:
        """Scheduler-independent coordinates: every scheduler sees the same
        workload + failure storm at a given env_key (paper §5 protocol)."""
        if self.fleet_size:
            return (self.scenario, self.workload, f"n{self.fleet_size}",
                    self.seed_index)
        return (self.scenario, self.workload, self.seed_index)

    @property
    def env_label(self) -> str:
        env = f"{self.scenario}/{self.workload}"
        if self.fleet_size:
            env += f"/n{self.fleet_size}"
        return env

    @property
    def cell_id(self) -> str:
        return f"{self.env_label}/{self.scheduler}/s{self.seed_index}"


@dataclasses.dataclass
class SweepSpec:
    """Declarative sweep: the cross product of four axes plus shared knobs."""
    schedulers: tuple = ("fifo", "atlas-fifo")
    seeds: int | tuple = 3            # count (0..n-1) or explicit indices
    scenarios: tuple = ("baseline",)
    workloads: tuple = ("default",)
    fleet_sizes: tuple = (0,)         # 0 = paper fleet; N = make_fleet(N)
    hazard: str = "cluster"           # chaos scaling: cluster | per-node
    algo: str = "R.F."
    threshold: float = 0.5
    n_speculative: int = 2
    heartbeat_interval: float = 600.0
    min_samples: int = 150
    max_train: int = 20000
    check_invariants: bool = False    # per-tick invariant checker in every cell

    def seed_indices(self) -> tuple:
        if isinstance(self.seeds, int):
            return tuple(range(self.seeds))
        return tuple(self.seeds)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["seeds"] = list(self.seed_indices())
        for k in ("schedulers", "scenarios", "workloads", "fleet_sizes"):
            d[k] = list(d[k])
        if not d["check_invariants"]:
            # the JAX package's spec bytes when the checker is off
            d.pop("check_invariants")
        return d


def cell_seed(*parts) -> int:
    """Stable, platform-independent seed from cell coordinates (CRC32, not
    Python's salted hash) — same spec => same seeds => same SWEEP.json."""
    return zlib.crc32("|".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def expand(spec: SweepSpec) -> list[CellSpec]:
    """Expand the spec into its deduplicated, deterministically ordered matrix."""
    for s in spec.scenarios:
        if s not in SCENARIOS:
            raise KeyError(f"unknown scenario {s!r}; known: "
                           f"{', '.join(sorted(SCENARIOS))}")
    for w in spec.workloads:
        if w not in WORKLOAD_SHAPES:
            raise KeyError(f"unknown workload shape {w!r}; known: "
                           f"{', '.join(sorted(WORKLOAD_SHAPES))}")
    for name in spec.schedulers:
        atlas_base_name(name)  # raises on unknown scheduler
    from repro_torch.ml.models import ALL_MODELS
    if spec.algo not in ALL_MODELS:
        raise KeyError(f"unknown predictor algo {spec.algo!r}; known: "
                       f"{', '.join(sorted(ALL_MODELS))}")
    for fs in spec.fleet_sizes:
        if fs < 0:
            raise KeyError(f"negative fleet size {fs}")
    if spec.hazard not in ("cluster", "per-node"):
        raise KeyError(f"unknown hazard mode {spec.hazard!r} "
                       "(cluster|per-node)")
    cells = {
        CellSpec(scheduler=sched, scenario=sc, workload=wl, seed_index=si,
                 fleet_size=fs)
        for sc in spec.scenarios for wl in spec.workloads
        for fs in spec.fleet_sizes
        for sched in spec.schedulers for si in spec.seed_indices()
    }
    return sorted(cells, key=lambda c: (c.scenario, c.workload, c.fleet_size,
                                        c.scheduler, c.seed_index))


def cell_config(spec: SweepSpec, cell: CellSpec) -> ExperimentConfig:
    env = cell.env_key
    # scenario/workload *names* resolve here, in the parent process, so
    # temporarily registered search points (scenario_scope) work with the
    # spawn process pool — workers receive fully resolved configs
    point = make_spec(cell.scenario, cell.workload)
    # hazard mode rides on the chaos config; "cluster" (the default) leaves
    # the scenario's bytes untouched, "per-node" scales event rates with
    # fleet size so failure rates compare across --fleet-size
    chaos = point.chaos_for_seed(cell_seed("chaos", *env))
    if spec.hazard != "cluster":
        chaos = dataclasses.replace(chaos, hazard=spec.hazard)
    return ExperimentConfig(
        workload=point.workload_for_seed(cell_seed("workload", *env)),
        chaos=chaos,
        seed=cell_seed("sim", *env),
        heartbeat_interval=spec.heartbeat_interval,
        algo=spec.algo, threshold=spec.threshold,
        n_speculative=spec.n_speculative, min_samples=spec.min_samples,
        max_train=spec.max_train, fleet_size=cell.fleet_size,
        check_invariants=spec.check_invariants)


# ---------------------------------------------------------------------------
# Cell execution (top-level functions: picklable into spawn workers)
# ---------------------------------------------------------------------------

def _numeric_metrics(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float))}


def _train_model_name(cell: CellSpec) -> str:
    """Registry entry for a training run: one model per (base, env)."""
    return (f"{cell.scheduler}/{cell.scenario}/{cell.workload}"
            f"/s{cell.seed_index}")


def _predictor_kw(cfg: ExperimentConfig) -> dict:
    return dict(algo=cfg.algo, seed=cfg.seed, min_samples=cfg.min_samples,
                max_train=cfg.max_train, device=cfg.device)


def _run_base_cell(args):
    """Wave 1: a base-scheduler cell.  When some ATLAS cell needs this
    (base, env) as a training run, the trained state ships either as raw trace
    datasets or — with a registry — as a published model *version*."""
    cell, cfg, want_trace, registry_dir = args
    metrics, trace, _ = run_scheduler(cell.scheduler, cfg,
                                      with_trace=want_trace)
    payload = None
    if want_trace:
        datasets = trace.datasets()
        if registry_dir is not None:
            from repro_torch.online.registry import ModelRegistry
            predictor = TaskPredictor(**_predictor_kw(cfg))
            predictor.fit_datasets(*datasets)
            name = _train_model_name(cell)
            version = ModelRegistry(registry_dir).publish(
                name, predictor.snapshot(),
                meta={"cell": cell.cell_id, "role": "train"})
            payload = ("registry", name, version)
        else:
            payload = ("datasets", datasets)
    return (cell, _numeric_metrics(metrics), metrics["sched_stats"], payload,
            metrics.get("obs"))


def _load_predictor(predictor: TaskPredictor, payload, registry_dir):
    """Initialise a wave-2 predictor from its shipped training payload."""
    if payload is None:
        return predictor
    kind = payload[0]
    if kind == "datasets":
        predictor.fit_datasets(*payload[1])
    elif kind == "registry":
        from repro_torch.online.registry import ModelRegistry
        _, name, version = payload
        predictor.load_snapshot(
            ModelRegistry(registry_dir).load(name, version))
    else:
        raise ValueError(f"unknown training payload {kind!r}")
    return predictor


def _run_atlas_cell(args):
    """Wave 2: an ATLAS cell; the predictor comes pre-trained from the shipped
    payload (one simulated training run shared across the matrix)."""
    cell, cfg, payload, registry_dir = args
    predictor = _load_predictor(TaskPredictor(**_predictor_kw(cfg)),
                                payload, registry_dir)
    metrics, _, _ = run_scheduler(cell.scheduler, cfg, predictor)
    return (cell, _numeric_metrics(metrics), metrics["sched_stats"],
            metrics.get("obs"))


def _broker_observer(obs_dir):
    """The serving broker's flush observer, streaming its per-flush frames
    to ``<obs_dir>/broker.ndjson``; None when telemetry is off."""
    if obs_dir is None:
        return None
    from repro_torch.obs import BrokerObserver, NDJSONSink
    return BrokerObserver(
        sink=NDJSONSink(pathlib.Path(obs_dir) / "broker.ndjson"))


def _run_atlas_wave_brokered(wave2, registry_dir, device, obs_dir=None):
    """Run every ATLAS cell concurrently as a client of one shared
    PredictionBroker on ``device``.  Clients are registered before any thread
    starts so the lock-step rounds (and hence dispatch counts) are a pure
    function of the decision streams, not of thread scheduling.  With
    ``obs_dir`` a ``BrokerObserver`` records every flush.  Returns (records,
    perf)."""
    from repro_torch.online.broker import BrokerPredictor, PredictionBroker

    broker = PredictionBroker(device=device)
    broker.obs = broker_obs = _broker_observer(obs_dir)
    broker.add_clients(len(wave2))
    predictors = []

    def run_one(args):
        cell, cfg, payload = args
        try:  # broker.done() exactly once, or the barrier waits forever
            predictor = _load_predictor(
                BrokerPredictor(broker=broker, **_predictor_kw(cfg)),
                payload, registry_dir)
            predictors.append(predictor)
            metrics, _, _ = run_scheduler(cell.scheduler, cfg, predictor)
        finally:
            broker.done()
        return (cell, _numeric_metrics(metrics), metrics["sched_stats"],
                metrics.get("obs"))

    # every cell MUST get a thread: all clients are registered up front, and a
    # round only flushes once every registered client has queued — capping
    # max_workers below len(wave2) would leave unstarted cells registered but
    # silent, deadlocking the running ones inside broker.submit
    try:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(len(wave2), 1)) as pool:
            out = list(pool.map(run_one, wave2))
    finally:
        if broker_obs is not None:
            broker_obs.close()
    demand_calls = sum(p.n_demand_calls for p in predictors)
    demand_rows = sum(p.n_demand_rows for p in predictors)
    perf = {"broker": {
        **broker.stats(),
        "demand_calls": demand_calls,
        "demand_rows": demand_rows,
        "dispatch_reduction": round(
            demand_calls / max(broker.n_dispatches, 1), 2),
    }}
    if broker_obs is not None:
        perf["broker_obs"] = broker_obs.summary(deterministic_only=True)
    return out, perf


def _run_atlas_wave_async(wave2, registry_dir, device, obs_dir=None,
                          fault_plan=None, fault_stats=None):
    """Run every ATLAS cell as a *transport client* of one serving
    ``AsyncBroker`` (policy="barrier") on ``device``: the same lock-step
    rounds as ``--executor broker``, driven by an event loop over
    ``repro_torch.online.transport`` comms instead of a condition variable.
    Rounds are a pure function of each client's request sequence, so the
    SWEEP.json bytes — including ``perf.broker`` — match the threaded
    broker executor exactly.

    ``fault_plan`` (``repro_torch.online.faults.FaultPlan``) injects the
    plan's seeded fault schedule into the serving path (reply drops/delays/
    duplicates, abrupt closes, listener restarts); clients then run with the
    plan's retry budget and the broker's request replay keeps retried
    flushes idempotent — the SWEEP bytes still match a fault-free run.
    ``fault_stats`` (a caller-owned dict) receives the retry/replay/fallback
    counters and the longest request wait; they are reported there and
    *only* there so the deterministic ``perf.broker`` block stays
    byte-identical under chaos.  With ``obs_dir`` a ``BrokerObserver``
    records every flush.  Returns (records, perf)."""
    from repro_torch.online.broker import BrokerPredictor
    from repro_torch.online.server import AsyncBroker, BrokerClient

    server = AsyncBroker(policy="barrier", device=device)
    server.obs = broker_obs = _broker_observer(obs_dir)
    predictors = []
    clients = []
    client_kw = {}
    if fault_plan is not None:
        client_kw = dict(request_timeout_s=fault_plan.request_timeout_s,
                         deadline_s=fault_plan.deadline_s,
                         retry_seed=fault_plan.seed,
                         # backoff scaled to the timeout: retry pacing should
                         # track how fast this client detects a lost reply,
                         # not a wall-clock constant sized for remote links
                         backoff_base_s=fault_plan.request_timeout_s / 4,
                         backoff_cap_s=fault_plan.request_timeout_s * 4)

    def run_one(args):
        cell, cfg, payload = args
        client = BrokerClient(address, server.loop, **client_kw)
        clients.append(client)
        try:  # client.done() exactly once, or the round waits forever
            predictor = _load_predictor(
                BrokerPredictor(broker=client, **_predictor_kw(cfg)),
                payload, registry_dir)
            predictors.append(predictor)
            metrics, _, _ = run_scheduler(cell.scheduler, cfg, predictor)
        finally:
            client.done()
            client.close()
        return (cell, _numeric_metrics(metrics), metrics["sched_stats"],
                metrics.get("obs"))

    try:
        server.start()
        address = server.serve(fault_plan=fault_plan)
        server.add_clients(len(wave2))
        # same rule as the threaded broker wave: every registered client
        # needs a live thread or the barrier round can never complete
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(len(wave2), 1)) as pool:
            out = list(pool.map(run_one, wave2))
        demand_calls = sum(p.n_demand_calls for p in predictors)
        demand_rows = sum(p.n_demand_rows for p in predictors)
        perf = {"broker": {
            **server.stats(),
            "demand_calls": demand_calls,
            "demand_rows": demand_rows,
            "dispatch_reduction": round(
                demand_calls / max(server.n_dispatches, 1), 2),
        }}
        if fault_stats is not None:
            fault_stats.update(server.fault_stats())
            fault_stats["client_retries"] = sum(
                c.n_retries for c in clients)
            fault_stats["client_reconnects"] = sum(
                c.n_reconnects for c in clients)
            fault_stats["fallbacks"] = sum(
                p.n_fallbacks for p in predictors)
            fault_stats["fallback_rows"] = sum(
                p.n_fallback_rows for p in predictors)
            fault_stats["max_request_wait_s"] = max(
                (c.max_wait_s for c in clients), default=0.0)
    finally:
        server.stop()
        if broker_obs is not None:
            broker_obs.close()
    if broker_obs is not None:
        perf["broker_obs"] = broker_obs.summary(deterministic_only=True)
    return out, perf


class _SerialExecutor:
    def map(self, fn, it):
        return list(map(fn, it))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _make_executor(kind: str, workers: int | None):
    if kind in ("serial", "broker", "async"):
        # "broker"/"async" batch only the ATLAS wave (threads sharing one
        # broker); wave 1 runs serially in-process so payloads stay local
        return _SerialExecutor()
    if kind == "thread":
        return concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    if kind == "process":
        # spawn, not fork: a forked child of a process that holds a CUDA
        # context cannot use the card; each spawned worker makes its own
        ctx = multiprocessing.get_context("spawn")
        return concurrent.futures.ProcessPoolExecutor(
            max_workers=workers or os.cpu_count(), mp_context=ctx)
    raise ValueError(f"unknown executor {kind!r} ({'|'.join(EXECUTORS)})")


# ---------------------------------------------------------------------------
# Resumable sweeps: atomic per-cell ledger
# ---------------------------------------------------------------------------

class _CellLedger:
    """Atomic per-cell result ledger — the resumable-sweep substrate.

    Every finished cell lands as one JSON file written tmp-then-
    ``os.replace``, so a SIGKILL anywhere leaves either a complete record or
    none.  Training payloads ride along (registry versions inline, raw trace
    datasets as an ``.npz`` sidecar written *before* its record, so a record
    always implies a readable payload), and so does each cell's telemetry
    roll-up.  ``MANIFEST.json`` carries a fingerprint over (spec, executor,
    registry, obs): a restart with the same
    coordinates skips finished cells and reassembles byte-identical
    ``SWEEP.json``; any mismatch wipes the ledger rather than mixing cells
    from different sweeps.  The device is not in the fingerprint: cells are
    equal on every device.

    The broker/async ATLAS wave is reused all-or-nothing: its ``perf.broker``
    counters are a function of the *entire* barrier-round schedule, so
    partial reuse would stitch together a schedule no real run produces.
    That wave only resumes when every cell record plus the wave perf record
    (``w2__PERF.json``) survived; otherwise the whole wave reruns — which
    regenerates the exact same bytes anyway."""

    def __init__(self, dir, spec: SweepSpec, executor: str,
                 registry: str | None, obs: bool):
        self.dir = pathlib.Path(dir)
        self.fingerprint = cell_seed(
            "ledger", json.dumps(spec.to_json(), sort_keys=True), executor,
            registry or "", int(obs))
        self.dir.mkdir(parents=True, exist_ok=True)
        manifest = self.dir / "MANIFEST.json"
        keep = False
        try:
            keep = (json.loads(manifest.read_text())
                    .get("fingerprint") == self.fingerprint)
        except (OSError, ValueError):
            keep = False
        if not keep:
            for pat in ("*.json", "*.npz", "*.tmp"):
                for p in self.dir.glob(pat):
                    p.unlink()
            self._write(manifest, {"fingerprint": self.fingerprint})

    def _write(self, path: pathlib.Path, obj: dict):
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(obj, sort_keys=True))
        os.replace(tmp, path)

    def _path(self, wave: int, cell: CellSpec) -> pathlib.Path:
        return self.dir / (f"w{wave}__"
                           + cell.cell_id.replace("/", "__") + ".json")

    def load(self, wave: int, cell: CellSpec) -> dict | None:
        try:
            return json.loads(self._path(wave, cell).read_text())
        except (OSError, ValueError):
            return None

    def store_wave1(self, cell, metrics, stats, payload, obs):
        rec = {"metrics": metrics, "stats": stats, "obs": obs,
               "payload": None}
        if payload is not None:
            if payload[0] == "registry":
                rec["payload"] = list(payload)
            else:
                import numpy as np
                (mx, my), (rx, ry) = payload[1]
                npz = self._path(1, cell).with_suffix(".npz")
                tmp = npz.with_name(npz.name + ".tmp")
                with open(tmp, "wb") as f:
                    np.savez(f, map_X=mx, map_y=my, red_X=rx, red_y=ry)
                os.replace(tmp, npz)
                rec["payload"] = ["datasets", npz.name]
        self._write(self._path(1, cell), rec)

    def payload_from(self, rec: dict):
        pl = rec.get("payload")
        if pl is None:
            return None
        if pl[0] == "registry":
            return (pl[0], pl[1], pl[2])
        import numpy as np
        with np.load(self.dir / pl[1]) as z:
            # .copy() detaches the arrays from the npz file handle
            return ("datasets", ((z["map_X"].copy(), z["map_y"].copy()),
                                 (z["red_X"].copy(), z["red_y"].copy())))

    def store_wave2(self, cell, metrics, stats, obs):
        self._write(self._path(2, cell),
                    {"metrics": metrics, "stats": stats, "obs": obs})

    def store_wave2_perf(self, perf: dict):
        self._write(self.dir / "w2__PERF.json", perf)

    def load_wave2_batch(self, cells):
        """All-or-nothing reuse of the broker/async wave: (records, perf)
        when every cell and the wave perf record are present, else None."""
        try:
            perf = json.loads((self.dir / "w2__PERF.json").read_text())
        except (OSError, ValueError):
            return None
        out = []
        for cell in cells:
            rec = self.load(2, cell)
            if rec is None:
                return None
            out.append((cell, rec["metrics"], rec["stats"], rec["obs"]))
        return out, perf


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------

def _obs_path(obs_dir, cell: CellSpec) -> str:
    """Frame-stream path for one cell: cell_id with '/' flattened to '__'."""
    return str(pathlib.Path(obs_dir)
               / (cell.cell_id.replace("/", "__") + ".ndjson"))


def run_sweep(spec: SweepSpec, *, executor: str = "process",
              workers: int | None = None, registry: str | None = None,
              obs_dir: str | None = None, obs_live: str | None = None,
              resume_dir: str | None = None, fault_plan=None,
              fault_stats: dict | None = None, device=None,
              log=print) -> dict:
    """Execute the full matrix; returns the SWEEP result dict (see sweep_json).

    Two waves: (1) all base-scheduler cells plus any training-only runs ATLAS
    cells require, (2) all ATLAS cells with pre-trained predictors.  Cells
    within a wave run in parallel; results are keyed by cell id so completion
    order never affects the output.

    ``executor="broker"`` serves wave 2 through one shared PredictionBroker
    (identical cells, far fewer predictor dispatches — see ``perf.broker``).
    ``registry=DIR`` ships model *versions* through a ModelRegistry instead of
    raw trace arrays (forest-family algos).  ``obs_dir=DIR`` streams per-cell
    telemetry frames there and stamps per-cell roll-ups under ``perf.obs`` —
    cells/aggregates/rankings stay byte-identical either way.
    ``obs_live=ADDR`` additionally streams every cell's frames to a live
    TelemetryCollector over the serving transport (source = cell id); use a
    ``tcp://`` address with the process/spawn executors — ``inproc://``
    channels don't cross process boundaries.  The live path only observes:
    SWEEP output bytes are identical with it on or off.

    ``resume_dir=DIR`` keeps an atomic per-cell ledger there
    (:class:`_CellLedger`): a sweep killed mid-run and restarted with the
    same coordinates skips finished cells and reassembles the identical
    ``SWEEP.json`` bytes.  ``device`` is where every predictor fits and
    scores (None: CUDA, raising without a GPU).

    ``executor="async"`` serves wave 2 through one ``AsyncBroker`` over the
    transport (the broker executor's bytes, ``perf.broker`` included).
    ``fault_plan`` (async executor only) injects a seeded fault schedule
    into that serving path; ``fault_stats`` (a caller-owned dict) receives
    the retry/replay/fallback counters, kept out of the returned result so
    SWEEP bytes match a fault-free run."""
    if fault_plan is not None and executor != "async":
        raise ValueError("fault_plan requires executor='async' "
                         "(the transport-served ATLAS wave)")
    device = str(resolve_device(device))
    t0 = time.perf_counter()
    cells = expand(spec)
    base_cells = [c for c in cells if atlas_base_name(c.scheduler) is None]
    atlas_cells = [c for c in cells if atlas_base_name(c.scheduler) is not None]

    def _cfg(cell: CellSpec) -> ExperimentConfig:
        cfg = dataclasses.replace(cell_config(spec, cell), device=device)
        if obs_dir is not None:
            cfg = dataclasses.replace(cfg, obs_path=_obs_path(obs_dir, cell))
        if obs_live is not None:
            cfg = dataclasses.replace(cfg, obs_live_addr=obs_live,
                                      obs_source=cell.cell_id)
        return cfg

    # training runs needed: one per (base, env) over the ATLAS cells
    needed_cells: dict[tuple, CellSpec] = {}
    for c in atlas_cells:
        base = atlas_base_name(c.scheduler)
        needed_cells.setdefault(
            (base,) + c.env_key, dataclasses.replace(c, scheduler=base))
    needed_train = set(needed_cells)
    covered = {(c.scheduler,) + c.env_key for c in base_cells}
    # env_key tuples vary in length across fleet sizes: sort on stringified
    # coordinates so the wave order stays total and deterministic
    train_only = sorted(needed_train - covered,
                        key=lambda k: tuple(str(p) for p in k))
    train_cells = [needed_cells[k] for k in train_only]

    wave1 = [(c, _cfg(c), (c.scheduler,) + c.env_key
              in needed_train, registry) for c in base_cells]
    wave1 += [(c, _cfg(c), True, registry) for c in train_cells]

    log(f"[fleet] {len(cells)} cells "
        f"({len(base_cells)} base + {len(atlas_cells)} atlas), "
        f"{len(train_cells)} extra training runs, executor={executor}, "
        f"device={device}"
        + (f", registry={registry}" if registry else "")
        + (f", obs={obs_dir}" if obs_dir else "")
        + (f", obs_live={obs_live}" if obs_live else ""))

    ledger = None
    if resume_dir is not None:
        ledger = _CellLedger(resume_dir, spec, executor, registry,
                             obs_dir is not None)

    results: dict[str, dict] = {}
    train_data: dict[tuple, object] = {}
    perf: dict = {}
    obs_cells: dict[str, dict] = {}

    def _fold1(cell, metrics, stats, payload, obs):
        if payload is not None:
            train_data[(cell.scheduler,) + cell.env_key] = payload
        results[cell.cell_id] = _cell_record(cell, metrics, stats)
        if obs is not None:
            obs_cells[cell.cell_id] = obs

    def _fold2(cell, metrics, stats, obs):
        results[cell.cell_id] = _cell_record(cell, metrics, stats)
        if obs is not None:
            obs_cells[cell.cell_id] = obs

    wave1_todo, n1_resumed = [], 0
    for args in wave1:
        rec = ledger.load(1, args[0]) if ledger is not None else None
        if rec is None:
            wave1_todo.append(args)
        else:
            _fold1(args[0], rec["metrics"], rec["stats"],
                   ledger.payload_from(rec), rec["obs"])
            n1_resumed += 1

    n2_resumed = 0
    with _make_executor(executor, workers) as pool:
        for cell, metrics, stats, payload, obs in pool.map(_run_base_cell,
                                                           wave1_todo):
            if ledger is not None:
                ledger.store_wave1(cell, metrics, stats, payload, obs)
            _fold1(cell, metrics, stats, payload, obs)
        log(f"[fleet] wave 1 done: {len(wave1)} runs"
            + (f" ({n1_resumed} resumed)" if n1_resumed else "")
            + f", {len(train_data)} training payloads "
              f"({time.perf_counter() - t0:.1f}s)")

        wave2 = [(c, _cfg(c),
                  train_data.get((atlas_base_name(c.scheduler),) + c.env_key))
                 for c in atlas_cells]
        if executor in ("broker", "async"):
            cached = (ledger.load_wave2_batch([w[0] for w in wave2])
                      if ledger is not None else None)
            if cached is not None:
                wave2_out, perf = cached
                n2_resumed = len(wave2_out)
            elif executor == "broker":
                wave2_out, perf = _run_atlas_wave_brokered(
                    wave2, registry, device, obs_dir)
            else:
                wave2_out, perf = _run_atlas_wave_async(
                    wave2, registry, device, obs_dir, fault_plan=fault_plan,
                    fault_stats=fault_stats)
            if ledger is not None and not n2_resumed:
                for cell, metrics, stats, obs in wave2_out:
                    ledger.store_wave2(cell, metrics, stats, obs)
                ledger.store_wave2_perf(perf)
            for cell, metrics, stats, obs in wave2_out:
                _fold2(cell, metrics, stats, obs)
        else:
            wave2_todo = []
            for w in wave2:
                rec = ledger.load(2, w[0]) if ledger is not None else None
                if rec is None:
                    wave2_todo.append(w)
                else:
                    _fold2(w[0], rec["metrics"], rec["stats"], rec["obs"])
                    n2_resumed += 1
            for cell, metrics, stats, obs in pool.map(
                    _run_atlas_cell, [w + (registry,) for w in wave2_todo]):
                if ledger is not None:
                    ledger.store_wave2(cell, metrics, stats, obs)
                _fold2(cell, metrics, stats, obs)
    log(f"[fleet] wave 2 done: {len(atlas_cells)} atlas runs"
        + (f" ({n2_resumed} resumed)" if n2_resumed else "")
        + f" ({time.perf_counter() - t0:.1f}s total)")
    if perf.get("broker"):
        b = perf["broker"]
        log(f"[fleet] broker: {b['demand_calls']} demand calls -> "
            f"{b['dispatches']} dispatches "
            f"({b['dispatch_reduction']}x reduction, "
            f"{b['flushes']} flushes, max batch {b['max_flush_rows']} rows)")

    # keep only requested cells (training-only runs served their purpose)
    wanted = {c.cell_id for c in cells}
    records = [results[cid] for cid in sorted(wanted)]
    aggregates = aggregate(records)
    # telemetry roll-ups live ONLY under perf.obs: strip perf.obs (and an
    # emptied perf) from SWEEP.json and the bytes match an obs-off run
    if obs_dir is not None:
        obs_block = {"cells": {cid: obs_cells[cid]
                               for cid in sorted(obs_cells) if cid in wanted}}
        broker_obs = perf.pop("broker_obs", None)
        if broker_obs is not None:
            obs_block["broker"] = broker_obs
        perf["obs"] = obs_block
    import repro_torch
    return {
        "spec": spec.to_json(),
        "provenance": {"pr": repro_torch.PR_TAG},
        "cells": records,
        "aggregates": aggregates,
        "rankings": rank(aggregates),
        **({"perf": perf} if perf else {}),
    }


def _cell_record(cell: CellSpec, metrics: dict, stats: dict) -> dict:
    return {
        "cell_id": cell.cell_id,
        "scheduler": cell.scheduler,
        "scenario": cell.scenario,
        "workload": cell.workload,
        "seed_index": cell.seed_index,
        "fleet_size": cell.fleet_size,
        "metrics": metrics,
        "stats": dict(stats),
    }


# ---------------------------------------------------------------------------
# Reduction: aggregates + rankings + rendering
# ---------------------------------------------------------------------------

def mean_ci(values) -> dict:
    """Mean and normal-approximation 95% CI half-width (sample std, ddof=1)."""
    xs = [float(v) for v in values]
    n = len(xs)
    mean = sum(xs) / n if n else 0.0
    if n > 1:
        var = sum((x - mean) ** 2 for x in xs) / (n - 1)
        ci95 = 1.96 * math.sqrt(var) / math.sqrt(n)
    else:
        ci95 = 0.0
    return {"mean": mean, "ci95": ci95, "n": n}


def aggregate(records: list[dict]) -> dict:
    """Reduce per-cell metrics over seeds: {scenario/workload/scheduler:
    {metric: {mean, ci95, n}}}."""
    groups: dict[str, list[dict]] = {}
    for r in records:
        env = f"{r['scenario']}/{r['workload']}"
        if r.get("fleet_size"):
            env += f"/n{r['fleet_size']}"
        groups.setdefault(f"{env}/{r['scheduler']}", []).append(r)
    out = {}
    for key, rs in sorted(groups.items()):
        metric_names = sorted({m for r in rs for m in r["metrics"]})
        out[key] = {m: mean_ci([r["metrics"][m] for r in rs
                                if m in r["metrics"]])
                    for m in metric_names}
    return out


def rank(aggregates: dict) -> dict:
    """Per (scenario, workload): schedulers best-first by mean failed-task %,
    then mean job runtime; plus an overall ranking averaged over scenarios."""
    per_env: dict[str, list] = {}
    overall: dict[str, list] = {}
    for key, metrics in aggregates.items():
        scenario, workload, scheduler = key.rsplit("/", 2)
        env = f"{scenario}/{workload}"
        row = (metrics["pct_tasks_failed"]["mean"],
               metrics["job_exec_time"]["mean"], scheduler)
        per_env.setdefault(env, []).append(row)
        overall.setdefault(scheduler, []).append(row[:2])
    rankings = {env: [{"scheduler": s, "pct_tasks_failed": ft,
                       "job_exec_time": jt}
                      for ft, jt, s in sorted(rows)]
                for env, rows in sorted(per_env.items())}
    overall_rows = sorted(
        (sum(ft for ft, _ in rows) / len(rows),
         sum(jt for _, jt in rows) / len(rows), s)
        for s, rows in overall.items())
    rankings["overall"] = [{"scheduler": s, "pct_tasks_failed": ft,
                            "job_exec_time": jt}
                           for ft, jt, s in overall_rows]
    return rankings


def _round_floats(obj, ndigits: int = 6):
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, ndigits) for v in obj]
    return obj


def sweep_json(result: dict) -> str:
    """Canonical byte-stable serialisation: sorted keys, floats rounded to 6
    decimals, no timestamps — re-running the same spec reproduces these bytes."""
    return json.dumps(_round_floats(result), indent=2, sort_keys=True) + "\n"


def sweep_markdown(result: dict) -> str:
    """Ranking tables (schedulers best-first by failed-task %, then runtime)."""
    agg = result["aggregates"]
    rankings = result["rankings"]
    lines = ["# Fleet sweep", ""]
    spec = result["spec"]
    lines.append(f"Schedulers: {', '.join(spec['schedulers'])} — "
                 f"seeds: {len(spec['seeds'])} — "
                 f"scenarios: {', '.join(spec['scenarios'])} — "
                 f"workloads: {', '.join(spec['workloads'])}")
    sizes = spec.get("fleet_sizes", [0])
    if any(sizes):
        lines.append("Fleet sizes: " + ", ".join(
            "paper (13)" if s == 0 else str(s) for s in sizes))
    pr = result.get("provenance", {}).get("pr")
    if pr:
        lines += ["", f"Produced by: {pr}"]
    broker = result.get("perf", {}).get("broker")
    if broker:
        lines += ["", f"Broker: {broker['demand_calls']} demand calls -> "
                      f"{broker['dispatches']} dispatches "
                      f"({broker['dispatch_reduction']}x reduction)"]
    header = ("| scheduler | failed tasks % | failed jobs % | job time (s) "
              "| sim time (s) |")
    sep = "|---|---|---|---|---|"

    def fmt(m):
        return f"{m['mean']:.2f} ± {m['ci95']:.2f}"

    for env, rows in rankings.items():
        if env == "overall":
            continue
        lines += ["", f"## {env}", "", header, sep]
        for row in rows:
            m = agg[f"{env}/{row['scheduler']}"]
            lines.append("| " + " | ".join(
                [row["scheduler"]] + [fmt(m[k]) for k in TABLE_METRICS]) + " |")
    lines += ["", "## overall (mean over scenarios)", "",
              "| rank | scheduler | failed tasks % | job time (s) |",
              "|---|---|---|---|"]
    for i, row in enumerate(rankings["overall"], 1):
        lines.append(f"| {i} | {row['scheduler']} | "
                     f"{row['pct_tasks_failed']:.2f} | "
                     f"{row['job_exec_time']:.1f} |")
    return "\n".join(lines) + "\n"


def write_outputs(result: dict, out_dir) -> tuple[pathlib.Path, pathlib.Path]:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jp = out / "SWEEP.json"
    mp = out / "SWEEP.md"
    jp.write_text(sweep_json(result))
    mp.write_text(sweep_markdown(result))
    return jp, mp


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_seeds(s: str):
    if "," in s:
        return tuple(int(x) for x in s.split(",") if x != "")
    return int(s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.fleet",
        description="Fleet-scale scheduler sweep over chaos scenarios")
    ap.add_argument("--schedulers", default="fifo,atlas-fifo",
                    help="comma list: fifo,fair,capacity,atlas-<base>")
    ap.add_argument("--seeds", default="3", type=_parse_seeds,
                    help="seed count (N => 0..N-1) or comma list of indices")
    ap.add_argument("--scenarios", default="baseline",
                    help=f"comma list or 'all' ({', '.join(sorted(SCENARIOS))})")
    ap.add_argument("--workloads", default="default",
                    help="comma list: " + ", ".join(sorted(WORKLOAD_SHAPES)))
    ap.add_argument("--fleet-size", default="0", dest="fleet_sizes",
                    metavar="SIZES",
                    help="comma list of fleet sizes (0 = the paper's "
                         "13-slave fleet; N = an N-node fleet of the same "
                         "machine mix) — a sweep axis")
    ap.add_argument("--algo", default="R.F.")
    ap.add_argument("--min-samples", type=int, default=150,
                    help="min labelled rows before a model trains")
    ap.add_argument("--executor", default="process", choices=EXECUTORS)
    ap.add_argument("--hazard", default="cluster",
                    choices=("cluster", "per-node"),
                    help="chaos scaling: 'cluster' keeps the "
                         "cluster-wide event rate; 'per-node' scales it "
                         "with fleet size so failure rates stay comparable "
                         "across --fleet-size")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--registry", default=None,
                    help="model-registry dir: ship trained model versions "
                         "to ATLAS cells instead of raw trace arrays")
    ap.add_argument("--device", default=None,
                    help="where predictors fit and score (default: cuda, "
                         "which needs a GPU; 'cpu' for the CPU)")
    ap.add_argument("--check-invariants", action="store_true",
                    help="run the per-tick invariant checker in every cell "
                         "and stamp violation counts into cell metrics "
                         "(repro_torch.cluster.invariants)")
    ap.add_argument("--obs", action="store_true",
                    help="stream per-cell telemetry frames to <out>/obs/ and "
                         "stamp deterministic roll-ups under perf.obs "
                         "(simulation results unchanged)")
    ap.add_argument("--obs-live", default=None, metavar="ADDR",
                    help="also stream every cell's frames to a live "
                         "TelemetryCollector at this transport address "
                         "(tcp://host:port — see python -m "
                         "repro_torch.obs.live); simulation results "
                         "unchanged")
    ap.add_argument("--resume", action="store_true",
                    help="keep an atomic per-cell ledger in <out>/cells and "
                         "skip cells it already holds: a sweep killed "
                         "mid-run restarts to byte-identical SWEEP.json "
                         "without re-running finished cells")
    ap.add_argument("--faults", default=None, metavar="FILE",
                    help="JSON FaultPlan (repro_torch.online.faults) "
                         "injected into the --executor async serving path; "
                         "retry/replay/fallback counters land in "
                         "<out>/FAULTS.json — SWEEP.json bytes are "
                         "unaffected")
    ap.add_argument("--out", default="experiments",
                    help="directory for SWEEP.json + SWEEP.md")
    ap.add_argument("--list-scenarios", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_scenarios:
        for name, sc in sorted(SCENARIOS.items()):
            print(f"{name:18s} {sc.description}")
        return 0
    scenarios = (tuple(sorted(SCENARIOS)) if args.scenarios == "all"
                 else tuple(args.scenarios.split(",")))
    spec = SweepSpec(
        schedulers=tuple(args.schedulers.split(",")),
        seeds=args.seeds,
        scenarios=scenarios,
        workloads=tuple(args.workloads.split(",")),
        fleet_sizes=tuple(int(s) for s in args.fleet_sizes.split(",")),
        hazard=args.hazard,
        algo=args.algo, min_samples=args.min_samples,
        check_invariants=args.check_invariants)
    try:
        expand(spec)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    fault_plan = None
    if args.faults:
        from repro_torch.online.faults import FaultPlan
        if args.executor != "async":
            print("error: --faults requires --executor async",
                  file=sys.stderr)
            return 2
        fault_plan = FaultPlan.from_dict(
            json.loads(pathlib.Path(args.faults).read_text()))
    resume_dir = (str(pathlib.Path(args.out) / "cells")
                  if args.resume else None)
    fault_stats = {} if fault_plan is not None else None
    obs_dir = str(pathlib.Path(args.out) / "obs") if args.obs else None
    result = run_sweep(
        spec, executor=args.executor, workers=args.workers,
        registry=args.registry, obs_dir=obs_dir,
        obs_live=args.obs_live, resume_dir=resume_dir,
        fault_plan=fault_plan, fault_stats=fault_stats, device=args.device)
    jp, mp = write_outputs(result, args.out)
    if fault_stats is not None:
        fp = pathlib.Path(args.out) / "FAULTS.json"
        fp.write_text(json.dumps(fault_stats, indent=2, sort_keys=True)
                      + "\n")
        print(f"[fleet] fault stats in {fp}: "
              f"{fault_stats.get('client_retries', 0)} retries, "
              f"{fault_stats.get('fallbacks', 0)} fallbacks, "
              f"{fault_stats['injected']['events']} injected events")
    sys.stdout.write(sweep_markdown(result))
    print(f"[fleet] wrote {jp} and {mp}"
          + (f" (+ telemetry frames in {obs_dir})" if obs_dir else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
