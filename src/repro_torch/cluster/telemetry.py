"""Telemetry: per-attempt feature logging (the paper's Table 1 attributes) and the
training-set builder for the failure predictors.

Features are captured at *launch time* (what the scheduler can know when deciding),
the label is the attempt outcome.  Separate datasets for map and reduce tasks, as the
paper trains two models."""

from __future__ import annotations

import dataclasses

import numpy as np

FEATURE_NAMES = [
    "is_reduce",            # task type
    "priority",             # job priority (penalties lower it)
    "locality",             # data-local?
    "speculative",          # execution type
    "prev_finished_attempts",
    "prev_failed_attempts",
    "reschedule_events",
    "job_finished_tasks",
    "job_failed_tasks",
    "job_total_tasks",
    "tt_running_tasks",
    "tt_finished_tasks",
    "tt_failed_recent",
    "tt_free_slot_frac",
    "tt_net_rtt",           # heartbeat RTT proxy for net quality
    "tt_since_heartbeat",
    "tt_restarts",
    "input_mb",
    "penalty",
    "jt_is_wordcount",
    "jt_is_teragen",
    "jt_is_terasort",
]
N_FEATURES = len(FEATURE_NAMES)


def attempt_features(sim, task, node, speculative: bool,
                     out: np.ndarray | None = None) -> np.ndarray:
    """Feature vector for (task -> node) at time sim.now.  Everything here is
    JobTracker-observable (no hidden sim state).

    Job-level finished/failed counts read the simulator's incrementally
    maintained counters (exactly equal to scanning ``job.tasks``) so building
    a row is O(1) in job size — this runs once per scored placement, the
    hottest per-decision loop in the repo.  ``out`` writes the row into a
    caller-provided float32 buffer row (columnar append) instead of
    allocating."""
    job = sim.jobs[task.job_id]
    jt = job.jtype
    total_slots = node.spec.map_slots + node.spec.reduce_slots
    free = node.free_map_slots() + node.free_reduce_slots()
    local = 1.0 if (task.kind == "reduce" or node.nid in task.block_nodes) else 0.0
    # RTT proxy: degraded network AND a degraded TaskTracker process both inflate
    # the observed heartbeat round-trip (the JT genuinely sees this)
    rtt = (1.0 / max(node.net_quality, 0.05)) * (1.0 + 0.8 * (1.0 - node.health))
    vals = (
        1.0 if task.kind == "reduce" else 0.0,
        float(job.priority - task.penalty),
        local,
        1.0 if speculative else 0.0,
        float(task.finished_attempts),
        float(task.failed_attempts),
        float(task.reschedules),
        float(job.n_finished_tasks), float(job.n_failed_tasks),
        float(len(job.tasks)),
        float(len(node.running)),
        float(node.finished_count),
        float(node.recent_failure_count(sim.now)),
        free / max(total_slots, 1),
        rtt,
        (sim.now - node.last_heartbeat) / max(sim.heartbeat_interval, 1.0),
        float(node.restarts),
        task.input_mb,
        float(task.penalty),
        1.0 if jt == "wordcount" else 0.0,
        1.0 if jt == "teragen" else 0.0,
        1.0 if jt == "terasort" else 0.0,
    )
    if out is None:
        return np.array(vals, dtype=np.float32)
    out[:] = vals
    return out


@dataclasses.dataclass
class TelemetryTrace:
    """Collects (features, label) per attempt + job/task ledger rows."""
    map_X: list = dataclasses.field(default_factory=list)
    map_y: list = dataclasses.field(default_factory=list)
    red_X: list = dataclasses.field(default_factory=list)
    red_y: list = dataclasses.field(default_factory=list)
    _pending: dict = dataclasses.field(default_factory=dict)  # aid -> features
    jobs: dict = dataclasses.field(default_factory=dict)      # jid -> ledger row

    def record_launch(self, sim, att, p_fail_hidden):
        self._pending[att.aid] = attempt_features(sim, att.task, att.node,
                                                  att.speculative)

    def record_outcome(self, sim, att, finished: bool):
        feats = self._pending.pop(att.aid, None)
        if feats is None:
            return
        if att.task.kind == "map":
            self.map_X.append(feats)
            self.map_y.append(1.0 if finished else 0.0)
        else:
            self.red_X.append(feats)
            self.red_y.append(1.0 if finished else 0.0)
        row = self.jobs.get(att.task.job_id)
        if row is not None:
            row["failed_attempts" if not finished else
                "finished_attempts"] += 1

    def record_job_submit(self, sim, job):
        """Open a ledger row at submit — fires when sim.now == job.submit_time,
        so `submit` below is exactly job.submit_time."""
        self.jobs[job.jid] = {
            "job": job.jid, "jtype": job.jtype, "chain_id": job.chain_id,
            "submit": float(sim.now), "end": None, "outcome": None,
            "tasks": len(job.tasks), "maps": job.n_map_tasks,
            "reduces": len(job.tasks) - job.n_map_tasks,
            "finished_attempts": 0, "failed_attempts": 0,
        }

    def record_job_end(self, sim, job):
        """Close the row — fires when sim.now == job.done_time, so ledger
        durations equal ``done_time - submit_time`` recomputed from sim.jobs
        (the experiment-summary scans reuse this instead of rescanning)."""
        row = self.jobs.get(job.jid)
        if row is not None:
            row["end"] = float(sim.now)
            row["outcome"] = job.status

    def job_times(self, *, jtypes=None, outcome="finished") -> list[float]:
        """Completion durations straight from the ledger (submit order)."""
        out = []
        for jid in sorted(self.jobs):
            row = self.jobs[jid]
            if row["end"] is None or row["outcome"] != outcome:
                continue
            if jtypes is not None and row["jtype"] not in jtypes:
                continue
            out.append(row["end"] - row["submit"])
        return out

    def datasets(self):
        mx = np.stack(self.map_X) if self.map_X else np.zeros((0, N_FEATURES),
                                                              np.float32)
        my = np.asarray(self.map_y, np.float32)
        rx = np.stack(self.red_X) if self.red_X else np.zeros((0, N_FEATURES),
                                                              np.float32)
        ry = np.asarray(self.red_y, np.float32)
        return (mx, my), (rx, ry)
