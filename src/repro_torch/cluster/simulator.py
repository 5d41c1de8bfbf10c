"""Discrete-event cluster simulator — the testbed for ATLAS vs FIFO/Fair/Capacity.

Models the paper's Amazon EMR setup: a heterogeneous fleet (m3.large / m4.xlarge /
c4.xlarge), a JobTracker with heartbeat-based liveness (failures between heartbeats
are invisible to the scheduler, reproducing Dinu et al.'s observations), per-node
map/reduce slots, HDFS block locality, task attempt retry budgets (K maps, L
reduces), and a *hidden* failure-generating hazard whose drivers match the
correlations the paper reports (co-located failures on a TaskTracker, locality,
previous failed attempts, resource pressure).

The JAX package's training runtime (repro.runtime, not yet ported) drives the same
simulator with accelerator hosts as nodes and training step-shards as tasks; here
they are Hadoop tasks, which is what the paper's tables measure.

Everything is deterministic given (seed, workload, scheduler).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import random
from collections import defaultdict, deque
from typing import Any

# ---------------------------------------------------------------------------
# Machine fleet (Table 2 of the paper)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineSpec:
    name: str
    vcpu: int
    mem_gb: float
    net: str           # "moderate" | "high"
    speed: float       # relative task speed factor
    map_slots: int
    reduce_slots: int


MACHINE_TYPES = {
    "m3.large": MachineSpec("m3.large", 1, 3.75, "moderate", 1.00, 2, 1),
    "m4.xlarge": MachineSpec("m4.xlarge", 2, 8.0, "high", 1.30, 3, 2),
    "c4.xlarge": MachineSpec("c4.xlarge", 4, 7.5, "high", 1.60, 4, 2),
}

# paper: 15 machines — 1 master, 1 secondary master, 13 slaves of 3 types
DEFAULT_FLEET = (["m3.large"] * 5 + ["m4.xlarge"] * 4 + ["c4.xlarge"] * 4)


def make_fleet(n_nodes: int) -> list[str]:
    """A fleet of ``n_nodes`` machines cycling the paper's Table-2 mix — the
    scale axis beyond the 15-machine EMR cluster (0 -> the paper's fleet)."""
    if n_nodes <= 0:
        return list(DEFAULT_FLEET)
    return [DEFAULT_FLEET[i % len(DEFAULT_FLEET)] for i in range(n_nodes)]


# failure-history window (seconds) behind Node.recent_failure_count — also the
# eviction cutoff, so the deque holds O(window) entries however long the run
FAILURE_WINDOW = 600.0


@dataclasses.dataclass
class Node:
    nid: int
    spec: MachineSpec
    tt_alive: bool = True          # TaskTracker process
    dn_alive: bool = True          # DataNode process
    suspended: bool = False
    net_quality: float = 1.0       # 1 ok, 0.3 slow, 0 dropped
    health: float = 1.0            # latent degradation in [0,1] (hidden from sched)
    last_heartbeat: float = 0.0
    known_alive: bool = True       # what the JobTracker believes
    running: set = dataclasses.field(default_factory=set)      # attempt ids
    running_maps: int = 0
    running_reduces: int = 0
    recent_failures: deque = dataclasses.field(
        default_factory=deque)     # failure times on node, window-evicted
    finished_count: int = 0
    failed_count: int = 0
    restarts: int = 0

    def free_map_slots(self) -> int:
        return self.spec.map_slots - self.running_maps

    def free_reduce_slots(self) -> int:
        return self.spec.reduce_slots - self.running_reduces

    def record_failure(self, now: float):
        """Append a failure timestamp, evicting entries past the window — the
        deque stays O(window) over arbitrarily long chaos runs.  (Unlike the
        old fixed maxlen=64 deque, a node with >64 failures inside the window
        now reports its true count.)"""
        dq = self.recent_failures
        dq.append(now)
        cutoff = now - FAILURE_WINDOW
        while dq[0] < cutoff:
            dq.popleft()

    def recent_failure_count(self, now: float,
                             horizon: float = FAILURE_WINDOW) -> int:
        """Failures within the horizon: O(evicted) amortised, not a scan.
        Eviction always uses FAILURE_WINDOW (a shorter query horizon must not
        destroy entries still inside the retention window); timestamps are
        appended in event order, so the post-eviction deque IS the window."""
        dq = self.recent_failures
        cutoff = now - FAILURE_WINDOW
        while dq and dq[0] < cutoff:
            dq.popleft()
        if horizon >= FAILURE_WINDOW:
            return len(dq)
        return sum(1 for t in dq if now - t <= horizon)


# ---------------------------------------------------------------------------
# Jobs / tasks / attempts
# ---------------------------------------------------------------------------

MAP, REDUCE = "map", "reduce"


@dataclasses.dataclass
class Task:
    job_id: int
    tid: int
    kind: str                      # map | reduce
    duration_base: float           # seconds on a speed-1.0 node
    input_mb: float
    block_nodes: tuple             # nodes holding the HDFS block (maps)
    max_attempts: int
    status: str = "pending"        # pending | running | finished | failed | blocked
    finished_attempts: int = 0
    failed_attempts: int = 0
    reschedules: int = 0
    penalty: int = 0
    first_submit: float = 0.0
    done_time: float = 0.0
    live_attempts: set = dataclasses.field(default_factory=set)
    # resource usage accumulated over ALL attempts (paper Table 4)
    cpu_ms: float = 0.0
    mem_bytes: float = 0.0
    hdfs_read: float = 0.0
    hdfs_write: float = 0.0

    @property
    def key(self):
        return (self.job_id, self.tid)


@dataclasses.dataclass
class Job:
    jid: int
    jtype: str                     # wordcount | teragen | terasort
    n_maps: int
    n_reduces: int
    priority: int = 1
    chain_id: int = -1             # chained-job group (-1: single)
    chain_kind: str = "single"     # single | sequential | parallel | mix
    chain_pos: int = 0
    submit_time: float = 0.0
    status: str = "pending"        # pending | running | finished | failed
    done_time: float = 0.0
    tasks: dict = dataclasses.field(default_factory=dict)
    # incrementally maintained by the Simulator (exactly equal to scanning
    # tasks for the matching status — the predictor reads these per decision)
    n_finished_tasks: int = 0
    n_failed_tasks: int = 0
    n_finished_maps: int = 0
    n_map_tasks: int = -1          # resolved at submit

    def map_tasks(self):
        return [t for t in self.tasks.values() if t.kind == MAP]

    def reduce_tasks(self):
        return [t for t in self.tasks.values() if t.kind == REDUCE]


@dataclasses.dataclass
class Attempt:
    aid: int
    task: Task
    node: Node
    start: float
    duration: float                # planned wall duration
    will_fail: bool
    fail_at: float                 # absolute failure time if will_fail
    speculative: bool = False
    local: bool = True
    status: str = "running"        # running | finished | failed | killed | stalled


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

(EV_SUBMIT, EV_ATTEMPT_END, EV_HEARTBEAT, EV_CHAOS, EV_TIMEOUT,
 EV_NODE_RECOVER, EV_RETRAIN) = range(7)


class Simulator:
    """Single cluster run under one scheduler.  Usage:

        sim = Simulator(scheduler=FIFOScheduler(), seed=0)
        sim.submit_workload(make_workload(...))
        sim.run()
        sim.metrics  ->  aggregate results
    """

    def __init__(self, scheduler, *, fleet=None, seed: int = 0,
                 heartbeat_interval: float = 600.0, task_timeout: float = 1800.0,
                 chaos=None, trace=None, time_limit: float = 10_000_000.0,
                 hazard_noise: float = 0.55, obs=None, invariants=None):
        self.rng = random.Random(seed)
        fleet = fleet or DEFAULT_FLEET
        self.nodes = [Node(i, MACHINE_TYPES[m]) for i, m in enumerate(fleet)]
        self.scheduler = scheduler
        self.heartbeat_interval = heartbeat_interval  # may be adapted by ATLAS
        self.task_timeout = task_timeout
        self.chaos = chaos
        self.trace = trace                    # TelemetryTrace or None
        self.obs = obs                        # obs.SimObserver or None
        self.time_limit = time_limit
        self.hazard_noise = hazard_noise

        self.now = 0.0
        self._heap: list = []
        self._seq = 0
        self.jobs: dict[int, Job] = {}
        self.pending: deque = deque()         # runnable task keys (FIFO arrival order)
        self.blocked_chains: dict[int, list] = defaultdict(list)
        self.attempts: dict[int, Attempt] = {}
        self._next_aid = 0
        self.waiting_submits = 0
        self.n_running_jobs = 0
        # observable signals the scheduler/ATLAS may read (JT-side knowledge)
        self.hb_failures_window: int = 0      # TT failures since last heartbeat sweep
        # incrementally maintained node indices — the per-decision candidate
        # generators read these instead of rebuilding list comprehensions over
        # the whole fleet every tick (the 100-1000-node hot path).  Slot sets
        # change only in launch/_release; known_alive changes only in
        # detect_tt_failure/_on_heartbeat — all Simulator methods.
        self._free_map: set = {n.nid for n in self.nodes}
        self._free_reduce: set = {n.nid for n in self.nodes}
        self._known_alive: set = {n.nid for n in self.nodes}
        # nodes whose running / failed counts, and nodes whose last
        # heartbeat, moved since the telemetry observer's last frame (None
        # without an observer)
        self.changed_nodes: set | None = set() if obs is not None else None
        self.beat_nodes: set | None = set() if obs is not None else None

        scheduler.bind(self)
        # invariant checker (repro_torch.cluster.invariants): read-only observer, so
        # results are byte-identical with checking on or off
        self.invariants = invariants
        if invariants is not None:
            invariants.bind(self)
        if obs is not None:
            obs.bind(self)
        for n in self.nodes:
            self._push(self.heartbeat_interval * (0.5 + 0.5 * self.rng.random()),
                       EV_HEARTBEAT, n.nid)
        if chaos is not None:
            chaos.bind(self)
            chaos.schedule_initial()

    # ------------------------------------------------------------------ utils
    def _push(self, t: float, kind: int, payload: Any = None):
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def alive_nodes(self):
        return [n for n in self.nodes if n.tt_alive and not n.suspended]

    def jt_believed_alive(self):
        nodes = self.nodes
        return [nodes[i] for i in sorted(self._known_alive)]

    def _sync_free(self, node: Node):
        """Refresh the node's membership in the free-slot indices (called on
        every running-count change — launch and release only — and so on
        every failed-count change too, each of which follows a release on
        the same node).  With telemetry on, the node also lands in
        ``changed_nodes``, the nodes whose counts a frame must re-read (a
        node whose heartbeat lands goes to ``beat_nodes``, in
        ``_on_heartbeat``)."""
        nid = node.nid
        if self.changed_nodes is not None:
            self.changed_nodes.add(nid)
        if node.running_maps < node.spec.map_slots:
            self._free_map.add(nid)
        else:
            self._free_map.discard(nid)
        if node.running_reduces < node.spec.reduce_slots:
            self._free_reduce.add(nid)
        else:
            self._free_reduce.discard(nid)

    def free_nodes(self, kind: str, *, liveness: str = "jt") -> list[Node]:
        """Nodes with a free slot of ``kind``, in nid order (deterministic
        candidate lists), read from the incremental indices.

        liveness: "jt" — the JobTracker believes them alive (scheduler view);
        "actual" — TaskTracker up and not suspended (ATLAS's active probe);
        "any" — slot availability only (the broker's tick-priming superset)."""
        idx = self._free_map if kind == MAP else self._free_reduce
        nodes = self.nodes
        if liveness == "jt":
            return [nodes[i] for i in sorted(idx & self._known_alive)]
        if liveness == "actual":
            out = []
            for i in sorted(idx):
                n = nodes[i]
                if n.tt_alive and not n.suspended:
                    out.append(n)
            return out
        return [nodes[i] for i in sorted(idx)]

    # ------------------------------------------------------------------ workload
    def submit_workload(self, jobs: list[Job]):
        for job in jobs:
            self._push(job.submit_time, EV_SUBMIT, job)
            self.waiting_submits += 1

    # ------------------------------------------------------------------ hazard
    def _attempt_outcome(self, task: Task, node: Node, local: bool,
                         speculative: bool):
        """Hidden ground-truth generator: duration + failure decision.  The drivers
        mirror the paper's observed correlates so the Table-1 features are genuinely
        predictive."""
        spec = node.spec
        net_pen = 1.0 + (1.0 - node.net_quality) * 1.5
        loc_pen = 1.0 if local else 1.35
        load = (node.running_maps + node.running_reduces) \
            / max(spec.map_slots + spec.reduce_slots, 1)
        load_pen = 1.0 + 0.45 * load
        dur = (task.duration_base / spec.speed) * net_pen * loc_pen * load_pen
        dur *= 0.85 + 0.3 * self.rng.random()

        # failure drivers are predominantly node-exogenous (injected chaos, node
        # degradation, network, data availability) as on the paper's EMR cluster;
        # load contention contributes mildly
        # NOTE: no explicit "failures beget failures" term — the correlation the
        # paper observes between co-located failures and outcomes emerges from the
        # shared hidden cause (node health / network), which is what makes the
        # tt_failed_recent *feature* informative without a runaway feedback loop.
        logit = -3.0
        logit += 2.3 * (1.0 - node.net_quality)
        logit += 0.5 * load
        logit += 0.0 if local else 0.7
        logit += 0.25 * min(task.failed_attempts, 4)
        logit += 2.6 * (1.0 - node.health)
        # idiosyncratic, unobservable component: bounds any predictor's accuracy
        # (the paper's best model reaches ~84% map / ~95% reduce accuracy, not 100%)
        logit += self.rng.gauss(0.0, self.hazard_noise)
        if task.kind == MAP and task.block_nodes and not any(
                self.nodes[b].dn_alive for b in task.block_nodes):
            logit += 3.5                       # input block unavailable
        p_fail = 1.0 / (1.0 + math.exp(-logit))
        will_fail = self.rng.random() < p_fail
        fail_at = self.now + dur * (0.15 + 0.8 * self.rng.random())
        return dur, will_fail, fail_at, p_fail

    # ------------------------------------------------------------------ actions
    def launch(self, task: Task, node: Node, *, speculative: bool = False) -> Attempt:
        if self.invariants is not None:    # pre-mutation state is what L1-L3 check
            self.invariants.check_launch(self, task, node, speculative)
        local = task.kind == REDUCE or node.nid in task.block_nodes
        dur, will_fail, fail_at, p_fail = self._attempt_outcome(
            task, node, local, speculative)
        aid = self._next_aid
        self._next_aid += 1
        att = Attempt(aid, task, node, self.now, dur, will_fail, fail_at,
                      speculative=speculative, local=local)
        self.attempts[aid] = att
        task.live_attempts.add(aid)
        task.status = "running"
        node.running.add(aid)
        if task.kind == MAP:
            node.running_maps += 1
        else:
            node.running_reduces += 1
        self._sync_free(node)
        if self.trace is not None:
            self.trace.record_launch(self, att, p_fail)
        end = fail_at if will_fail else self.now + dur
        # node death may pre-empt; handled when the node dies
        self._push(end, EV_ATTEMPT_END, aid)
        return att

    def _release(self, att: Attempt):
        node = att.node
        node.running.discard(att.aid)
        if att.task.kind == MAP:
            node.running_maps = max(0, node.running_maps - 1)
        else:
            node.running_reduces = max(0, node.running_reduces - 1)
        self._sync_free(node)
        att.task.live_attempts.discard(att.aid)

    def _charge_resources(self, att: Attempt, ran_for: float):
        t = att.task
        spec = att.node.spec
        cpu_frac = 0.8 if t.kind == MAP else 0.6
        t.cpu_ms += ran_for * 1000.0 * cpu_frac
        t.mem_bytes += ran_for * (0.9 if t.kind == MAP else 1.4) * 1e5
        read = t.input_mb * 1e3 * (1.0 if att.local else 1.6)
        write = t.input_mb * 1e3 * (0.35 if t.kind == MAP else 1.0)
        frac = min(1.0, ran_for / max(att.duration, 1e-9))
        t.hdfs_read += read * frac
        t.hdfs_write += write * frac

    # ------------------------------------------------------------------ event handlers
    def _on_submit(self, job: Job):
        self.waiting_submits -= 1
        job.status = "running"
        self.n_running_jobs += 1
        self.jobs[job.jid] = job
        maps = job.map_tasks()
        job.n_map_tasks = len(maps)
        for t in maps:
            t.first_submit = self.now
            self.pending.append(t.key)
        # reduces become runnable once all maps finish (coarse barrier, as in the
        # paper's formulation eq. (2))
        if self.trace is not None:
            self.trace.record_job_submit(self, job)

    def _maybe_release_reduces(self, job: Job):
        if job.n_finished_maps == job.n_map_tasks:
            for t in job.reduce_tasks():
                if t.status == "pending" and not t.first_submit:
                    t.first_submit = self.now
                    self.pending.append(t.key)

    def _on_attempt_end(self, aid: int):
        att = self.attempts.get(aid)
        if att is None or att.status != "running":
            return
        node, task = att.node, att.task
        if not node.tt_alive:
            return  # node died first; resolution happens via heartbeat detection
        if node.suspended:
            # stalled: retry this event later
            self._push(self.now + 30.0, EV_ATTEMPT_END, aid)
            return
        self._release(att)
        ran_for = self.now - att.start
        self._charge_resources(att, ran_for)
        if att.will_fail:
            att.status = "failed"
            # a failed *speculative* copy doesn't burn the task's retry budget
            # while another attempt is still live (it was insurance, not the task)
            if not (att.speculative and task.live_attempts):
                task.failed_attempts += 1
            node.failed_count += 1
            node.record_failure(self.now)
            if self.trace is not None:
                self.trace.record_outcome(self, att, False)
            self._task_attempt_failed(task)
        else:
            att.status = "finished"
            node.finished_count += 1
            if self.trace is not None:
                self.trace.record_outcome(self, att, True)
            self._task_finished(task)

    def _task_attempt_failed(self, task: Task):
        if task.status in ("finished", "failed"):
            return
        if task.live_attempts:
            return  # other (speculative) copies still running
        if task.failed_attempts >= task.max_attempts:
            self._task_failed(task)
        else:
            task.reschedules += 1
            task.status = "pending"
            self.pending.append(task.key)

    def _task_finished(self, task: Task):
        if task.status == "finished":
            return
        task.status = "finished"
        task.finished_attempts += 1
        task.done_time = self.now
        job_of = self.jobs[task.job_id]
        job_of.n_finished_tasks += 1
        if task.kind == MAP:
            job_of.n_finished_maps += 1
        # kill outstanding speculative copies
        for aid in list(task.live_attempts):
            a = self.attempts[aid]
            a.status = "killed"
            self._release(a)
            self._charge_resources(a, self.now - a.start)
        job = self.jobs[task.job_id]
        if task.kind == MAP:
            self._maybe_release_reduces(job)
        self._maybe_finish_job(job)

    def _task_failed(self, task: Task):
        task.status = "failed"
        task.done_time = self.now
        job = self.jobs[task.job_id]
        job.n_failed_tasks += 1
        if job.status == "running":
            job.status = "failed"
            job.done_time = self.now
            self.n_running_jobs -= 1
            # map failure cascades to dependent reduces (paper Fig. 2)
            for t in job.tasks.values():
                if t.status in ("pending", "running"):
                    t.status = "failed"
                    t.done_time = self.now
                    job.n_failed_tasks += 1
                    for aid in list(t.live_attempts):
                        a = self.attempts[aid]
                        a.status = "killed"
                        self._release(a)
            self._fail_chain_siblings(job)
        if self.trace is not None:
            self.trace.record_job_end(self, job)

    def _fail_chain_siblings(self, job: Job):
        if job.chain_id < 0:
            return
        for j in self.jobs.values():
            if j.chain_id == job.chain_id and j.status == "running" \
                    and j.jid != job.jid and j.chain_kind == "sequential":
                pass  # running siblings in parallel chains keep going; sequential
                      # successors simply never get submitted
        # drop queued successors of a sequential chain
        self.blocked_chains.pop(job.chain_id, None)

    def _maybe_finish_job(self, job: Job):
        if job.status != "running":
            return
        if job.n_finished_tasks == len(job.tasks):
            job.status = "finished"
            job.done_time = self.now
            self.n_running_jobs -= 1
            if self.trace is not None:
                self.trace.record_job_end(self, job)
            # release next job of a sequential chain
            if job.chain_id >= 0 and self.blocked_chains.get(job.chain_id):
                nxt = self.blocked_chains[job.chain_id].pop(0)
                nxt.submit_time = self.now
                self._push(self.now, EV_SUBMIT, nxt)
                self.waiting_submits += 1

    def detect_tt_failure(self, node: Node):
        """The JobTracker learns a TaskTracker is dead (heartbeat timeout, or an
        ATLAS active probe): every attempt stranded on it fails now."""
        if not node.known_alive:
            return
        node.known_alive = False
        self._known_alive.discard(node.nid)
        self.hb_failures_window += 1
        for aid in list(node.running):
            att = self.attempts[aid]
            att.status = "failed"
            self._release(att)
            self._charge_resources(att, self.now - att.start)
            if not (att.speculative and att.task.live_attempts):
                att.task.failed_attempts += 1
            node.failed_count += 1
            node.record_failure(self.now)
            if self.trace is not None:
                self.trace.record_outcome(self, att, False)
            self._task_attempt_failed(att.task)

    def _on_heartbeat(self, nid: int):
        node = self.nodes[nid]
        if node.tt_alive:
            node.last_heartbeat = self.now
            if self.beat_nodes is not None:
                self.beat_nodes.add(nid)
            if not node.known_alive:
                node.known_alive = True
                self._known_alive.add(nid)
        else:
            self.detect_tt_failure(node)
        self.scheduler.on_heartbeat(node)
        self._push(self.now + self.heartbeat_interval, EV_HEARTBEAT, nid)

    def _on_timeout(self, payload):
        kind, key = payload
        if kind == "task":
            task = self._task_by_key(key)
            if task is not None and task.status == "running":
                # attempt exceeded the scheduler timeout -> failed + requeue
                for aid in list(task.live_attempts):
                    att = self.attempts[aid]
                    if self.now - att.start >= self.task_timeout:
                        att.status = "failed"
                        self._release(att)
                        self._charge_resources(att, self.now - att.start)
                        task.failed_attempts += 1
                        att.node.failed_count += 1
                        att.node.record_failure(self.now)
                        if self.trace is not None:
                            self.trace.record_outcome(self, att, False)
                self._task_attempt_failed(task)

    def _task_by_key(self, key):
        job = self.jobs.get(key[0])
        return None if job is None else job.tasks.get(key[1])

    # ------------------------------------------------------------------ loop
    def run(self):
        obs = self.obs
        # telemetry hot path inlined: a list add + one float compare per
        # event (a per-event method call costs ~10x as much).  Read-only —
        # never touches the RNG or any scheduling input.
        ev_counts = obs.event_counts if obs is not None else None
        # invariant hot path inlined like the telemetry one: the E1/E2
        # compares run on loop locals and the checker method is entered only
        # on a violation or a sweep boundary
        inv = self.invariants
        inv_every = inv.sweep_interval if inv is not None else 0
        inv_last = self.now
        inv_events = 0
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > self.time_limit:
                break
            self.now = t
            if kind == EV_SUBMIT:
                self._on_submit(payload)
            elif kind == EV_ATTEMPT_END:
                self._on_attempt_end(payload)
            elif kind == EV_HEARTBEAT:
                self._on_heartbeat(payload)
            elif kind == EV_CHAOS:
                self.chaos.fire(payload)
            elif kind == EV_TIMEOUT:
                self._on_timeout(payload)
            elif kind == EV_RETRAIN:
                self.scheduler.on_retrain()
            self.scheduler.on_tick()
            if inv is not None:
                inv_events += 1
                if (t < inv_last or self.n_running_jobs < 0
                        or inv_events % inv_every == 0):
                    inv.on_event(self, inv_last)
                inv_last = t
            if ev_counts is not None:
                ev_counts[kind] += 1
                if t >= obs.next_frame_t:
                    obs.maybe_frame(self)
            if self._done():
                break
        if inv is not None:
            inv.finish(self, inv_events)
        if obs is not None:
            obs.finish(self)
        return self.metrics()

    def _done(self) -> bool:
        if self.waiting_submits > 0 or self.pending:
            return False
        if self.n_running_jobs > 0:
            return False
        if any(self.blocked_chains.values()):
            return False
        return True

    # ------------------------------------------------------------------ results
    def metrics(self) -> dict:
        jobs = list(self.jobs.values())
        tasks = [t for j in jobs for t in j.tasks.values()]
        fin_j = [j for j in jobs if j.status == "finished"]
        fail_j = [j for j in jobs if j.status == "failed"]
        fin_t = [t for t in tasks if t.status == "finished"]
        fail_t = [t for t in tasks if t.status == "failed"]
        fin_m = [t for t in fin_t if t.kind == MAP]
        fin_r = [t for t in fin_t if t.kind == REDUCE]
        fail_m = [t for t in fail_t if t.kind == MAP]
        fail_r = [t for t in fail_t if t.kind == REDUCE]

        def avg(xs):
            xs = list(xs)
            return sum(xs) / len(xs) if xs else 0.0

        job_time = avg(j.done_time - j.submit_time for j in fin_j)
        map_time = avg(t.done_time - t.first_submit for t in fin_m)
        red_time = avg(t.done_time - t.first_submit for t in fin_r)
        # direct failures (retry budget exhausted) vs cascade (Fig. 2 teardown)
        direct_fail = [t for t in fail_t if t.failed_attempts >= t.max_attempts]
        out = {
            "jobs_total": len(jobs), "jobs_finished": len(fin_j),
            "jobs_failed": len(fail_j),
            "pct_jobs_failed": 100.0 * len(fail_j) / max(len(jobs), 1),
            "tasks_total": len(tasks), "tasks_finished": len(fin_t),
            "tasks_failed": len(fail_t),
            "tasks_failed_direct": len(direct_fail),
            "pct_tasks_failed": 100.0 * len(fail_t) / max(len(tasks), 1),
            "maps_finished": len(fin_m), "maps_failed": len(fail_m),
            "reduces_finished": len(fin_r), "reduces_failed": len(fail_r),
            "job_exec_time": job_time, "map_exec_time": map_time,
            "reduce_exec_time": red_time,
            "cpu_ms_per_job": avg(sum(t.cpu_ms for t in j.tasks.values())
                                  for j in jobs),
            "mem_per_job": avg(sum(t.mem_bytes for t in j.tasks.values())
                               for j in jobs),
            "hdfs_read_per_job": avg(sum(t.hdfs_read for t in j.tasks.values())
                                     for j in jobs),
            "hdfs_write_per_job": avg(sum(t.hdfs_write for t in j.tasks.values())
                                      for j in jobs),
            "cpu_ms_per_task": avg(t.cpu_ms for t in tasks),
            "mem_per_task": avg(t.mem_bytes for t in tasks),
            "hdfs_read_per_task": avg(t.hdfs_read for t in tasks),
            "hdfs_write_per_task": avg(t.hdfs_write for t in tasks),
            "sim_time": self.now,
        }
        if self.invariants is not None:
            out["invariant_checks"] = self.invariants.n_checks
            out["invariant_violations"] = self.invariants.n_violations
        return out
