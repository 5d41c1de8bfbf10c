"""Scheduler interface + the three Hadoop baselines (§2.3).

A scheduler turns the simulator's pending queue into (task, node) launches.  The
baselines also carry Hadoop's stock straggler speculation (one copy for slow tasks),
so ATLAS's *multiple predicted-failure* speculation is measured against a fair
baseline."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.cluster.simulator import MAP, Node, Task


@dataclasses.dataclass
class SchedulerStats:
    """The documented ``Scheduler.stats()`` schema, shared by all four
    schedulers (FIFO/Fair/Capacity return exactly these two counters; ATLAS
    returns the :class:`repro_torch.core.atlas.AtlasStats` extension).

    launches            every attempt handed to ``Simulator.launch``
    speculative_copies  redundant copies among them, whatever the trigger
                        (straggler speculation here; predicted-failure
                        replication under ATLAS)
    """
    launches: int = 0
    speculative_copies: int = 0

    def to_dict(self) -> dict:
        """JSON-ready form, in field order, with ``None``-valued optional
        extension fields omitted."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


class Scheduler:
    name = "base"

    def __init__(self):
        self.n_launches = 0
        self.n_speculative_copies = 0

    def bind(self, sim):
        self.sim = sim

    # --- hooks
    def on_tick(self):
        self.schedule()
        self.speculate_stragglers()

    def on_heartbeat(self, node: Node):
        pass

    def on_retrain(self):
        pass

    # --- helpers shared by all policies
    def _runnable(self):
        """Pending task keys, resolved and filtered (drops stale keys)."""
        sim = self.sim
        out = []
        seen = set()
        while sim.pending:
            key = sim.pending.popleft()
            if key in seen:
                continue
            seen.add(key)
            t = sim._task_by_key(key)
            if t is not None and t.status == "pending":
                out.append(t)
        return out

    def _requeue(self, tasks):
        for t in tasks:
            self.sim.pending.append(t.key)

    def _free_nodes(self, kind: str):
        """Nodes the JobTracker *believes* are schedulable with a free slot —
        read from the simulator's incremental indices (O(free) per call, not
        a rebuild over the whole fleet)."""
        return self.sim.free_nodes(kind)

    def _pick_node(self, task: Task, nodes):
        """Prefer data-local nodes for maps, then least loaded."""
        if not nodes:
            return None
        if task.kind == MAP and task.block_nodes:
            local = [n for n in nodes if n.nid in task.block_nodes]
            if local:
                nodes = local
        return min(nodes, key=lambda n: (len(n.running), n.nid))

    def launch(self, task: Task, node: Node, *, speculative=False):
        self.n_launches += 1
        self.n_speculative_copies += int(speculative)
        return self.sim.launch(task, node, speculative=speculative)

    def stats(self) -> SchedulerStats:
        """Uniform per-run counters every scheduler exposes; the fleet sweep
        surfaces ``stats().to_dict()`` per cell (ATLAS extends the schema
        with its Algorithm-1 counters — see :class:`SchedulerStats`)."""
        return SchedulerStats(launches=self.n_launches,
                              speculative_copies=self.n_speculative_copies)

    def frame_stats(self) -> dict:
        """Cheap live-state snapshot for the obs layer's per-frame gather:
        ``{"penalty_box": int, "pred": dict | None}``.  Base schedulers have
        no penalty box and no predictor; ATLAS overrides both fields."""
        return {"penalty_box": 0, "pred": None}

    # --- policy body
    def schedule(self):
        raise NotImplementedError

    # --- stock Hadoop speculation (single copy for stragglers)
    def speculate_stragglers(self):
        sim = self.sim
        for job in sim.jobs.values():
            if job.status != "running":
                continue
            # counter gate first: the task scan only runs for jobs already
            # half-done (this loop fires on every simulator event)
            if job.n_finished_tasks < max(2, len(job.tasks) // 2):
                continue
            done = [t for t in job.tasks.values() if t.status == "finished"]
            med = sorted(t.done_time - t.first_submit for t in done)[len(done) // 2]
            for t in job.tasks.values():
                if t.status != "running" or len(t.live_attempts) != 1:
                    continue
                (aid,) = t.live_attempts
                att = sim.attempts[aid]
                if att.speculative or sim.now - att.start < 1.5 * max(med, 30.0):
                    continue
                nodes = self._free_nodes(t.kind)
                nodes = [n for n in nodes if n.nid != att.node.nid]
                if nodes:
                    self.launch(t, self._pick_node(t, nodes), speculative=True)


class FIFOScheduler(Scheduler):
    """Strict submission order; head-of-line blocking included."""
    name = "fifo"

    def schedule(self):
        tasks = self._runnable()
        tasks.sort(key=lambda t: (self.sim.jobs[t.job_id].submit_time, t.job_id,
                                  t.tid))
        blocked = []
        for t in tasks:
            nodes = self._free_nodes(t.kind)
            if not nodes:
                blocked.append(t)
                continue
            self.launch(t, self._pick_node(t, nodes))
        self._requeue(blocked)


class FairScheduler(Scheduler):
    """Fair sharing: repeatedly grant a slot to the job with the smallest
    running-share (weighted by priority)."""
    name = "fair"

    def schedule(self):
        sim = self.sim
        tasks = self._runnable()
        if not tasks:
            return
        by_job = defaultdict(list)
        for t in tasks:
            by_job[t.job_id].append(t)
        running = defaultdict(int)
        for att in sim.attempts.values():
            if att.status == "running":
                running[att.task.job_id] += 1
        progress = True
        while progress and by_job:
            progress = False
            # job with min share that still has a placeable task
            order = sorted(by_job, key=lambda j: (
                running[j] / max(sim.jobs[j].priority + 1, 1), j))
            for jid in order:
                queue = by_job[jid]
                placed_idx = None
                for i, t in enumerate(queue):
                    nodes = self._free_nodes(t.kind)
                    if nodes:
                        self.launch(t, self._pick_node(t, nodes))
                        running[jid] += 1
                        placed_idx = i
                        break
                if placed_idx is not None:
                    queue.pop(placed_idx)
                    if not queue:
                        del by_job[jid]
                    progress = True
                    break
        self._requeue([t for q in by_job.values() for t in q])


class CapacityScheduler(Scheduler):
    """Two queues split by job priority with capacity caps, FIFO within a queue.
    Reproduces the documented over-memory kill: when a node oversubscribes memory,
    the newest task on it is killed (counted as a failed attempt) — the behaviour
    the paper cites to explain Capacity's task-failure profile."""
    name = "capacity"
    queue_caps = (0.5, 0.5)

    def schedule(self):
        sim = self.sim
        tasks = self._runnable()
        if not tasks:
            self._memory_police()
            return
        queues = ([], [])
        for t in tasks:
            q = 0 if sim.jobs[t.job_id].priority >= 2 else 1
            queues[q].append(t)
        total_slots = sum(n.spec.map_slots + n.spec.reduce_slots
                          for n in sim.nodes if n.known_alive)
        used = defaultdict(int)
        for att in sim.attempts.values():
            if att.status == "running":
                q = 0 if sim.jobs[att.task.job_id].priority >= 2 else 1
                used[q] += 1
        leftovers = []
        for qi, queue in enumerate(queues):
            cap = int(self.queue_caps[qi] * total_slots) + 1
            queue.sort(key=lambda t: (sim.jobs[t.job_id].submit_time, t.tid))
            for t in queue:
                if used[qi] >= cap:
                    leftovers.append(t)
                    continue
                nodes = self._free_nodes(t.kind)
                if not nodes:
                    leftovers.append(t)
                    continue
                self.launch(t, self._pick_node(t, nodes))
                used[qi] += 1
        self._requeue(leftovers)
        self._memory_police()

    def _memory_police(self):
        sim = self.sim
        for n in sim.nodes:
            if not n.tt_alive:
                continue
            # crude memory model: each running task needs ~1.2 GB
            need = len(n.running) * 1.2
            if need <= n.spec.mem_gb:
                continue
            # kill the newest attempt
            newest = max((sim.attempts[a] for a in n.running),
                         key=lambda a: a.start, default=None)
            if newest is None:
                continue
            newest.status = "failed"
            sim._release(newest)
            sim._charge_resources(newest, sim.now - newest.start)
            newest.task.failed_attempts += 1
            n.failed_count += 1
            n.record_failure(sim.now)
            if sim.trace is not None:
                sim.trace.record_outcome(sim, newest, False)
            sim._task_attempt_failed(newest.task)


BASELINES = {"fifo": FIFOScheduler, "fair": FairScheduler,
             "capacity": CapacityScheduler}
