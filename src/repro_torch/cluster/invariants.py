"""Per-tick machine-checkable scheduler invariants — the model-checking layer.

The companion line of work on Hadoop schedulers (PAPERS.md, arXiv 2109.04196)
verifies scheduler behaviour by model checking + simulation; this module is the
simulation half of that idea for our fast simulator: a catalogue of predicates
that must hold at every step of *any* run, checked live behind a cheap
``check_invariants`` flag so every adversarial-search evaluation doubles as a
model-checking run.

Catalogue (see docs/SEARCH.md for the full rationale):

  launch-time (every ``Simulator.launch``, O(1)):
    L1  free slot: the target node has a free slot of the task's kind
    L2  liveness: no launch on a node the JobTracker knows is dead unless the
        TaskTracker is actually up (ATLAS's active probe may legally launch on
        an up node the JT hasn't re-learned yet; a launch that is dead in BOTH
        views can never run)
    L3  status: non-speculative launches take a *pending* task, speculative
        copies shadow a *running* one

  per-event (every simulator event, O(1)):
    E1  time is monotone non-decreasing
    E2  the running-job counter never goes negative

  full sweep (every ``sweep_every`` events + at end of run, O(nodes+tasks)):
    S1  slot conservation: 0 <= running_maps <= map_slots (same for reduces)
        and |node.running| == running_maps + running_reduces
    S2  index consistency: the incremental free-slot / known-alive index sets
        exactly mirror per-node state
    S3  node counters (failed/finished/restarts) are monotone
    S4  outage => recovery: every node in an outage state (TT/DN dead,
        suspended, degraded network) has >= 1 chaos recovery scheduled
        (``ChaosInjector.pending_recoveries``); latent health is excluded —
        recovery restores the *degradation amount*, not health == 1.0
    S5  penalty-box monotonicity: enqueue timestamps are non-decreasing along
        the deque and every boxed task has penalty >= 1
    S6  task counters (failed/finished attempts, reschedules, penalty) are
        monotone

Violations are recorded (bounded examples + a total count) and surface in
``Simulator.metrics()['invariant_violations']``; ``raise_on_violation=True``
turns the first one into an :class:`InvariantViolation` for property tests.
The checker only *reads* simulator state — decisions and results are
byte-identical with checking on or off.
"""

from __future__ import annotations

from repro_torch.cluster import simulator as S


class InvariantViolation(AssertionError):
    """A per-tick scheduler invariant failed (raise_on_violation mode)."""


class InvariantChecker:
    """Attachable invariant monitor for one :class:`Simulator` run.

    Cost model: the E1/E2 per-event checks are INLINED in the simulator run
    loop (a couple of compares on loop locals); this class is only entered on
    a violation, a sweep boundary, or a launch.  The O(nodes + tasks) full
    sweep runs every ``max(sweep_every, 2 * n_nodes)`` events plus once at end
    of run, so its amortised cost stays O(1) per event at any fleet size —
    together this keeps the checker inside the <=10% runtime budget on
    500-node cells.
    """

    def __init__(self, *, sweep_every: int = 128,
                 raise_on_violation: bool = False, max_examples: int = 16):
        self.sweep_every = max(int(sweep_every), 1)
        self.raise_on_violation = raise_on_violation
        self.max_examples = max_examples
        self.n_checks = 0          # events + launches + sweeps examined
        self.n_sweeps = 0
        self.n_violations = 0
        self.violations: list[dict] = []   # bounded examples
        self.sweep_interval = self.sweep_every   # effective; set in bind()
        self._node_mono: list[tuple] = []
        self._task_mono: dict = {}

    # ------------------------------------------------------------------ wiring
    def bind(self, sim: "S.Simulator"):
        self.sim = sim
        self._node_mono = [(0, 0, 0)] * len(sim.nodes)
        # amortise the O(nodes) sweep to O(1)/event regardless of fleet size
        self.sweep_interval = max(self.sweep_every, 2 * len(sim.nodes))

    def _viol(self, sim, name: str, detail: str):
        self.n_violations += 1
        if len(self.violations) < self.max_examples:
            self.violations.append(
                {"invariant": name, "t": round(sim.now, 3), "detail": detail})
        if self.raise_on_violation:
            raise InvariantViolation(f"[{name}] t={sim.now:.1f}: {detail}")

    # ------------------------------------------------------------------ launch
    def check_launch(self, sim, task, node, speculative: bool):
        self.n_checks += 1
        if task.kind == S.MAP:
            free = node.spec.map_slots - node.running_maps
        else:
            free = node.spec.reduce_slots - node.running_reduces
        if free <= 0:
            self._viol(sim, "launch_no_free_slot",
                       f"{task.kind} task {task.key} on node {node.nid} "
                       f"with no free {task.kind} slot")
        if not node.known_alive and not (node.tt_alive and not node.suspended):
            self._viol(sim, "launch_on_dead_node",
                       f"task {task.key} on node {node.nid} "
                       f"(known_alive=False, tt_alive={node.tt_alive}, "
                       f"suspended={node.suspended})")
        if speculative:
            if task.status != "running":
                self._viol(sim, "speculative_copy_of_nonrunning",
                           f"speculative copy of {task.status} task {task.key}")
        elif task.status != "pending":
            self._viol(sim, "launch_of_nonpending",
                       f"primary launch of {task.status} task {task.key}")

    # ------------------------------------------------------------------ events
    def on_event(self, sim, prev_now: float):
        """Slow path behind the inlined E1/E2 compares in ``Simulator.run``:
        entered only on a violation or a sweep boundary."""
        if sim.now < prev_now:
            self._viol(sim, "time_regression",
                       f"now {sim.now} < previous event time {prev_now}")
        if sim.n_running_jobs < 0:
            self._viol(sim, "negative_running_jobs",
                       f"n_running_jobs == {sim.n_running_jobs}")
        self.full_sweep(sim)

    def finish(self, sim, n_events: int = 0):
        self.n_checks += n_events      # inlined per-event checks, tallied once
        self.full_sweep(sim)

    # ------------------------------------------------------------------ sweep
    def full_sweep(self, sim):
        self.n_checks += 1
        self.n_sweeps += 1
        free_map, free_reduce = sim._free_map, sim._free_reduce
        known = sim._known_alive
        pend_rec = getattr(sim.chaos, "pending_recoveries", None)
        node_mono = self._node_mono
        for n in sim.nodes:
            rm, rr = n.running_maps, n.running_reduces
            if not 0 <= rm <= n.spec.map_slots:
                self._viol(sim, "map_slot_conservation",
                           f"node {n.nid}: running_maps={rm} "
                           f"slots={n.spec.map_slots}")
            if not 0 <= rr <= n.spec.reduce_slots:
                self._viol(sim, "reduce_slot_conservation",
                           f"node {n.nid}: running_reduces={rr} "
                           f"slots={n.spec.reduce_slots}")
            if len(n.running) != rm + rr:
                self._viol(sim, "running_set_mismatch",
                           f"node {n.nid}: |running|={len(n.running)} "
                           f"!= maps {rm} + reduces {rr}")
            if (n.nid in free_map) != (rm < n.spec.map_slots):
                listed = "in" if n.nid in free_map else "out"
                self._viol(sim, "free_map_index_stale",
                           f"node {n.nid}: index={listed} "
                           f"running_maps={rm}/{n.spec.map_slots}")
            if (n.nid in free_reduce) != (rr < n.spec.reduce_slots):
                listed = "in" if n.nid in free_reduce else "out"
                self._viol(sim, "free_reduce_index_stale",
                           f"node {n.nid}: index={listed} "
                           f"running_reduces={rr}/{n.spec.reduce_slots}")
            if (n.nid in known) != n.known_alive:
                self._viol(sim, "known_alive_index_stale",
                           f"node {n.nid}: known_alive={n.known_alive} "
                           f"index={'in' if n.nid in known else 'out'}")
            prev = node_mono[n.nid]
            cur = (n.failed_count, n.finished_count, n.restarts)
            if cur[0] < prev[0] or cur[1] < prev[1] or cur[2] < prev[2]:
                self._viol(sim, "node_counter_regression",
                           f"node {n.nid}: {prev} -> {cur}")
            node_mono[n.nid] = cur
            if pend_rec is not None and (
                    not n.tt_alive or not n.dn_alive or n.suspended
                    or n.net_quality < 1.0) and pend_rec.get(n.nid, 0) <= 0:
                self._viol(sim, "outage_without_recovery",
                           f"node {n.nid} in outage state "
                           f"(tt={n.tt_alive} dn={n.dn_alive} "
                           f"susp={n.suspended} net={n.net_quality}) "
                           "with no recovery scheduled")
        self._check_penalty_box(sim)
        self._check_task_monotone(sim)

    def _check_penalty_box(self, sim):
        box = getattr(sim.scheduler, "penalty_box", None)
        if not box:
            return
        last_t = None
        for key, enq in box:
            if last_t is not None and enq < last_t:
                self._viol(sim, "penalty_box_order",
                           f"enqueue time {enq} after {last_t} for {key}")
            last_t = enq
            task = sim._task_by_key(key)
            if task is not None and task.penalty < 1:
                self._viol(sim, "penalty_box_unpenalized",
                           f"boxed task {key} has penalty={task.penalty}")

    def _check_task_monotone(self, sim):
        mono = self._task_mono
        for job in sim.jobs.values():
            for task in job.tasks.values():
                cur = (task.failed_attempts, task.finished_attempts,
                       task.reschedules, task.penalty)
                prev = mono.get(task.key)
                if prev is not None and any(c < p for c, p in zip(cur, prev)):
                    self._viol(sim, "task_counter_regression",
                               f"task {task.key}: {prev} -> {cur}")
                mono[task.key] = cur

    # ------------------------------------------------------------------ report
    def summary(self) -> dict:
        return {"checks": self.n_checks, "sweeps": self.n_sweeps,
                "violations": self.n_violations,
                "examples": list(self.violations)}
