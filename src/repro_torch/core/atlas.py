"""ATLAS — the paper's Algorithm 1, wrapping any base scheduler.

Control flow per (task -> node) decision the base scheduler proposes:

  predict outcome (map/reduce model, Table-1 features)
  ├─ SUCCESS ──> Check-Availability(TT, DN)  (active probe; a dead node found here
  │              is reported to the JobTracker *before* its heartbeat timeout)
  │     ├─ alive ──> Check-Availability-Slots ──> Execute
  │     │             └─ none free: wait; on time-out -> queue + PENALTY
  │     └─ dead  ──> notify JT; on time-out -> queue + PENALTY
  └─ FAIL ────> enough resources? Execute-Speculatively(Task, N) on the N nodes
                with the highest predicted success; else queue + PENALTY

plus (running alongside): the adaptive heartbeat controller (§4.2) and periodic
model retraining (every 10 simulated minutes, §5.1)."""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.cluster.simulator import EV_RETRAIN, MAP
from repro_torch.core.heartbeat import HeartbeatController
from repro_torch.core.predictor import TaskPredictor
from repro_torch.sched.base import Scheduler, SchedulerStats


@dataclasses.dataclass
class AtlasStats(SchedulerStats):
    """ATLAS's ``stats()`` schema: the shared counters plus Algorithm-1
    accounting.  The refresher trio is ``None`` (omitted from ``to_dict``)
    when no drift-aware refresh loop is attached, so cell stats stay
    byte-identical whichever lifecycle ran the model."""
    predictions: int = 0
    predicted_fail: int = 0
    relocations: int = 0
    speculative_launches: int = 0
    penalties: int = 0
    dead_probes: int = 0
    hb_adjustments: int = 0
    model_fits: int = 0
    refreshes: int | None = None
    promotions: int | None = None
    rollbacks: int | None = None
    # decisions taken while the serving predictor was degraded (broker
    # unreachable past its retry budget, scoring fell back to the paper's
    # schedule-anyway default); None/omitted on every healthy run so clean
    # cell stats keep their historical bytes
    degraded_decisions: int | None = None


class ATLASScheduler(Scheduler):
    """ATLAS integrates with any Hadoop base scheduler (FIFO/Fair/Capacity)."""

    def __init__(self, base: Scheduler, *, predictor: TaskPredictor | None = None,
                 threshold: float = 0.5, n_speculative: int = 2,
                 retrain_every: float = 600.0, refresher=None,
                 heartbeat: HeartbeatController | None = None,
                 max_penalty_box: int = 512, penalty_timeout: float = 150.0):
        super().__init__()
        self.base = base
        self.name = f"atlas-{base.name}"
        self.predictor = predictor or TaskPredictor()
        self.threshold = threshold
        self.n_speculative = n_speculative
        self.retrain_every = retrain_every
        self.hb = heartbeat or HeartbeatController()
        # optional drift-aware refresh loop (repro_torch.online.drift):
        # retrains on feature/score drift instead of only the fixed §5.1 clock
        self.refresher = refresher
        if refresher is not None:
            refresher.bind_predictor(self.predictor)
        self.penalty_timeout = penalty_timeout
        self.penalty_box: deque = deque(maxlen=max_penalty_box)
        # counters (reported in EXPERIMENTS.md)
        self.n_predictions = 0
        self.n_predicted_fail = 0
        self.n_speculative_launches = 0
        self.n_relocations = 0
        self.n_penalties = 0
        self.n_dead_probes = 0
        self.n_degraded_decisions = 0

    # ------------------------------------------------------------------ binding
    def bind(self, sim):
        self.sim = sim
        self.base.bind(sim)
        self.base.launch = self._atlas_launch        # intercept Algorithm-1 gate
        if self.refresher is not None:
            sim._push(self.refresher.check_every, EV_RETRAIN, None)
        elif self.retrain_every > 0:
            sim._push(self.retrain_every, EV_RETRAIN, None)

    # ------------------------------------------------------------------ hooks
    def on_tick(self):
        # broker hook: snapshot the schedulable set so every p_success raised
        # during this tick can be served from one primed batch
        self.predictor.begin_tick(
            self.sim, extra_keys=[key for key, _ in self.penalty_box])
        self.base.schedule()
        self._drain_penalty_box()
        self.base.speculate_stragglers()

    def on_heartbeat(self, node):
        self.hb.on_heartbeat(self.sim)
        self.base.on_heartbeat(node)

    def on_retrain(self):
        if self.refresher is not None:
            # drift-aware path: check often, retrain when the monitor (or the
            # staleness clock it keeps) says the environment moved
            if self.sim.trace is not None:
                self.refresher.step(self.sim)
            self.sim._push(self.sim.now + self.refresher.check_every,
                           EV_RETRAIN, None)
            return
        if self.sim.trace is not None:
            self.predictor.fit(self.sim.trace)
        self.sim._push(self.sim.now + self.retrain_every, EV_RETRAIN, None)

    # ------------------------------------------------------------------ Algorithm 1
    def _atlas_launch(self, task, node, *, speculative=False):
        sim = self.sim
        self.n_predictions += 1
        p = self.predictor.p_success(sim, task, node, speculative)
        if getattr(self.predictor, "degraded", False):
            # graceful degradation: the serving path is answering with the
            # untrained-predictor default (p=1.0, schedule anyway) — count
            # the decision so operators can bound the outage's blast radius
            self.n_degraded_decisions += 1

        if p >= self.threshold:
            # ---- predicted SUCCESS: verify TT/DN liveness, then slots
            if not node.tt_alive or node.suspended:
                # active probe found a dead/suspended TT the JT thought alive:
                # notify the JT *now* (stranded attempts fail early and get
                # rescheduled, instead of waiting out the heartbeat)
                self.n_dead_probes += 1
                sim.detect_tt_failure(node)
                alt = self._best_alternative(task, exclude={node.nid})
                if alt is not None:
                    return self.launch(task, alt, speculative=speculative)
                return self._penalize(task)
            if task.kind == MAP and task.block_nodes and not any(
                    sim.nodes[b].dn_alive for b in task.block_nodes):
                # input block unavailable: executing now would fail (DN dead)
                self.n_dead_probes += 1
                return self._penalize(task)
            free = (node.free_map_slots() if task.kind == MAP
                    else node.free_reduce_slots())
            if free <= 0:
                alt = self._best_alternative(task, exclude={node.nid})
                if alt is not None:
                    return self.launch(task, alt, speculative=speculative)
                return self._penalize(task)
            return self.launch(task, node, speculative=speculative)

        # ---- predicted FAIL on the *proposed* node
        self.n_predicted_fail += 1
        if speculative:
            return None  # never multiply a copy that is itself predicted to fail
        # first remedy: reschedule onto a node where the model predicts success
        alt = self._best_alternative(task, exclude={node.nid})
        if alt is not None:
            self.n_relocations += 1
            return self.launch(task, alt, speculative=False)
        # predicted to fail everywhere -> multiple speculative instances, but only
        # with genuine spare capacity (never starve the normal queue)
        return self._execute_speculatively(task)

    def _execute_speculatively(self, task):
        """Launch up to N instances on the nodes with best predicted outcome."""
        sim = self.sim
        cands = self._free_alive_nodes(task)
        if len(cands) < 1 or not self._enough_resources(task, len(cands)):
            return self._penalize(task)
        ps = self.predictor.p_success_nodes(sim, task, cands)
        order = sorted(range(len(cands)), key=lambda i: -ps[i])
        picked = [cands[i] for i in order[: self.n_speculative]]
        att = None
        for j, n in enumerate(picked):
            att = self.launch(task, n, speculative=(j > 0)) or att
            self.n_speculative_launches += int(j > 0)
        return att

    def _penalize(self, task):
        task.penalty += 1
        self.n_penalties += 1
        self.penalty_box.append((task.key, self.sim.now))
        return None

    def _drain_penalty_box(self):
        """Penalised tasks wait (priority lowered) until the cluster has spare
        capacity — then they get the multi-node speculative treatment.  A bounded
        wait (the paper's scheduler time-out) force-launches stragglers on the
        best-predicted node so jobs can't stall forever."""
        sim = self.sim
        budget = 16
        while self.penalty_box and budget > 0:
            key, enq = self.penalty_box[0]
            task = sim._task_by_key(key)
            if task is None or task.status != "pending":
                self.penalty_box.popleft()
                continue
            cands = self._free_alive_nodes(task)
            timed_out = sim.now - enq >= self.penalty_timeout
            spare = len(cands) >= self.n_speculative and not sim.pending
            if not (spare or (timed_out and cands)):
                break
            self.penalty_box.popleft()
            ps = self.predictor.p_success_nodes(sim, task, cands)
            order = sorted(range(len(cands)), key=lambda i: -ps[i])
            n_copies = self.n_speculative if spare else 1
            picked = [cands[i] for i in order[:n_copies]]
            for j, n in enumerate(picked):
                self.launch(task, n, speculative=(j > 0))
                self.n_speculative_launches += int(j > 0)
            budget -= 1

    # ------------------------------------------------------------------ helpers
    def _free_alive_nodes(self, task):
        # ATLAS's active probe view: actually-up nodes with a free slot, read
        # from the simulator's incremental free-slot index (1000-node fleets
        # call this per decision)
        return self.sim.free_nodes(task.kind, liveness="actual")

    def _enough_resources(self, task, n_free: int) -> bool:
        # spare capacity beyond what the normal queue needs right now: multi-
        # speculation must never starve ordinarily-scheduled work
        backlog = len(self.sim.pending)
        return n_free >= self.n_speculative + max(1, backlog)

    def _best_alternative(self, task, exclude=()):
        cands = [n for n in self._free_alive_nodes(task) if n.nid not in exclude]
        if not cands:
            return None
        ps = self.predictor.p_success_nodes(self.sim, task, cands)
        best = max(range(len(cands)), key=lambda i: ps[i])
        if ps[best] < self.threshold:
            return None
        return cands[best]

    def stats(self) -> AtlasStats:
        return AtlasStats(
            launches=self.n_launches,
            speculative_copies=self.n_speculative_copies,
            predictions=self.n_predictions,
            predicted_fail=self.n_predicted_fail,
            relocations=self.n_relocations,
            speculative_launches=self.n_speculative_launches,
            penalties=self.n_penalties,
            dead_probes=self.n_dead_probes,
            hb_adjustments=self.hb.adjustments,
            model_fits=self.predictor.fits,
            # NOTE: dispatch counters live on the predictor/broker, not here —
            # cell stats must be identical whichever batching executor ran them
            **({"refreshes": self.refresher.refreshes,
                "promotions": self.refresher.promotions,
                "rollbacks": self.refresher.rollbacks}
               if self.refresher is not None else {}),
            **({"degraded_decisions": self.n_degraded_decisions}
               if self.n_degraded_decisions else {}),
        )

    def frame_stats(self) -> dict:
        return {"penalty_box": len(self.penalty_box),
                "pred": self.predictor.frame_stats()}
