"""Chaos injection — the AnarchyApe equivalent (Faghri et al., FSaaS).

Injects the same failure classes the paper used on its EMR cluster:
  - kill / suspend TaskTrackers and DataNodes (+ recovery)
  - network slow-down / drop on a node
  - random thread kills inside a TT (transient latent-health degradation)
  - data loss (an HDFS block replica disappears with its DataNode)

Rates are calibrated by a single ``intensity`` knob; intensity=1.0 targets the
paper's Google-trace-derived ceiling (~40% task/job failure rates on the FIFO
baseline — §5.1)."""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict

from repro_torch.cluster import simulator as S


# the paper's 13-slave EMR fleet: ``intensity`` is calibrated against it, so
# per-node hazard scaling is defined relative to this size
REFERENCE_FLEET = 13


@dataclasses.dataclass
class ChaosConfig:
    # intensity 5.0 calibrates the FIFO baseline near the paper's Google-trace
    # ceiling (~30-40% failed jobs); see EXPERIMENTS.md §Calibration
    intensity: float = 5.0
    # hazard scaling across fleet sizes.  "cluster" (default, the historical
    # behaviour) keeps the event rate cluster-wide, so a 1000-node fleet sees
    # the same events/second as the paper's 13 slaves — proportionally ~77x
    # less chaos per node, which silently softens every large --fleet-size
    # cell.  "per-node" scales the event rate by n_nodes/REFERENCE_FLEET
    # (burst footprints stay absolute, so per-node burst hazard scales
    # identically): failure *rates* stay comparable across fleet sizes.
    hazard: str = "cluster"
    mean_interarrival: float = 240.0   # seconds between chaos events at intensity 1
    kill_tt: float = 0.22
    suspend_tt: float = 0.12
    kill_dn: float = 0.16
    net_slow: float = 0.22
    net_drop: float = 0.08
    thread_kill: float = 0.20
    mean_outage: float = 900.0         # node downtime before recovery
    # correlated "power event" bursts (paper §1: power problems bring down large
    # groups of machines at once) — these are what the adaptive heartbeat's
    # 1/3-of-TTs rule reacts to
    burst_prob: float = 0.04
    burst_size: tuple = (4, 7)
    seed: int = 1234


class ChaosInjector:
    def __init__(self, cfg: ChaosConfig | None = None):
        self.cfg = cfg or ChaosConfig()
        if self.cfg.hazard not in ("cluster", "per-node"):
            raise ValueError(f"unknown hazard mode {self.cfg.hazard!r} "
                             "(cluster|per-node)")
        self.rng = random.Random(self.cfg.seed)
        self.sim: S.Simulator | None = None
        self.events_fired = 0
        # outage => recovery bookkeeping (read by the invariant checker):
        # nid -> scheduled-but-unfired recovery closures.  Every injected
        # outage schedules exactly one recovery, so a node stuck in an outage
        # state with a zero count here is a lost-recovery bug.
        self.pending_recoveries: dict[int, int] = defaultdict(int)

    def bind(self, sim: "S.Simulator"):
        self.sim = sim

    def schedule_initial(self):
        self._schedule_next()

    def hazard_scale(self) -> float:
        """Event-rate multiplier: 1 for cluster-wide hazard, fleet-size
        proportional (n/13) in per-node mode."""
        if self.cfg.hazard == "per-node" and self.sim is not None:
            return max(len(self.sim.nodes), 1) / REFERENCE_FLEET
        return 1.0

    def _schedule_next(self):
        rate = self.cfg.intensity * self.hazard_scale()
        lam = self.cfg.mean_interarrival / max(rate, 1e-6)
        dt = self.rng.expovariate(1.0 / lam)
        self.sim._push(self.sim.now + dt, S.EV_CHAOS, None)

    def fire(self, payload):
        if callable(payload):       # a scheduled recovery closure
            payload(None)
            return
        sim = self.sim
        self.events_fired += 1
        c = self.cfg
        if self.rng.random() < c.burst_prob:
            # power event: several TaskTrackers go down at once
            k = self.rng.randint(*c.burst_size)
            victims = self.rng.sample(sim.nodes, min(k, len(sim.nodes)))
            for v in victims:
                self._kill_tt(v, self.rng.expovariate(1.0 / c.mean_outage))
            self._schedule_next()
            return
        node = self.rng.choice(sim.nodes)
        r = self.rng.random()
        outage = self.rng.expovariate(1.0 / c.mean_outage)
        if r < c.kill_tt:
            self._kill_tt(node, outage)
        elif r < c.kill_tt + c.suspend_tt:
            self._suspend(node, outage * 0.5)
        elif r < c.kill_tt + c.suspend_tt + c.kill_dn:
            self._kill_dn(node, outage)
        elif r < c.kill_tt + c.suspend_tt + c.kill_dn + c.net_slow:
            self._net(node, 0.3, outage * 0.7)
        elif r < c.kill_tt + c.suspend_tt + c.kill_dn + c.net_slow + c.net_drop:
            self._net(node, 0.0, outage * 0.4)
        else:
            # thread kill: latent health degradation; recovers after the outage
            amount = 0.35 + 0.3 * self.rng.random()
            node.health = max(0.0, node.health - amount)
            self._recover_later(node, outage, health=amount)
        self._schedule_next()

    # --- helpers: all recoveries are scheduled closures via EV_CHAOS payloads
    def _recover_later(self, node, dt, *, tt=False, dn=False, net=False,
                       susp=False, health: float = 0.0):
        self.pending_recoveries[node.nid] += 1

        def recover(_):
            self.pending_recoveries[node.nid] -= 1
            if tt and not node.tt_alive:
                node.tt_alive = True
                node.restarts += 1
                node.health = min(1.0, node.health + 0.5)
            if dn:
                node.dn_alive = True
            if net:
                node.net_quality = 1.0
            if susp:
                node.suspended = False
            if health:
                # restore the full degradation (no permanent ratchet)
                node.health = min(1.0, node.health + health)
        self.sim._push(self.sim.now + dt, S.EV_CHAOS, recover)

    def fire_payload(self, fn):
        fn(None)

    def _kill_tt(self, node, outage):
        if not node.tt_alive:
            return
        node.tt_alive = False
        node.health = max(0.0, node.health - 0.2)
        # NOTE: the JobTracker does NOT learn this until the next heartbeat
        self._recover_later(node, outage, tt=True)

    def _suspend(self, node, outage):
        node.suspended = True
        self._recover_later(node, outage, susp=True)

    def _kill_dn(self, node, outage):
        node.dn_alive = False
        self._recover_later(node, outage, dn=True)

    def _net(self, node, quality, outage):
        node.net_quality = quality
        self._recover_later(node, outage, net=True)
