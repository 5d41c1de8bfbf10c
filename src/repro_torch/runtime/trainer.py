"""ATLAS-driven elastic training runtime — the paper's scheduler operating a real
training job on a (simulated) fleet of hosts.

Mapping (DESIGN.md §2): TPU hosts = TaskTrackers; the schedulable task = a
*step-shard* (one data-parallel group's microbatch for one step).  Per step:

  1. heartbeat tick: liveness the coordinator *believes*; the adaptive controller
     (paper §4.2) shortens the interval under failure bursts.
  2. ATLAS placement: per-host failure prediction (same Table-1-style features:
     recent co-located failures, heartbeat RTT, restarts, load).  Suspect hosts get
     their shard *speculatively duplicated* onto the healthiest spare host —
     first-success-wins becomes grad-quorum: the step commits as long as every
     shard has at least one surviving copy.
  3. the jitted train step runs on the mesh of live hosts; a host dying mid-step
     with an un-duplicated shard loses the step -> rollback to the last checkpoint
     and elastic re-mesh (the fleet shrinks; state re-shards via CheckpointManager).
  4. hazard-driven checkpointing (beyond-paper): when predicted fleet hazard
     exceeds a threshold, snapshot immediately — insurance gets cheaper than replay.

The same loop runs unchanged on real hardware (the chaos process is replaced by
actual failure notifications); on CPU it runs a reduced model over N fake hosts.

The port's copy of ``repro/runtime/trainer.py``: the same chaos process (the
same ``random.Random(seed)`` draws in the same order), heartbeats, ATLAS
placement with the port's ``ALL_MODELS`` GLM refitted online, duplication,
hazard checkpoints and rollbacks, around the port's train step on
``device`` (None: CUDA, under the port's device rule).  The step is not
compiled; it runs the CUDA kernels under autograd on the card."""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.kernels.ops import resolve_device
from repro_torch.ml.models import ALL_MODELS
from repro_torch.models.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig


@dataclasses.dataclass
class HostState:
    hid: int
    alive: bool = True
    known_alive: bool = True
    health: float = 1.0
    down_until: int = -1
    restarts: int = 0
    recent_failures: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=16))
    shards_done: int = 0

    def rtt(self) -> float:
        return 1.0 + 0.8 * (1.0 - self.health)


@dataclasses.dataclass
class RuntimeConfig:
    n_hosts: int = 8
    steps: int = 60
    checkpoint_every: int = 10
    heartbeat_every: int = 5          # steps between liveness sweeps (adaptive)
    hb_min: int = 1
    hb_max: int = 10
    atlas: bool = True                # predict + duplicate + hazard checkpoints
    threshold: float = 0.5
    hazard_ckpt_threshold: float = 0.35   # P(any shard lost next step)
    fail_rate: float = 0.02           # per-host per-step base kill prob
    degrade_rate: float = 0.05        # per-host per-step health-degrade prob
    outage_steps: tuple = (5, 15)
    algo: str = "Glm"                 # online model (fast to refit every few steps)
    refit_every: int = 8
    seed: int = 0


def _host_features(h: HostState, step: int, hb_interval: int) -> np.ndarray:
    return np.array([
        len([1 for s in h.recent_failures if step - s <= 20]),
        h.rtt(),
        float(h.restarts),
        float(h.shards_done % 97) / 97.0,   # benign load proxy
        1.0,
    ], dtype=np.float32)


class ElasticTrainer:
    def __init__(self, arch: ArchConfig, rcfg: RuntimeConfig, ckpt_dir,
                 data_cfg: DataConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        self.arch = arch
        self.rcfg = rcfg
        self.rng = random.Random(rcfg.seed)
        self.hosts = [HostState(i) for i in range(rcfg.n_hosts)]
        self.hb_interval = rcfg.heartbeat_every
        self.ckpt = CheckpointManager(ckpt_dir, keep=2, async_write=False)
        self.data = SyntheticStream(data_cfg or DataConfig(
            vocab_size=arch.vocab_size, seq_len=128,
            global_batch=rcfg.n_hosts * 2, seed=rcfg.seed))
        self.opt_cfg = AdamWConfig(warmup_steps=5, total_steps=rcfg.steps)
        self.step_fn, _ = make_train_step(arch, self.opt_cfg)
        self.state = init_train_state(arch, rcfg.seed, self.opt_cfg,
                                      device=self.device)
        # online predictor state
        self._X: list = []
        self._y: list = []
        self.model = None
        # metrics
        self.committed = 0
        self.rollbacks = 0
        self.lost_steps = 0
        self.duplicated = 0
        self.wasted_shards = 0
        self.checkpoints = 0
        self.hazard_checkpoints = 0
        self.losses: list = []

    # ------------------------------------------------------------------ fleet
    def _alive(self):
        return [h for h in self.hosts if h.alive]

    def _known_alive(self):
        return [h for h in self.hosts if h.known_alive and h.alive or
                (h.known_alive and not h.alive)]  # what the coordinator believes

    def _chaos_tick(self, step: int):
        for h in self.hosts:
            if not h.alive:
                if step >= h.down_until:
                    h.alive = True
                    h.health = 1.0
                    h.restarts += 1
                continue
            if self.rng.random() < self.rcfg.degrade_rate:
                h.health = max(0.1, h.health - self.rng.uniform(0.2, 0.5))
            elif h.health < 1.0 and self.rng.random() < 0.3:
                h.health = min(1.0, h.health + 0.3)

    def _mid_step_failure(self, h: HostState, step: int) -> bool:
        p = self.rcfg.fail_rate + 0.12 * (1.0 - h.health)
        if self.rng.random() < p:
            h.alive = False
            h.down_until = step + self.rng.randint(*self.rcfg.outage_steps)
            h.recent_failures.append(step)  # 'step' here is the tick
            return True
        return False

    def _heartbeat(self, step: int):
        newly_dead = 0
        for h in self.hosts:
            if h.known_alive and not h.alive:
                newly_dead += 1
            h.known_alive = h.alive
        # paper §4.2 rule at fleet scale: >1/3 failed within a window -> halve
        if newly_dead > len(self.hosts) / 3:
            self.hb_interval = max(self.rcfg.hb_min, self.hb_interval // 2)
        else:
            self.hb_interval = min(self.rcfg.hb_max,
                                   int(self.hb_interval * 1.5) or 1)

    # ------------------------------------------------------------------ predictor
    def _p_success(self, hosts, step) -> np.ndarray:
        if self.model is None:
            return np.ones(len(hosts), np.float32)
        X = np.stack([_host_features(h, step, self.hb_interval) for h in hosts])
        return self.model.predict_proba(X)

    def _record(self, h: HostState, step: int, ok: bool):
        self._X.append(_host_features(h, step, self.hb_interval))
        self._y.append(1.0 if ok else 0.0)

    def _maybe_refit(self, tick):
        if not self.rcfg.atlas or tick % self.rcfg.refit_every:
            return
        if len(self._y) >= 40 and len(set(self._y)) > 1:
            X = np.stack(self._X[-2000:])
            y = np.asarray(self._y[-2000:], np.float32)
            self.model = ALL_MODELS[self.rcfg.algo](device=self.device).fit(
                X, y)

    # ------------------------------------------------------------------ loop
    def run(self) -> dict:
        rcfg = self.rcfg
        t0 = time.time()
        step = int(self.state["step"])
        self.ckpt.save(step, self.state, block=True)
        self.checkpoints += 1
        tick = 0  # wall-time ticks: outages heal in ticks even when steps stall
        max_ticks = rcfg.steps * 20
        while step < rcfg.steps and tick < max_ticks:
            tick += 1
            self._chaos_tick(tick)
            if tick % max(self.hb_interval, 1) == 0:
                self._heartbeat(tick)

            workers = [h for h in self.hosts if h.known_alive]
            if not workers:
                self._heartbeat(tick)  # forced sweep; wait for recovery
                workers = [h for h in self.hosts if h.alive]
                if not workers:
                    self.lost_steps += 1
                    continue

            # ---- ATLAS placement: shard -> host (+ speculative duplicates)
            ps = self._p_success(workers, tick) if rcfg.atlas \
                else np.ones(len(workers), np.float32)
            assignment = {h.hid: [h] for h in workers}  # shard keyed by primary
            if rcfg.atlas:
                order = np.argsort(ps)  # most suspect first
                spares = [workers[i] for i in order[::-1]
                          if ps[i] >= rcfg.threshold]
                for i in order:
                    if ps[i] >= rcfg.threshold or not spares:
                        break
                    spare = spares.pop(0)
                    if spare.hid != workers[i].hid:
                        assignment[workers[i].hid].append(spare)
                        self.duplicated += 1

            # ---- hazard-driven checkpoint (beyond-paper)
            if rcfg.atlas:
                p_loss = 1.0
                for hid, copies in assignment.items():
                    p_all_fail = 1.0
                    for h in copies:
                        p_all_fail *= (rcfg.fail_rate + 0.12 * (1 - self._p_success(
                            [h], tick)[0]))
                    p_loss *= (1.0 - p_all_fail)
                p_any_loss = 1.0 - p_loss
                if p_any_loss > rcfg.hazard_ckpt_threshold and \
                        int(self.state["step"]) > self.ckpt.last_saved_step:
                    self.ckpt.save(int(self.state["step"]), self.state, block=True)
                    self.checkpoints += 1
                    self.hazard_checkpoints += 1

            # ---- run the step (host deaths may strike mid-step)
            batch = self.data.batch(step, 0, 1)  # full global batch on this mesh
            died = [h for h in workers if self._mid_step_failure(h, tick)]
            for h in workers:
                self._record(h, tick, h.alive)
                if h.alive:
                    h.shards_done += 1
            lost_shard = False
            for hid, copies in assignment.items():
                if all(not c.alive for c in copies):
                    lost_shard = True
                self.wasted_shards += sum(1 for c in copies[1:] if c.alive)

            if lost_shard:
                # step lost: rollback + elastic re-mesh (fleet shrank)
                self.rollbacks += 1
                self.lost_steps += 1
                last = self.ckpt.latest_step()
                self.state = self.ckpt.restore(last, self.state)
                step = int(self.state["step"])
                self._maybe_refit(tick)
                continue

            jb = {k: torch.as_tensor(v, device=self.device)
                  for k, v in batch.items()}
            self.state, metrics = self.step_fn(self.state, jb)
            self.losses.append(float(metrics["loss"]))
            self.committed += 1
            step = int(self.state["step"])

            if step % rcfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state, block=True)
                self.checkpoints += 1
            self._maybe_refit(tick)

        return {
            "steps": rcfg.steps,
            "committed": self.committed,
            "rollbacks": self.rollbacks,
            "lost_steps": self.lost_steps,
            "duplicated_shards": self.duplicated,
            "wasted_shards": self.wasted_shards,
            "checkpoints": self.checkpoints,
            "hazard_checkpoints": self.hazard_checkpoints,
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "first_loss": self.losses[0] if self.losses else float("nan"),
            "wall_s": time.time() - t0,
        }

    def _advance_outages(self, step):
        for h in self.hosts:
            if not h.alive and step >= h.down_until:
                h.alive = True
                h.restarts += 1
