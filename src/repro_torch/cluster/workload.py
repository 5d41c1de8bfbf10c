"""Workload generation — the paper's job mix (§4.1.1, §5.1):

single jobs (WordCount / TeraGen / TeraSort with varying map/reduce counts) plus
chained jobs (sequential, parallel and mixed chains of 3-20 units), over large input
files split into HDFS blocks (block count drives the map count, as in the paper)."""

from __future__ import annotations

import dataclasses
import random

from repro_torch.cluster.simulator import Job, MAP, REDUCE, Task

# per-unit duration profile: (map base secs, reduce base secs, input MB per map)
# scaled so baseline job times land near the paper's (~20 min avg, ~2.3 min maps)
JOB_PROFILES = {
    "wordcount": (110.0, 170.0, 64.0),
    "teragen": (75.0, 0.0, 128.0),     # generation: map-only
    "terasort": (140.0, 260.0, 128.0),
}


@dataclasses.dataclass
class WorkloadConfig:
    n_single: int = 48
    n_chains: int = 8
    chain_len_range: tuple = (3, 8)
    maps_range: tuple = (6, 16)
    reduces_range: tuple = (4, 15)
    max_map_attempts: int = 4
    max_reduce_attempts: int = 4
    submit_horizon: float = 14400.0     # jobs arrive over this window
    n_nodes: int = 13                   # slaves holding HDFS blocks
    replication: int = 3
    seed: int = 7


def _make_job(jid: int, jtype: str, rng: random.Random, cfg: WorkloadConfig,
              submit: float, chain_id=-1, chain_kind="single", chain_pos=0) -> Job:
    mb, rb, in_mb = JOB_PROFILES[jtype]
    n_maps = rng.randint(*cfg.maps_range)
    n_reduces = 0 if jtype == "teragen" else rng.randint(*cfg.reduces_range)
    job = Job(jid=jid, jtype=jtype, n_maps=n_maps, n_reduces=n_reduces,
              priority=rng.randint(0, 2), chain_id=chain_id,
              chain_kind=chain_kind, chain_pos=chain_pos, submit_time=submit)
    tid = 0
    for _ in range(n_maps):
        blocks = tuple(rng.sample(range(cfg.n_nodes), k=min(cfg.replication,
                                                            cfg.n_nodes)))
        job.tasks[tid] = Task(
            job_id=jid, tid=tid, kind=MAP,
            duration_base=mb * (0.7 + 0.6 * rng.random()),
            input_mb=in_mb * (0.7 + 0.6 * rng.random()),
            block_nodes=blocks, max_attempts=cfg.max_map_attempts)
        tid += 1
    for _ in range(n_reduces):
        job.tasks[tid] = Task(
            job_id=jid, tid=tid, kind=REDUCE,
            duration_base=rb * (0.7 + 0.6 * rng.random()),
            input_mb=in_mb * n_maps / max(n_reduces, 1) * 0.4,
            block_nodes=(), max_attempts=cfg.max_reduce_attempts)
        tid += 1
    return job


def make_workload(cfg: WorkloadConfig | None = None):
    """Returns (immediate_jobs, deferred_sequential) — deferred lists must be handed
    to the simulator via ``install_chains``."""
    cfg = cfg or WorkloadConfig()
    rng = random.Random(cfg.seed)
    types = list(JOB_PROFILES)
    jobs: list[Job] = []
    deferred: dict[int, list[Job]] = {}
    jid = 0
    for _ in range(cfg.n_single):
        t = rng.uniform(0, cfg.submit_horizon)
        jobs.append(_make_job(jid, rng.choice(types), rng, cfg, t))
        jid += 1
    for c in range(cfg.n_chains):
        kind = rng.choice(["sequential", "parallel", "mix"])
        n = rng.randint(*cfg.chain_len_range)
        t0 = rng.uniform(0, cfg.submit_horizon)
        chain_jobs = []
        for pos in range(n):
            j = _make_job(jid, rng.choice(types), rng, cfg, t0,
                          chain_id=c, chain_kind=kind, chain_pos=pos)
            jid += 1
            chain_jobs.append(j)
        if kind == "parallel":
            jobs.extend(chain_jobs)
        elif kind == "sequential":
            jobs.append(chain_jobs[0])
            deferred[c] = chain_jobs[1:]
        else:  # mix: first half parallel now, second half sequential after
            half = max(1, n // 2)
            jobs.extend(chain_jobs[:half])
            if chain_jobs[half:]:
                deferred[c] = chain_jobs[half:]
    return jobs, deferred


def install(sim, workload):
    jobs, deferred = workload
    sim.submit_workload(jobs)
    for cid, chain in deferred.items():
        sim.blocked_chains[cid] = list(chain)
