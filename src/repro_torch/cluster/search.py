"""Adversarial scenario search — where does ATLAS stop paying for itself?

The paper evaluates ATLAS on a handful of hand-picked chaos regimes (§5); this
module searches the *typed scenario space* (repro_torch.cluster.scenarios) for
regimes that maximise **ATLAS regret** — the seed-paired degradation of
ATLAS-<base> relative to its base scheduler on identical scenario bytes:

    regret = w_tasks * (pct_tasks_failed[atlas] - pct_tasks_failed[base])
           + w_jobs  * (pct_jobs_failed[atlas]  - pct_jobs_failed[base])
           + w_makespan * 100 * (sim_time[atlas] - sim_time[base])
                              / max(sim_time[base], 1)

averaged over seeds.  Positive regret = ATLAS made things worse; the search is
a budgeted hill-climb (``ScenarioSpec.perturb``) with random restarts
(``ScenarioSpec.sample``) after ``restart_after`` non-improving evaluations.

Every candidate is evaluated through the *existing* fleet engine
(``run_sweep``: two-wave training-trace reuse, process pool, per-cell CRC32
seeds) under a ``scenario_scope`` registration with fixed synthetic names, so
every candidate sees byte-identical per-seed workload + failure storms and the
paired delta is a true like-for-like comparison.  With ``check_invariants``
(default on) every evaluation doubles as a model-checking run — a regime that
breaks a scheduler invariant is a bug report, not just a bad regime.

Determinism + resumability: the iteration-``i`` move is drawn from
``random.Random(cell_seed("search", seed, i))`` and acceptance state is a pure
function of the eval ledger, so replaying ``experiments/SEARCH.json`` (written
atomically after every eval) resumes bit-for-bit: run 1 eval, resume for 2
more == run 3 straight.

The device every evaluation's predictors fit and score on is an argument of
``run_search`` / ``evaluate``, not a ``SearchConfig`` field: the config is
written into ``SEARCH.json``, whose bytes do not depend on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import random

import repro_torch
from repro_torch.cluster.fleet import (SweepSpec, _round_floats, cell_seed,
                                       run_sweep)
from repro_torch.cluster.scenarios import ScenarioSpec, make_spec, scenario_scope
from repro_torch.kernels.ops import resolve_device

# fixed synthetic registry names: part of every cell's env_key, so keeping
# them constant keeps per-seed chaos/workload/sim seeds identical across
# candidates (paired comparisons stay seed-matched along the whole search)
SEARCH_NAME = "search"


def _r6(x) -> float:
    return round(float(x), 6)


@dataclasses.dataclass
class SearchConfig:
    """Knobs of one search run.  ``budget`` counts candidate evaluations; each
    evaluation is a small paired sweep (base + atlas-<base>) over ``seeds``."""
    base: str = "fifo"                # base scheduler; atlas-<base> is paired
    budget: int = 24
    seeds: int = 2                    # seed indices 0..n-1 per evaluation
    fleet_size: int = 20
    scenario: str = "baseline"        # named starting point of the climb
    workload: str = "smoke"
    scale: float = 0.25               # perturbation size (fraction of bounds)
    restart_after: int = 6            # non-improving evals before a restart
    seed: int = 0                     # search-level seed (move generation)
    executor: str = "process"
    workers: int | None = None
    hazard: str = "cluster"
    check_invariants: bool = True
    algo: str = "R.F."
    min_samples: int = 150
    max_train: int = 20000
    heartbeat_interval: float = 600.0
    w_tasks: float = 1.0
    w_jobs: float = 1.0
    w_makespan: float = 0.25

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Candidate evaluation (one paired sweep through the fleet engine)
# ---------------------------------------------------------------------------

def regret_for(base: dict, atlas: dict, cfg: SearchConfig) -> float:
    """Seed-paired ATLAS regret from two metrics dicts (positive = worse)."""
    return _r6(
        cfg.w_tasks * (atlas["pct_tasks_failed"] - base["pct_tasks_failed"])
        + cfg.w_jobs * (atlas["pct_jobs_failed"] - base["pct_jobs_failed"])
        + cfg.w_makespan * 100.0 * (atlas["sim_time"] - base["sim_time"])
        / max(base["sim_time"], 1.0))


def evaluate(point: ScenarioSpec, cfg: SearchConfig, *, log=None,
             device=None) -> dict:
    """Regret of one scenario point: {regret, per_seed, violations, checks}."""
    spec = SweepSpec(
        schedulers=(cfg.base, f"atlas-{cfg.base}"), seeds=cfg.seeds,
        scenarios=(SEARCH_NAME,), workloads=(SEARCH_NAME,),
        fleet_sizes=(cfg.fleet_size,), hazard=cfg.hazard, algo=cfg.algo,
        heartbeat_interval=cfg.heartbeat_interval,
        min_samples=cfg.min_samples, max_train=cfg.max_train,
        check_invariants=cfg.check_invariants)
    with scenario_scope(point, scenario_name=SEARCH_NAME,
                        workload_name=SEARCH_NAME):
        result = run_sweep(spec, executor=cfg.executor, workers=cfg.workers,
                           device=device, log=log or (lambda *a, **k: None))
    cells = {(c["scheduler"], c["seed_index"]): c["metrics"]
             for c in result["cells"]}
    per_seed, violations, checks = [], 0, 0
    for si in spec.seed_indices():
        b = cells[(cfg.base, si)]
        a = cells[(f"atlas-{cfg.base}", si)]
        per_seed.append(regret_for(b, a, cfg))
        for m in (b, a):
            violations += int(m.get("invariant_violations", 0))
            checks += int(m.get("invariant_checks", 0))
    return {"regret": _r6(sum(per_seed) / max(len(per_seed), 1)),
            "per_seed": per_seed, "violations": violations, "checks": checks}


# ---------------------------------------------------------------------------
# Hill-climb state machine (shared by the live loop and ledger replay)
# ---------------------------------------------------------------------------

def _fresh_state() -> dict:
    return {"cur_point": None, "cur_regret": None, "since_improve": 0,
            "best": None}


def _propose(state: dict, cfg: SearchConfig, i: int):
    """Deterministic move for iteration ``i``: the rng derives from the ledger
    coordinates alone, so a resumed search proposes the same candidates."""
    rng = random.Random(cell_seed("search", cfg.seed, i))
    if state["cur_point"] is None:
        return make_spec(cfg.scenario, cfg.workload), "init"
    if state["since_improve"] >= cfg.restart_after:
        return ScenarioSpec.sample(rng, name=f"restart-{i}"), "restart"
    return state["cur_point"].perturb(rng, cfg.scale), "perturb"


def _advance(state: dict, rec: dict) -> None:
    """Fold one completed eval record into the climb state (used identically
    while searching and while replaying a ledger on resume)."""
    if rec["accepted"]:
        state["cur_point"] = ScenarioSpec.from_dict(rec["point"])
        state["cur_regret"] = rec["regret"]
        state["since_improve"] = 0
    else:
        state["since_improve"] += 1
    if state["best"] is None or rec["regret"] > state["best"]["regret"]:
        state["best"] = rec


def _accepts(state: dict, origin: str, regret: float) -> bool:
    if origin in ("init", "restart"):      # unconditional moves
        return True
    return state["cur_regret"] is None or regret > state["cur_regret"]


# ---------------------------------------------------------------------------
# Ledger (atomic, resumable) + rendering
# ---------------------------------------------------------------------------

def search_json(result: dict) -> str:
    return json.dumps(_round_floats(result), indent=2, sort_keys=True) + "\n"


def _write_atomic(path: pathlib.Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _ranking(evals: list[dict], top: int = 10) -> list[dict]:
    worst = sorted(evals, key=lambda e: (-e["regret"], e["i"]))[:top]
    return [{"i": e["i"], "origin": e["origin"], "regret": e["regret"],
             "violations": e["violations"],
             "intensity": e["point"]["chaos"]["intensity"],
             "mean_interarrival": e["point"]["chaos"]["mean_interarrival"],
             "burst_prob": e["point"]["chaos"]["burst_prob"]}
            for e in worst]


def _result(cfg: SearchConfig, evals: list[dict], best: dict | None) -> dict:
    return {"config": cfg.to_json(),
            "provenance": {"pr": repro_torch.PR_TAG},
            "n_evals": len(evals), "evals": evals,
            "best": best, "ranking": _ranking(evals)}


def search_markdown(result: dict) -> str:
    cfg = result["config"]
    lines = [
        "# Adversarial scenario search",
        "",
        f"Objective: ATLAS regret of `atlas-{cfg['base']}` vs `{cfg['base']}`"
        f" (w_tasks={cfg['w_tasks']}, w_jobs={cfg['w_jobs']},"
        f" w_makespan={cfg['w_makespan']}); positive = ATLAS worse.",
        f"Budget {cfg['budget']} evals x {cfg['seeds']} seeds, "
        f"{cfg['fleet_size']}-node fleet, invariants "
        f"{'on' if cfg['check_invariants'] else 'off'}.",
        "",
        "| rank | eval | origin | regret | violations | intensity "
        "| interarrival | burst_prob |",
        "|---:|---:|---|---:|---:|---:|---:|---:|",
    ]
    for rank, e in enumerate(result["ranking"], 1):
        lines.append(
            f"| {rank} | {e['i']} | {e['origin']} | {e['regret']:.3f} "
            f"| {e['violations']} | {e['intensity']:.3f} "
            f"| {e['mean_interarrival']:.0f} | {e['burst_prob']:.3f} |")
    best = result["best"]
    if best is not None:
        lines += ["",
                  f"Worst regime: eval {best['i']} "
                  f"(regret {best['regret']:.3f}, origin {best['origin']}).",
                  "```json",
                  json.dumps(_round_floats(best["point"]), indent=2,
                             sort_keys=True),
                  "```"]
    return "\n".join(lines) + "\n"


# operational knobs a resume may legitimately change: a bigger budget extends
# the climb, and the executor/worker choice never affects cell results (the
# fleet engine guarantees byte-identical cells across executors)
_RESUME_FREE = ("budget", "executor", "workers")


def _load_ledger(path: pathlib.Path, cfg: SearchConfig) -> list[dict]:
    data = json.loads(path.read_text())
    old = {k: v for k, v in (data.get("config") or {}).items()
           if k not in _RESUME_FREE}
    new = {k: v for k, v in cfg.to_json().items() if k not in _RESUME_FREE}
    if old != new:
        raise ValueError(
            f"{path} was written by a different SearchConfig; "
            "delete it or match the original parameters to resume")
    return data["evals"]


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_search(cfg: SearchConfig, *, out_dir=None, resume: bool = True,
               device=None, log=print) -> dict:
    """Run (or resume) the climb up to ``cfg.budget`` evaluations, every
    predictor on ``device`` (None: CUDA, raising without a GPU).

    Writes ``SEARCH.json`` atomically after every evaluation when ``out_dir``
    is given, so an interrupted search loses at most the in-flight eval."""
    device = str(resolve_device(device))
    out_path = md_path = None
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path = out_dir / "SEARCH.json"
        md_path = out_dir / "SEARCH.md"

    state = _fresh_state()
    evals: list[dict] = []
    if resume and out_path is not None and out_path.exists():
        evals = _load_ledger(out_path, cfg)[:cfg.budget]
        for rec in evals:
            _advance(state, rec)
        if evals:
            log(f"[search] resumed {len(evals)} evals from {out_path}")

    for i in range(len(evals), cfg.budget):
        point, origin = _propose(state, cfg, i)
        ev = evaluate(point, cfg, device=device)
        accepted = _accepts(state, origin, ev["regret"])
        best_so_far = max(ev["regret"],
                          state["best"]["regret"] if state["best"] else
                          ev["regret"])
        rec = {"i": i, "origin": origin, "point": point.to_dict(),
               "regret": ev["regret"], "per_seed": ev["per_seed"],
               "violations": ev["violations"], "checks": ev["checks"],
               "accepted": accepted, "best_so_far": _r6(best_so_far)}
        evals.append(rec)
        _advance(state, rec)
        log(f"[search] eval {i + 1}/{cfg.budget} ({origin}): "
            f"regret {ev['regret']:+.3f}"
            + (" ACCEPT" if accepted else "")
            + (f" [{ev['violations']} INVARIANT VIOLATIONS]"
               if ev["violations"] else ""))
        if out_path is not None:
            result = _result(cfg, evals, state["best"])
            _write_atomic(out_path, search_json(result))
            _write_atomic(md_path, search_markdown(result))

    result = _result(cfg, evals, state["best"])
    if out_path is not None:
        _write_atomic(out_path, search_json(result))
        _write_atomic(md_path, search_markdown(result))
        log(f"[search] wrote {out_path} and {md_path}")
    return result
