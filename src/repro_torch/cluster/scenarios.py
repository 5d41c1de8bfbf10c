"""Typed scenario space: named chaos scenarios + workload shapes + search bounds.

The paper's §5 evaluation (and the follow-up literature: model-checking sweeps of
Hadoop schedulers, Google-trace failure studies) compares schedulers over a
*matrix* of failure regimes, not a single chaos configuration.  Each scenario here
is a named, documented point in that matrix, expressed as a ``ChaosConfig``
template on top of the existing injector:

  baseline          the paper's calibrated default (§5.1 Google-trace ceiling)
  bursty_tt         frequent correlated TaskTracker crash bursts (power events)
  dn_loss           DataNode-dominated failures -> input-block unavailability
  slot_degradation  latent thread-kill degradation: nodes stay up but rot
  net_flap          rapid short network slow-downs/drops (flapping switches)
  rack_failure      rare but huge correlated outages with long recovery
  straggler_heavy   suspensions + slow links: few hard failures, many stragglers
  kitchen_sink      everything at once at high intensity (stress ceiling)

The branch weights feed ``ChaosInjector.fire``'s cumulative draw: kill_tt,
suspend_tt, kill_dn, net_slow, net_drop are consumed in order and the residual
mass is the thread-kill (latent degradation) branch, so weights must sum to <= 1.

Workload shapes are the second declarative axis: named ``WorkloadConfig``
templates (job mix size/shape), including the tiny ``smoke`` shape CI sweeps use.

The canonical unit is ``ScenarioSpec``: a (chaos, workload) pair with
per-parameter ``Bound`` metadata.  The bounds double as the *search space* of the
adversarial driver in ``repro_torch.cluster.search`` — ``perturb``/``sample``
never leave them, and they are calibrated against the Google-trace failure
characterisation (arXiv 2308.02358): event interarrivals of minutes-to-tens-of-
minutes, outages of minutes-to-an-hour, burst footprints up to roughly a rack.

Per-cell seeds are injected by the fleet (``ScenarioSpec.chaos_for_seed``),
never baked into the templates, so one scenario fans out across any number of
seeded repeats.  The older free functions (``scenario_chaos``,
``get_workload_shape``, ``workload_for_seed``) and the ``Scenario`` name remain
as thin deprecated wrappers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import warnings

from repro_torch.cluster.chaos import ChaosConfig
from repro_torch.cluster.workload import WorkloadConfig


# ---------------------------------------------------------------------------
# Parameter bounds — the typed search space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bound:
    """Closed interval for one searchable parameter.

    kind: "float" (linear), "weight" (linear float, part of the branch-mass
    simplex), "int" (scalar integer), or "span" (an (lo, hi) integer pair such
    as ``burst_size``).  ``log=True`` floats mutate multiplicatively — right for
    scale parameters (rates, durations) whose realistic regimes span decades.
    """
    lo: float
    hi: float
    kind: str = "float"
    log: bool = False


# Chaos bounds follow the Google-trace failure characterisation (arXiv
# 2308.02358) and the paper's EMR calibration: event interarrivals from one
# minute to twenty, outages from two minutes to an hour, correlated bursts up
# to ~a rack of the reference 13-slave fleet.
CHAOS_BOUNDS: dict[str, Bound] = {
    "intensity": Bound(0.5, 12.0, log=True),
    "mean_interarrival": Bound(60.0, 1200.0, log=True),
    "kill_tt": Bound(0.0, 0.7, "weight"),
    "suspend_tt": Bound(0.0, 0.7, "weight"),
    "kill_dn": Bound(0.0, 0.7, "weight"),
    "net_slow": Bound(0.0, 0.7, "weight"),
    "net_drop": Bound(0.0, 0.7, "weight"),
    "mean_outage": Bound(120.0, 3600.0, log=True),
    "burst_prob": Bound(0.0, 0.5),
    "burst_size": Bound(1, 12, "span"),
}

# Workload bounds bracket the four named shapes (smoke ... map_heavy) so every
# named scenario is an interior point of the space the search mutates.
WORKLOAD_BOUNDS: dict[str, Bound] = {
    "n_single": Bound(2, 96, "int"),
    "n_chains": Bound(0, 24, "int"),
    "chain_len_range": Bound(2, 20, "span"),
    "maps_range": Bound(2, 32, "span"),
    "reduces_range": Bound(1, 24, "span"),
    "max_map_attempts": Bound(2, 6, "int"),
    "max_reduce_attempts": Bound(2, 6, "int"),
    "submit_horizon": Bound(1200.0, 21600.0, log=True),
}

# branch weights share a simplex: their combined mass is capped below 1 so the
# thread-kill residual branch never fully vanishes from a searched point
WEIGHT_FIELDS = ("kill_tt", "suspend_tt", "kill_dn", "net_slow", "net_drop")
MAX_EVENT_MASS = 0.95


def _r6(x: float) -> float:
    # ledger floats are canonicalised with round(6); rounding at creation time
    # keeps in-memory values identical to resumed-from-JSON values
    return round(float(x), 6)


def _renorm_weights(chaos_kw: dict) -> None:
    mass = sum(chaos_kw[w] for w in WEIGHT_FIELDS)
    if mass > MAX_EVENT_MASS:
        f = MAX_EVENT_MASS / mass
        for w in WEIGHT_FIELDS:
            chaos_kw[w] = _r6(chaos_kw[w] * f)


def _mutate(rng: random.Random, value, b: Bound, scale: float):
    lo_i, hi_i = int(b.lo), int(b.hi)
    if b.kind == "span":
        step = max(1, round(scale * (hi_i - lo_i) * 0.5))
        lo, hi = value
        lo = min(max(lo_i, lo + rng.randint(-step, step)), hi_i)
        hi = min(max(lo_i, hi + rng.randint(-step, step)), hi_i)
        return (lo, hi) if lo <= hi else (hi, lo)
    if b.kind == "int":
        step = max(1, round(scale * (hi_i - lo_i) * 0.5))
        return min(max(lo_i, int(value) + rng.randint(-step, step)), hi_i)
    if b.log:
        nv = value * math.exp(rng.gauss(0.0, scale))
    else:
        nv = value + rng.gauss(0.0, scale) * (b.hi - b.lo) * 0.5
    return _r6(min(max(b.lo, nv), b.hi))


def _draw(rng: random.Random, b: Bound):
    lo_i, hi_i = int(b.lo), int(b.hi)
    if b.kind == "span":
        a, c = rng.randint(lo_i, hi_i), rng.randint(lo_i, hi_i)
        return (a, c) if a <= c else (c, a)
    if b.kind == "int":
        return rng.randint(lo_i, hi_i)
    if b.log:
        return _r6(math.exp(rng.uniform(math.log(b.lo), math.log(b.hi))))
    return _r6(rng.uniform(b.lo, b.hi))


def _encode_cfg(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def _decode_cfg(cls, payload: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(payload) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in payload.items()})


# ---------------------------------------------------------------------------
# ScenarioSpec — the typed (chaos, workload) point
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One typed point in the scenario space: a chaos regime paired with a
    workload shape, serialisable (``to_dict``/``from_dict``) and mutable within
    the declared bounds (``perturb``/``sample``)."""

    name: str
    description: str
    chaos: ChaosConfig
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)

    def __post_init__(self):
        # hook point: the deprecated Scenario subclass warns from here
        pass

    # --- per-cell seed injection (templates stay untouched) ----------------
    def chaos_for_seed(self, seed: int) -> ChaosConfig:
        return dataclasses.replace(self.chaos, seed=seed)

    def workload_for_seed(self, seed: int) -> WorkloadConfig:
        return dataclasses.replace(self.workload, seed=seed)

    # --- validity ----------------------------------------------------------
    def validate(self) -> "ScenarioSpec":
        c, w = self.chaos, self.workload
        mass = sum(getattr(c, f) for f in WEIGHT_FIELDS)
        if mass > 1.0 + 1e-9:
            raise ValueError(f"chaos branch weights sum to {mass} > 1")
        if min(getattr(c, f) for f in WEIGHT_FIELDS) < 0.0:
            raise ValueError("chaos branch weights must be >= 0")
        if c.intensity <= 0 or c.mean_interarrival <= 0 or c.mean_outage <= 0:
            raise ValueError("chaos rate/duration parameters must be > 0")
        if not 0.0 <= c.burst_prob <= 1.0:
            raise ValueError(f"burst_prob {c.burst_prob} outside [0, 1]")
        lo, hi = c.burst_size
        if not 1 <= lo <= hi:
            raise ValueError(f"burst_size {c.burst_size} must satisfy 1<=lo<=hi")
        if w.n_single < 0 or w.n_chains < 0:
            raise ValueError("workload job counts must be >= 0")
        for rng_name in ("chain_len_range", "maps_range", "reduces_range"):
            rlo, rhi = getattr(w, rng_name)
            if not 0 <= rlo <= rhi:
                raise ValueError(f"{rng_name} {(rlo, rhi)} must be ordered")
        if w.max_map_attempts < 1 or w.max_reduce_attempts < 1:
            raise ValueError("attempt caps must be >= 1")
        if w.submit_horizon <= 0 or w.n_nodes < 1 or w.replication < 1:
            raise ValueError("submit_horizon/n_nodes/replication out of range")
        return self

    # --- serialisation (round-trip identity) -------------------------------
    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "chaos": _encode_cfg(self.chaos),
                "workload": _encode_cfg(self.workload)}

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return cls(name=d["name"], description=d.get("description", ""),
                   chaos=_decode_cfg(ChaosConfig, d["chaos"]),
                   workload=_decode_cfg(WorkloadConfig, d["workload"]))

    # --- search moves ------------------------------------------------------
    def perturb(self, rng: random.Random, scale: float = 0.25) -> "ScenarioSpec":
        """One hill-climb move: mutate 1-3 searchable parameters, clip to
        bounds, renormalise the branch-weight simplex.  Deterministic given the
        rng state; float outputs are pre-rounded to the ledger's 6 decimals."""
        chaos_kw = dataclasses.asdict(self.chaos)
        wl_kw = dataclasses.asdict(self.workload)
        fields = ([("chaos", n, b) for n, b in CHAOS_BOUNDS.items()]
                  + [("workload", n, b) for n, b in WORKLOAD_BOUNDS.items()])
        for which, fname, b in rng.sample(fields, rng.randint(1, 3)):
            target = chaos_kw if which == "chaos" else wl_kw
            target[fname] = _mutate(rng, target[fname], b, scale)
        _renorm_weights(chaos_kw)
        return dataclasses.replace(
            self, chaos=ChaosConfig(**chaos_kw),
            workload=WorkloadConfig(**wl_kw)).validate()

    @classmethod
    def sample(cls, rng: random.Random, *, name: str = "sampled",
               description: str = "uniform draw from the search bounds",
               ) -> "ScenarioSpec":
        """Uniform (log-uniform for scale parameters) draw within the bounds —
        the random-restart move of the search driver."""
        chaos_kw = {n: _draw(rng, b) for n, b in CHAOS_BOUNDS.items()}
        _renorm_weights(chaos_kw)
        wl_kw = {n: _draw(rng, b) for n, b in WORKLOAD_BOUNDS.items()}
        return cls(name=name, description=description,
                   chaos=ChaosConfig(**chaos_kw),
                   workload=WorkloadConfig(**wl_kw)).validate()


class Scenario(ScenarioSpec):
    """Deprecated older name for :class:`ScenarioSpec`."""

    def __post_init__(self):
        warnings.warn("repro_torch.cluster.Scenario is deprecated; use "
                      "ScenarioSpec", DeprecationWarning, stacklevel=3)


def _chaos(**kw) -> ChaosConfig:
    cfg = ChaosConfig(**kw)
    event_mass = sum(getattr(cfg, f) for f in WEIGHT_FIELDS)
    if event_mass > 1.0 + 1e-9:
        raise ValueError(f"chaos branch weights sum to {event_mass} > 1")
    return cfg


SCENARIOS: dict[str, ScenarioSpec] = {}


def _register(name: str, description: str, chaos: ChaosConfig) -> ScenarioSpec:
    sc = ScenarioSpec(name, description, chaos)
    SCENARIOS[name] = sc
    return sc


_register(
    "baseline",
    "Paper §5.1 calibrated default: mixed failures near the Google-trace ceiling",
    _chaos())

_register(
    "bursty_tt",
    "Correlated TaskTracker crash bursts (power events) dominate; the regime the "
    "adaptive heartbeat's 1/3-of-TTs rule targets",
    _chaos(intensity=6.0, kill_tt=0.50, suspend_tt=0.10, kill_dn=0.05,
           net_slow=0.10, net_drop=0.05, burst_prob=0.30, burst_size=(5, 9),
           mean_outage=700.0))

_register(
    "dn_loss",
    "DataNode-dominated failures: HDFS block replicas vanish, maps hit "
    "input-unavailable faults",
    _chaos(intensity=5.5, kill_tt=0.08, suspend_tt=0.05, kill_dn=0.60,
           net_slow=0.10, net_drop=0.05, mean_outage=1200.0, burst_prob=0.02))

_register(
    "slot_degradation",
    "Nodes stay nominally alive but thread kills rot their latent health; "
    "failures look idiopathic to a liveness-only scheduler",
    _chaos(intensity=6.5, kill_tt=0.05, suspend_tt=0.05, kill_dn=0.04,
           net_slow=0.08, net_drop=0.03, mean_outage=1500.0, burst_prob=0.01))

_register(
    "net_flap",
    "Flapping network: frequent short slow-downs and drops, quick recovery",
    _chaos(intensity=7.5, kill_tt=0.05, suspend_tt=0.05, kill_dn=0.05,
           net_slow=0.50, net_drop=0.25, mean_outage=300.0,
           mean_interarrival=180.0, burst_prob=0.01))

_register(
    "rack_failure",
    "Rare correlated rack-scale outages with long recovery (paper §1: power "
    "problems take down large machine groups at once)",
    _chaos(intensity=3.5, kill_tt=0.30, suspend_tt=0.05, kill_dn=0.20,
           net_slow=0.10, net_drop=0.05, burst_prob=0.45, burst_size=(6, 10),
           mean_outage=1800.0))

_register(
    "straggler_heavy",
    "Few hard failures, many stragglers: suspensions and slow links stretch "
    "task runtimes (the speculative-execution battleground)",
    _chaos(intensity=6.0, kill_tt=0.04, suspend_tt=0.40, kill_dn=0.03,
           net_slow=0.40, net_drop=0.03, mean_outage=900.0, burst_prob=0.01))

_register(
    "kitchen_sink",
    "Everything at once at high intensity — the stress ceiling every scheduler "
    "should degrade gracefully under",
    _chaos(intensity=9.0, kill_tt=0.22, suspend_tt=0.12, kill_dn=0.16,
           net_slow=0.22, net_drop=0.08, burst_prob=0.10, burst_size=(4, 8),
           mean_outage=1100.0))


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(SCENARIOS))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") from None


# ---------------------------------------------------------------------------
# Workload shapes (the fourth sweep axis)
# ---------------------------------------------------------------------------

WORKLOAD_SHAPES: dict[str, WorkloadConfig] = {
    # the paper's §5.1 mix
    "default": WorkloadConfig(),
    # tiny shape for CI smoke sweeps and unit tests: seconds per cell
    "smoke": WorkloadConfig(n_single=6, n_chains=1, chain_len_range=(3, 4),
                            maps_range=(4, 8), reduces_range=(2, 6),
                            submit_horizon=2400.0),
    # long chained pipelines dominate (cascade-failure sensitivity)
    "chain_heavy": WorkloadConfig(n_single=12, n_chains=16,
                                  chain_len_range=(6, 14)),
    # many small map-dominated jobs (TeraGen-ish scan shape)
    "map_heavy": WorkloadConfig(n_single=64, n_chains=4, maps_range=(10, 24),
                                reduces_range=(1, 4)),
}


def get_workload(name: str) -> WorkloadConfig:
    try:
        return WORKLOAD_SHAPES[name]
    except KeyError:
        known = ", ".join(sorted(WORKLOAD_SHAPES))
        raise KeyError(f"unknown workload shape {name!r}; known: {known}") \
            from None


def make_spec(scenario: str, workload: str = "default") -> ScenarioSpec:
    """Combine a named chaos scenario with a named workload shape into one
    typed ScenarioSpec — the canonical way fleet cells resolve their axes."""
    sc = get_scenario(scenario)
    return ScenarioSpec(name=sc.name, description=sc.description,
                        chaos=sc.chaos, workload=get_workload(workload))


@contextlib.contextmanager
def scenario_scope(spec: ScenarioSpec, *, scenario_name: str | None = None,
                   workload_name: str | None = None):
    """Temporarily register ``spec`` under fresh names in both registries, so
    the fleet engine (which resolves scenario/workload *names* in the parent
    process before fanning cells out to workers) can sweep a synthetic point.

    Yields ``(scenario_name, workload_name)``; always unregisters on exit.
    """
    s_name = scenario_name or spec.name
    w_name = workload_name or spec.name
    if s_name in SCENARIOS:
        raise ValueError(f"scenario name {s_name!r} already registered")
    if w_name in WORKLOAD_SHAPES:
        raise ValueError(f"workload name {w_name!r} already registered")
    SCENARIOS[s_name] = spec
    WORKLOAD_SHAPES[w_name] = spec.workload
    try:
        yield s_name, w_name
    finally:
        SCENARIOS.pop(s_name, None)
        WORKLOAD_SHAPES.pop(w_name, None)


# ---------------------------------------------------------------------------
# Deprecated older free functions (thin wrappers; emit DeprecationWarning)
# ---------------------------------------------------------------------------

def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}", DeprecationWarning,
                  stacklevel=3)


def scenario_chaos(name: str, seed: int) -> ChaosConfig:
    """Deprecated: use ``get_scenario(name).chaos_for_seed(seed)``."""
    _deprecated("scenario_chaos()", "get_scenario(name).chaos_for_seed(seed)")
    return get_scenario(name).chaos_for_seed(seed)


def get_workload_shape(name: str) -> WorkloadConfig:
    """Deprecated: use ``get_workload(name)``."""
    _deprecated("get_workload_shape()", "get_workload(name)")
    return get_workload(name)


def workload_for_seed(name: str, seed: int) -> WorkloadConfig:
    """Deprecated: use ``dataclasses.replace(get_workload(name), seed=seed)``
    or ``ScenarioSpec.workload_for_seed``."""
    _deprecated("workload_for_seed()", "ScenarioSpec.workload_for_seed")
    return dataclasses.replace(get_workload(name), seed=seed)
