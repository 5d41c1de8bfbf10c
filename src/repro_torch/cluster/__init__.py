from repro_torch.cluster.chaos import ChaosConfig, ChaosInjector
from repro_torch.cluster.invariants import InvariantChecker, InvariantViolation
from repro_torch.cluster.scenarios import (
    CHAOS_BOUNDS, SCENARIOS, WORKLOAD_BOUNDS, WORKLOAD_SHAPES, Bound, Scenario,
    ScenarioSpec, get_scenario, get_workload, get_workload_shape, make_spec,
    scenario_chaos, scenario_scope, workload_for_seed,
)
from repro_torch.cluster.simulator import (
    DEFAULT_FLEET, MACHINE_TYPES, MAP, REDUCE, Job, Node, Simulator, Task,
)
from repro_torch.cluster.telemetry import (FEATURE_NAMES, N_FEATURES,
                                           TelemetryTrace)
from repro_torch.cluster.workload import WorkloadConfig, install, make_workload

# fleet engine exports are lazy (PEP 562): repro_torch.cluster.fleet pulls in
# the predictor stack (torch), and importing it here would trip runpy's
# double-import warning for `python -m repro_torch.cluster.fleet`
_FLEET_NAMES = ("CellSpec", "SweepSpec", "aggregate", "cell_seed", "expand",
                "run_sweep", "sweep_json", "sweep_markdown")
_SEARCH_NAMES = ("SearchConfig", "evaluate", "run_search", "search_json",
                 "search_markdown")


def __getattr__(name):
    if name in _FLEET_NAMES:
        from repro_torch.cluster import fleet
        return getattr(fleet, name)
    if name in _SEARCH_NAMES:
        from repro_torch.cluster import search
        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Bound", "CHAOS_BOUNDS", "ChaosConfig", "ChaosInjector", "DEFAULT_FLEET",
    "InvariantChecker", "InvariantViolation", "MACHINE_TYPES", "MAP",
    "REDUCE", "Job", "Node", "SCENARIOS", "Scenario", "ScenarioSpec",
    "Simulator", "Task", "FEATURE_NAMES", "N_FEATURES", "TelemetryTrace",
    "WORKLOAD_BOUNDS", "WORKLOAD_SHAPES", "WorkloadConfig", "get_scenario",
    "get_workload", "get_workload_shape", "install", "make_spec",
    "make_workload", "scenario_chaos", "scenario_scope", "workload_for_seed",
    *_FLEET_NAMES, *_SEARCH_NAMES,
]
