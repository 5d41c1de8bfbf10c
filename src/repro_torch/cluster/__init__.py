from repro_torch.cluster.chaos import ChaosConfig, ChaosInjector
from repro_torch.cluster.invariants import InvariantChecker, InvariantViolation
from repro_torch.cluster.simulator import (
    DEFAULT_FLEET, MACHINE_TYPES, MAP, REDUCE, Job, Node, Simulator, Task,
)
from repro_torch.cluster.telemetry import (FEATURE_NAMES, N_FEATURES,
                                           TelemetryTrace)
from repro_torch.cluster.workload import WorkloadConfig, install, make_workload

__all__ = [
    "ChaosConfig", "ChaosInjector", "DEFAULT_FLEET", "InvariantChecker",
    "InvariantViolation", "MACHINE_TYPES", "MAP", "REDUCE", "Job", "Node",
    "Simulator", "Task", "FEATURE_NAMES", "N_FEATURES", "TelemetryTrace",
    "WorkloadConfig", "install", "make_workload",
]
