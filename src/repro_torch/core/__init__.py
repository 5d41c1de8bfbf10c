# ATLAS — the paper's primary contribution: failure prediction + Algorithm 1
# scheduling + adaptive heartbeat + penalty/speculation mechanisms.
from repro_torch.core.atlas import ATLASScheduler
from repro_torch.core.heartbeat import HeartbeatController
from repro_torch.core.predictor import TaskPredictor

__all__ = ["ATLASScheduler", "HeartbeatController", "TaskPredictor"]
