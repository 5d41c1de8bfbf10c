from repro_torch.sched.base import (
    BASELINES, CapacityScheduler, FIFOScheduler, FairScheduler, Scheduler,
)

__all__ = ["BASELINES", "CapacityScheduler", "FIFOScheduler", "FairScheduler",
           "Scheduler"]
