from repro_torch.optim.adamw import (
    AdamWConfig, abstract_opt_state, apply_updates, global_norm, init_opt_state,
    opt_state_axes, schedule,
)

__all__ = ["AdamWConfig", "abstract_opt_state", "apply_updates", "global_norm",
           "init_opt_state", "opt_state_axes", "schedule"]
