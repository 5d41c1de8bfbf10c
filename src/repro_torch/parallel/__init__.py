"""Parameter definitions with logical axes (no mesh on one device)."""

from repro_torch.parallel.axes import (ParamDef, abstract_params, init_params,
                                       is_param_def)

__all__ = ["ParamDef", "abstract_params", "init_params", "is_param_def"]
