"""Logical-axis sharding rules and parameter definitions."""

from repro_torch.parallel.axes import (
    DEFAULT_RULES, Initializer, NamedSharding, ParamDef, PartitionSpec,
    abstract_params, init_params, is_param_def, logical_to_spec, make_rules,
    params_axes, tree_sharding, tree_spec,
)

__all__ = [
    "DEFAULT_RULES", "Initializer", "NamedSharding", "ParamDef",
    "PartitionSpec", "abstract_params", "init_params", "is_param_def",
    "logical_to_spec", "make_rules", "params_axes", "tree_sharding",
    "tree_spec",
]
