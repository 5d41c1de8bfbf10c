"""The model zoo, the dense family so far: layers, the decoder-only LM and
the ``Model`` facade."""

from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.models.registry import Model, get_model, param_count

__all__ = ["Model", "ShardCtx", "NO_SHARD", "get_model", "param_count"]
