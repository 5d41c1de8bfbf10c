"""The model zoo: layers, the decoder-only LM, the encoder-decoder and the
``Model`` facade."""

from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.models.registry import (Model, active_param_count,
                                         get_model, param_count)

__all__ = ["Model", "ShardCtx", "NO_SHARD", "active_param_count",
           "get_model", "param_count"]
