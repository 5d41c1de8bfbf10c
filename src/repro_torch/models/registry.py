"""Model registry: the ``Model`` facade over a family implementation, and
analytic parameter counts.

The port's copy of ``repro/models/registry.py``.  The dense, ssm and hybrid
families are ported (``models/lm.py``); ``get_model`` raises
``NotImplementedError`` for the others.  Every method that makes or takes tensors has a ``device``
argument under the port's device rule: ``None`` means CUDA and raises
without a GPU (``kernels.ops.resolve_device``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import NO_SHARD
from repro_torch.parallel.axes import abstract_params, init_params, param_numel


def _on(params, tokens, device):
    """tokens as an int64 tensor on the resolved device; the parameters must
    already live there."""
    dev = resolve_device(device)
    at = params["embed"]["embedding"].device
    if at.type != dev.type:
        raise ValueError(f"the parameters are on {at}, the call asks for "
                         f"{dev}")
    return torch.as_tensor(tokens, device=at).long()


@dataclasses.dataclass(frozen=True)
class Model:
    """Thin functional facade over a family implementation."""
    cfg: ArchConfig

    # --- parameters
    def param_defs(self):
        return lm.param_defs(self.cfg)

    def abstract_params(self):
        return abstract_params(self.param_defs(), self.cfg.dtype)

    def init(self, seed: int, device=None):
        """Seeded random parameters, materialised on ``device`` layer by
        layer (``parallel.axes.init_params``)."""
        return init_params(self.param_defs(), seed, self.cfg.dtype,
                           resolve_device(device))

    # --- forward fns
    def apply(self, params, tokens, *, ctx=None, device=None, **kw):
        return lm.apply(params, self.cfg, _on(params, tokens, device),
                        ctx=ctx or NO_SHARD, **kw)

    def prefill(self, params, tokens, *, ctx=None, device=None, **kw):
        return lm.prefill(params, self.cfg, _on(params, tokens, device),
                          ctx=ctx or NO_SHARD, **kw)

    def decode(self, params, cache, tokens, pos, *, ctx=None, device=None):
        tokens = _on(params, tokens, device)
        pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32)
        return lm.decode(params, self.cfg, cache, tokens, pos,
                         ctx=ctx or NO_SHARD)

    # --- caches
    def cache_struct(self, batch: int, max_len: int):
        return lm.cache_struct(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None):
        return lm.init_cache(self.cfg, batch, max_len, resolve_device(device))

    # --- media stubs (frontends)
    def needs_media(self) -> bool:
        return self.cfg.family in ("audio", "vlm")


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in lm.PORTED_FAMILIES:
        lm.param_defs(cfg)                    # raises NotImplementedError
    return Model(cfg)


def param_count(cfg: ArchConfig) -> int:
    """Number of parameters, from the definitions alone (nothing is
    allocated)."""
    return param_numel(lm.param_defs(cfg))
