"""Model registry: the ``Model`` facade over a family implementation
(``models/encdec.py`` for the audio family, ``models/lm.py`` for the
others), the media stubs, and analytic parameter counts.

The port's copy of ``repro/models/registry.py``; ``get_model`` raises for
a family neither module handles.  Every method that makes or takes tensors
has a ``device`` argument under the port's device rule: ``None`` means CUDA
and raises without a GPU (``kernels.ops.resolve_device``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.layers import NO_SHARD
from repro_torch.parallel.axes import (abstract_params, init_params,
                                       param_numel, params_axes)

FAMILIES = lm.FAMILIES + ("audio",)


def family_module(cfg: ArchConfig):
    """The module that implements ``cfg``'s family."""
    return encdec if cfg.family == "audio" else lm


def _device_of(params, device) -> torch.device:
    """The parameters' device, which must be the resolved ``device``."""
    dev = resolve_device(device)
    at = params["embed"]["embedding"].device
    if at.type != dev.type:
        raise ValueError(f"the parameters are on {at}, the call asks for "
                         f"{dev}")
    return at


def _on(params, tokens, device):
    """tokens as an int64 tensor on the resolved device; the parameters must
    already live there."""
    return torch.as_tensor(tokens, device=_device_of(params, device)).long()


def _media_on(params, media, device):
    """media (B, M, D) unchanged, after checking that it lies on the
    parameters' device (None passes)."""
    if media is None:
        return None
    at = _device_of(params, device)
    if media.device.type != at.type:
        raise ValueError(f"media is on {media.device}, the parameters on "
                         f"{at}")
    return media


@dataclasses.dataclass(frozen=True)
class Model:
    """Thin functional facade over a family implementation."""
    cfg: ArchConfig

    # --- parameters
    def param_defs(self):
        return family_module(self.cfg).param_defs(self.cfg)

    def abstract_params(self):
        return abstract_params(self.param_defs(), self.cfg.dtype)

    def params_axes(self):
        return params_axes(self.param_defs())

    def init(self, seed: int, device=None):
        """Seeded random parameters, materialised on ``device`` layer by
        layer (``parallel.axes.init_params``)."""
        return init_params(self.param_defs(), seed, self.cfg.dtype,
                           resolve_device(device))

    # --- forward fns
    def apply(self, params, tokens, *, media=None, ctx=None, device=None,
              **kw):
        return family_module(self.cfg).apply(
            params, self.cfg, _on(params, tokens, device),
            media=_media_on(params, media, device), ctx=ctx or NO_SHARD,
            **kw)

    def prefill(self, params, tokens, *, media=None, ctx=None, device=None,
                **kw):
        return family_module(self.cfg).prefill(
            params, self.cfg, _on(params, tokens, device),
            media=_media_on(params, media, device), ctx=ctx or NO_SHARD,
            **kw)

    def decode(self, params, cache, tokens, pos, *, ctx=None, device=None):
        tokens = _on(params, tokens, device)
        pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32)
        return family_module(self.cfg).decode(params, self.cfg, cache,
                                              tokens, pos,
                                              ctx=ctx or NO_SHARD)

    # --- caches
    def cache_struct(self, batch: int, max_len: int):
        return family_module(self.cfg).cache_struct(self.cfg, batch, max_len)

    def cache_axes(self):
        return family_module(self.cfg).cache_axes(self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None):
        return family_module(self.cfg).init_cache(self.cfg, batch, max_len,
                                                  resolve_device(device))

    # --- media stubs (frontends)
    def needs_media(self) -> bool:
        return self.cfg.family in ("audio", "vlm")

    def media_struct(self, batch: int):
        """The media a call takes as a ``meta`` tensor of the config's
        dtype: (batch, n_frames, d_model) frame embeddings (audio),
        (batch, n_media_tokens, d_model) image embeddings (vlm); None for
        the other families."""
        cfg = self.cfg
        if cfg.family == "audio":
            m = cfg.enc_dec.n_frames
        elif cfg.family == "vlm":
            m = cfg.cross_attn.n_media_tokens
        else:
            return None
        return torch.empty((batch, m, cfg.d_model), dtype=cfg.dtype,
                           device="meta")


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"({', '.join(FAMILIES)})")
    return Model(cfg)


def param_count(cfg: ArchConfig) -> int:
    """Number of parameters, from the definitions alone (nothing is
    allocated)."""
    return param_numel(Model(cfg).param_defs())


def active_param_count(cfg: ArchConfig) -> int:
    """Activated parameters per token (MoE: top_k + shared experts only),
    the N in 6*N*D for MoE archs."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.expert_ff
    n_moe_layers = cfg.n_layers - m.first_dense
    routed_total = n_moe_layers * m.n_experts * per_expert
    routed_active = n_moe_layers * m.top_k * per_expert
    return total - routed_total + routed_active
