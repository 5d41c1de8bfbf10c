"""Decoder-only LM assembly, the dense family, in PyTorch.

The port's copy of ``repro/models/lm.py`` for ``family == "dense"``.  The
parameter tree has the reference's paths and shapes (layer stacks carry a
leading ``layers`` axis); a Python loop over the layers replaces
``lax.scan``.  Three entry points:

  apply(params, cfg, tokens, ctx)              full-seq forward -> (logits, aux)
  prefill(params, cfg, tokens, ctx, max_len)   -> (logits_last, cache)
  decode(params, cfg, cache, tokens, pos, ctx) one-token step -> (logits, cache)

``decode`` writes the new key/value rows into ``cache`` in place (see
``layers.attn_decode``) and returns the same dict.  The other families (moe,
ssm, hybrid, vlm, audio) are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.parallel.axes import ParamDef, tree_map

PORTED_FAMILIES = ("dense",)


def _require_ported(cfg: ArchConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ported: {', '.join(PORTED_FAMILIES)})")


def stack_defs(defs: Any, n: int) -> Any:
    return tree_map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       dtype=d.dtype, init=d.init,
                                       scale=d.scale), defs)


def layer(tree: Any, i: int) -> Any:
    """Layer i of a stacked parameter tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def _dense_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.norm_defs(cfg.d_model),
        "attn": L.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim),
        "ln2": L.norm_defs(cfg.d_model),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff),
    }


def param_defs(cfg: ArchConfig) -> dict:
    _require_ported(cfg)
    return {"embed": L.embed_defs(cfg), "final_norm": L.norm_defs(cfg.d_model),
            "blocks": stack_defs(_dense_block_defs(cfg), cfg.n_layers)}


def n_layers(params) -> int:
    return params["blocks"]["ln1"]["scale"].shape[0]


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _dense_block_apply(cfg, blk, x, positions, ctx):
    h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                     positions=positions, theta=cfg.rope_theta,
                     causal=cfg.causal, window=cfg.sliding_window, ctx=ctx)
    x = x + h
    return x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)


def apply(params, cfg: ArchConfig, tokens, *, ctx: ShardCtx = NO_SHARD):
    """Full-sequence forward.  tokens (B, S) int.  Returns (logits (B, S, V)
    float32, aux_loss 0-dim float32)."""
    _require_ported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed_apply(params["embed"], tokens, ctx)
    for i in range(n_layers(params)):
        x = _dense_block_apply(cfg, layer(params["blocks"], i), x, positions,
                               ctx)
    x = L.norm_apply(params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.lm_head_apply(params["embed"], x, ctx), aux


# ---------------------------------------------------------------------------
# KV cache, prefill and decode
# ---------------------------------------------------------------------------

def cache_struct(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors: k and v, each (n_layers, batch,
    max_len, n_kv_heads, head_dim) in the model's dtype."""
    _require_ported(cfg)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {name: torch.empty(kv, dtype=cfg.dtype, device="meta")
            for name in ("k", "v")}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_struct(cfg, batch, max_len).items()}


def prefill(params, cfg: ArchConfig, tokens, *, ctx: ShardCtx = NO_SHARD,
            max_len: int | None = None):
    """Process a prompt; return (logits_last (B, V) float32, cache filled to
    S and zero beyond, of length max_len)."""
    _require_ported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = _positions(B, S, tokens.device)
    x = L.embed_apply(params["embed"], tokens, ctx)
    cache = init_cache(cfg, B, max_len, x.device)
    for i in range(n_layers(params)):
        blk = layer(params["blocks"], i)
        h, (k, v) = L.attn_prefill(blk["attn"], L.norm_apply(blk["ln1"], x),
                                   positions=positions, theta=cfg.rope_theta,
                                   window=cfg.sliding_window, ctx=ctx,
                                   cache_len=max_len)
        cache["k"][i] = k
        cache["v"][i] = v
        x = x + h
        x = x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)
    x = L.norm_apply(params["final_norm"], x[:, -1:])
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache


def decode(params, cfg: ArchConfig, cache: dict, tokens, pos, *,
           ctx: ShardCtx = NO_SHARD):
    """One decode step.  tokens (B, 1) int; pos (B,) int32 tokens already in
    the cache.  Writes the step's keys and values into ``cache`` in place;
    returns (logits (B, V) float32, cache)."""
    _require_ported(cfg)
    x = L.embed_apply(params["embed"], tokens, ctx)
    for i in range(n_layers(params)):
        blk = layer(params["blocks"], i)
        h, _ = L.attn_decode(blk["attn"], L.norm_apply(blk["ln1"], x),
                             cache["k"][i], cache["v"][i], pos,
                             theta=cfg.rope_theta, window=cfg.sliding_window,
                             ctx=ctx)
        x = x + h
        x = x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)
    x = L.norm_apply(params["final_norm"], x)
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache
