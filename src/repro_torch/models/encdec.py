"""Whisper-style encoder-decoder backbone (the audio family) in PyTorch.

The port's copy of ``repro/models/encdec.py``.  The mel/conv frontend is a
stub: inputs are precomputed frame embeddings (B, n_frames, d_model).
LayerNorm, GELU MLP and absolute sinusoidal positions (no RoPE), Whisper's
transformer shape.  The entry points are ``models/lm.py``'s, with the
frames as ``media``; ``decode`` updates the self-attention cache in place
and leaves the cross-attention keys and values (``xk``, ``xv``) as prefill
cached them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.models.lm import (_need_media, _remat, fresh_cache,
                                   promote_cross_cache, put, put_rows,
                                   stack_defs, unstack, zeros_of)


def _freqs(D: int, device) -> torch.Tensor:
    """The sinusoid's D / 2 frequencies, in float32 as the reference
    computes them."""
    half = D // 2
    log_10k = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                     device=device))
    return torch.exp(-log_10k * torch.arange(half, dtype=torch.float32,
                                             device=device) / half)


def _sinusoid_at(pos: torch.Tensor, D: int) -> torch.Tensor:
    """(..., D) float32 positional embeddings of positions ``pos``: the
    sines of pos * freqs, then the cosines."""
    ang = pos.float()[..., None] * _freqs(D, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.norm_defs(cfg.d_model, "layer"),
        "attn": L.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim),
        "ln2": L.norm_defs(cfg.d_model, "layer"),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, kind="gelu"),
    }


def _dec_block_defs(cfg: ArchConfig) -> dict:
    d = _enc_block_defs(cfg)
    d["ln_x"] = L.norm_defs(cfg.d_model, "layer")
    d["xattn"] = L.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim)
    return d


def param_defs(cfg: ArchConfig) -> dict:
    e = cfg.enc_dec
    return {
        "embed": L.embed_defs(cfg),
        "enc_blocks": stack_defs(_enc_block_defs(cfg), e.n_enc_layers),
        "enc_norm": L.norm_defs(cfg.d_model, "layer"),
        "dec_blocks": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "final_norm": L.norm_defs(cfg.d_model, "layer"),
    }


def _mlp(blk, x, ctx):
    return x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)


def encode(params, cfg: ArchConfig, frames, ctx: ShardCtx = NO_SHARD):
    """frames (B, n_frames, d_model) stub embeddings -> the encoder's output
    (B, n_frames, d_model): non-causal self-attention blocks, each
    rematerialised in the backward pass per ``cfg.remat``."""
    S, D = frames.shape[1:]
    pos = torch.arange(S, device=frames.device)
    x = frames + _sinusoid_at(pos, D).to(frames.dtype)[None]
    x = ctx.constrain(x, "batch", "frames", "embed")

    def body(x, blk):
        h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                         causal=False, ctx=ctx, use_rope=False)
        return _mlp(blk, x + h, ctx)
    body = _remat(body, cfg)
    for blk in unstack(params["enc_blocks"]):
        x = body(x, blk)
    return L.norm_apply(params["enc_norm"], x)


def _cross(blk, x, enc_out, ctx):
    """x plus the decoder block's cross-attention to the encoder output."""
    return x + L.attn_apply(blk["xattn"], L.norm_apply(blk["ln_x"], x),
                            causal=False, ctx=ctx, kv_x=enc_out,
                            use_rope=False)


def _embed(params, cfg, tokens, ctx):
    """Token embeddings plus the sinusoid at positions 0..S-1."""
    x = L.embed_apply(params["embed"], tokens, ctx)
    pos = torch.arange(tokens.shape[1], device=x.device)
    return x + _sinusoid_at(pos, cfg.d_model).to(x.dtype)[None]


def apply(params, cfg: ArchConfig, tokens, *, media=None,
          ctx: ShardCtx = NO_SHARD, return_hidden: bool = False):
    """Teacher-forced decoder over ``tokens`` (B, S) given ``media`` frames:
    (logits (B, S, V) float32, aux 0); with ``return_hidden`` the
    final-norm hidden state instead of the logits."""
    _need_media(cfg, media)
    enc_out = encode(params, cfg, media, ctx)
    x = _embed(params, cfg, tokens, ctx)

    def body(x, blk):
        h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                         causal=True, ctx=ctx, use_rope=False)
        return _mlp(blk, _cross(blk, x + h, enc_out, ctx), ctx)
    body = _remat(body, cfg)
    for blk in unstack(params["dec_blocks"]):
        x = body(x, blk)
    x = L.norm_apply(params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.lm_head_apply(params["embed"], x, ctx), aux


def cache_struct(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """``meta`` tensors of the reference's layout: the decoder's
    self-attention k, v (n_layers, batch, max_len, n_kv_heads, head_dim)
    and its cross-attention keys and values of the encoder output xk, xv
    (n_layers, batch, n_frames, n_kv_heads, head_dim)."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    xkv = (cfg.n_layers, batch, cfg.enc_dec.n_frames, cfg.n_kv_heads,
           cfg.resolved_head_dim)
    return {name: torch.empty(shape, dtype=cfg.dtype, device="meta")
            for name, shape in (("k", kv), ("v", kv), ("xk", xkv),
                                ("xv", xkv))}


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes matching cache_struct (for sharding)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    xkv = ("layers", "batch", "frames", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    return zeros_of(cache_struct(cfg, batch, max_len), device)


def prefill(params, cfg: ArchConfig, tokens, *, media=None,
            ctx: ShardCtx = NO_SHARD, max_len: int | None = None):
    """Encode the frames, run the decoder over the prompt; return
    (logits_last (B, V) float32, cache): the self-attention cache filled to
    S and zero beyond, and each layer's keys and values of the encoder
    output."""
    _need_media(cfg, media)
    enc_out = encode(params, cfg, media, ctx)
    B, S = tokens.shape
    max_len = max_len or S
    x = _embed(params, cfg, tokens, ctx)
    cache = fresh_cache(cache_struct(cfg, B, max_len), cache_axes(cfg), x,
                        ctx)
    promote_cross_cache(cache, enc_out, params["dec_blocks"]["xattn"]["wk"])
    for i, blk in enumerate(unstack(params["dec_blocks"])):
        h, (k, v) = L.attn_prefill(blk["attn"], L.norm_apply(blk["ln1"], x),
                                   positions=None, theta=0.0, ctx=ctx,
                                   use_rope=False)
        put_rows(cache, "k", i, k)
        put_rows(cache, "v", i, v)
        put(cache, "xk", i, L.einsum("bmd,dhk->bmhk", enc_out,
                                     blk["xattn"]["wk"]))
        put(cache, "xv", i, L.einsum("bmd,dhk->bmhk", enc_out,
                                     blk["xattn"]["wv"]))
        x = _mlp(blk, _cross(blk, x + h, enc_out, ctx), ctx)
    x = L.norm_apply(params["final_norm"], x[:, -1:])
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache


def decode(params, cfg: ArchConfig, cache: dict, tokens, pos, *,
           ctx: ShardCtx = NO_SHARD):
    """One decoder step.  tokens (B, 1) int; pos (B,) int32 tokens already
    seen, each row's sinusoid taken at its own pos.  Updates ``cache`` in
    place; returns (logits (B, V) float32, cache)."""
    x = L.embed_apply(params["embed"], tokens, ctx)
    x = x + _sinusoid_at(pos, cfg.d_model)[:, None].to(x.dtype)
    for i, blk in enumerate(unstack(params["dec_blocks"])):
        h, _ = L.attn_decode(blk["attn"], L.norm_apply(blk["ln1"], x),
                             cache["k"][i], cache["v"][i], pos, theta=0.0,
                             ctx=ctx, use_rope=False)
        x = x + h
        h, _ = L.attn_decode(blk["xattn"], L.norm_apply(blk["ln_x"], x),
                             None, None, pos, theta=0.0, ctx=ctx,
                             cross_kv=(cache["xk"][i], cache["xv"][i]))
        x = _mlp(blk, x + h, ctx)
    x = L.norm_apply(params["final_norm"], x)
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache
