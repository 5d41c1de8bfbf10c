"""Model-zoo building blocks, the dense subset, in PyTorch.

The port's copy of ``repro/models/layers.py`` for the dense decoder: norms,
RoPE, attention (full sequence, prefill with a KV cache, cached decode),
the MLPs, embedding and LM head.  Every block exposes
``<block>_defs(...) -> tree[ParamDef]`` and apply functions on tensors, with
the reference's names, parameter layouts and arithmetic: norms and RoPE
compute in float32 and cast back; projections are ``torch.einsum`` (the
reference leaves them to XLA, outside any Pallas kernel); attention goes
through ``kernels.ops``, which launches the CUDA kernels on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.parallel.axes import ParamDef


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Runtime knobs carried into the apply functions.  On one device only
    the kernel choice remains: ``impl`` is passed to ``kernels.ops`` (None
    picks by device, "torch" the plain versions, "cuda" the kernels)."""
    impl: str | None = None


NO_SHARD = ShardCtx()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_defs(dim: int, kind: str = "rms") -> dict:
    d = {"scale": ParamDef((dim,), ("embed",), init="ones")}
    if kind == "layer":
        d["bias"] = ParamDef((dim,), ("embed",), init="zeros")
    return d


def norm_apply(p: dict, x, eps: float = 1e-5):
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # RMSNorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_apply(x, positions, theta: float):
    """x: (..., S, H, D) with positions (..., S) or (S,).  Rotates pairs
    (d, d + D/2)."""
    D = x.shape[-1]
    half = D // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (full sequence, prefill into a cache, cached decode)
# ---------------------------------------------------------------------------

def attn_defs(d_model: int, n_heads: int, n_kv: int, head_dim: int) -> dict:
    return {
        "wq": ParamDef((d_model, n_heads, head_dim),
                       ("embed", "heads", "head_dim"), init="scaled"),
        "wk": ParamDef((d_model, n_kv, head_dim),
                       ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": ParamDef((d_model, n_kv, head_dim),
                       ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": ParamDef((n_heads, head_dim, d_model),
                       ("heads", "head_dim", "embed"), init="scaled"),
    }


def _qkv(p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def _out(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def attn_apply(p, x, *, positions, theta=10000.0, causal=True, window=0,
               ctx: ShardCtx = NO_SHARD):
    """Full-sequence self-attention (the forward path)."""
    q, k, v = _qkv(p, x)
    q = rope_apply(q, positions, theta)
    k = rope_apply(k, positions, theta)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, impl=ctx.impl)
    return _out(p, out)


def attn_prefill(p, x, *, positions, theta, causal=True, window=0,
                 ctx: ShardCtx = NO_SHARD, cache_len: int):
    """Full-sequence attention that also emits a right-padded KV cache of
    length cache_len: (y, (k, v)) with k/v (B, cache_len, Hkv, Dh)."""
    q, k, v = _qkv(p, x)
    q = rope_apply(q, positions, theta)
    k = rope_apply(k, positions, theta)
    k, v = k.contiguous(), v.contiguous()
    out = ops.flash_attention(q.contiguous(), k, v, causal=causal,
                              window=window, impl=ctx.impl)
    S = x.shape[1]
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return _out(p, out), (F.pad(k, pad), F.pad(v, pad))


def attn_decode(p, x, cache_k, cache_v, pos, *, theta, window=0,
                ctx: ShardCtx = NO_SHARD):
    """Single-token decode.  x: (B, 1, D); cache_k/v: (B, Smax, Hkv, Dh);
    pos: (B,) number of tokens already in the cache.  Returns
    y, (cache_k, cache_v).

    Unlike the reference, which returns new arrays, the new key and value
    rows are written into ``cache_k``/``cache_v`` IN PLACE at ``pos`` and
    the same tensors are returned: a serving cache is updated, never
    copied."""
    q, k, v = _qkv(p, x)
    q = rope_apply(q, pos[:, None], theta)
    k = rope_apply(k, pos[:, None], theta)
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = pos.to(device=x.device, dtype=torch.long)
    cache_k[bidx, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos] = v[:, 0].to(cache_v.dtype)
    kv_len = (pos + 1).to(torch.int32)
    out = ops.decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                               window=window, impl=ctx.impl)
    return _out(p, out), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, kind: str = "swiglu") -> dict:
    d = {
        "wu": ParamDef((d_model, d_ff), ("embed", "ff"), init="scaled"),
        "wd": ParamDef((d_ff, d_model), ("ff", "embed"), init="scaled"),
    }
    if kind == "swiglu":
        d["wg"] = ParamDef((d_model, d_ff), ("embed", "ff"), init="scaled")
    return d


def mlp_apply(p, x, ctx: ShardCtx = NO_SHARD):
    """SwiGLU when the block has a gate ``wg``, else GELU (tanh form, as
    ``jax.nn.gelu``'s default)."""
    up = torch.einsum("bsd,df->bsf", x, p["wu"])
    if "wg" in p:
        h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"]).float())
        h = h.to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["wd"])


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig) -> dict:
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), init="scaled")
    return d


def embed_apply(p, tokens, ctx: ShardCtx = NO_SHARD):
    return p["embedding"][tokens]


def lm_head_apply(p, x, ctx: ShardCtx = NO_SHARD):
    """Logits in float32 (B, S, V)."""
    if "lm_head" in p:
        logits = torch.einsum("bsd,dv->bsv", x, p["lm_head"])
    else:
        logits = torch.einsum("bsd,vd->bsv", x, p["embedding"])
    return logits.float()
