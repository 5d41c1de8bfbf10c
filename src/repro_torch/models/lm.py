"""Decoder-only LM assembly in PyTorch: the dense, moe, ssm (RWKV6),
hybrid (Mamba2 + shared attention, Zamba2-style) and vlm (cross-attention
image layers) families.

The port's copy of ``repro/models/lm.py``.  The parameter tree has the
reference's paths and shapes (layer stacks carry a leading ``layers``
axis); a Python loop over the layers replaces ``lax.scan``.  Three entry
points:

  apply(params, cfg, tokens, media, ctx)  full-seq forward -> (logits, aux)
                                          (return_hidden: the final-norm
                                          hidden state instead of logits)
  prefill(params, cfg, tokens, media, ctx, max_len) -> (logits_last, cache)
  decode(params, cfg, cache, tokens, pos, ctx) one-token step -> (logits, cache)

``media`` (B, M, D) is the vlm family's image embeddings, None for the
others.  ``decode`` updates ``cache`` in place (the new key/value rows, the
recurrent states and token-shift rows) and returns the same dict; the
reference returns a new one.  The audio family (Whisper's encoder-decoder)
is ``models/encdec.py``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.parallel.axes import ParamDef, tree_leaves, tree_map
from repro_torch.parallel.partition import (is_dtensor, like,
                                           local_shape_offset, placed)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _require_family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} not handled by "
                         f"lm.py ({', '.join(FAMILIES)})")


def stack_defs(defs: Any, n: int) -> Any:
    return tree_map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       dtype=d.dtype, init=d.init,
                                       scale=d.scale), defs)


def unstack(tree: Any) -> list:
    """Every layer of a stacked parameter tree, each leaf split once by
    ``torch.unbind`` (views, no copy).  Under autograd an unbind has one
    backward, which stacks the layers' gradients into one buffer; indexing
    ``t[i]`` per layer would instead allocate a zero gradient the size of
    the whole stack for every layer."""
    split = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(split)[0])
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


def _remat(fn, cfg: ArchConfig):
    """The reference's ``_remat`` (``repro/models/lm.py:37``): recompute
    ``fn``'s activations in the backward pass instead of keeping them, when
    grad is enabled.  "full" and "dots" both recompute everything here: the
    reference's "dots" keeps the matmul outputs under an XLA checkpoint
    policy, which has no counterpart in ``torch.utils.checkpoint``."""
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return run


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


def _moe_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.norm_defs(cfg.d_model),
        "attn": L.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim),
        "ln2": L.norm_defs(cfg.d_model),
        "moe": L.moe_defs(cfg),
    }


def _dense_fallback_ff(cfg: ArchConfig) -> int:
    # deepseek-style: the leading dense layer matches the activated expert
    # width
    m = cfg.moe
    return (m.top_k + m.n_shared_experts) * m.expert_ff


def _rwkv_block_defs(cfg: ArchConfig) -> dict:
    d = L.rwkv6_defs(cfg)
    d["ln1"] = L.norm_defs(cfg.d_model)
    d["ln2"] = L.norm_defs(cfg.d_model)
    return d


def _mamba_block_defs(cfg: ArchConfig) -> dict:
    return {"ln": L.norm_defs(cfg.d_model), "mamba": L.mamba2_defs(cfg)}


def _shared_attn_defs(cfg: ArchConfig) -> dict:
    h = cfg.hybrid
    hd = cfg.d_model // h.shared_attn_heads
    return {
        "ln1": L.norm_defs(cfg.d_model),
        "attn": L.attn_defs(cfg.d_model, h.shared_attn_heads,
                            h.shared_attn_heads, hd),
        "ln2": L.norm_defs(cfg.d_model),
        "mlp": L.mlp_defs(cfg.d_model, h.shared_attn_ff),
    }


def _cross_block_defs(cfg: ArchConfig) -> dict:
    d = _dense_block_defs(cfg)
    d["gate_attn"] = ParamDef((1,), (None,), init="zeros")
    d["gate_mlp"] = ParamDef((1,), (None,), init="zeros")
    return d


def _vlm_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(cross blocks, self blocks per period): each period is period - 1
    self-attention blocks, then one cross-attention block."""
    period = cfg.cross_attn.period
    return cfg.n_layers // period, period - 1


def param_defs(cfg: ArchConfig) -> dict:
    _require_family(cfg)
    p: dict = {"embed": L.embed_defs(cfg),
               "final_norm": L.norm_defs(cfg.d_model)}
    if cfg.family == "dense":
        p["blocks"] = stack_defs(_dense_block_defs(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense
        if nd:
            dense = dict(_moe_block_defs(cfg))
            dense.pop("moe")
            dense["mlp"] = L.mlp_defs(cfg.d_model, _dense_fallback_ff(cfg))
            p["dense0"] = stack_defs(dense, nd)
        p["blocks"] = stack_defs(_moe_block_defs(cfg), cfg.n_layers - nd)
    elif cfg.family == "ssm":
        p["ln0"] = L.norm_defs(cfg.d_model)
        p["blocks"] = stack_defs(_rwkv_block_defs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        p["blocks"] = stack_defs(_mamba_block_defs(cfg), cfg.n_layers)
        p["shared"] = _shared_attn_defs(cfg)
    else:  # vlm
        n_cross = _vlm_layout(cfg)[0]
        p["self_blocks"] = stack_defs(_dense_block_defs(cfg),
                                      cfg.n_layers - n_cross)
        p["cross_blocks"] = stack_defs(_cross_block_defs(cfg), n_cross)
    return p


def _hybrid_groups(cfg: ArchConfig) -> list[tuple[int, int]]:
    """(lo, hi) Mamba-layer slices; the shared block runs before each."""
    period = cfg.hybrid.period
    return [(lo, min(lo + period, cfg.n_layers))
            for lo in range(0, cfg.n_layers, period)]


def n_shared_invocations(cfg: ArchConfig) -> int:
    return len(_hybrid_groups(cfg))


def _rwkv_zeros(cfg, B, x):
    """The zero token-shift row and WKV state a sequence starts from."""
    H, Dh = L.rwkv_heads(cfg), cfg.ssm.head_dim
    return (x.new_zeros(B, cfg.d_model),
            torch.zeros(B, H, Dh, Dh, dtype=torch.float32, device=x.device))


def _mamba_zeros(cfg, B, x):
    """The zero conv context and SSD state a sequence starts from."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    conv_ch = d_inner + 2 * s.state_dim
    return (x.new_zeros(B, s.conv_width - 1, conv_ch),
            torch.zeros(B, d_inner // s.head_dim, s.head_dim, s.state_dim,
                        dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _dense_block_apply(cfg, blk, x, positions, ctx):
    h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                     positions=positions, theta=cfg.rope_theta,
                     causal=cfg.causal, window=cfg.sliding_window, ctx=ctx)
    x = x + h
    return x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)


def _moe_block_apply(cfg, blk, x, positions, ctx):
    h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                     positions=positions, theta=cfg.rope_theta,
                     causal=cfg.causal, window=cfg.sliding_window, ctx=ctx)
    x = x + h
    y, aux = L.moe_apply(blk["moe"], L.norm_apply(blk["ln2"], x), cfg, ctx)
    return x + y, aux


def _rwkv_block_apply(cfg, blk, x, tm_prev, cm_prev, state0, ctx):
    h, (tm_last, state) = L.rwkv6_time_mix(
        blk, L.norm_apply(blk["ln1"], x), tm_prev, state0, cfg, ctx)
    x = x + h
    h, cm_last = L.rwkv6_channel_mix(blk, L.norm_apply(blk["ln2"], x),
                                     cm_prev)
    return x + h, tm_last, cm_last, state


def _mamba_block_apply(cfg, blk, x, conv0, ssd0, ctx):
    h, (conv_s, ssd_s) = L.mamba2_apply(blk["mamba"],
                                        L.norm_apply(blk["ln"], x), conv0,
                                        ssd0, cfg, ctx)
    return x + h, conv_s, ssd_s


def _shared_block_apply(cfg, p, x, positions, ctx):
    blk = p["shared"]
    y = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x),
                     positions=positions, theta=cfg.rope_theta, causal=True,
                     window=cfg.sliding_window, ctx=ctx)
    x = x + y
    return x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln2"], x), ctx)


def _layers(params) -> list:
    """The dense and moe families' layers in order: dense0, then blocks."""
    head = unstack(params["dense0"]) if "dense0" in params else []
    return head + unstack(params["blocks"])


def _gated(gate, x, h):
    """x + tanh(gate) h, the gate in float32 and cast to x's dtype."""
    return x + torch.tanh(gate.float()).to(x.dtype) * h


def _cross_mlp(blk, x, ctx):
    """The cross block's gated MLP residual."""
    return _gated(blk["gate_mlp"], x, L.mlp_apply(
        blk["mlp"], L.norm_apply(blk["ln2"], x), ctx))


def _cross_block_apply(cfg, blk, x, media, ctx):
    h = L.attn_apply(blk["attn"], L.norm_apply(blk["ln1"], x), causal=False,
                     ctx=ctx, kv_x=media, use_rope=False)
    return _cross_mlp(blk, _gated(blk["gate_attn"], x, h), ctx)


def _need_media(cfg, media):
    if media is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs media "
                         "embeddings (B, M, d_model)")


def apply(params, cfg: ArchConfig, tokens, *, media=None,
          ctx: ShardCtx = NO_SHARD, return_hidden: bool = False):
    """Full-sequence forward.  tokens (B, S) int; media (B, M, D) for vlm.
    Returns (logits (B, S, V) float32, aux_loss 0-dim float32: the MoE
    layers' load-balance losses summed, else 0); with ``return_hidden`` the
    first element is the final-norm hidden state (B, S, D) instead (the
    train step computes the loss in sequence chunks, so the float32 logits
    never exist whole).  Each layer (dense, moe, ssm), each hybrid group
    (the shared block and its Mamba2 layers, as the reference's
    ``group_fn``) or each vlm period (its self blocks and its cross block)
    is rematerialised in the backward pass per ``cfg.remat``."""
    _require_family(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed_apply(params["embed"], tokens, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "moe"):
        dense = _remat(lambda x, blk: _dense_block_apply(cfg, blk, x,
                                                         positions, ctx), cfg)
        moe = _remat(lambda x, blk: _moe_block_apply(cfg, blk, x, positions,
                                                     ctx), cfg)
        auxs = []
        for blk in _layers(params):
            if "moe" in blk:
                x, a = moe(x, blk)
                auxs.append(a)
            else:
                x = dense(x, blk)
        if auxs:
            aux = aux + torch.stack(auxs).sum()
    elif cfg.family == "ssm":
        x = L.norm_apply(params["ln0"], x)
        zeros_prev, state0 = _rwkv_zeros(cfg, B, x)
        body = _remat(lambda x, blk: _rwkv_block_apply(
            cfg, blk, x, zeros_prev, zeros_prev, state0, ctx)[0], cfg)
        for blk in unstack(params["blocks"]):
            x = body(x, blk)
    elif cfg.family == "hybrid":
        conv0, ssd0 = _mamba_zeros(cfg, B, x)
        blocks = unstack(params["blocks"])

        def group_fn(x, group):
            x = _shared_block_apply(cfg, params, x, positions, ctx)
            for blk in group:
                x, _, _ = _mamba_block_apply(cfg, blk, x, conv0, ssd0, ctx)
            return x
        group_fn = _remat(group_fn, cfg)
        for lo, hi in _hybrid_groups(cfg):
            x = group_fn(x, blocks[lo:hi])
    else:  # vlm
        _need_media(cfg, media)
        n_cross, per = _vlm_layout(cfg)
        selfs = unstack(params["self_blocks"])

        def period_fn(x, group, cross):
            for blk in group:
                x = _dense_block_apply(cfg, blk, x, positions, ctx)
            return _cross_block_apply(cfg, cross, x, media, ctx)
        period_fn = _remat(period_fn, cfg)
        for g, cross in enumerate(unstack(params["cross_blocks"])):
            x = period_fn(x, selfs[g * per:(g + 1) * per], cross)
    x = L.norm_apply(params["final_norm"], x)
    if return_hidden:
        return x, aux
    return L.lm_head_apply(params["embed"], x, ctx), aux


# ---------------------------------------------------------------------------
# KV cache, prefill and decode
# ---------------------------------------------------------------------------

def cache_struct(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors, the reference's layout:
    dense, moe: k and v (n_layers, batch, max_len, n_kv_heads, head_dim);
    vlm: k and v of the self blocks (n_self, batch, max_len, n_kv_heads,
    head_dim) and the cross blocks' static media keys and values xk, xv
    (n_cross, batch, n_media_tokens, n_kv_heads, head_dim);
    ssm: wkv (n_layers, batch, H, Dh, Dh) float32 and the token-shift rows
    tm_prev, cm_prev (n_layers, batch, d_model); hybrid: conv (n_layers,
    batch, conv_width - 1, conv_ch), ssd (n_layers, batch, H, P, N) float32
    and the shared block's window cache shared_k, shared_v (invocations,
    batch, W, heads, head_dim), W = min(max_len, sliding_window)."""
    _require_family(cfg)
    dt, f32 = cfg.dtype, torch.float32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    nl = cfg.n_layers
    hd = cfg.resolved_head_dim
    if cfg.family in ("dense", "moe"):
        kv = (nl, batch, max_len, cfg.n_kv_heads, hd)
        return {"k": meta(kv, dt), "v": meta(kv, dt)}
    if cfg.family == "vlm":
        n_cross = _vlm_layout(cfg)[0]
        kv = (nl - n_cross, batch, max_len, cfg.n_kv_heads, hd)
        xkv = (n_cross, batch, cfg.cross_attn.n_media_tokens, cfg.n_kv_heads,
               hd)
        return {"k": meta(kv, dt), "v": meta(kv, dt), "xk": meta(xkv, dt),
                "xv": meta(xkv, dt)}
    s = cfg.ssm
    if cfg.family == "ssm":
        H = cfg.d_model // s.head_dim
        return {"wkv": meta((nl, batch, H, s.head_dim, s.head_dim), f32),
                "tm_prev": meta((nl, batch, cfg.d_model), dt),
                "cm_prev": meta((nl, batch, cfg.d_model), dt)}
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    W = min(max_len, cfg.sliding_window or max_len)
    hh = cfg.hybrid.shared_attn_heads
    kv = (n_shared_invocations(cfg), batch, W, hh, cfg.d_model // hh)
    return {"conv": meta((nl, batch, s.conv_width - 1, conv_ch), dt),
            "ssd": meta((nl, batch, H, s.head_dim, s.state_dim), f32),
            "shared_k": meta(kv, dt), "shared_v": meta(kv, dt)}


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes matching cache_struct (for sharding)."""
    _require_family(cfg)
    if cfg.family in ("dense", "moe"):
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return {"wkv": ("layers", "batch", "heads", "head_dim", "head_dim"),
                "tm_prev": ("layers", "batch", "embed"),
                "cm_prev": ("layers", "batch", "embed")}
    if cfg.family == "hybrid":
        kv = ("layers", "batch", "kv_seq", "heads", "head_dim")
        return {"conv": ("layers", "batch", "conv", "heads_x_dim"),
                "ssd": ("layers", "batch", "heads", "head_dim", "state"),
                "shared_k": kv, "shared_v": kv}
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    xkv = ("layers", "batch", "frames", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def zeros_of(struct: dict, device: torch.device) -> dict:
    """Zero tensors on ``device`` of a cache_struct's shapes and dtypes."""
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in struct.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    return zeros_of(cache_struct(cfg, batch, max_len), device)


def fresh_cache(struct: dict, axes: dict, x, ctx: ShardCtx) -> dict:
    """A zero cache of ``struct``'s shapes and dtypes on x's device; when x
    is a DTensor (a step on a mesh), DTensors laid out by the cache's
    logical ``axes`` under ``ctx``'s rules."""
    if not is_dtensor(x):
        return zeros_of(struct, x.device)
    if ctx.mesh is None or ctx.rules is None:
        raise ValueError("a step on DTensors needs a ShardCtx with the mesh "
                         "and rules its cache is laid out by")
    from torch.distributed.tensor import zeros
    dm = x.device_mesh
    return {name: zeros(s.shape, dtype=s.dtype, device_mesh=dm,
                        placements=ctx.spec_placements(dm, *axes[name]))
            for name, s in struct.items()}


def put(cache: dict, name: str, i: int, value):
    """cache[name][i] = value, laid out as the cache is (a DTensor value
    redistributed, a plain one replicated, on a DTensor cache)."""
    dst = cache[name][i]
    dst.copy_(like(value, dst) if is_dtensor(dst) else value)


def put_rows(cache: dict, name: str, i: int, rows, skip: int = 0):
    """cache[name][i][:, :n] = rows[:, skip:skip + n] (n = rows' length -
    skip, at most the cache's; nothing when n <= 0), the cache's later rows
    left as they are (zero in a fresh cache).  On a DTensor cache each rank
    writes only the rows its own block holds: ``rows`` is laid out as the
    cache is apart from its second dimension, whose every rank gets all of
    it."""
    dst = cache[name][i]
    if not is_dtensor(dst):
        n = min(dst.shape[1], rows.shape[1] - skip)
        if n > 0:
            dst[:, :n].copy_(rows[:, skip:skip + n])
        return
    from torch.distributed.tensor import Replicate
    rows = placed(rows, dst.device_mesh, tuple(
        Replicate() if pl.is_shard(1) else pl
        for pl in dst.placements)).to_local()
    local = dst.to_local()
    lo = skip + local_shape_offset(dst)[1][1]
    n = min(local.shape[1], rows.shape[1] - lo)
    if n > 0:
        local[:, :n].copy_(rows[:, lo:lo + n])


def _prefill_attn(cfg, blk, x, positions, cache, i, ctx):
    """x plus the block's self-attention over the prompt; its keys and
    values go into the first rows of layer i of the KV cache."""
    h, (k, v) = L.attn_prefill(blk["attn"], L.norm_apply(blk["ln1"], x),
                               positions=positions, theta=cfg.rope_theta,
                               window=cfg.sliding_window, ctx=ctx)
    put_rows(cache, "k", i, k)
    put_rows(cache, "v", i, v)
    return x + h


def _ffn(cfg, blk, x, ctx, dropless=False):
    """x plus the block's MLP or MoE (its aux loss dropped)."""
    xin = L.norm_apply(blk["ln2"], x)
    if "moe" in blk:
        return x + L.moe_apply(blk["moe"], xin, cfg, ctx,
                               dropless=dropless)[0]
    return x + L.mlp_apply(blk["mlp"], xin, ctx)


def _media_kv(blk, media):
    """A cross block's keys and values of the media (B, M, Hkv, Dh), in the
    dtype the media and the weights promote to."""
    return (L.einsum("bmd,dhk->bmhk", media, blk["attn"]["wk"]),
            L.einsum("bmd,dhk->bmhk", media, blk["attn"]["wv"]))


def promote_cross_cache(cache: dict, kv_in, wk):
    """Make the cross-attention cache entries ``xk``, ``xv`` hold the dtype
    that keys computed from ``kv_in`` (the media, or the encoder's output)
    and the weights ``wk`` come out in: float32 media on bf16 weights give
    float32 keys, which the reference's prefill returns as they are."""
    dt = torch.promote_types(kv_in.dtype, wk.dtype)
    for name in ("xk", "xv"):
        cache[name] = cache[name].to(dt)


def prefill(params, cfg: ArchConfig, tokens, *, media=None,
            ctx: ShardCtx = NO_SHARD, max_len: int | None = None):
    """Process a prompt; return (logits_last (B, V) float32, cache): the KV
    cache filled to S and zero beyond, of length max_len (dense, moe, vlm,
    whose cache also holds the media keys and values); the states after
    the prompt (ssm, hybrid).  The MoE layers are capacity-bounded, as in
    the forward."""
    _require_family(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = _positions(B, S, tokens.device)
    x = L.embed_apply(params["embed"], tokens, ctx)
    cache = fresh_cache(cache_struct(cfg, B, max_len), cache_axes(cfg), x,
                        ctx)
    if cfg.family in ("dense", "moe"):
        for i, blk in enumerate(_layers(params)):
            x = _prefill_attn(cfg, blk, x, positions, cache, i, ctx)
            x = _ffn(cfg, blk, x, ctx)
    elif cfg.family == "vlm":
        _need_media(cfg, media)
        per = _vlm_layout(cfg)[1]
        selfs = unstack(params["self_blocks"])
        promote_cross_cache(cache, media, params["cross_blocks"]["attn"]["wk"])
        for g, cross in enumerate(unstack(params["cross_blocks"])):
            for i in range(g * per, (g + 1) * per):
                x = _prefill_attn(cfg, selfs[i], x, positions, cache, i,
                                  ctx)
                x = _ffn(cfg, selfs[i], x, ctx)
            xk, xv = _media_kv(cross, media)
            put(cache, "xk", g, xk)
            put(cache, "xv", g, xv)
            x = _cross_block_apply(cfg, cross, x, media, ctx)
    elif cfg.family == "ssm":
        x = L.norm_apply(params["ln0"], x)
        zeros_prev, state0 = _rwkv_zeros(cfg, B, x)
        for i, blk in enumerate(unstack(params["blocks"])):
            x, tm_last, cm_last, state = _rwkv_block_apply(
                cfg, blk, x, zeros_prev, zeros_prev, state0, ctx)
            put(cache, "wkv", i, state)
            put(cache, "tm_prev", i, tm_last)
            put(cache, "cm_prev", i, cm_last)
    else:  # hybrid
        conv0, ssd0 = _mamba_zeros(cfg, B, x)
        blocks = unstack(params["blocks"])
        W = cache["shared_k"].shape[2]
        sh = params["shared"]
        for g, (lo, hi) in enumerate(_hybrid_groups(cfg)):
            h, (k, v) = L.attn_prefill(sh["attn"], L.norm_apply(sh["ln1"], x),
                                       positions=positions,
                                       theta=cfg.rope_theta,
                                       window=cfg.sliding_window, ctx=ctx)
            x = x + h
            x = x + L.mlp_apply(sh["mlp"], L.norm_apply(sh["ln2"], x), ctx)
            # the trailing window of the cache (wrap-indexed at decode).  As
            # in the reference, it is cut from the cache padded to max_len,
            # not from the S prompt rows (ROADMAP's watch list): rows
            # max_len - W on when S >= W, else rows 0 on; of those, the
            # prompt's rows fill the front and the rest stays zero
            for name, t in (("shared_k", k), ("shared_v", v)):
                put_rows(cache, name, g, t,
                         skip=max_len - W if S >= W else 0)
            for i in range(lo, hi):
                x, conv_s, ssd_s = _mamba_block_apply(
                    cfg, blocks[i], x, conv0, ssd0, ctx)
                put(cache, "conv", i, conv_s)
                put(cache, "ssd", i, ssd_s)
    x = L.norm_apply(params["final_norm"], x[:, -1:])
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache


def _rwkv_step(cfg, blk, x, cache, i):
    """One RWKV6 layer for one token; updates layer i of ``cache`` in
    place."""
    B = x.shape[0]
    xin = L.norm_apply(blk["ln1"], x)
    r, k, v, w, g = L._rwkv6_projections(blk, xin, cache["tm_prev"][i][:, None],
                                         cfg)
    # the reference's decode step (repro/models/lm.py:545) calls this plain
    # function on every impl, outside any Pallas kernel, as it computes the
    # projections: it is the decode path, not a stand-in for the scan kernel
    y, wkv = ref.rwkv6_step_ref(r[:, 0], k[:, 0], v[:, 0],
                                w[:, 0].to(r.dtype), blk["tm"]["bonus"],
                                cache["wkv"][i])
    y = L.group_norm_apply(blk["tm"]["ln_x"], y.reshape(B, 1, cfg.d_model),
                           L.rwkv_heads(cfg))
    x = x + torch.einsum("bse,ed->bsd", y * g, blk["tm"]["wo"])
    h, cm_last = L.rwkv6_channel_mix(blk, L.norm_apply(blk["ln2"], x),
                                     cache["cm_prev"][i])
    put(cache, "wkv", i, wkv)
    put(cache, "tm_prev", i, xin[:, -1])
    put(cache, "cm_prev", i, cm_last)
    return x + h


def _mamba_step(cfg, blk, x, cache, i):
    """One Mamba2 layer for one token; updates layer i of ``cache`` in
    place."""
    s = cfg.ssm
    p = blk["mamba"]
    B = x.shape[0]
    z, xbc, dt, d_inner, H, N = L._mamba2_split(
        p, L.norm_apply(blk["ln"], x), cfg)
    seq = torch.cat([cache["conv"][i].to(xbc.dtype), xbc], dim=1)
    conv = sum(seq[:, j] * p["conv_w"][j][None] for j in range(s.conv_width))
    conv = F.silu((conv + p["conv_b"][None]).float()).to(x.dtype)
    x_ssm, Bv, Cv = torch.split(conv, [d_inner, N, N], dim=-1)
    xh = x_ssm.reshape(B, H, s.head_dim)
    dtf = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    # the reference's decode path (repro/models/lm.py:583) on every impl,
    # outside any Pallas kernel: not a stand-in for the SSD kernel
    y, ssd = ref.mamba2_step_ref(xh, dtf, A, Bv, Cv, cache["ssd"][i])
    y = y + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = L.group_norm_apply(p["norm"], y.reshape(B, 1, d_inner), H)
    y = y * F.silu(z.float()).to(x.dtype)
    put(cache, "conv", i, seq[:, 1:])
    put(cache, "ssd", i, ssd)
    return x + torch.einsum("bse,ed->bsd", y, p["out_proj"])


def _shared_step(cfg, sh, x, cache, g, pos, ctx):
    """The shared attention block for one token against its wrap-indexed
    window cache: the new key/value row goes IN PLACE into slot pos % W of
    invocation g's cache, and the live length is min(pos + 1, W)."""
    xin = L.norm_apply(sh["ln1"], x)
    q, k, v = L._qkv(sh["attn"], xin)
    q = L.rope_apply(q, pos[:, None], cfg.rope_theta)
    k = L.rope_apply(k, pos[:, None], cfg.rope_theta)
    ck, cv = cache["shared_k"][g], cache["shared_v"][g]
    W = ck.shape[1]
    pos = pos.to(device=x.device, dtype=torch.long)
    L.write_row(ck, k[:, 0], pos % W)
    L.write_row(cv, v[:, 0], pos % W)
    kv_len = torch.clamp(pos + 1, max=W).to(torch.int32)
    out = ops.decode_attention(q.contiguous(), ck, cv, kv_len, impl=ctx.impl)
    x = x + L._out(sh["attn"], out)
    return x + L.mlp_apply(sh["mlp"], L.norm_apply(sh["ln2"], x), ctx)


def _decode_attn(cfg, blk, x, cache, i, pos, ctx):
    """x plus the block's self-attention for one token against layer i of
    the KV cache, whose row ``pos`` it writes in place."""
    h, _ = L.attn_decode(blk["attn"], L.norm_apply(blk["ln1"], x),
                         cache["k"][i], cache["v"][i], pos,
                         theta=cfg.rope_theta, window=cfg.sliding_window,
                         ctx=ctx)
    return x + h


def decode(params, cfg: ArchConfig, cache: dict, tokens, pos, *,
           ctx: ShardCtx = NO_SHARD):
    """One decode step.  tokens (B, 1) int; pos (B,) int32 tokens already
    seen.  Updates ``cache`` in place; returns (logits (B, V) float32,
    cache).  The MoE layers are dropless; the vlm cross blocks attend to
    the media keys and values cached by prefill."""
    _require_family(cfg)
    x = L.embed_apply(params["embed"], tokens, ctx)
    if cfg.family in ("dense", "moe"):
        for i, blk in enumerate(_layers(params)):
            x = _decode_attn(cfg, blk, x, cache, i, pos, ctx)
            x = _ffn(cfg, blk, x, ctx, dropless=True)
    elif cfg.family == "vlm":
        per = _vlm_layout(cfg)[1]
        selfs = unstack(params["self_blocks"])
        for g, cross in enumerate(unstack(params["cross_blocks"])):
            for i in range(g * per, (g + 1) * per):
                x = _decode_attn(cfg, selfs[i], x, cache, i, pos, ctx)
                x = _ffn(cfg, selfs[i], x, ctx)
            h, _ = L.attn_decode(cross["attn"],
                                 L.norm_apply(cross["ln1"], x), None, None,
                                 pos, theta=cfg.rope_theta, ctx=ctx,
                                 cross_kv=(cache["xk"][g], cache["xv"][g]))
            x = _cross_mlp(cross, _gated(cross["gate_attn"], x, h), ctx)
    elif cfg.family == "ssm":
        x = L.norm_apply(params["ln0"], x)
        for i, blk in enumerate(unstack(params["blocks"])):
            x = _rwkv_step(cfg, blk, x, cache, i)
    else:  # hybrid
        blocks = unstack(params["blocks"])
        for g, (lo, hi) in enumerate(_hybrid_groups(cfg)):
            x = _shared_step(cfg, params["shared"], x, cache, g, pos, ctx)
            for i in range(lo, hi):
                x = _mamba_step(cfg, blocks[i], x, cache, i)
    x = L.norm_apply(params["final_norm"], x)
    return L.lm_head_apply(params["embed"], x, ctx)[:, 0], cache
