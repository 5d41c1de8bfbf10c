"""Model-zoo building blocks in PyTorch.

The port's copy of ``repro/models/layers.py``: norms, RoPE, attention (self
and cross, for the full sequence, prefill with a KV cache and cached
decode), the MLPs, the Mixture of Experts, RWKV6's time and channel mix,
the Mamba2 block, the embedding and the LM head.  Every block exposes
``<block>_defs(...) -> tree[ParamDef]`` and apply functions on tensors,
with the reference's names, parameter layouts and arithmetic: norms, RoPE
and the activations compute in float32 and cast back; projections and the
experts' products are ``torch.einsum`` (the reference leaves them to XLA,
outside any Pallas kernel); attention and the two scans go through
``kernels.ops``, which launches the CUDA kernels on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.parallel.axes import NamedSharding, ParamDef, logical_to_spec
from repro_torch.parallel.partition import (is_dtensor, local_shape_offset,
                                           placed)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Runtime knobs carried into the apply functions, the reference's
    ``ShardCtx``.  ``mesh`` (a ``launch.mesh.Mesh``) and ``rules`` (its
    logical-axis rule table) place activations: ``constrain`` lays a
    DTensor out as the rules say, on its own DeviceMesh, and is the
    identity on plain tensors or without a mesh.  ``impl`` is
    passed to ``kernels.ops`` (None picks by device, "torch" the plain
    versions, "cuda" the kernels); ``n_groups`` is the number of data
    shards (1 on one device): the groups ``moe_apply`` routes and caps
    tokens within, and what ``models.steps.make_train_step`` keeps every
    microbatch divisible across."""
    mesh: Any = None
    rules: Mapping[str, Any] | None = None
    n_groups: int = 1
    impl: str | None = None

    def spec_placements(self, device_mesh, *axes) -> tuple:
        """The DTensor placements of logical ``axes`` on ``device_mesh``."""
        return NamedSharding(self.mesh, logical_to_spec(
            axes, self.rules, self.mesh)).placements(device_mesh)

    def constrain(self, x, *axes):
        if self.mesh is None or self.rules is None or not is_dtensor(x):
            return x
        return placed(x, x.device_mesh,
                      self.spec_placements(x.device_mesh, *axes))


NO_SHARD = ShardCtx()


def einsum(eq: str, *operands):
    """``torch.einsum`` with its operands promoted to their common dtype,
    as ``jnp.einsum`` promotes them: float32 media (or an activation
    computed from them) meeting bf16 weights is a float32 product, where
    ``torch.einsum`` refuses mixed dtypes.  Operands of one dtype pass
    unchanged."""
    dt = operands[0].dtype
    if all(o.dtype == dt for o in operands):
        return torch.einsum(eq, *operands)
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(eq, *(o.to(dt) for o in operands))


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


def group_norm_apply(scale, x, n_groups: int, eps: float = 1e-5):
    """Per-head group norm over the last dim cut into groups (RWKV6's ln_x,
    Mamba2's gated norm)."""
    B, S, D = x.shape
    xf = x.float().reshape(B, S, n_groups, D // n_groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, D)
    return (y * scale.float()).to(x.dtype)


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
# Attention (self / cross, full sequence, prefill into a cache, cached
# decode)
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


def _qkv(p, x, kv_x=None):
    """q from x, k and v from kv_x (x when None), each promoted as
    ``jnp.einsum`` does: float32 media give float32 keys and values on bf16
    weights, and attention then computes in float32 (``kernels.ops``)."""
    kv_x = x if kv_x is None else kv_x
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", kv_x, p["wk"])
    v = einsum("bsd,dhk->bshk", kv_x, p["wv"])
    return q, k, v


def _out(p, o):
    return einsum("bshk,hkd->bsd", o, p["wo"])


def attn_apply(p, x, *, positions=None, theta=10000.0, causal=True,
               window=0, ctx: ShardCtx = NO_SHARD, kv_x=None, use_rope=True):
    """Full-sequence attention.  ``kv_x`` (B, M, D) makes it cross
    attention: keys and values from kv_x, never causal, RoPE (when
    ``use_rope`` and positions are given) on the queries only."""
    q, k, v = _qkv(p, x, kv_x)
    if use_rope and positions is not None:
        q = rope_apply(q, positions, theta)
        if kv_x is None:
            k = rope_apply(k, positions, theta)
    q = ctx.constrain(q, "batch", "seq", "heads", "head_dim")
    k = ctx.constrain(k, "batch", "seq", "kv_heads", "head_dim")
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal and kv_x is None, window=window,
                              impl=ctx.impl)
    return ctx.constrain(_out(p, out), "batch", "seq", "embed")


def attn_prefill(p, x, *, positions, theta, causal=True, window=0,
                 ctx: ShardCtx = NO_SHARD, cache_len: int | None = None,
                 use_rope=True):
    """Full-sequence attention that also emits a right-padded KV cache of
    length cache_len: (y, (k, v)) with k/v (B, cache_len, Hkv, Dh).  With
    ``cache_len`` None, k/v are the S prompt rows unpadded, which the
    model's prefill writes into its zero cache (``lm.put_rows``)."""
    q, k, v = _qkv(p, x)
    if use_rope:
        q = rope_apply(q, positions, theta)
        k = rope_apply(k, positions, theta)
    k, v = k.contiguous(), v.contiguous()
    out = ops.flash_attention(q.contiguous(), k, v, causal=causal,
                              window=window, impl=ctx.impl)
    if cache_len is not None:
        pad = (0, 0, 0, 0, 0, cache_len - x.shape[1])
        k, v = F.pad(k, pad), F.pad(v, pad)
    return ctx.constrain(_out(p, out), "batch", "seq", "embed"), (k, v)


def attn_decode(p, x, cache_k, cache_v, pos, *, theta, window=0,
                ctx: ShardCtx = NO_SHARD, use_rope=True, cross_kv=None):
    """Single-token decode.  x: (B, 1, D); cache_k/v: (B, Smax, Hkv, Dh);
    pos: (B,) number of tokens already in the cache.  Returns
    y, (cache_k, cache_v).

    Unlike the reference, which returns new arrays, the new key and value
    rows are written into ``cache_k``/``cache_v`` IN PLACE at ``pos`` and
    the same tensors are returned: a serving cache is updated, never
    copied.  With ``cross_kv`` = (k, v), each (B, M, Hkv, Dh), the query
    attends to all M rows of that static cache instead, nothing is written
    and ``cache_k``/``cache_v`` come back as given."""
    if cross_kv is not None:
        ck, cv = cross_kv
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        kv_len = torch.full((x.shape[0],), ck.shape[1], dtype=torch.int32,
                            device=x.device)
        out = ops.decode_attention(q.contiguous(), ck, cv, kv_len,
                                   impl=ctx.impl)
        return ctx.constrain(_out(p, out), "batch", "seq", "embed"), \
            (cache_k, cache_v)
    q, k, v = _qkv(p, x)
    if use_rope:
        q = rope_apply(q, pos[:, None], theta)
        k = rope_apply(k, pos[:, None], theta)
    pos = pos.to(device=x.device, dtype=torch.long)
    write_row(cache_k, k[:, 0], pos)
    write_row(cache_v, v[:, 0], pos)
    cache_k = ctx.constrain(cache_k, "batch", "kv_seq", "kv_heads",
                            "head_dim")
    cache_v = ctx.constrain(cache_v, "batch", "kv_seq", "kv_heads",
                            "head_dim")
    kv_len = (pos + 1).to(torch.int32)
    out = ops.decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                               window=window, impl=ctx.impl)
    return ctx.constrain(_out(p, out), "batch", "seq", "embed"), \
        (cache_k, cache_v)


def write_row(cache, row, slot):
    """cache[b, slot[b]] = row[b] IN PLACE, for a cache (B, Smax, Hkv, Dh)
    and rows (B, Hkv, Dh), cast to the cache's dtype.  On a DTensor cache
    cut along its sequence, only the rank whose slice holds a sequence's
    slot writes its row, at slot - start: the row is laid out as the cache
    is apart from the sequence (replicated over the ranks that cut it),
    and every rank writes into its own block."""
    if not is_dtensor(cache):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, slot] = row.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    dm = cache.device_mesh
    row = placed(row, dm, tuple(
        Shard(0) if pl.is_shard(0) else Shard(1) if pl.is_shard(2)
        else Replicate() for pl in cache.placements)).to_local()
    slot = placed(slot, dm, tuple(
        Shard(0) if pl.is_shard(0) else Replicate()
        for pl in cache.placements)).to_local()
    local = cache.to_local()
    idx = slot - local_shape_offset(cache)[1][1]
    own = (idx >= 0) & (idx < local.shape[1])
    idx = idx.clamp(0, local.shape[1] - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    local[bidx, idx] = torch.where(own[:, None, None], row.to(local.dtype),
                                   local[bidx, idx])


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
    up = einsum("bsd,df->bsf", x, p["wu"])
    if "wg" in p:
        h = F.silu(einsum("bsd,df->bsf", x, p["wg"]).float())
        h = h.to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    h = ctx.constrain(h, "batch", "seq", "ff")
    return ctx.constrain(einsum("bsf,fd->bsd", h, p["wd"]),
                         "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based token dispatch, capacity-bounded)
# ---------------------------------------------------------------------------

def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d_model = cfg.d_model
    d = {
        "router": ParamDef((d_model, m.n_experts), ("embed", "experts"),
                           init="scaled", scale=0.1),
        "wg": ParamDef((m.n_experts, d_model, m.expert_ff),
                       ("experts", "embed", "expert_ff"), init="scaled"),
        "wu": ParamDef((m.n_experts, d_model, m.expert_ff),
                       ("experts", "embed", "expert_ff"), init="scaled"),
        "wd": ParamDef((m.n_experts, m.expert_ff, d_model),
                       ("experts", "expert_ff", "embed"), init="scaled"),
    }
    if m.n_shared_experts:
        d["shared"] = mlp_defs(d_model, m.n_shared_experts * m.expert_ff)
    return d


def moe_capacity(cfg: ArchConfig, Tg: int, dropless: bool) -> int:
    """Slots per expert for a group of Tg tokens: all Tg * top_k pairs when
    dropless, else capacity_factor's share, at least 1 (the reference's
    formula, in Python on the shapes)."""
    m = cfg.moe
    K = m.top_k
    if dropless:
        return Tg * K
    return min(max(1, int(m.capacity_factor * Tg * K / m.n_experts)), Tg * K)


def moe_route(p, xt, cfg: ArchConfig):
    """The router on tokens xt (G, Tg, D): the softmax probabilities
    (G, Tg, E) float32, and each token's top_k experts (G, Tg, K) with
    their probabilities renormalised to sum to 1.  Equal probabilities go
    to the lower expert id first, the order of ``jax.lax.top_k``: a stable
    descending sort, where ``torch.topk`` promises no order among equal
    values."""
    K = cfg.moe.top_k
    logits = torch.einsum("gtd,de->gte", xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :K], idx[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def moe_apply(p, x, cfg: ArchConfig, ctx: ShardCtx = NO_SHARD,
              dropless=False):
    """x: (B, S, D) -> (y (B, S, D), aux loss 0-dim float32).

    The reference's sort-based dispatch (``repro/models/layers.py:229``):
    tokens in ``ctx.n_groups`` groups, each group's (token, expert) pairs
    stably sorted by expert, the first C of each expert kept (C from
    ``moe_capacity``; the rest are dropped and keep the shared-expert and
    residual paths), the experts' SwiGLU as three batched products, each
    token's weighted outputs summed in increasing expert id in x's dtype
    (the order of a sequential scatter over the sorted pairs, without the
    run-to-run variation of atomics), then the shared experts.  Groups of
    more than ``chunk_tokens`` tokens are dispatched chunk by chunk and the
    aux loss is the chunks' mean.  Nothing here waits for the device: no
    boolean indexing and no host read, the reference's masks are
    multiplications.

    On a DTensor x the dispatch runs under ``local_map`` on every rank's
    own tokens (whole groups: the groups are the data shards), each rank
    computing only the products of the experts it holds (the experts are
    sharded over ``model``); the combine is then a partial sum over those
    ranks, which the last ``constrain`` reduces."""
    if is_dtensor(x):
        return _moe_sharded(p, x, cfg, ctx, dropless)
    B, S, _ = x.shape
    y, me, ce = _moe_dispatch(p, x, cfg, _moe_groups(ctx.n_groups, B * S),
                              dropless, ctx=ctx)
    return ctx.constrain(y, "batch", "seq", "embed"), _moe_aux(cfg, me, ce)


def _moe_groups(n_groups: int, T: int) -> int:
    """The routing groups of T tokens: n_groups, or the largest divisor of
    T below it."""
    G = min(n_groups, T)
    while T % G:
        G -= 1
    return G


def _moe_aux(cfg: ArchConfig, me, ce):
    """The load-balance aux loss (Switch-style, counted before drops) from
    each chunk's mean router probabilities ``me`` and top-1 shares ``ce``
    (n_chunks, E): the chunks' mean."""
    m = cfg.moe
    return ((me * ce).sum(-1) * m.n_experts * m.router_aux_weight).mean()


def _moe_dispatch(p, x, cfg: ArchConfig, G: int, dropless, *, e_lo=0,
                  shared=True, ctx: ShardCtx = NO_SHARD):
    """The dispatch on plain tensors: x (B, S, D) in G groups -> (y (B, S,
    D), me, ce (n_chunks, E)).  ``p``'s experts may be a block of the E:
    those from expert ``e_lo``; y then holds only their outputs (and the
    shared experts' when ``shared``)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    Tg = T // G
    if m.chunk_tokens and Tg > m.chunk_tokens:
        sub = m.chunk_tokens
        while Tg % sub:
            sub -= 1
        xs = x.reshape(G, Tg // sub, sub, D)
        ys, mes, ces = zip(*(_moe_dispatch(p, xs[:, i], cfg, G, dropless,
                                           e_lo=e_lo, shared=shared, ctx=ctx)
                             for i in range(Tg // sub)))
        return (torch.stack(ys, 1).reshape(B, S, D), torch.cat(mes),
                torch.cat(ces))
    E, K = m.n_experts, m.top_k
    El = p["wg"].shape[0]                     # the experts held here
    C = moe_capacity(cfg, Tg, dropless)
    dev = x.device

    xt = ctx.constrain(x.reshape(G, Tg, D), "batch", None, "embed")
    probs, topv, topi = moe_route(p, xt, cfg)
    me = probs.mean(dim=(0, 1))[None]
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))[None]

    # dispatch: pair j = t * K + k of a group, sorted stably by expert
    eid = topi.reshape(G, Tg * K)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = eid.gather(1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(eid_s, experts)                 # (G, E)
    count = torch.searchsorted(eid_s, experts, right=True) - start
    if El < E:
        start_l = start[:, e_lo:e_lo + El]
        count_l = count[:, e_lo:e_lo + El]
    else:
        start_l, count_l = start, count
    slot = torch.arange(C, device=dev)
    src = start_l[..., None] + slot                            # (G, El, C)
    filled = slot < count_l[..., None]
    src = torch.where(filled, src, 0).reshape(G, El * C)
    tok = (order.gather(1, src) // K).reshape(G, El, C)
    gidx = torch.arange(G, device=dev)
    xin = xt[gidx[:, None, None], tok] * filled[..., None].to(x.dtype)
    xin = ctx.constrain(xin, "batch", "experts", None, "embed")

    # the experts' FFN (G, El, C, D)
    gate = F.silu(torch.einsum("gecd,edf->gecf", xin, p["wg"]).float())
    up = torch.einsum("gecd,edf->gecf", xin, p["wu"])
    h = ctx.constrain(gate.to(x.dtype) * up, "batch", "experts", None,
                      "expert_ff")
    out_e = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out_e = ctx.constrain(out_e, "batch", "experts", None, "embed")

    # combine: each pair's slot, its kept weight, the K outputs of a token
    # summed in increasing expert id
    pair_slot = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tg * K, device=dev).expand(G, -1)
        - start.gather(1, eid_s))
    keep = pair_slot < C
    if El < E:
        held = (eid >= e_lo) & (eid < e_lo + El)
        keep = keep & held
        eid = torch.where(held, eid - e_lo, 0)
    vals = out_e[gidx[:, None], eid, torch.where(keep, pair_slot, 0)]
    w = topv.reshape(G, Tg * K) * keep.float()
    vals = (vals * w.to(x.dtype)[..., None]).reshape(G, Tg, K, D)
    by_id = torch.argsort(topi, dim=-1)[..., None].expand(-1, -1, -1, D)
    vals = vals.gather(2, by_id)
    y = vals[:, :, 0]
    for k in range(1, K):
        y = y + vals[:, :, k]
    y = y.reshape(B, S, D)
    if shared and m.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, ctx)
    return y, me, ce


def _moe_sharded(p, x, cfg: ArchConfig, ctx: ShardCtx, dropless):
    """moe_apply on a DTensor x: the dispatch under ``local_map`` on each
    rank's tokens and its block of experts.  Per mesh dimension that
    shards the batch the groups split with it; per mesh dimension that
    shards the experts each rank combines only its experts' outputs, a
    partial sum.  The router is gathered whole.  The mean router
    probabilities and top-1 shares come out as partial sums of each
    rank's share, so their gradients reach every rank whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    E = cfg.moe.n_experts
    B, S, _ = x.shape
    dm = x.device_mesh
    wpl = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                for pl in p["wg"].placements)
    xpl = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                for pl in x.placements)
    batch = [i for i, pl in enumerate(xpl) if pl.is_shard()]
    ep = [i for i, pl in enumerate(wpl) if pl.is_shard()]
    if set(batch) & set(ep):
        raise ValueError("one mesh dimension shards both the tokens and "
                         "the experts")
    n_batch = math.prod(dm.size(i) for i in batch)
    n_ep = math.prod(dm.size(i) for i in ep)
    G = _moe_groups(ctx.n_groups, B * S)
    if G % n_batch or B % n_batch or E % n_ep:
        raise ValueError(f"{G} routing groups of {B} sequences, {E} "
                         f"experts: not whole on {n_batch} x {n_ep} ranks")
    x = placed(x, dm, xpl)
    experts = {k: placed(p[k], dm, wpl) for k in ("wg", "wu", "wd")}
    router = placed(p["router"], dm, (Replicate(),) * dm.ndim)
    e_lo = local_shape_offset(experts["wg"])[1][0]

    def per(kinds):
        return tuple(Partial() if i in kinds[0] else Shard(0)
                     if i in kinds[1] else Replicate()
                     for i in range(dm.ndim))
    part = per((batch + ep, ()))

    def local(xl, rl, wg, wu, wd):
        y, me, ce = _moe_dispatch(
            {"router": rl, "wg": wg, "wu": wu, "wd": wd}, xl, cfg,
            G // n_batch, dropless, e_lo=e_lo, shared=False)
        share = n_batch * n_ep
        return y, me / share, ce / share
    y, me, ce = local_map(
        local,
        out_placements=(per((ep, batch)), part, part),
        in_placements=(xpl, router.placements) + (wpl,) * 3,
        in_grad_placements=(per((ep, batch)), part) + (per((batch, ep)),) * 3,
        device_mesh=dm)(x, router, experts["wg"], experts["wu"],
                        experts["wd"])
    if cfg.moe.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, ctx)
    return ctx.constrain(y, "batch", "seq", "embed"), _moe_aux(cfg, me, ce)


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

def rwkv_heads(cfg: ArchConfig) -> int:
    """RWKV time-mix heads are d_model / head_dim (projections are D->D)."""
    return cfg.d_model // cfg.ssm.head_dim


def rwkv6_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    n_mix = 5  # r, k, v, w, g
    return {
        "tm": {  # time mix
            "mu": ParamDef((n_mix, D), (None, "embed"), init="zeros"),
            "mix_w1": ParamDef((D, n_mix * s.lora_mix), ("embed", None),
                               init="scaled"),
            "mix_w2": ParamDef((n_mix, s.lora_mix, D), (None, None, "embed"),
                               init="scaled", scale=0.1),
            "decay0": ParamDef((D,), ("embed",), init="zeros"),
            "decay_w1": ParamDef((D, s.lora_decay), ("embed", None),
                                 init="scaled"),
            "decay_w2": ParamDef((s.lora_decay, D), (None, "embed"),
                                 init="scaled", scale=0.1),
            "bonus": ParamDef((rwkv_heads(cfg), s.head_dim),
                              ("heads", "head_dim"), init="zeros"),
            "wr": ParamDef((D, D), ("embed", "heads_x_dim"), init="scaled"),
            "wk": ParamDef((D, D), ("embed", "heads_x_dim"), init="scaled"),
            "wv": ParamDef((D, D), ("embed", "heads_x_dim"), init="scaled"),
            "wg": ParamDef((D, D), ("embed", "heads_x_dim"), init="scaled"),
            "wo": ParamDef((D, D), ("heads_x_dim", "embed"), init="scaled"),
            "ln_x": ParamDef((D,), ("embed",), init="ones"),
        },
        "cm": {  # channel mix
            "mu_k": ParamDef((D,), ("embed",), init="zeros"),
            "mu_r": ParamDef((D,), ("embed",), init="zeros"),
            "wk": ParamDef((D, cfg.d_ff), ("embed", "ff"), init="scaled"),
            "wv": ParamDef((cfg.d_ff, D), ("ff", "embed"), init="scaled"),
            "wr": ParamDef((D, D), ("embed", "heads_x_dim"), init="scaled"),
        },
    }


def _rwkv6_projections(p, x, x_prev, cfg: ArchConfig):
    """Shared by the full-sequence time mix and the decode step.  x, x_prev:
    (B, S, D).  Returns r, k, v (B, S, H, Dh) in x's dtype, the decay w
    (B, S, H, Dh) in float32, in (0, 1), and the gate g (B, S, D)."""
    s = cfg.ssm
    H, Dh = rwkv_heads(cfg), s.head_dim
    B, S, D = x.shape
    tm = p["tm"]
    delta = x_prev - x
    # data-dependent token-shift amounts (5 lerp amounts via LoRA)
    mix_in = torch.tanh(torch.einsum("bsd,dr->bsr", x + 0.5 * delta,
                                     tm["mix_w1"]).float()).to(x.dtype)
    mix_in = mix_in.reshape(B, S, 5, s.lora_mix)
    dyn = torch.einsum("bsnr,nrd->nbsd", mix_in, tm["mix_w2"])
    mu = tm["mu"][:, None, None, :].to(x.dtype)
    xr, xk, xv, xw, xg = x[None] + delta[None] * (mu + dyn)     # (5, B, S, D)
    r = torch.einsum("bsd,de->bse", xr, tm["wr"]).reshape(B, S, H, Dh)
    k = torch.einsum("bsd,de->bse", xk, tm["wk"]).reshape(B, S, H, Dh)
    v = torch.einsum("bsd,de->bse", xv, tm["wv"]).reshape(B, S, H, Dh)
    g = F.silu(torch.einsum("bsd,de->bse", xg, tm["wg"]).float()).to(x.dtype)
    dec = tm["decay0"].float() + torch.einsum(
        "bsd,dr->bsr", torch.tanh(xw.float()),
        tm["decay_w1"].float()) @ tm["decay_w2"].float()
    w = torch.exp(-torch.exp(dec.clamp(-20.0, 10.0))).reshape(B, S, H, Dh)
    return r, k, v, w, g


def _shift(x, x_prev_row):
    """(B, S, D) -> the previous token's row at every position, x_prev_row
    (B, D) before the first."""
    return torch.cat([x_prev_row[:, None], x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, x_prev_row, state0, cfg: ArchConfig,
                   ctx: ShardCtx = NO_SHARD):
    """Full-sequence time mix.  x: (B, S, D); x_prev_row: (B, D) last token
    of the previous segment (zeros at the start); state0: (B, H, Dh, Dh)
    float32.  Returns y, (last x row, final state)."""
    B, S, D = x.shape
    r, k, v, w, g = _rwkv6_projections(p, x, _shift(x, x_prev_row), cfg)
    y, state = ops.rwkv6_scan(r, k, v, w.to(r.dtype), p["tm"]["bonus"],
                              state0, impl=ctx.impl)
    y = group_norm_apply(p["tm"]["ln_x"], y.reshape(B, S, D), rwkv_heads(cfg))
    y = torch.einsum("bse,ed->bsd", y * g, p["tm"]["wo"])
    return ctx.constrain(y, "batch", "seq", "embed"), (x[:, -1], state)


def rwkv6_channel_mix(p, x, x_prev_row):
    """x: (B, S, D); returns y, last x row."""
    delta = _shift(x, x_prev_row) - x
    cm = p["cm"]
    xk = x + delta * cm["mu_k"].to(x.dtype)
    xr = x + delta * cm["mu_r"].to(x.dtype)
    k = torch.einsum("bsd,df->bsf", xk, cm["wk"])
    k = torch.square(F.relu(k.float())).to(x.dtype)
    v = torch.einsum("bsf,fd->bsd", k, cm["wv"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, cm["wr"]).float()
                      ).to(x.dtype)
    return r * v, x[:, -1]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_defs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner = s.expand * D
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return {
        "in_proj": ParamDef((D, 2 * d_inner + 2 * s.state_dim + H),
                            ("embed", "heads_x_dim"), init="scaled"),
        "conv_w": ParamDef((s.conv_width, conv_ch), ("conv", "heads_x_dim"),
                           init="scaled", scale=0.5),
        "conv_b": ParamDef((conv_ch,), ("heads_x_dim",), init="zeros"),
        "a_log": ParamDef((H,), ("heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("heads",), init="ones"),
        "norm": ParamDef((d_inner,), ("heads_x_dim",), init="ones"),
        "out_proj": ParamDef((d_inner, D), ("heads_x_dim", "embed"),
                             init="scaled"),
    }


def _mamba2_split(p, x, cfg: ArchConfig):
    """The input projection cut into z (gate), xbc (conv input) and dt."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    N = s.state_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt, d_inner, H, N


def mamba2_apply(p, x, conv_state0, ssd_state0, cfg: ArchConfig,
                 ctx: ShardCtx = NO_SHARD):
    """Full-sequence Mamba2 block.  conv_state0: (B, conv_w - 1, conv_ch)
    left context; ssd_state0: (B, H, P, N) float32.  Returns y,
    (conv_state, ssd_state)."""
    s = cfg.ssm
    B, S, D = x.shape
    z, xbc, dt, d_inner, H, N = _mamba2_split(p, x, cfg)
    # causal conv over the sequence with the carried left context: the
    # reference's sum of shifted products, in its order
    seq = torch.cat([conv_state0.to(xbc.dtype), xbc], dim=1)
    kernel = p["conv_w"]
    conv = sum(seq[:, i:i + S] * kernel[i][None, None]
               for i in range(s.conv_width))
    conv = F.silu((conv + p["conv_b"][None, None]).float()).to(x.dtype)
    x_ssm, Bmat, Cmat = torch.split(conv, [d_inner, N, N], dim=-1)
    xh = x_ssm.reshape(B, S, H, s.head_dim)
    dtf = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    y, ssd_state = ops.mamba2_ssd(xh.contiguous(), dtf.to(x.dtype), A,
                                  Bmat.contiguous(), Cmat.contiguous(),
                                  ssd_state0, impl=ctx.impl)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = group_norm_apply(p["norm"], y.reshape(B, S, d_inner), H)
    y = y * F.silu(z.float()).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return ctx.constrain(out, "batch", "seq", "embed"), \
        (seq[:, S:], ssd_state)


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
    """The tokens' rows of the embedding.  On DTensors the table is
    gathered whole and every rank looks up its own tokens (``local_map``):
    a lookup into a table sharded over its vocabulary is left to no
    DTensor strategy, whose backward differs between torch versions."""
    table = p["embedding"]
    if is_dtensor(table):
        return ctx.constrain(_embed_local(table, tokens), "batch", "seq",
                             "embed")
    return ctx.constrain(table[tokens], "batch", "seq", "embed")


def _embed_local(table, tokens):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = table.device_mesh
    whole = (Replicate(),) * dm.ndim
    if not is_dtensor(tokens):
        tokens = placed(tokens, dm, whole)
    tpl = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                for pl in tokens.placements)
    # each rank's rows of the table's gradient: its own tokens' share
    grad = tuple(Partial() if pl.is_shard() else Replicate() for pl in tpl)
    return local_map(lambda t, ids: t[ids], out_placements=list(tpl),
                     in_placements=(whole, tpl),
                     in_grad_placements=(grad, tpl), device_mesh=dm)(
        placed(table, dm, whole), placed(tokens, dm, tpl))


def lm_head_apply(p, x, ctx: ShardCtx = NO_SHARD):
    """Logits in float32 (B, S, V)."""
    if "lm_head" in p:
        logits = torch.einsum("bsd,dv->bsv", x, p["lm_head"])
    else:
        logits = torch.einsum("bsd,vd->bsv", x, p["embedding"])
    return ctx.constrain(logits.float(), "batch", "seq", "vocab")


def xent_loss(logits, targets, mask=None):
    """Stable cross-entropy; logits (B, S, V) float32, targets (B, S) int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
