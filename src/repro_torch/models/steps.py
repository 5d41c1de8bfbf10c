"""Step factories: train_step / prefill_step / decode_step closures for an
arch.

The port's copy of ``repro/models/steps.py``.  ``make_train_step`` computes
the loss and its gradients with ``torch.autograd`` (the reference's
``jax.value_and_grad``), accumulates them over microbatches in the
reference's order and dtypes, and applies AdamW; nothing is updated in
place, so a caller may keep the state it passed in.  ``train_state_axes``
is the state's tree of logical axes, which the dry run's shardings read."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import cost
from repro_torch.models.layers import NO_SHARD, ShardCtx, lm_head_apply
from repro_torch.models.registry import family_module, get_model
from repro_torch.optim import adamw
from repro_torch.parallel.axes import tree_leaves, tree_unflatten
from repro_torch.parallel.partition import (is_dtensor, like, placed,
                                           replicated)


def _xent_chunk(embed_params, ctx, h, t):
    logits = lm_head_apply(embed_params, h, ctx)              # (B, c, V) fp32
    if is_dtensor(logits):      # the gold logit's gather reads whole rows
        from torch.distributed.tensor import Replicate
        logits = placed(logits, logits.device_mesh, tuple(
            Replicate() if p.is_shard(2) else p for p in logits.placements))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(t, min=0)[..., None])[..., 0]
    mask = (t >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(hidden, embed_params, targets, ctx: ShardCtx = NO_SHARD,
                 chunk: int = 1024):
    """Next-token cross-entropy computed in sequence chunks, so the (B, S, V)
    float32 logits never exist whole (each chunk is recomputed in the
    backward pass).  hidden: (B, S, D) final-norm states aligned with
    ``targets`` (B, S); padded positions get target -1 and are masked."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    # a DTensor's last chunk is ragged instead (padded rows add nothing)
    pad = 0 if is_dtensor(hidden) else (-S) % chunk
    targets = targets.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        args = (embed_params, ctx, hidden[:, c0:c0 + chunk],
                targets[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            s, c = torch.utils.checkpoint.checkpoint(_xent_chunk, *args,
                                                     use_reentrant=False)
        else:
            s, c = _xent_chunk(*args)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(cfg: ArchConfig, params, tokens, ctx: ShardCtx = NO_SHARD,
               *, media=None):
    """The train step's loss on one microbatch: (next-token CE over
    tokens[1:], aux loss: the MoE layers' load-balance losses, else 0),
    each 0-dim float32.  ``media`` (B, M, D): the vlm family's image
    embeddings or the audio family's frames, None for the others."""
    hidden, aux = family_module(cfg).apply(params, cfg, tokens, media=media,
                                           ctx=ctx, return_hidden=True)
    loss = chunked_xent(hidden[:, :-1], params["embed"], tokens[:, 1:], ctx)
    return loss, aux


def n_microbatches(cfg: ArchConfig, batch: int,
                   ctx: ShardCtx = NO_SHARD) -> int:
    """cfg.accum_steps clamped so that every microbatch stays shardable
    across ctx.n_groups data groups and divides the batch."""
    A = max(1, min(cfg.accum_steps, batch // max(ctx.n_groups, 1) or 1))
    while batch % A:
        A -= 1
    return A


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig | None = None,
                    ctx: ShardCtx = NO_SHARD):
    """Returns (train_step(state, batch) -> (state, metrics), opt_cfg).

    state = {params, opt, step}; batch = {tokens (B, S) [, media (B, M,
    D)]} (tensors or arrays; they go to the parameters' device, the media
    in their own dtype).  Loss: next-token CE over tokens[1:]
    (sequence-chunked, ``train_loss``) plus the MoE aux loss.
    cfg.accum_steps > 1 splits every batch key into microbatches
    (``n_microbatches``) with gradient accumulation: each microbatch's
    gradient cast to float32, added to the accumulator and cast to its
    dtype (float32, or bf16 when cfg.opt_dtype is "bf16"), the sum divided
    by the count in float32.

    On DTensor state (a step on a mesh, ``parallel/partition.py``) the
    same step runs on the shards: the loss is reduced to a replicated
    scalar before the backward pass, every gradient comes back laid out as
    its parameter (the partial sums of parameters replicated over ``data``
    reduced) before the accumulation and the update, and microbatch i holds
    the batch's rows [i B / A, (i + 1) B / A), each split over the data
    shards as the batch was."""
    get_model(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        moment_dtype="bf16" if cfg.opt_dtype == "bf16" else "fp32")
    acc_dtype = torch.bfloat16 if cfg.opt_dtype == "bf16" else torch.float32

    def grad_fn(params, batch):
        """(loss, aux, gradients in sorted-key leaf order)."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = train_loss(cfg, tree_unflatten(params, leaves),
                                   batch["tokens"], ctx,
                                   media=batch.get("media"))
            if is_dtensor(loss):       # partial sums reduced
                mesh = loss.device_mesh
                loss, aux = replicated(loss, mesh), replicated(aux, mesh)
            grads = torch.autograd.grad(loss + aux, leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None
                 else like(g, p) if is_dtensor(p) else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), aux.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = {k: batch[k] if is_dtensor(batch[k])
                 else torch.as_tensor(batch[k], device=dev)
                 for k in ("tokens", "media") if batch.get(k) is not None}
        batch["tokens"] = batch["tokens"].long()
        B = batch["tokens"].shape[0]
        A = n_microbatches(cfg, B, ctx)
        if A == 1:
            loss, aux, grads = grad_fn(params, batch)
        else:
            acc = [torch.zeros_like(p, dtype=acc_dtype)
                   for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            mbs = {k: _microbatches(v, A) for k, v in batch.items()}
            # on meta under launch/cost.py's count, one microbatch counted
            # for all: each runs the same operations on the same shapes
            with cost.repeat(batch["tokens"], A) as runs:
                for i in range(runs):
                    lm_, am, g = grad_fn(params, {k: v[i]
                                                  for k, v in mbs.items()})
                    acc = [(ga.float() + gi.float()).to(acc_dtype)
                           for ga, gi in zip(acc, g)]
                    del g
                    loss, aux = loss + lm_, aux + am
            grads = [g.float() / A for g in acc]
            del acc
            loss, aux = loss / A, aux / A
        total = loss + aux
        grads = tree_unflatten(params, grads)
        new_params, opt, om = adamw.apply_updates(params, grads, state["opt"],
                                                  opt_cfg)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total, **om}
        return {"params": new_params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step, opt_cfg


def _microbatches(v, A: int):
    """(B, ...) -> (A, B / A, ...): microbatch i is rows [i B / A, (i + 1)
    B / A).  A DTensor's batch split moves to the second dimension, so
    each microbatch is split over the data shards as the batch was."""
    out = v.reshape(A, v.shape[0] // A, *v.shape[1:])
    if not is_dtensor(v):
        return out
    from torch.distributed.tensor import Shard
    return placed(out, v.device_mesh, tuple(
        Shard(p.dim + 1) if p.is_shard() else p for p in v.placements))


def make_prefill_step(cfg: ArchConfig, ctx: ShardCtx = NO_SHARD):
    get_model(cfg)
    family = family_module(cfg)

    def prefill_step(params, batch):
        return family.prefill(params, cfg, batch["tokens"],
                              media=batch.get("media"), ctx=ctx)

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: ShardCtx = NO_SHARD):
    """decode_step(params, cache, tokens (B, 1), pos (B,)) -> (next_token,
    logits, cache); the cache is updated in place (``lm.decode``)."""
    get_model(cfg)
    family = family_module(cfg)

    def decode_step(params, cache, tokens, pos):
        logits, cache = family.decode(params, cfg, cache, tokens, pos,
                                      ctx=ctx)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return decode_step


def init_train_state(cfg: ArchConfig, seed: int, opt_cfg: adamw.AdamWConfig,
                     device=None) -> dict:
    """Seeded parameters (``Model.init``), zero moments and step 0 on
    ``device`` (None: CUDA, under the port's device rule)."""
    dev = resolve_device(device)
    params = get_model(cfg).init(seed, device=dev)
    return {"params": params, "opt": adamw.init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig) -> dict:
    """The train state's shapes and dtypes, on the ``meta`` device."""
    ap = get_model(cfg).abstract_params()
    return {"params": ap, "opt": adamw.abstract_opt_state(ap, opt_cfg),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_axes(cfg: ArchConfig) -> dict:
    pa = get_model(cfg).params_axes()
    return {"params": pa, "opt": adamw.opt_state_axes(pa), "step": ()}
