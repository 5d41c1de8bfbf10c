"""AdamW from scratch, with a configurable moment dtype: bf16 moments halve
the optimizer's bytes while the update arithmetic stays float32.

The port's copy of ``repro/optim/adamw.py``: the same configuration,
schedule (linear warmup, cosine decay to ``min_lr_frac``), global-norm
clipping and update rule (weight decay on leaves of two or more dimensions,
not on norms and biases), on torch tensors.  Leaves are visited in
sorted-key order (``parallel.axes.tree_leaves``), JAX's order for dicts."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.axes import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel.partition import is_dtensor, replicated


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "fp32"  # fp32 | bf16
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bf16" else torch.float32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    md = _mdtype(cfg)
    count_on = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=md, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=count_on)}


def abstract_opt_state(abstract_params: Any, cfg: AdamWConfig) -> dict:
    """The optimizer state's shapes and dtypes, on the ``meta`` device."""
    md = _mdtype(cfg)

    def meta(p):
        return torch.empty(p.shape, dtype=md, device="meta")
    return {"m": tree_map(meta, abstract_params),
            "v": tree_map(meta, abstract_params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_axes(param_axes: Any) -> dict:
    """Moments shard exactly like their parameters."""
    return {"m": param_axes, "v": param_axes, "count": ()}


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf together.  On DTensors each leaf's sum of
    squares is reduced over the shards first (a sharded leaf's local sum
    is a partial sum), so the norm, and the clip scale taken from it, are
    the whole tree's on every rank, never a rank's own."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    mesh = next((x.device_mesh for x in sums if is_dtensor(x)), None)
    if mesh is not None:
        sums = [replicated(x, mesh) for x in sums]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics); nothing is updated in
    place."""
    count = opt_state["count"] + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 \
        else torch.ones_like(gnorm)
    md = _mdtype(cfg)
    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:  # matrices, not norms/biases
            step = step + cfg.weight_decay * p.float()
        newp = p.float() - lr * step
        return newp.to(p.dtype), m32.to(md), v32.to(md)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
