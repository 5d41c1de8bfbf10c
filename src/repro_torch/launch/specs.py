"""Per-(arch x shape x mesh) inputs of a dry run: ``meta`` tensors (no
allocation) and the NamedShardings they would have on the mesh.

The port's copy of ``repro/launch/specs.py``: the same rules, specs and
cell layout.  ``build_cell`` returns the step and its arguments for
``launch/cost.py``'s counting mode (the reference lowers them with
``jax.jit``) and for ``parallel/partition.py:run_cell``, which runs the
step on a DeviceMesh with the shardings applied; the shardings are
records that also give each leaf's per-device shape
(``parallel.axes.NamedSharding``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import data_shards
from repro_torch.models.layers import ShardCtx
from repro_torch.models.registry import get_model
from repro_torch.models.steps import (abstract_train_state, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      train_state_axes)
from repro_torch.optim import adamw
from repro_torch.parallel.axes import (NamedSharding, logical_to_spec,
                                       make_rules, tree_sharding)


def arch_rules(arch: ArchConfig, shape: ShapeConfig, mesh):
    """Sharding rule table for this cell.

    Inference KV caches shard along ``kv_seq`` over the model axis (GQA
    kv-heads are usually too few for it).  Long-context decode with batch
    too small for the data axes additionally spreads kv_seq over them."""
    seq_par = shape.kind == "decode" and shape.global_batch < data_shards(mesh)
    overrides = dict(arch.sharding_overrides)
    if shape.kind in ("decode", "prefill"):
        overrides.setdefault("kv_seq",
                             ("data", "model") if seq_par else "model")
    fsdp = arch.fsdp
    if shape.kind == "decode" and arch.decode_fsdp is not None:
        fsdp = arch.decode_fsdp
    return make_rules(fsdp=fsdp, shard_kv_heads=arch.shard_kv_heads,
                      sequence_parallel=seq_par, overrides=overrides)


def shard_ctx(arch: ArchConfig, shape: ShapeConfig, mesh) -> ShardCtx:
    """The step's runtime knobs on ``mesh``: the mesh and the cell's rules
    (``constrain`` lays DTensor activations out by them), and the data
    shards, which set the MoE routing groups and the microbatch split.
    ``impl`` stays with the device (the reference forces "xla"): on the
    card, and on ``meta`` under the counting mode, the cell runs the
    kernels."""
    return ShardCtx(mesh=mesh, rules=arch_rules(arch, shape, mesh),
                    n_groups=data_shards(mesh))


def batch_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """Abstract input batch for this cell, on ``meta``."""
    model = get_model(arch)
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta(B, S)}
        if model.needs_media():
            batch["media"] = model.media_struct(B)
        return batch
    # decode: one new token against a cache of S
    return {"tokens": meta(B, 1), "pos": meta(B)}


def batch_shardings(arch: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    rules = arch_rules(arch, shape, mesh)

    def named(*axes):
        return NamedSharding(mesh, logical_to_spec(axes, rules, mesh))
    if shape.kind in ("train", "prefill"):
        out = {"tokens": named("batch", "seq")}
        if get_model(arch).needs_media():
            out["media"] = named("batch", "frames", None)
        return out
    return {"tokens": named("batch", None), "pos": named("batch")}


_sharding_tree = tree_sharding      # the reference's name


def build_cell(arch: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """{fn, args, in_shardings, out_shardings, donate_argnums}: the step,
    its ``meta`` arguments and their shardings on ``mesh`` (None:
    replicated).  ``parallel.partition.run_cell`` runs it on a DeviceMesh
    of ``mesh``."""
    model = get_model(arch)
    rules = arch_rules(arch, shape, mesh)
    ctx = shard_ctx(arch, shape, mesh)
    opt_cfg = adamw.AdamWConfig(
        moment_dtype="bf16" if arch.opt_dtype == "bf16" else "fp32")

    if shape.kind == "train":
        step, _ = make_train_step(arch, opt_cfg, ctx)
        state = abstract_train_state(arch, opt_cfg)
        state_shard = _sharding_tree(train_state_axes(arch), rules, mesh)
        return dict(fn=step, args=(state, batch_specs(arch, shape)),
                    in_shardings=(state_shard,
                                  batch_shardings(arch, shape, mesh)),
                    out_shardings=(state_shard, None),  # metrics replicated
                    donate_argnums=(0,))

    params = model.abstract_params()
    params_shard = _sharding_tree(model.params_axes(), rules, mesh)
    cache_shard = _sharding_tree(model.cache_axes(), rules, mesh)
    logits_shard = NamedSharding(
        mesh, logical_to_spec(("batch", "vocab"), rules, mesh))

    if shape.kind == "prefill":
        return dict(fn=make_prefill_step(arch, ctx),
                    args=(params, batch_specs(arch, shape)),
                    in_shardings=(params_shard,
                                  batch_shardings(arch, shape, mesh)),
                    out_shardings=(logits_shard, cache_shard),
                    donate_argnums=())

    # decode
    cache = model.cache_struct(shape.global_batch, shape.seq_len)
    b = batch_specs(arch, shape)
    bshard = batch_shardings(arch, shape, mesh)
    next_shard = NamedSharding(mesh, logical_to_spec(("batch",), rules, mesh))
    return dict(fn=make_decode_step(arch, ctx),
                args=(params, cache, b["tokens"], b["pos"]),
                in_shardings=(params_shard, cache_shard, bshard["tokens"],
                              bshard["pos"]),
                out_shardings=(next_shard, logits_shard, cache_shard),
                donate_argnums=(1,))
