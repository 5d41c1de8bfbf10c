"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig``; every assigned input shape is a
``ShapeConfig``.  The (arch x shape) grid drives smoke tests, the multi-pod dry-run
and the roofline table.  The port's copy of ``repro/configs/base.py``: the same
fields and values, with ``ArchConfig.dtype`` a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int            # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0      # leading layers that use a dense FFN instead of MoE
    router_aux_weight: float = 0.01
    chunk_tokens: int = 0     # >0: serialise dispatch over token chunks of this
                              # size per group (bounds the (T*k, D) gather buffers)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"      # mamba2 | rwkv6
    state_dim: int = 64       # N for mamba2; head_dim implies state for rwkv6
    head_dim: int = 64
    expand: int = 2           # d_inner = expand * d_model  (mamba2)
    conv_width: int = 4       # causal conv kernel (mamba2)
    lora_decay: int = 64      # rwkv6 data-dependent decay LoRA rank
    lora_mix: int = 32        # rwkv6 token-shift mix LoRA rank
    chunk: int = 128          # scan chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: a single shared attention block applied every `period` layers."""
    period: int = 6
    shared_attn_heads: int = 32
    shared_attn_ff: int = 8192


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """Llama-3.2-vision style: every `period`-th layer cross-attends to vision tokens."""
    period: int = 5
    n_media_tokens: int = 1024


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; the modality frontend is a stub — inputs are
    precomputed frame embeddings."""
    n_enc_layers: int = 32
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    max_position: int = 131072
    rope_theta: float = 500000.0
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    cross_attn: CrossAttnConfig | None = None
    enc_dec: EncDecConfig | None = None
    tie_embeddings: bool = False
    # attention structure
    causal: bool = True
    sliding_window: int = 0   # 0 = full attention; >0 = window (used by hybrid @500k)
    # distribution knobs (per-arch defaults; the perf loop edits these)
    fsdp: bool = False
    decode_fsdp: bool | None = None   # None -> same as fsdp; decode-only override
    shard_kv_heads: bool = True
    sharding_overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    remat: str = "full"       # full | dots | none
    accum_steps: int = 1      # gradient-accumulation microbatches (train memory knob)
    dtype: torch.dtype = torch.bfloat16
    # optimizer memory policy (fp32 | bf16 moments); big archs need bf16 to fit v5e
    opt_dtype: str = "fp32"
    source: str = ""          # provenance tag from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if long-context (500k) decode is supported."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        from repro_torch.models import registry  # lazy; avoids import cycle
        return registry.param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if skipped.

    Skips follow the assignment: long_500k needs sub-quadratic attention; pure
    full-attention archs skip it (recorded in DESIGN.md §4)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k skipped: pure full-attention arch (O(S) KV read per decoded "
            "token at S=524288 exceeds the model's published context; see DESIGN.md §4)")
    return True, ""


def smoke_reduce(arch: ArchConfig) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests: tiny widths/layers/experts,
    same structural wiring (GQA ratios, MoE top-k, hybrid period, enc-dec...)."""
    kw: dict[str, Any] = dict(
        name=arch.name + "-smoke",
        n_layers=min(arch.n_layers, 4 if arch.hybrid is None else 6),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(arch.n_kv_heads, 4 if arch.n_kv_heads >= arch.n_heads else 2)),
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        max_position=512,
        fsdp=False,
        remat="none",
        accum_steps=1,
        dtype=torch.float32,
    )
    if arch.moe is not None:
        # capacity_factor 8 >= E/K makes the smoke config drop-free, so the
        # decode-vs-forward consistency test is exact; drop behaviour at tight
        # capacity is covered separately in tests/test_moe.py
        kw["moe"] = dataclasses.replace(
            arch.moe, n_experts=8, top_k=2, expert_ff=64, capacity_factor=8.0,
            n_shared_experts=min(arch.moe.n_shared_experts, 1),
            first_dense=min(arch.moe.first_dense, 1))
    if arch.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            arch.ssm, state_dim=16, head_dim=16, lora_decay=8, lora_mix=4, chunk=16)
    if arch.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(
            arch.hybrid, period=3, shared_attn_heads=4, shared_attn_ff=256)
    if arch.cross_attn is not None:
        kw["cross_attn"] = dataclasses.replace(arch.cross_attn, period=2, n_media_tokens=16)
        kw["n_layers"] = 4
    if arch.enc_dec is not None:
        kw["enc_dec"] = dataclasses.replace(arch.enc_dec, n_enc_layers=2, n_frames=24)
        kw["n_layers"] = 2
    return dataclasses.replace(arch, **kw)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
