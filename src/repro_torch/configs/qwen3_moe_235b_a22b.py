"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                # per-expert hidden
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=128, top_k=8, expert_ff=1536,
                  n_shared_experts=0, capacity_factor=1.25, first_dense=0,
                  chunk_tokens=8192),  # bounds the (T*k, D) dispatch buffers
    fsdp=True,                # 235B total: must shard everything everywhere
    shard_kv_heads=False,     # 4 kv heads on 16-way model axis -> replicate
    accum_steps=32,
    opt_dtype="bf16",         # fp32 moments = 7.3 GB/chip on 256 chips; bf16 fits
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
