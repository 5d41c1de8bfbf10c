"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6, 2 shared + 64 routed, fine-grained, first layer dense.
[arXiv:2401.06066; hf]"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MHA
    d_ff=1408,                # per-expert hidden (fine-grained)
    vocab_size=102400,
    head_dim=128,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408,
                  n_shared_experts=2, capacity_factor=1.25, first_dense=1),
    fsdp=True,
    shard_kv_heads=True,      # 16 kv heads / 16 = 1 per shard
    accum_steps=8,
    opt_dtype="bf16",    # fp32 moments alone are 8 GB/chip
    source="arXiv:2401.06066; hf",
)
