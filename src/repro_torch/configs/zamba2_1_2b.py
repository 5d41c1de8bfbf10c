"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention block. [arXiv:2411.15242; hf]

At long_500k the shared attention block uses a sliding window (4096) so the KV cache
stays O(window); the Mamba2 state is O(1) — this is the hybrid path the assignment
says to run at 500k."""

from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,                # shared-block MLP hidden
    vocab_size=32000,
    head_dim=64,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  conv_width=4, chunk=128),
    hybrid=HybridConfig(period=6, shared_attn_heads=32, shared_attn_ff=8192),
    sliding_window=4096,
    fsdp=False,
    accum_steps=8,   # d_inner=2x width: per-token state memory is 2x a dense arch
    opt_dtype="fp32",
    source="arXiv:2411.15242; hf",
)
