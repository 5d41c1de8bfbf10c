"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. Cross-attn image layers every 5th layer; patch-embedding frontend is
a STUB (input_specs supplies precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.configs.base import ArchConfig, CrossAttnConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,             # 80 self-attn + 20 cross-attn (period 5)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    cross_attn=CrossAttnConfig(period=5, n_media_tokens=1024),
    fsdp=True,
    shard_kv_heads=False,
    accum_steps=16,
    opt_dtype="bf16",         # 90B: fp32 moments alone would be 8.4 GB/chip
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
