"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,            # MHA (kv == heads)
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    rope_theta=10000.0,
    fsdp=False,               # small enough to replicate over data
    shard_kv_heads=True,      # 32 kv heads / 16 = 2 per shard
    accum_steps=2,
    opt_dtype="fp32",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
