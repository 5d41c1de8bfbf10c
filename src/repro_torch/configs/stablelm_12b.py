"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,              # 5120 / 32
    rope_theta=10000.0,
    fsdp=True,                 # 12B params: shard over data for v5e HBM headroom
    shard_kv_heads=False,      # 8 kv heads on a 16-way model axis -> replicate KV
    accum_steps=8,
    opt_dtype="fp32",
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)
