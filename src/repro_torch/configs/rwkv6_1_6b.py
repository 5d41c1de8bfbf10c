"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Finch — data-dependent decay. [arXiv:2404.05892; unverified]"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,               # 2048 / head_dim 64 time-mix heads
    n_kv_heads=32,
    d_ff=7168,                # channel-mix hidden
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64,
                  lora_decay=64, lora_mix=32, chunk=128),
    fsdp=False,
    accum_steps=2,
    opt_dtype="fp32",
    source="arXiv:2404.05892; unverified",
)
