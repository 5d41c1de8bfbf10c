"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA. [arXiv:2403.04652; hf]

Note: 56 query heads do not divide the 16-way model axis (and explicit pjit arg
shardings must divide evenly).  The shipped config PADS the head count to 64 —
8 zero-initialised heads whose wo rows are zero keep the math equal to 56-head
Yi — so attention shards 16-way.  EXPERIMENTS §Perf: this took the train_4k cell
from 24.5s compute / 455s memory (replicated attention) to 6.7s / 116s and from
18.6 GiB/dev to 12.9 GiB/dev.  `n_heads_logical` records the true count."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=64,               # 56 logical + 8 padding (see note above)
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5000000.0,
    fsdp=True,
    shard_kv_heads=False,
    sharding_overrides={"kv_heads": None},
    accum_steps=16,
    opt_dtype="bf16",          # 34B moments in fp32 leave no activation headroom
    source="arXiv:2403.04652; hf",
)
