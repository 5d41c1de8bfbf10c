"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
128k context. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,              # nemo uses 128 (d_model/40 != head_dim; explicit)
    max_position=131072,       # 128k context
    rope_theta=1000000.0,
    fsdp=True,
    shard_kv_heads=False,
    accum_steps=8,
    opt_dtype="fp32",
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
)
