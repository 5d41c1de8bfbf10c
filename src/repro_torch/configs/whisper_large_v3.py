"""whisper-large-v3 [audio] — 32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
Encoder-decoder; conv/mel frontend is a STUB (input_specs supplies precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,              # decoder layers; encoder in enc_dec
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,            # MHA
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    causal=True,
    enc_dec=EncDecConfig(n_enc_layers=32, n_frames=1500),
    fsdp=True,
    shard_kv_heads=False,     # 20 heads don't divide 16; replicate KV, pad Q via d_ff shard
    sharding_overrides={"heads": None,   # 20 % 16 != 0: heads replicated
                        "vocab": None},  # 51866 % 16 != 0: embedding replicated
                                          # (133 MB bf16 — cheap); ff=5120/16 shards
    accum_steps=8,
    opt_dtype="fp32",
    source="arXiv:2212.04356; unverified",
)
