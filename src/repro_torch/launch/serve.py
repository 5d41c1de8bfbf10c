"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [options]``.

The port's copy of ``repro/launch/serve.py``: seeded random weights, a
batch of random prompts, one batched prefill, then greedy decode against
the cache (KV cache, or the recurrent state), ``tokens - 1`` steps.  It
prints the same two lines as the reference.  Reduced (smoke) configs by
default; ``--full-config`` serves the published widths and depth.
``--device`` defaults to CUDA and raises without a GPU; ``--device cpu``
runs the plain torch versions on the CPU.  Every family of the zoo serves:
dense, moe (deepseek-moe-16b, qwen3-moe-235b-a22b), ssm (rwkv6-1.6b),
hybrid (zamba2-1.2b), vlm (llama-3.2-vision-90b) and audio
(whisper-large-v3); the code is family-blind.  The vlm and audio models
take the reference's stub media, every embedding 0.02.

    python -m repro_torch.launch.serve --arch mistral-nemo-12b --full-config
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --full-config \
        --prompt-len 1024 --tokens 64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch, smoke_reduce
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import get_model

PROMPT_SEED = 1


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompts(batch: int, prompt_len: int, vocab_size: int,
            device) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids, uniform over the vocabulary,
    from a CPU generator seeded with PROMPT_SEED (the same ids on every
    device)."""
    gen = torch.Generator().manual_seed(PROMPT_SEED)
    return torch.randint(0, vocab_size, (batch, prompt_len),
                         generator=gen).to(device)


def generate(model, params, prompt, n_tokens: int, *, device=None, ctx=None,
             keep_logits: bool = False, media=None) -> dict:
    """Greedy generation: prefill ``prompt`` (B, S) (with ``media`` (B, M,
    D) for the vlm and audio families), then ``n_tokens - 1`` decode
    steps, each feeding back the previous argmax.  Returns the
    tokens (B, n_tokens) on the host, the prefill and decode wall times
    (each ending in a device synchronisation) and, with ``keep_logits``, the
    float32 logits of every step (n_tokens, B, V) on the device."""
    dev = resolve_device(device)
    B, S = prompt.shape
    max_len = S + n_tokens
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, media=media,
                                  max_len=max_len, ctx=ctx, device=dev)
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out, kept = [tok], [logits] if keep_logits else []
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(n_tokens - 1):
        logits, cache = model.decode(params, cache, tok, pos, ctx=ctx,
                                     device=dev)
        tok = logits.argmax(-1)[:, None]
        pos += 1
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, 1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "logits": torch.stack(kept) if keep_logits else None,
            "cache": cache}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if not args.full_config:
        arch = smoke_reduce(arch)
    model = get_model(arch)
    params = model.init(args.seed, device=dev)
    prompt = prompts(args.batch, args.prompt_len, arch.vocab_size, dev)
    media = None
    if model.needs_media():
        ms = model.media_struct(args.batch)
        media = torch.ones(ms.shape, dtype=ms.dtype, device=dev) * 0.02
    res = generate(model, params, prompt, args.tokens, device=dev,
                   media=media)
    n = res["tokens"].size
    dt = res["decode_s"]
    print(f"[serve] {arch.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s']:.2f}s; decoded {n} tokens in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} tok/s)")
    print("[serve] sample:", np.asarray(res["tokens"][0][:16]))
    return res


if __name__ == "__main__":
    main()
