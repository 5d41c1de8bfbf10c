"""Serving example on the PyTorch/CUDA port: batched prefill+decode with the
KV-cache path, plus ATLAS-style replica routing — requests are routed to the
serving replica with the best predicted health; a replica failure
mid-decode fails over using the shared prefix cache discipline (re-prefill
on the survivor).  The counterpart of serve_atlas.py, on ``repro_torch``.

    python examples/torch_serve_atlas.py [--tokens 16] [--batch 4]
    python examples/torch_serve_atlas.py --device cpu

Prefill and decode go through the port's attention kernels on the CUDA
device by default (raising without one); ``--device cpu`` runs their plain
torch versions on the CPU.  The weights are the port's seeded init (seed
0) and the prompts come from a torch.Generator seeded with 1, so the
tokens are the port's own; ``serve`` takes any weights and prompts (the
tests hand it the reference's).
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch, smoke_reduce  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def serve(model, params, prompts, *, tokens, replicas, kill_replica_at,
          device) -> dict:
    """Prefill ``prompts`` (B, S) on the healthiest replica, then greedy
    decode ``tokens - 1`` steps; at step ``kill_replica_at`` that replica
    dies and, with a survivor, the survivor re-prefills the prompts plus
    every token generated so far (the cache rebuilt) before decoding on.
    Returns the generated tokens (B, tokens) on the host, the failovers
    and the wall seconds (ending in a device synchronisation)."""
    dev = torch.device(device)
    B, S = prompts.shape
    max_len = S + tokens
    # replicas = independent serving processes (same weights)
    health = [1.0] * replicas

    def pick_replica():
        # ATLAS-style: route to best predicted-health replica
        return max(range(replicas), key=lambda i: health[i])

    t0 = time.time()
    rep = pick_replica()
    logits, cache = model.prefill(params, prompts, max_len=max_len,
                                  device=dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    tok = logits.argmax(-1)[:, None]
    generated = [tok[:, 0]]
    failovers = 0
    for step in range(tokens - 1):
        if step == kill_replica_at and replicas > 1:
            health[rep] = 0.0  # replica dies: fail over
            new = pick_replica()
            if new != rep:
                failovers += 1
                rep = new
                # survivor re-prefills the full generated prefix (cache
                # rebuild)
                ctx_tokens = torch.cat(
                    [prompts, torch.stack(generated, dim=1)], dim=1)
                logits, cache = model.prefill(params, ctx_tokens,
                                              max_len=max_len, device=dev)
                pos = torch.full((B,), ctx_tokens.shape[1],
                                 dtype=torch.int32, device=dev)
        logits, cache = model.decode(params, cache, tok, pos, device=dev)
        tok = logits.argmax(-1)[:, None]
        pos = pos + 1
        generated.append(tok[:, 0])
    out = torch.stack(generated, dim=1).cpu().numpy()
    return {"tokens": out, "failovers": failovers, "seconds": time.time() - t0}


def report(res: dict, batch: int, device):
    """serve_atlas.py's two lines."""
    total = res["tokens"].size
    dt = res["seconds"]
    print(f"served {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s on {torch.device(device).type.upper()}, "
          f"batch={batch}) with {res['failovers']} replica failover(s)")
    print("sample:", res["tokens"][0][:12])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--kill-replica-at", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = smoke_reduce(get_arch(args.arch))
    model = get_model(arch)
    params = model.init(0, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, arch.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=gen).to(dev)
    res = serve(model, params, prompts, tokens=args.tokens,
                replicas=args.replicas, kill_replica_at=args.kill_replica_at,
                device=dev)
    report(res, args.batch, dev)
    return res


if __name__ == "__main__":
    main()
