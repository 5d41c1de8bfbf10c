"""Quickstart on the PyTorch/CUDA port: train a small LM end-to-end with the
ATLAS elastic runtime (``repro_torch``; the counterpart of quickstart.py).

    python examples/torch_quickstart.py [--steps 60] [--d-model 256]
    python examples/torch_quickstart.py --device cpu --steps 6

Picks an architecture config, reduces it, builds a data stream and lets the
ATLAS-driven trainer run it with failure injection, speculative shard
duplication and hazard-driven checkpoints.  Runs on the CUDA device by
default and raises without one; ``--device cpu`` runs the plain torch
versions on the CPU.  Prints what quickstart.py prints."""

import argparse
import dataclasses
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch, smoke_reduce  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402
from repro_torch.runtime import ElasticTrainer, RuntimeConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--hosts", type=int, default=6)
    ap.add_argument("--fail-rate", type=float, default=0.02)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = smoke_reduce(get_arch(args.arch))
    arch = dataclasses.replace(
        arch, d_model=args.d_model, n_layers=args.layers,
        vocab_size=args.vocab, d_ff=args.d_model * 3,
        head_dim=max(32, args.d_model // 4))
    print(f"arch: {arch.name}  layers={arch.n_layers} d_model={arch.d_model}")

    rcfg = RuntimeConfig(n_hosts=args.hosts, steps=args.steps,
                         fail_rate=args.fail_rate, checkpoint_every=10,
                         atlas=True, seed=0)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="atlas_ckpt_")
    trainer = ElasticTrainer(
        arch, rcfg, ckpt_dir,
        data_cfg=DataConfig(vocab_size=arch.vocab_size, seq_len=128,
                            global_batch=args.hosts * 2), device=dev)
    out = trainer.run()
    print("\n== result ==")
    for k, v in out.items():
        print(f"  {k}: {v}")
    print(f"\nloss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} over "
          f"{out['committed']} committed steps "
          f"({out['rollbacks']} rollbacks, {out['lost_steps']} lost steps)")
    return out


if __name__ == "__main__":
    main()
