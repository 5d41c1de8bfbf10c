"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

The port's copy of ``repro/launch/train.py``: the same flags, plus
``--device`` (CUDA by default, raising without a GPU; ``--device cpu`` runs
the plain torch versions on the CPU) and ``--layers`` (the depth cut to that
many layers, the widths kept).  Reduced (smoke) configs by default;
``--full-config`` trains the published widths and depth on the card.  The
control loop is the ElasticTrainer (checkpoint/restart, ATLAS placement,
speculative shard duplication, adaptive heartbeats); it prints the same
lines as the reference.

    python -m repro_torch.launch.train --arch stablelm-1.6b --device cpu --steps 4
    python -m repro_torch.launch.train --arch stablelm-1.6b --full-config
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

from repro_torch.configs import ARCH_IDS, get_arch, smoke_reduce
from repro_torch.data import DataConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime import ElasticTrainer, RuntimeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture")
    ap.add_argument("--fail-rate", type=float, default=0.01)
    ap.add_argument("--atlas", dest="atlas", action="store_true", default=True)
    ap.add_argument("--no-atlas", dest="atlas", action="store_false")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if not args.full_config:
        arch = smoke_reduce(arch)
    if args.layers is not None:
        if not 0 < args.layers <= arch.n_layers:
            ap.error(f"--layers must be in 1..{arch.n_layers}")
        arch = dataclasses.replace(arch, n_layers=args.layers)
    print(f"[train] arch={arch.name} layers={arch.n_layers} "
          f"d_model={arch.d_model} atlas={args.atlas}")

    rcfg = RuntimeConfig(n_hosts=args.hosts, steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         atlas=args.atlas, fail_rate=args.fail_rate,
                         seed=args.seed)
    ckpt = pathlib.Path(args.checkpoint_dir) / arch.name
    trainer = ElasticTrainer(
        arch, rcfg, ckpt,
        data_cfg=DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                            global_batch=args.global_batch, seed=args.seed),
        device=dev)
    out = trainer.run()
    for k, v in out.items():
        print(f"[train] {k}: {v}")
    return out


if __name__ == "__main__":
    main()
