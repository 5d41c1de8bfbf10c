"""End-to-end fault-tolerant training comparison on the PyTorch/CUDA port:
the SAME model, data and chaos seed trained (a) with ATLAS placement /
speculation / hazard-checkpoints and (b) with plain periodic checkpointing
— the training-fleet transposition of the paper's Hadoop experiment.  The
counterpart of chaos_train.py, on ``repro_torch``.

    python examples/torch_chaos_train.py [--steps 40] [--fail-rate 0.05]
    python examples/torch_chaos_train.py --device cpu --steps 6

The train steps run on the CUDA device by default (the attention kernel
under autograd) and raise without one; ``--device cpu`` runs the plain
torch versions on the CPU.  Prints chaos_train.py's table.
"""

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
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hosts", type=int, default=6)
    ap.add_argument("--fail-rate", type=float, default=0.05)
    ap.add_argument("--degrade-rate", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = smoke_reduce(get_arch("stablelm-1.6b"))
    arch = dataclasses.replace(arch, n_layers=2, d_model=64, d_ff=128,
                               vocab_size=512, n_heads=2, n_kv_heads=2,
                               head_dim=32)
    dc = DataConfig(vocab_size=arch.vocab_size, seq_len=64,
                    global_batch=args.hosts * 2)

    results = {}
    for atlas in (False, True):
        rcfg = RuntimeConfig(n_hosts=args.hosts, steps=args.steps,
                             fail_rate=args.fail_rate,
                             degrade_rate=args.degrade_rate,
                             checkpoint_every=5, atlas=atlas, seed=args.seed)
        with tempfile.TemporaryDirectory() as d:
            results[atlas] = ElasticTrainer(arch, rcfg, d, data_cfg=dc,
                                            device=dev).run()

    print(f"{'metric':22s} {'baseline':>12s} {'ATLAS':>12s}")
    for k in ("committed", "lost_steps", "rollbacks", "duplicated_shards",
              "wasted_shards", "checkpoints", "hazard_checkpoints",
              "final_loss", "wall_s"):
        b, a = results[False][k], results[True][k]
        fmt = (lambda v: f"{v:.3f}") if isinstance(b, float) else str
        print(f"{k:22s} {fmt(b):>12s} {fmt(a):>12s}")
    print("\nATLAS trades a few duplicated shards for fewer lost steps/rollbacks "
          "— the paper's speculative-execution insurance, transposed to training.")
    return results


if __name__ == "__main__":
    main()
