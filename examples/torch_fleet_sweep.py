"""Minimal fleet-sweep walkthrough on the PyTorch/CUDA port: compare FIFO vs
ATLAS-FIFO across two failure regimes, then print the scenario library
(``repro_torch``; the counterpart of fleet_sweep.py).

Run:  python examples/torch_fleet_sweep.py [--device cpu]

Every cell's predictor fits and scores on the CUDA device by default and
the sweep raises without one; ``--device cpu`` runs on the CPU.  The
``__main__`` guard is required: the fleet's process pool uses the *spawn*
start method, which re-imports the launching script in each worker.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cluster.fleet import (SweepSpec, run_sweep,  # noqa: E402
                                       sweep_markdown)
from repro_torch.cluster.scenarios import SCENARIOS  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    print("Scenario library:")
    for name, sc in sorted(SCENARIOS.items()):
        print(f"  {name:18s} {sc.description}")
    print()

    spec = SweepSpec(
        schedulers=("fifo", "atlas-fifo"),
        seeds=2,
        scenarios=("baseline", "dn_loss"),
        workloads=("smoke",),      # tiny mix; "default" is the paper's §5.1 mix
    )
    result = run_sweep(spec, device=device)  # parallel process pool by default
    print(sweep_markdown(result))
    return result


if __name__ == "__main__":
    main()
