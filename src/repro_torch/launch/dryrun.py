"""Dry run: count every (architecture x input shape) cell's step on the
production meshes (16x16 single-pod and 2x16x16 multi-pod) as one H100
runs it, without a device.

The port's copy of ``repro/launch/dryrun.py``.  Where the reference lowers
and compiles each cell for the mesh, the port traces its step on ``meta``
tensors under ``launch/cost.py``'s counting mode: the kernels' launchers
check their shapes and the kernels count by their own work formulas, the
rest op by op.  The trace is the whole step on one device (the count does
not run the partitioned step of ``parallel/partition.py``, whose
collectives it would have to estimate): ``cost`` and ``temp_bytes`` are
the global step's, the
arguments' bytes are given both per device (from the shardings, as the
reference's ``memory_analysis``) and whole, and ``fits_one_h100`` asks
whether the whole step fits one card.  The mesh still sets the step's MoE
routing groups and microbatch split (``n_groups``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--force] [--jobs N]

--jobs N traces N cells at a time in spawned processes (a cell's trace is
host work: one Python thread).

Records go to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json (kept
apart from the reference's experiments/dryrun/, whose test reads any
records there against the reference's schema); a record there is reused
unless --force.  status is "ok", "skipped" (the reference's unsupported
cells), "refused" (traced and counted, but a kernel's launcher refuses
shapes the step gives it: the card cannot run the cell; ``refused`` says
which) or "error" (a failed cell, recorded with its traceback; the CLI
then exits 1).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_arch
from repro_torch.launch import cost
from repro_torch.launch.mesh import data_shards, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.parallel.axes import tree_leaves

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def _leaves(tree) -> list:
    """The tensors or shardings of a tree of dicts, tuples and lists, in
    order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return tree_leaves(tree)


def sharded_bytes(args, shardings, select=None) -> int:
    """Bytes one device holds of ``args`` under ``shardings`` (None:
    replicated); ``select``: the argument indices to count."""
    total = 0
    for i, (a, s) in enumerate(zip(args, shardings)):
        if select is not None and i not in select:
            continue
        tensors, named = _leaves(a), _leaves(s)
        if s is not None and len(named) != len(tensors):
            raise ValueError(f"argument {i}: {len(tensors)} tensors against "
                             f"{len(named)} shardings")
        for j, t in enumerate(tensors):
            total += cost.tree_bytes(t) if s is None \
                else named[j].shard_bytes(t)
    return total


def memory_record(cell: dict, counted: dict) -> dict:
    """Per-device argument, output and donated bytes from the cell's
    shardings; the whole step's arguments and temporaries on one device."""
    args = cell["args"]
    outs = counted["outputs"]
    out_shard = cell["out_shardings"]
    whole_args = cost.tree_bytes(args)
    return {
        "argument_bytes": sharded_bytes(args, cell["in_shardings"]),
        "output_bytes": sharded_bytes(outs, out_shard),
        "alias_bytes": sharded_bytes(args, cell["in_shardings"],
                                     set(cell["donate_argnums"])),
        "temp_bytes": counted["temp_bytes"],
        "one_device_argument_bytes": whole_args,
        "fits_one_h100": cost.fits_one_h100(whole_args,
                                            counted["temp_bytes"]),
        "hbm_bytes": cost.HBM_BYTES,
    }


def trace_cell(arch, shape, mesh) -> tuple[dict, dict]:
    """(the cell from ``build_cell``, its counts on ``meta``)."""
    cell = build_cell(arch, shape, mesh)
    return cell, cost.count(cell["fn"], *cell["args"])


def run_cell(arch_id: str, shape_id: str, *, multi_pod: bool = False,
             force: bool = False, verbose: bool = True,
             out_dir: pathlib.Path | None = None) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    out_dir = OUT_DIR if out_dir is None else pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch_id}__{shape_id}__{mesh.name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    arch = get_arch(arch_id)
    shape = SHAPES[shape_id]
    ok, why = cell_supported(arch, shape)
    if not ok:
        rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh.name,
               "status": "skipped", "reason": why}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.perf_counter()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh.name}
    try:
        cell, counted = trace_cell(arch, shape, mesh)
        refused = {k: v["refused"] for k, v in counted["kernels"].items()
                   if v["refused"]}
        rec.update({
            "status": "refused" if refused else "ok",
            "trace_s": time.perf_counter() - t0,
            "memory": memory_record(cell, counted),
            "cost": {k: counted[k] for k in (
                "flops", "traffic_bytes", "transcendentals", "kernels")},
            "collectives": None,
            "collectives_reason": counted["collectives_reason"],
            "n_devices": mesh.size,
            "n_groups": data_shards(mesh),
        })
        if refused:
            rec["refused"] = refused
        if verbose:
            m = rec["memory"]
            print(f"[dryrun] {arch_id} x {shape_id} x {mesh.name}: "
                  f"{rec['status'].upper()} (trace {rec['trace_s']:.1f}s, "
                  f"args {m['argument_bytes'] / 2**30:.2f} GiB/dev, "
                  f"temp {m['temp_bytes'] / 2**30:.2f} GiB on one device, "
                  f"flops {rec['cost']['flops']:.3g})")
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded result
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        if verbose:
            print(f"[dryrun] {arch_id} x {shape_id} x {mesh.name}: "
                  f"FAILED {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _run_one(cell: tuple, force: bool, out_dir) -> dict:
    arch_id, shape_id, multi_pod = cell
    return run_cell(arch_id, shape_id, multi_pod=multi_pod, force=force,
                    out_dir=out_dir)


def run_cells(cells, *, force: bool = False, jobs: int = 1,
              out_dir: pathlib.Path | None = None) -> list:
    """``run_cell`` of every (arch, shape, multi_pod) in ``cells``, ``jobs``
    at a time in spawned processes; the records in the cells' order."""
    if jobs <= 1:
        return [_run_one(c, force, out_dir) for c in cells]
    ctx = multiprocessing.get_context("spawn")
    n = len(cells)
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        return list(ex.map(_run_one, cells, [force] * n, [out_dir] * n))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time (spawned processes)")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    t0 = time.perf_counter()
    counts = dict.fromkeys(("ok", "refused", "skipped", "error"), 0)
    for rec in run_cells(cells, force=args.force, jobs=args.jobs):
        counts[rec["status"]] += 1
    print(f"[dryrun] done: {counts['ok']} ok, {counts['refused']} refused, "
          f"{counts['skipped']} skipped, {counts['error']} errors "
          f"({time.perf_counter() - t0:.1f} s)")
    if counts["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
