#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ATLAS on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out records.json]

Phases, each of which raises on failure (the script then exits non-zero):

  device   the card's name and power limit (nvidia-smi), torch and nvcc
  build    nvcc-builds the CUDA kernels from src/repro_torch/kernels/csrc
  kernels  each CUDA kernel against its plain torch version and the numpy
           mirror (torch.equal), on the grouped-inference test cases, a
           Tree (T=1, D=6) and a fat flush (M=2, R=4096, T=24, D=5); times
           both with CUDA events at 1, 13 and 4096 rows
  fit      the 1000-node map_heavy baseline run, then R.F. fitted on its
           trace on the card and on the CPU: equal parameters
  slice    the §5 protocol (compare("fifo")) on the card at 1000 nodes with
           invariant checking, then the same ATLAS run behind the batched
           BrokerPredictor; zero violations, each run launched its kernel,
           equal metrics, and every probability either run served equal to
           the numpy mirror on the same rows and parameters
  parity   100-node ATLAS runs under the baseline chaos and under the
           kitchen_sink scenario (where ATLAS predicts failures), each with
           the predictor on the card, on the CPU and behind the
           BrokerPredictor on the card, from the same trained parameters:
           equal metrics
  trace    the 1000-node ATLAS run, scalar and brokered, under
           torch.profiler: the card's idle share and the kernels' own
           device times

Earlier lines are JSON records; then the kernels line, the nvidia-smi line,
and last {"ok": true, "device": {...}}.  Without a CUDA device, or without
the repository's src/ beside this file, it exits non-zero and prints no
result.  Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
TIMED_ROWS = (1, 13, 4096)
N_TIMED = 100
FLEET = 1000
PARITY_FLEET = 100
SOURCE = "src/repro_torch/kernels/csrc/forest.cu"
REPLACES = {"forest_infer": "src/repro/kernels/forest.py:70",
            "forest_infer_grouped": "src/repro/kernels/forest.py:171"}
MAIN_ROWS = {"forest_infer": 13, "forest_infer_grouped": 4096}
# the JAX package's "kitchen_sink" chaos scenario (repro/cluster/scenarios.py),
# as values: at 100 nodes ATLAS predicts failures under it and relocates
KITCHEN_SINK = dict(intensity=9.0, kill_tt=0.22, suspend_tt=0.12,
                    kill_dn=0.16, net_slow=0.22, net_drop=0.08,
                    burst_prob=0.10, burst_size=(4, 8), mean_outage=1100.0)

RECORDS: list = []


def emit(record: dict):
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- phases

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "python": sys.version.split()[0]})
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(pathlib.Path(lib._name).relative_to(ROOT))})


def _data(n, f, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(n) > 0.8).astype(np.float32)
    return X, y


def _time_ms(torch, fn) -> float:
    """Median CUDA-event time of one call over N_TIMED calls, after warm-up;
    each event pair brackets one call, host-side launch cost included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(N_TIMED)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _bound(rows, F, T, D, M, trees_per_row):
    """Least time for the work: each input byte read once, each output byte
    written once, over the memory rate; compares + adds + one division
    per row over the fp32 rate.  The larger bounds it."""
    L = 1 << D
    nbytes = 4 * (rows * F + M * T * D * 2 + M * T * L + rows)
    if M > 1:
        nbytes += 4 * (M + 1 + M)               # segment offsets, tree counts
    ops = trees_per_row * (D + 1) + rows
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, dev):
    from repro_torch.cluster.telemetry import N_FEATURES
    from repro_torch.kernels import ops
    from repro_torch.ml import forest
    from repro_torch.ml.models import Tree

    max_err = dict.fromkeys(ops.KERNELS, 0.0)
    n_held = dict.fromkeys(ops.KERNELS, 0)

    def hold(kernel, got, plain, numpy_want):
        check(torch.equal(got, plain), f"{kernel}: kernel != plain version")
        check(np.array_equal(got.cpu().numpy(), numpy_want),
              f"{kernel}: kernel != numpy mirror")
        if got.numel():
            max_err[kernel] = max(max_err[kernel],
                                  float((got - plain).abs().max()))
        n_held[kernel] += 1

    def grouped_case(groups):
        packed = forest.pack_forests([p for p, _ in groups])
        x = np.concatenate([r for _, r in groups]).astype(np.float32)
        offsets = np.zeros(len(groups) + 1, np.int32)
        np.cumsum([r.shape[0] for _, r in groups], out=offsets[1:])
        args = (torch.from_numpy(x).to(dev),
                torch.from_numpy(offsets).to(dev), *packed.on(dev))
        got = ops.forest_infer_grouped(*args, impl="cuda")
        plain = ops.forest_infer_grouped(*args, impl="torch")
        want = np.concatenate([forest.forest_predict_np(p, r)
                               for p, r in groups])
        hold("forest_infer_grouped", got, plain, want)
        return args

    def single_case(params, x):
        args = (torch.from_numpy(x).to(dev), *params.on(dev))
        hold("forest_infer", ops.forest_infer(*args, impl="cuda"),
             ops.forest_infer(*args, impl="torch"),
             forest.forest_predict_np(params, x))
        return args

    # the grouped-inference test fixtures, refit on the card
    X, y = _data(300, 12, 0)
    fx = {"a": forest.fit_oblivious_forest(X, y, n_trees=24, depth=5,
                                           seed=0, device=dev),
          "b": forest.fit_oblivious_forest(X, 1 - y, n_trees=24, depth=5,
                                           seed=1, device=dev),
          "c": forest.fit_oblivious_forest(X, y, n_trees=8, depth=3, seed=2,
                                           device=dev),
          "d": forest.fit_oblivious_forest(X, 1 - y, n_trees=16, depth=4,
                                           seed=3, device=dev)}
    cases = []
    for sizes in [(1,), (1, 1, 1), (7, 33), (1, 64, 2), (65, 1, 5, 12)]:
        cases.append([("ab"[i % 2], b) for i, b in enumerate(sizes)])
    cases += [[("a", 9), ("c", 31), ("d", 1), ("a", 59), ("c", 3)],
              [("a", 50), ("a", 1)], [("a", 5), ("b", 25), ("a", 30),
                                      ("b", 1)]]
    for i, case in enumerate(cases):
        Xq = _data(300, 12, 4 + i)[0]
        at, groups = 0, []
        for name, b in case:
            groups.append((fx[name], Xq[at:at + b]))
            at += b
        # the flush's own path: one model per segment, rows contiguous
        outs, passes = forest.forest_predict_grouped(groups, device=dev)
        check(passes == 1, "one fused pass per flush")
        for (p, r), o in zip(groups, outs):
            check(np.array_equal(o, forest.forest_predict_np(p, r)),
                  "forest_predict_grouped != numpy mirror")
        # the kernel itself, one segment per group (repeats included)
        grouped_case(groups)

    # a Tree (T=1, D=6) and the fat flush (M=2, R=4096, T=24, D=5)
    Xt, yt = _data(2000, N_FEATURES, 20)
    tree = Tree(device=dev).fit(Xt, yt).params
    check(tree.feat_idx.shape == (1, 6), "Tree is T=1, D=6")
    rf = [forest.fit_oblivious_forest(Xt, t, n_trees=24, depth=5, seed=s,
                                      device=dev)
          for s, t in ((0, yt), (1, 1 - yt))]
    rows = np.random.RandomState(21).rand(4096, N_FEATURES).astype(np.float32)
    for B in TIMED_ROWS:
        single_case(tree, rows[:B])
        single_case(rf[0], rows[:B])
    grouped_case([(rf[0], rows[:2048]), (rf[1], rows[2048:])])
    torch.cuda.synchronize()

    # timing at the main path's widths: R.F. (T=24, D=5, F=N_FEATURES)
    timing = {k: {} for k in ops.KERNELS}
    for B in TIMED_ROWS:
        sargs = (torch.from_numpy(rows[:B]).to(dev), *rf[0].on(dev))
        half = B // 2
        gargs = grouped_case([(rf[0], rows[:half]), (rf[1], rows[half:B])])
        t = {}
        for kernel, args, fn in (
                ("forest_infer", sargs, ops.forest_infer),
                ("forest_infer_grouped", gargs, ops.forest_infer_grouped)):
            kms = _time_ms(torch, lambda: fn(*args, impl="cuda"))
            pms = _time_ms(torch, lambda: fn(*args, impl="torch"))
            M = 1 if kernel == "forest_infer" else 2
            bms, by = _bound(B, N_FEATURES, 24, 5, M, 24 * B)
            timing[kernel][B] = {"ms": kms, "plain_ms": pms,
                                 "bound_ms": bms, "bound_by": by}
            t[kernel] = timing[kernel][B]
        # the whole per-decision call: host rows -> card -> kernel -> host
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            forest.forest_predict(rf[0], rows[:B], device=dev)
        call_ms = 1e3 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            forest.forest_predict_np(rf[0], rows[:B])
        np_ms = 1e3 * (time.perf_counter() - t0) / reps
        emit({"phase": "kernels", "rows": B, **t,
              "forest_predict_call_ms": call_ms,
              "numpy_mirror_host_ms": np_ms})
    emit({"phase": "kernels", "held": "torch.equal to plain and numpy",
          "cases": n_held, "max_abs_err": max_err})
    return timing, max_err


def _slice_config(fleet_size, device, chaos=None):
    from repro_torch.cluster import ChaosConfig, WorkloadConfig
    from repro_torch.cluster.experiment import ExperimentConfig
    # the JAX package's "map_heavy" workload shape and, by default, its
    # "baseline" scenario (repro/cluster/scenarios.py), as values
    return ExperimentConfig(
        workload=WorkloadConfig(n_single=64, n_chains=4, maps_range=(10, 24),
                                reduces_range=(1, 4)),
        chaos=ChaosConfig(**(chaos or {})), seed=0, check_invariants=True,
        fleet_size=fleet_size, device=device)


def _predictor_kw(cfg):
    return dict(algo=cfg.algo, seed=cfg.seed, min_samples=cfg.min_samples,
                max_train=cfg.max_train)


def _same_params(a, b) -> bool:
    for kind in ("map", "reduce"):
        ma, mb = a.model_for_kind(kind), b.model_for_kind(kind)
        if (ma is None) != (mb is None):
            return False
        if ma is not None and not all(
                np.array_equal(getattr(ma.params, f), getattr(mb.params, f))
                for f in ("feat_idx", "thresholds", "leaves")):
            return False
    return True


def phase_fit(torch, dev):
    from repro_torch.cluster.experiment import run_baseline
    from repro_torch.core.predictor import TaskPredictor
    cfg = _slice_config(FLEET, None)
    t0 = time.perf_counter()
    base, trace, _ = run_baseline("fifo", cfg)
    t_base = time.perf_counter() - t0
    check(base["invariant_violations"] == 0, "baseline invariant violations")
    data = trace.datasets()
    fitted, secs = {}, {}
    for where in (dev, "cpu"):
        p = TaskPredictor(**_predictor_kw(cfg), device=where)
        t0 = time.perf_counter()
        check(p.fit_datasets(*data), "predictor fitted")
        torch.cuda.synchronize()
        secs[str(where)] = time.perf_counter() - t0
        fitted[str(where)] = p
    gpu, cpu = fitted[str(dev)], fitted["cpu"]
    check(gpu.map_model.params.feat_idx.shape == (24, 5), "R.F. is T=24, D=5")
    check(_same_params(gpu, cpu), "card-fitted != CPU-fitted parameters")
    emit({"phase": "fit", "fleet_size": FLEET, "baseline_run_s": t_base,
          "map_rows": int(data[0][0].shape[0]),
          "reduce_rows": int(data[1][0].shape[0]),
          "fit_s": secs, "params_equal": True})
    return cfg, base, gpu


@contextlib.contextmanager
def _served(log: list):
    """Record every (params, rows, probabilities) a forest-family predictor
    serves while the block runs: what ``TaskPredictor.predict_batch``
    returns and what ``BrokerPredictor._flush`` hands to its memo.  The
    rows and probabilities are copied, since the broker reuses its
    buffers."""
    from repro_torch.core.predictor import TaskPredictor, forest_family_params
    from repro_torch.online.broker import BrokerPredictor

    def keep(model, X, out):
        params = forest_family_params(model)
        if params is not None and len(X):
            log.append((params, np.array(X, np.float32), np.array(out)))

    predict_batch, flush = TaskPredictor.predict_batch, BrokerPredictor._flush

    def tapped_predict_batch(self, kind, X):
        out = predict_batch(self, kind, X)
        keep(self.model_for_kind(kind), X, out)
        return out

    def tapped_flush(self, groups):
        outs = flush(self, groups)
        for (model, X), out in zip(groups, outs):
            keep(model, X, out)
        return outs

    TaskPredictor.predict_batch = tapped_predict_batch
    BrokerPredictor._flush = tapped_flush
    try:
        yield log
    finally:
        TaskPredictor.predict_batch = predict_batch
        BrokerPredictor._flush = flush


def _check_served(log: list, what: str) -> dict:
    """Every served probability against the clipped numpy mirror on the same
    rows and parameters, one mirror pass per distinct parameter set."""
    from repro_torch.ml.forest import forest_predict_np
    by_params: dict = {}
    for params, X, out in log:
        by_params.setdefault(id(params), (params, [], []))
        by_params[id(params)][1].append(X)
        by_params[id(params)][2].append(out)
    rows, below, lowest = 0, 0, 1.0
    for params, xs, outs in by_params.values():
        got = np.concatenate(outs)
        want = np.clip(forest_predict_np(params, np.concatenate(xs)),
                       0.0, 1.0).astype(np.float32)
        check(got.dtype == np.float32 and np.array_equal(got, want),
              f"{what}: a served probability != numpy mirror")
        rows += got.size
        below += int((got < 0.5).sum())
        lowest = min(lowest, float(got.min()))
    check(rows > 0, f"{what}: no probability served")
    return {"calls": len(log), "rows": rows, "models": len(by_params),
            "rows_below_half": below, "min_p": lowest}


def phase_slice(torch, dev, cfg, base_metrics, trained):
    """The §5 protocol, then the same ATLAS run behind the BrokerPredictor.
    The launch counts are zeroed before each run and read after it: the
    scalar path (compare) must launch forest_infer, the brokered run
    forest_infer_grouped."""
    from repro_torch.cluster.experiment import compare, run_scheduler
    from repro_torch.kernels import ops
    from repro_torch.online.broker import BrokerPredictor
    broker = BrokerPredictor(**_predictor_kw(cfg), device=dev)
    broker.load_snapshot(trained.snapshot())

    with _served([]) as scalar_log:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = compare("fifo", cfg)
        torch.cuda.synchronize()
        t_compare = time.perf_counter() - t0
        launches_compare = ops.launch_counts()
    with _served([]) as broker_log:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        brokered, _, _ = run_scheduler("atlas-fifo", cfg, broker)
        torch.cuda.synchronize()
        t_broker = time.perf_counter() - t0
        launches_broker = ops.launch_counts()
    check(launches_compare["forest_infer"] > 0,
          "compare never launched forest_infer")
    check(launches_broker["forest_infer_grouped"] > 0,
          "the brokered run never launched forest_infer_grouped")

    base, atlas = result["base"], result["atlas"]
    for name, m in (("base", base), ("atlas", atlas), ("broker", brokered)):
        check(m["invariant_violations"] == 0, f"{name} invariant violations")
        check(m["invariant_checks"] > 0, f"{name} ran no invariant checks")
    check({k: v for k, v in base.items() if k not in (
        "job_exec_time_matched", "long_job_exec_time")} == base_metrics,
        "compare's baseline differs from the fit phase's")
    # run_scheduler adds sched_stats; compare adds the matched-job times
    extra = {"sched_stats", "job_exec_time_matched", "long_job_exec_time"}
    check(set(brokered) ^ set(atlas) <= extra, "metric keys differ")
    check({k: v for k, v in brokered.items() if k not in extra}
          == {k: v for k, v in atlas.items() if k not in extra},
          "BrokerPredictor run != TaskPredictor run")
    check(atlas["atlas"]["predictions"] > 0, "ATLAS made no predictions")
    t0 = time.perf_counter()
    served = {"scalar": _check_served(scalar_log, "compare"),
              "broker": _check_served(broker_log, "brokered run")}
    emit({"phase": "slice", "fleet_size": FLEET, "compare_s": t_compare,
          "broker_run_s": t_broker, "launches_compare": launches_compare,
          "launches_broker": launches_broker,
          "served_equal_numpy_mirror": served,
          "served_check_s": time.perf_counter() - t0,
          "broker": {"dispatches": broker.n_dispatches,
                     "rows": broker.n_rows_scored,
                     "memo_hits": broker.n_memo_hits,
                     "demand_calls": broker.n_demand_calls},
          "atlas": atlas["atlas"], "deltas": result["deltas"],
          "tasks_total": atlas["tasks_total"],
          "invariant_checks": atlas["invariant_checks"]})
    return {"forest_infer": launches_compare["forest_infer"],
            "forest_infer_grouped": launches_broker["forest_infer_grouped"]}


def phase_parity(torch, dev):
    """At 100 nodes, under the baseline chaos and under kitchen_sink: one
    CPU-fitted predictor's parameters scored on the card, on the CPU and
    behind the BrokerPredictor on the card give equal whole-run metrics.
    Under kitchen_sink ATLAS must predict failures, so the decisions do
    depend on the scores' values."""
    from repro_torch.cluster.experiment import run_baseline, run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    from repro_torch.online.broker import BrokerPredictor
    out = {}
    for scenario, chaos in (("baseline", None), ("kitchen_sink", KITCHEN_SINK)):
        cfg = _slice_config(PARITY_FLEET, None, chaos)
        _, trace, _ = run_baseline("fifo", cfg)
        trained = TaskPredictor(**_predictor_kw(cfg), device="cpu")
        check(trained.fit(trace), f"{scenario}: parity predictor fitted")
        metrics, secs = {}, {}
        for run, cls, where in (("cuda", TaskPredictor, dev),
                                ("cpu", TaskPredictor, "cpu"),
                                ("cuda_broker", BrokerPredictor, dev)):
            p = cls(**_predictor_kw(cfg), device=where)
            p.load_snapshot(trained.snapshot())
            t0 = time.perf_counter()
            metrics[run], _, _ = run_scheduler(
                "atlas-fifo", dataclasses.replace(cfg, device=where), p)
            secs[run] = time.perf_counter() - t0
            check(metrics[run]["invariant_violations"] == 0,
                  f"{scenario} {run}: invariant violations")
        check(metrics["cuda"] == metrics["cpu"],
              f"{scenario}: CUDA run != CPU run")
        check(metrics["cuda_broker"] == metrics["cuda"],
              f"{scenario}: BrokerPredictor run != TaskPredictor run")
        atlas = metrics["cpu"]["atlas"]
        if chaos is not None:
            check(atlas["predicted_fail"] > 0,
                  f"{scenario}: ATLAS predicted no failure")
        out[scenario] = {"run_s": secs, "metrics_equal": True,
                         **{k: atlas[k] for k in (
                             "predictions", "predicted_fail", "relocations",
                             "penalties", "model_fits")}}
    emit({"phase": "parity", "fleet_size": PARITY_FLEET, **out})


def _device_time(prof) -> dict:
    """Device time by kind from a torch.profiler trace: {kind: [n, us]}."""
    from torch.autograd import DeviceType
    kinds: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        kind = next((k for k in ("forest_infer_grouped", "forest_infer")
                     if k in name), "memcpy" if "emcpy" in name else "other")
        n_us = kinds.setdefault(kind, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.elapsed_us()
    return kinds


def phase_trace(torch, dev, cfg, trained):
    """The 1000-node ATLAS run again, scalar and brokered, under
    torch.profiler: the card's busy and idle share, and each kernel's own
    device time at the main path's shapes.  Profiling slows the host, so
    the idle share is an upper bound; the unprofiled walls are in slice."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.experiment import run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    from repro_torch.kernels import ops
    from repro_torch.online.broker import BrokerPredictor
    runs = {}
    for name, cls in (("scalar", TaskPredictor), ("broker", BrokerPredictor)):
        pred = cls(**_predictor_kw(cfg), device=dev)
        pred.load_snapshot(trained.snapshot())
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_scheduler("atlas-fifo", cfg, pred)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kinds = _device_time(prof)
        busy_s = sum(us for _, us in kinds.values()) / 1e6
        runs[name] = {
            "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall if kinds else None,
            "device_us": {k: {"n": n, "total_us": us, "mean_us": us / n}
                          for k, (n, us) in kinds.items()},
            "launches": ops.launch_counts()}
    emit({"phase": "trace", "fleet_size": FLEET, **runs})
    # each kernel's own mean device time on the main path (None if the
    # profiler saw no device activity)
    return {k: runs[run]["device_us"].get(k, {}).get("mean_us")
            for k, run in (("forest_infer", "scalar"),
                           ("forest_infer_grouped", "broker"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every record to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    timing, max_err = phase_kernels(torch, dev)
    cfg, base, trained = phase_fit(torch, dev)
    launches = phase_slice(torch, dev, cfg, base, trained)
    phase_parity(torch, dev)
    device_us = phase_trace(torch, dev, cfg, trained)
    kernels = []
    for k in ("forest_infer", "forest_infer_grouped"):
        main_t = timing[k][MAIN_ROWS[k]]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max_err[k], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"], "library_ms": None,
            "rows": MAIN_ROWS[k],
            "device_ms": (None if device_us[k] is None
                          else device_us[k] / 1e3),
            "by_rows": {str(b): timing[k][b] for b in TIMED_ROWS}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"records": RECORDS, "kernels": kernels},
                                  indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
