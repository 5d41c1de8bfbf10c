"""The port's scenario library and fleet sweep engine
(repro_torch.cluster.scenarios, repro_torch.cluster.fleet) against the JAX
package on the CPU.

The scenario library is pure Python copied from the reference: its draws,
moves and encodings are held equal.  A sweep's ``SWEEP.json`` is held equal
to the reference's apart from ``provenance`` (each package stamps its own
tag), under the serial, broker and async executors, ``perf.broker``
included; a faulted async sweep equals the clean one.
The kitchen_sink smoke matrix at 100 nodes with ``min_samples=40`` is used
because its ATLAS cells train and ask for predictions (the reference's
broker run makes demand calls), so the parity is not vacuous."""

import dataclasses
import json
import random
import time

import pytest

from repro.cluster import fleet as jfleet
from repro.cluster import scenarios as jsc
from repro_torch.cluster import fleet as tfleet
from repro_torch.cluster import scenarios as tsc
from repro_torch.online.faults import FaultPlan

CPU = "cpu"
SMALL = dict(schedulers=("fifo", "atlas-fifo"), seeds=2,
             scenarios=("kitchen_sink",), workloads=("smoke",),
             fleet_sizes=(100,), min_samples=40)


def _quiet(*a, **k):
    pass


def _without_provenance(result) -> dict:
    out = json.loads(tfleet.sweep_json(result))
    assert out.pop("provenance")["pr"]
    return out


# ---------------------------------------------------------------- scenarios

def test_scenario_library_matches_reference():
    assert list(tsc.SCENARIOS) == list(jsc.SCENARIOS)
    for name in jsc.SCENARIOS:
        assert tsc.SCENARIOS[name].to_dict() == jsc.SCENARIOS[name].to_dict()
    assert list(tsc.WORKLOAD_SHAPES) == list(jsc.WORKLOAD_SHAPES)
    for name, wl in jsc.WORKLOAD_SHAPES.items():
        assert dataclasses.asdict(tsc.WORKLOAD_SHAPES[name]) \
            == dataclasses.asdict(wl)
    for bounds in ("CHAOS_BOUNDS", "WORKLOAD_BOUNDS"):
        assert {k: dataclasses.asdict(b)
                for k, b in getattr(tsc, bounds).items()} \
            == {k: dataclasses.asdict(b)
                for k, b in getattr(jsc, bounds).items()}


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_scenario_draws_and_moves_match_reference(seed):
    j = jsc.ScenarioSpec.sample(random.Random(seed), name="s")
    t = tsc.ScenarioSpec.sample(random.Random(seed), name="s")
    assert t.to_dict() == j.to_dict()
    for scale in (0.1, 0.25, 1.0):
        jm = j.perturb(random.Random(seed + 1), scale)
        tm = t.perturb(random.Random(seed + 1), scale)
        assert tm.to_dict() == jm.to_dict()
    for name in ("baseline", "kitchen_sink", "bursty_tt"):
        jp, tp = jsc.make_spec(name, "map_heavy"), tsc.make_spec(name,
                                                                 "map_heavy")
        assert tp.to_dict() == jp.to_dict()
        assert dataclasses.asdict(tp.chaos_for_seed(seed)) \
            == dataclasses.asdict(jp.chaos_for_seed(seed))
        assert dataclasses.asdict(tp.workload_for_seed(seed)) \
            == dataclasses.asdict(jp.workload_for_seed(seed))
        again = tsc.ScenarioSpec.from_dict(jp.to_dict())
        assert again == tp


def test_scenario_scope_registers_for_the_sweep():
    point = tsc.ScenarioSpec.sample(random.Random(3), name="p")
    with tsc.scenario_scope(point, scenario_name="tmp_sc",
                            workload_name="tmp_wl"):
        assert tsc.make_spec("tmp_sc", "tmp_wl").to_dict()["chaos"] \
            == point.to_dict()["chaos"]
    assert "tmp_sc" not in tsc.SCENARIOS


# ---------------------------------------------------------------- matrix

SPECS = [
    dict(schedulers=("fifo", "fair", "atlas-fifo"), seeds=3,
         scenarios=("baseline", "dn_loss"), workloads=("smoke", "default")),
    dict(schedulers=("atlas-capacity",), seeds=(4, 1, 4),
         scenarios=("net_flap",), workloads=("map_heavy",),
         fleet_sizes=(0, 100, 1000), hazard="per-node"),
]


@pytest.mark.parametrize("kw", SPECS, ids=["paper", "sizes"])
def test_expand_and_cell_config_match_reference(kw):
    jspec, tspec = jfleet.SweepSpec(**kw), tfleet.SweepSpec(**kw)
    assert tspec.to_json() == jspec.to_json()
    jcells, tcells = jfleet.expand(jspec), tfleet.expand(tspec)
    assert [dataclasses.astuple(c) for c in tcells] \
        == [dataclasses.astuple(c) for c in jcells]
    for jc, tc in zip(jcells, tcells):
        assert tc.cell_id == jc.cell_id and tc.env_key == jc.env_key
        jcfg, tcfg = jfleet.cell_config(jspec, jc), tfleet.cell_config(tspec,
                                                                      tc)
        tdict = dataclasses.asdict(tcfg)
        assert tdict.pop("device") is None
        jdict = {k: v for k, v in dataclasses.asdict(jcfg).items()
                 if k in tdict}
        assert tdict == jdict


def test_cell_seed_matches_reference():
    for parts in [("chaos", "baseline", "smoke", 0),
                  ("sim", "kitchen_sink", "map_heavy", "n1000", 3),
                  ("search", 0, 7), ()]:
        assert tfleet.cell_seed(*parts) == jfleet.cell_seed(*parts)


def test_expand_rejects_what_the_reference_rejects():
    for bad in (dict(scenarios=("nope",)), dict(workloads=("nope",)),
                dict(schedulers=("atlas-nope",)), dict(algo="SVM"),
                dict(fleet_sizes=(-1,)), dict(hazard="rack")):
        with pytest.raises(KeyError):
            jfleet.expand(jfleet.SweepSpec(**bad))
        with pytest.raises(KeyError):
            tfleet.expand(tfleet.SweepSpec(**bad))
    # the dense algos are known to both packages
    tfleet.expand(tfleet.SweepSpec(algo="N.N."))
    tfleet.expand(tfleet.SweepSpec(algo="Glm"))


def test_aggregate_and_rank_match_reference():
    records = []
    for i, (sched, sc, fs) in enumerate(
            [(s, sc, fs) for s in ("fifo", "atlas-fifo", "fair")
             for sc in ("baseline", "dn_loss") for fs in (0, 100)]):
        for seed in range(3):
            records.append({
                "scenario": sc, "workload": "smoke", "scheduler": sched,
                "fleet_size": fs, "seed_index": seed,
                "metrics": {"pct_tasks_failed": (7 * i + seed) % 5 + 0.5,
                            "job_exec_time": 100.0 + 13 * i - seed,
                            "sim_time": 900.0 + i}})
    agg = tfleet.aggregate(records)
    assert agg == jfleet.aggregate(records)
    assert tfleet.rank(agg) == jfleet.rank(agg)
    for vals in ([], [1.0], [1.0, 2.5, 4.0]):
        assert tfleet.mean_ci(vals) == jfleet.mean_ci(vals)


# ---------------------------------------------------------------- sweeps

@pytest.fixture(scope="module")
def reference_sweeps():
    """The reference's small sweep under each executor (its JIT dominates
    the cost, so it runs once per module)."""
    return {ex: jfleet.run_sweep(jfleet.SweepSpec(**SMALL), executor=ex,
                                 log=_quiet)
            for ex in ("serial", "broker", "async")}


@pytest.mark.parametrize("executor", ["serial", "broker", "async"])
def test_sweep_json_matches_reference(reference_sweeps, executor):
    ref = reference_sweeps[executor]
    got = tfleet.run_sweep(tfleet.SweepSpec(**SMALL), executor=executor,
                           device=CPU, log=_quiet)
    assert _without_provenance(got) == _without_provenance(ref)
    if executor != "serial":
        assert ref["perf"]["broker"]["demand_calls"] > 0
        assert got["perf"] == ref["perf"]
    atlas = [c for c in got["cells"] if c["scheduler"] == "atlas-fifo"]
    assert atlas and all(c["stats"]["predictions"] > 0 for c in atlas)
    assert got["provenance"]["pr"].startswith("repro_torch-")


def test_registry_and_thread_sweeps_match_serial(reference_sweeps, tmp_path):
    want = _without_provenance(reference_sweeps["serial"])
    brokered = tfleet.run_sweep(tfleet.SweepSpec(**SMALL), executor="broker",
                                registry=str(tmp_path / "reg"), device=CPU,
                                log=_quiet)
    threaded = tfleet.run_sweep(tfleet.SweepSpec(**SMALL), executor="thread",
                                workers=2, device=CPU, log=_quiet)
    assert _without_provenance(threaded) == want
    out = _without_provenance(brokered)
    assert out.pop("perf") == _without_provenance(
        reference_sweeps["broker"])["perf"]
    assert out == want
    assert (tmp_path / "reg").is_dir()


def test_resumed_sweep_is_byte_identical(tmp_path):
    spec = tfleet.SweepSpec(schedulers=("fifo", "atlas-fifo"), seeds=1,
                            scenarios=("baseline",), workloads=("smoke",),
                            min_samples=40)
    kw = dict(executor="serial", device=CPU, log=_quiet,
              resume_dir=str(tmp_path / "cells"))
    first = tfleet.sweep_json(tfleet.run_sweep(spec, **kw))
    lines = []
    again = tfleet.sweep_json(tfleet.run_sweep(spec, **{**kw,
                                                        "log": lines.append}))
    assert again == first
    assert any("resumed" in line for line in lines)


def test_cli_writes_the_sweep(tmp_path):
    out = tmp_path / "out"
    assert tfleet.main(["--schedulers", "fifo,atlas-fifo", "--seeds", "1",
                        "--scenarios", "baseline", "--workloads", "smoke",
                        "--min-samples", "40", "--executor", "serial",
                        "--device", "cpu", "--out", str(out)]) == 0
    result = json.loads((out / "SWEEP.json").read_text())
    assert len(result["cells"]) == 2
    assert "atlas-fifo" in (out / "SWEEP.md").read_text()
    assert tfleet.main(["--scenarios", "nope", "--device", "cpu"]) == 2


# the fault plan of the JAX package's own faulted-sweep test, with twice
# its request timeout: a round that waits on a busy test machine should
# retry, not run out of attempts
CHAOS_PLAN = FaultPlan(seed=7, drop=0.15, delay=0.05, delay_s=(0.0, 0.005),
                       duplicate=0.1, restart_after=(40,), max_events=24,
                       request_timeout_s=0.5, deadline_s=120.0)


def test_async_sweep_equals_the_broker_sweep_bytes():
    spec = tfleet.SweepSpec(**SMALL)
    stats = {}
    asynced = tfleet.run_sweep(spec, executor="async", device=CPU,
                               fault_stats=stats, log=_quiet)
    brokered = tfleet.run_sweep(spec, executor="broker", device=CPU,
                                log=_quiet)
    # full equality, perf.broker included: same rounds, same counts
    assert tfleet.sweep_json(asynced) == tfleet.sweep_json(brokered)
    assert stats["fallbacks"] == 0 and stats["client_retries"] == 0
    assert stats["injected"]["events"] == 0
    assert stats["max_request_wait_s"] > 0.0


def test_faulted_async_sweep_equals_the_clean_one():
    spec = tfleet.SweepSpec(**SMALL)
    clean = tfleet.run_sweep(spec, executor="async", device=CPU, log=_quiet)
    stats = {}
    faulted = tfleet.run_sweep(spec, executor="async", device=CPU,
                               fault_plan=CHAOS_PLAN, fault_stats=stats,
                               log=_quiet)
    assert tfleet.sweep_json(faulted) == tfleet.sweep_json(clean)
    assert stats["injected"]["events"] > 0
    assert stats["injected"]["restarts"] == 1
    assert stats["client_retries"] > 0
    assert stats["fallbacks"] == 0       # degraded-free: parity is meaningful


@pytest.mark.parametrize("executor", ["serial", "broker", "thread"])
def test_fault_plan_needs_the_async_executor(executor):
    with pytest.raises(ValueError, match="async"):
        tfleet.run_sweep(tfleet.SweepSpec(**SMALL), executor=executor,
                         fault_plan=FaultPlan(), device=CPU, log=_quiet)


def test_cli_async_with_faults_writes_fault_stats(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(CHAOS_PLAN.to_dict()))
    common = ["--schedulers", "fifo,atlas-fifo", "--seeds", "1",
              "--scenarios", "kitchen_sink", "--workloads", "smoke",
              "--fleet-size", "100", "--min-samples", "40",
              "--device", "cpu"]
    out = tmp_path / "out"
    assert tfleet.main([*common, "--executor", "async", "--faults",
                        str(plan), "--out", str(out)]) == 0
    faults = json.loads((out / "FAULTS.json").read_text())
    assert faults["fallbacks"] == 0 and faults["injected"]["events"] > 0
    result = json.loads((out / "SWEEP.json").read_text())
    assert result["perf"]["broker"]["policy"] == "barrier"
    assert tfleet.main([*common, "--executor", "serial", "--faults",
                        str(plan), "--out", str(tmp_path / "bad")]) == 2


@pytest.mark.parametrize("option", ["obs_dir", "obs_live"])
def test_telemetry_options_stream(option, tmp_path):
    """run_sweep(obs_dir=) writes every cell's frames and stamps perf.obs;
    run_sweep(obs_live=) streams every cell's frames to a live collector
    over tcp.  Either way the cells, aggregates and rankings are the
    telemetry-off sweep's."""
    from repro_torch.obs import TelemetryCollector, read_ndjson
    from repro_torch.online.server import AsyncBroker
    spec = tfleet.SweepSpec(**SMALL)
    off = _without_provenance(tfleet.run_sweep(spec, executor="serial",
                                               device=CPU, log=_quiet))
    cell_ids = {c["cell_id"] for c in off["cells"]}
    with AsyncBroker(device=CPU) as srv:
        coll = TelemetryCollector()
        srv.collector = coll
        kw = ({"obs_dir": str(tmp_path)} if option == "obs_dir"
              else {"obs_live": srv.serve("tcp://127.0.0.1:0")})
        on = tfleet.run_sweep(spec, executor="serial", device=CPU,
                              log=_quiet, **kw)
        if option == "obs_live":
            deadline = time.time() + 10
            while time.time() < deadline and not (
                    set(coll.source_names()) == cell_ids and all(
                        a.get("done") for a in coll.aggregates().values())):
                time.sleep(0.01)
    if option == "obs_dir":
        block = on["perf"].pop("obs")
        if not on["perf"]:
            on.pop("perf")
        assert set(block["cells"]) == cell_ids
        for cid, summary in block["cells"].items():
            frames = read_ndjson(tmp_path / (cid.replace("/", "__")
                                             + ".ndjson"))
            assert frames[-1]["type"] == "final"
            assert frames[-1]["summary"] == summary
    else:
        assert "perf" not in on
        aggs = coll.aggregates()
        assert set(aggs) == cell_ids
        assert all(a["done"] and a["sim"]["frames"] > 0
                   for a in aggs.values())
    assert _without_provenance(on) == off


def test_telemetry_resume_never_reuses_obs_off_cells(tmp_path):
    """The resume ledger's fingerprint carries obs: an obs-on restart over
    an obs-off ledger wipes it and reruns every cell (so each cell streams
    its frames and has a roll-up); an obs-on restart over an obs-on ledger
    resumes, roll-ups included."""
    spec = tfleet.SweepSpec(schedulers=("fifo", "atlas-fifo"), seeds=1,
                            scenarios=("baseline",), workloads=("smoke",),
                            min_samples=40)
    kw = dict(executor="serial", device=CPU,
              resume_dir=str(tmp_path / "cells"))
    off = tfleet.run_sweep(spec, log=_quiet, **kw)
    runs = []
    for i in range(2):
        lines = []
        runs.append((tfleet.run_sweep(spec, log=lines.append,
                                      obs_dir=str(tmp_path / f"obs{i}"),
                                      **kw), lines))
    (first, first_log), (again, again_log) = runs
    assert not any("resumed" in line for line in first_log)
    assert any("resumed" in line for line in again_log)
    ids = {c["cell_id"] for c in off["cells"]}
    assert set(first["perf"]["obs"]["cells"]) == ids
    assert len(list((tmp_path / "obs0").glob("*.ndjson"))) == len(ids)
    assert not (tmp_path / "obs1").exists()           # nothing reran
    assert again["perf"] == first["perf"]
    for result in (first, again):
        result = dict(result)
        result.pop("perf")
        assert tfleet.sweep_json(result) == tfleet.sweep_json(off)
