"""The port's fault injection and fault tolerance (repro_torch.online.faults,
the retrying BrokerClient, the broker's idempotent replay, BrokerPredictor's
degraded mode) against the JAX package on the CPU: fault plans serialise to
the reference's dicts, backoff and fault draws follow the reference's
schedules, inproc and tcp see one schedule, retries and listener restarts
leave the deterministic counters clean, and a broker outage degrades to the
paper's schedule-anyway answer, decision for decision like the reference.
Every wait is bounded."""

import asyncio
import dataclasses
import random

import numpy as np
import pytest

from repro.cluster import experiment as jexp
from repro.cluster import workload as jworkload
from repro.core.atlas import AtlasStats as JAtlasStats
from repro.online import broker as jbroker
from repro.online import faults as jfaults
from repro_torch.cluster import experiment as texp
from repro_torch.cluster.workload import WorkloadConfig
from repro_torch.core.atlas import AtlasStats
from repro_torch.ml.models import ALL_MODELS
from repro_torch.online.broker import BrokerPredictor
from repro_torch.online.faults import (FAULT_BOUNDS, FaultInjector, FaultPlan,
                                       PredictorUnavailableError,
                                       backoff_delay, backoff_schedule)
from repro_torch.online.server import AsyncBroker, BrokerClient
from repro_torch.online.transport import CommClosedError, connect, listen

CPU = "cpu"
PLANS = [FaultPlan(),
         FaultPlan(seed=7, drop=0.2, delay=0.1, delay_s=(0.002, 0.05),
                   duplicate=0.15, abrupt_close=0.05, restart_after=(5, 12),
                   max_events=32, request_timeout_s=0.2, deadline_s=45.0)] \
    + [FaultPlan.sample(random.Random(k)) for k in range(12)]


def _forest_data(n=400, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(n) > 0.8).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def model():
    X, y = _forest_data()
    return ALL_MODELS["R.F."](device=CPU).fit(X, y)


def _want(model, X):
    return np.asarray(model.predict_proba(X), np.float32)


def _as_reference(plan: FaultPlan) -> jfaults.FaultPlan:
    return jfaults.FaultPlan.from_dict(plan.to_dict())


# ---------------------------------------------------------------------------
# FaultPlan: bounds, round trip, sampling — the reference's
# ---------------------------------------------------------------------------

def test_fault_plans_match_the_reference():
    assert {k: dataclasses.asdict(b) for k, b in FAULT_BOUNDS.items()} \
        == {k: dataclasses.asdict(b)
            for k, b in jfaults.FAULT_BOUNDS.items()}
    for k in range(12):
        assert FaultPlan.sample(random.Random(k)).to_dict() \
            == jfaults.FaultPlan.sample(random.Random(k)).to_dict()
    for plan in PLANS:
        assert FaultPlan.from_dict(plan.to_dict()) == plan
        assert _as_reference(plan).to_dict() == plan.to_dict()
        assert FaultPlan.from_dict(_as_reference(plan).to_dict()) == plan


@pytest.mark.parametrize("bad", [
    dict(drop=0.6), dict(drop=0.4, delay=0.4, duplicate=0.3),
    dict(delay_s=(0.02, 0.01)), dict(delay_s=(0.0, 0.5)),
    dict(restart_after=(3, 3)), dict(restart_after=(0,)), dict(seed=-1),
    dict(max_events=5000), dict(request_timeout_s=0.001),
    dict(deadline_s=0.01)])
def test_fault_plan_validate_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        FaultPlan(**bad).validate()
    with pytest.raises(ValueError):
        jfaults.FaultPlan(**bad).validate()


# ---------------------------------------------------------------------------
# Deterministic schedules: backoff and fault draws equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,base,cap", [(0, 0.05, 1.0), (3, 0.05, 1.0),
                                           (7, 0.0625, 1.0), (11, 0.5, 8.0)])
def test_backoff_schedule_matches_the_reference(seed, base, cap):
    sched = backoff_schedule(12, base=base, cap=cap, seed=seed)
    assert sched == jfaults.backoff_schedule(12, base=base, cap=cap,
                                             seed=seed)
    for i, d in enumerate(sched):
        env = min(cap, base * 2 ** i)
        assert env / 2 <= d <= env <= cap
    with pytest.raises(ValueError):
        backoff_delay(-1)


def test_fault_draws_match_the_reference():
    for plan in PLANS:
        mine, ref = FaultInjector(plan), jfaults.FaultInjector(
            _as_reference(plan))
        for conn in range(3):
            a, b = mine._rng_for_conn(conn), ref._rng_for_conn(conn)
            for _ in range(80):
                fa, fb = mine.draw(a), ref.draw(b)
                assert fa == fb
                if fa[0] != "none":
                    mine.record(fa[0])
                    ref.record(fb[0])
        assert mine.stats() == ref.stats()


def _faulted_echo_run(address, plan, n_msgs=60):
    """Send n id'd messages through a fault-wrapped client comm; return the
    ids the server received and the injector's counters."""
    async def go():
        got = []

        async def sink_handler(comm):
            try:
                while True:
                    got.append((await comm.recv())["i"])
            except CommClosedError:
                pass

        lst = await listen(address, sink_handler)
        injector = FaultInjector(plan)
        comm = injector.wrap(await connect(lst.address), side="client")
        for i in range(n_msgs):
            await comm.send({"i": i})
        await comm.send({"i": -1})       # flush marker past any delays
        for _ in range(1000):
            if got and got[-1] == -1:
                break
            await asyncio.sleep(0.01)
        await comm.close()
        await lst.stop()
        return got[:-1], injector.stats()
    return asyncio.run(asyncio.wait_for(go(), 30))


def test_fault_schedule_identical_on_inproc_and_tcp():
    plan = FaultPlan(seed=11, drop=0.2, delay=0.1, delay_s=(0.0, 0.002),
                     duplicate=0.15, max_events=4096)
    got_inproc, st_inproc = _faulted_echo_run("inproc://tf-faults", plan)
    got_tcp, st_tcp = _faulted_echo_run("tcp://127.0.0.1:0", plan)
    assert got_inproc == got_tcp
    assert st_inproc == st_tcp
    assert st_inproc["drops"] > 0 and st_inproc["duplicates"] > 0
    # and it is the schedule the reference derives from the plan alone
    ref = jfaults.FaultInjector(_as_reference(plan))
    rng = ref._rng_for_conn(0)
    expect = []
    for i in range(60):
        fault, _ = ref.draw(rng)
        if fault != "none":
            ref.record(fault)
        if fault == "drop":
            continue
        expect.extend([i, i] if fault == "duplicate" else [i])
    assert got_inproc == expect


def test_fault_budget_caps_injected_events():
    plan = FaultPlan(seed=1, drop=0.5, max_events=3)
    got, st = _faulted_echo_run("inproc://tf-budget", plan, n_msgs=50)
    assert st["drops"] == 3 and st["events"] == 3
    assert len(got) == 50 - 3            # budget spent: the rest fly clean


# ---------------------------------------------------------------------------
# Client retry + broker idempotent replay
# ---------------------------------------------------------------------------

def test_retries_and_replays_keep_deterministic_stats_byte_clean(model):
    stream = _forest_data(seed=1)[0]
    requests = [stream[i:i + 1 + (i % 3)] for i in range(0, 90, 3)]

    def run(plan):
        with AsyncBroker({"map": model}, policy="vt", device=CPU) as server:
            addr = server.serve(fault_plan=plan)
            kw = {} if plan is None else dict(
                request_timeout_s=plan.request_timeout_s,
                deadline_s=plan.deadline_s, retry_seed=plan.seed)
            client = BrokerClient(addr, server.loop, **kw)
            try:
                outs = [client.predict("map", X) for X in requests]
            finally:
                client.close()
            return outs, server.stats(), server.fault_stats(), client

    plan = FaultPlan(seed=5, drop=0.25, delay=0.1, delay_s=(0.0, 0.01),
                     duplicate=0.1, abrupt_close=0.05, max_events=48,
                     request_timeout_s=0.2, deadline_s=60.0)
    clean_outs, clean_stats, clean_faults, _ = run(None)
    fault_outs, fault_stats, faults, client = run(plan)
    for X, a, b in zip(requests, clean_outs, fault_outs):
        assert np.array_equal(a, _want(model, X))
        assert np.array_equal(b, a)      # every retry replayed bit-identically
    assert faults["injected"]["events"] > 0
    assert client.n_retries > 0 and faults["dup_requests"] > 0
    assert client.max_wait_s > 0.0
    assert fault_stats == clean_stats
    assert clean_faults == {"replays": 0, "dup_requests": 0,
                            "injected": {"events": 0, "drops": 0, "delays": 0,
                                         "duplicates": 0, "closes": 0,
                                         "restarts": 0, "messages_in": 0}}


@pytest.mark.parametrize("address", ["", "tcp://127.0.0.1:0"],
                         ids=["inproc", "tcp"])
def test_listener_restart_rides_through_on_reconnect(model, address):
    stream = _forest_data(seed=2)[0]
    plan = FaultPlan(seed=3, restart_after=(5, 12),
                     request_timeout_s=0.25, deadline_s=60.0)
    with AsyncBroker({"map": model}, policy="vt", device=CPU) as server:
        addr = server.serve(address, fault_plan=plan)
        client = BrokerClient(addr, server.loop,
                              request_timeout_s=plan.request_timeout_s,
                              deadline_s=plan.deadline_s,
                              backoff_base_s=0.01, backoff_cap_s=0.1)
        try:
            for i in range(25):
                X = stream[i:i + 2]
                assert np.array_equal(client.predict("map", X),
                                      _want(model, X))
        finally:
            client.close()
        faults = server.fault_stats()
        stats = server.stats()
    assert faults["injected"]["restarts"] == 2
    assert client.n_reconnects >= 2
    assert stats["requests"] == 25       # replay slot: retries never re-admit


def test_done_is_acked_and_deduped_by_client_id():
    with AsyncBroker(policy="barrier", device=CPU) as server:
        addr = server.serve()
        server.add_clients(2)

        async def go():
            comm = await connect(addr)
            for req_id in (1, 2):        # a retried done: same client id
                await comm.send({"op": "done", "id": req_id, "client": "cA"})
                ack = await comm.recv()
                assert ack == {"id": req_id, "ok": True}
            await comm.close()

        asyncio.run_coroutine_threadsafe(go(), server.loop).result(30)
        assert server._clients == 1      # shrank once despite two dones


def test_unreachable_broker_raises_predictor_unavailable():
    with AsyncBroker(policy="vt", device=CPU) as server:
        with pytest.raises(PredictorUnavailableError, match="cannot reach"):
            BrokerClient("inproc://tf-nobody", server.loop, max_retries=2,
                         backoff_base_s=0.001, backoff_cap_s=0.002)


# ---------------------------------------------------------------------------
# Graceful degradation: schedule anyway, probe, recover
# ---------------------------------------------------------------------------

class _FlakyBroker:
    """submit() raises PredictorUnavailableError for the first ``fail``
    calls that reach it, then serves a recognisable constant."""

    def __init__(self, fail):
        self.fail = fail
        self.n_submits = 0

    def submit(self, groups):
        self.n_submits += 1
        if self.fail > 0:
            self.fail -= 1
            raise PredictorUnavailableError("broker down")
        return [np.full(np.asarray(X).shape[0], 0.25, np.float32)
                for _, X in groups]


class _ReferenceFlaky(_FlakyBroker):
    def submit(self, groups):
        try:
            return super().submit(groups)
        except PredictorUnavailableError as e:
            raise jfaults.PredictorUnavailableError(str(e)) from None


def test_degraded_flushes_fall_back_then_probe_recovers():
    X = np.zeros((3, 4), np.float32)
    seen = {}
    for name, bp in (
            ("port", BrokerPredictor(broker=_FlakyBroker(fail=1),
                                     fallback_probe_every=2, device=CPU)),
            ("reference", jbroker.BrokerPredictor(
                broker=_ReferenceFlaky(fail=1), fallback_probe_every=2))):
        outs = [bp._flush_brokered([(None, X)])[0] for _ in range(4)]
        # outage: p=1.0 per row (the untrained-model answer, so the ATLAS
        # gate schedules anyway); countdown flushes skip the broker; the
        # probe flush retries for real and clears the degradation
        assert [np.array_equal(o, np.ones(3, np.float32))
                for o in outs] == [True, True, True, False]
        assert np.array_equal(outs[-1], np.full(3, 0.25, np.float32))
        assert not bp.degraded and bp.broker.n_submits == 2
        seen[name] = (bp.n_fallbacks, bp.n_fallback_rows)
    assert seen["port"] == seen["reference"] == (3, 9)


def test_broker_errors_are_not_outages():
    """A scoring failure the broker reports is an error, not an outage: the
    predictor raises it and never answers p = 1.0."""
    class Broken:
        def submit(self, groups):
            raise RuntimeError("broker error: launch failed")

    bp = BrokerPredictor(broker=Broken(), device=CPU)
    with pytest.raises(RuntimeError, match="launch failed"):
        bp._flush_brokered([(None, np.zeros((2, 4), np.float32))])
    assert not bp.degraded and bp.n_fallbacks == 0


def test_degraded_decisions_counter_is_omitted_while_zero():
    for cls in (AtlasStats, JAtlasStats):
        assert "degraded_decisions" not in cls().to_dict()
        assert cls(degraded_decisions=4).to_dict()["degraded_decisions"] == 4
    assert AtlasStats().to_dict() == JAtlasStats().to_dict()


class _DeadBroker:
    def __init__(self, error):
        self.error = error

    def submit(self, groups):
        raise self.error("broker unreachable")


def test_outage_run_degrades_like_the_reference():
    """An ATLAS run whose broker is down from the start: every decision is
    degraded and schedules anyway, with stats equal to the reference's."""
    wl = WorkloadConfig(n_single=6, n_chains=1, chain_len_range=(3, 4),
                        maps_range=(4, 8), reduces_range=(2, 6),
                        submit_horizon=2400.0)
    kw = dict(min_samples=40, max_train=40)
    tcfg = texp.ExperimentConfig(workload=wl, device=CPU, **kw)
    jcfg = jexp.ExperimentConfig(workload=jworkload.WorkloadConfig(
        **dataclasses.asdict(wl)), **kw)
    _, trace, _ = texp.run_baseline("fifo", tcfg)
    data = trace.datasets()
    stats = {}
    for name, mod, cfg, pred in (
            ("port", texp, tcfg, BrokerPredictor(
                broker=_DeadBroker(PredictorUnavailableError), device=CPU,
                **kw)),
            ("reference", jexp, jcfg, jbroker.BrokerPredictor(
                broker=_DeadBroker(jfaults.PredictorUnavailableError),
                **kw))):
        assert pred.fit_datasets(*data)
        metrics, _, _ = mod.run_scheduler("atlas-fifo", cfg, pred)
        stats[name] = metrics["sched_stats"]
    assert stats["port"] == stats["reference"]
    s = stats["port"]
    assert s["predictions"] > 0
    assert s["degraded_decisions"] == s["predictions"]
    assert s["predicted_fail"] == 0

