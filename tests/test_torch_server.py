"""The port's AsyncBroker and BrokerClient (repro_torch.online.server) on the
CPU: the vt policy serves the scalar floats bit for bit, barrier rounds
decompose as the threaded PredictionBroker's do, the SLO valve flushes a
parked request, errors reach the client as errors, telemetry frames are
forwarded, the named-model op works over tcp:// with either serializer,
the open-loop bench path keeps parity, and a broker rebuilt from a
version the JAX package's registry published scores like the reference.
Every wait is bounded."""

import asyncio
import threading
import time

import numpy as np
import pytest

from repro.core.predictor import TaskPredictor as JPredictor
from repro.online.registry import ModelRegistry as JRegistry
from repro_torch.ml.models import ALL_MODELS
from repro_torch.online import transport
from repro_torch.online.broker import BrokerPredictor, PredictionBroker
from repro_torch.online.server import AsyncBroker, BrokerClient, _Req
from repro_torch.online.transport import connect

CPU = "cpu"
WAIT_S = 60


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


def _join(threads):
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a client thread hung"


# ---------------------------------------------------------------------------
# vt policy: continuous batching, outputs bit-identical to scalar scoring
# ---------------------------------------------------------------------------

def test_vt_policy_predict_bitwise_matches_scalar(model):
    stream = _forest_data(seed=1)[0]
    requests = [stream[i:i + 1 + (i % 3)] for i in range(0, 90, 3)]
    with AsyncBroker({"map": model}, policy="vt", device=CPU) as server:
        addr = server.serve()
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S)
        try:
            for X in requests:
                assert np.array_equal(client.predict("map", X),
                                      _want(model, X))
        finally:
            client.close()
        stats = server.stats()
    assert stats["requests"] == len(requests)
    assert stats["rows"] == sum(X.shape[0] for X in requests)
    assert stats["flushes"] >= 1 and stats["policy"] == "vt"


def test_vt_depth_cap_batches_a_dense_burst_deterministically(model):
    """20 requests of 3 rows land on the channel before the handler wakes,
    so the handler drains them in one go: the depth cap (8 rows) closes a
    batch at 9 rows every third request, and the idle drain sweeps the
    6-row tail."""
    stream = _forest_data(seed=2)[0]
    with AsyncBroker({"map": model}, policy="vt", depth=8,
                     device=CPU) as server:
        addr = server.serve()

        async def burst():
            comm = await connect(addr)
            for i in range(20):
                await comm.send({"op": "predict", "id": i, "kind": "map",
                                 "X": stream[3 * i:3 * i + 3]})
            replies = [await comm.recv() for _ in range(20)]
            await comm.close()
            return replies

        replies = asyncio.run_coroutine_threadsafe(
            burst(), server.loop).result(WAIT_S)
        assert server.n_depth_flushes == 6
        assert server.n_idle_flushes == 1
        assert server.max_flush_rows == 9
    for r in replies:
        i = r["id"]
        assert np.array_equal(r["probs"][0],
                              _want(model, stream[3 * i:3 * i + 3]))


@pytest.mark.parametrize("serializer", ["json", "msgpack"])
def test_named_model_predict_over_tcp(model, serializer):
    if serializer == "msgpack":
        pytest.importorskip("msgpack")
    stream = _forest_data(seed=7)[0]
    with AsyncBroker({"map": model}, policy="vt", device=CPU,
                     serializer=serializer) as server:
        addr = server.serve("tcp://127.0.0.1:0")
        assert addr.startswith("tcp://127.0.0.1:")
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S,
                              serializer=serializer)
        try:
            for i in range(0, 40, 4):
                X = stream[i:i + 4]
                out = client.predict("map", X)
                assert out.dtype == np.float32
                assert np.array_equal(out, _want(model, X))
        finally:
            client.close()


def test_tcp_serves_json_frames_without_msgpack(model, monkeypatch):
    monkeypatch.setattr(transport, "msgpack", None)
    X = _forest_data(seed=8)[0][:5]
    with AsyncBroker({"map": model}, policy="vt", device=CPU) as server:
        addr = server.serve("tcp://127.0.0.1:0")
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S)
        try:
            assert np.array_equal(client.predict("map", X), _want(model, X))
        finally:
            client.close()


# ---------------------------------------------------------------------------
# barrier policy: PredictionBroker round rules on the event loop
# ---------------------------------------------------------------------------

def test_barrier_rounds_match_the_threaded_broker(model):
    """Clients with request counts [4, 2, 7]: 2 full three-way rounds, then
    2 two-way rounds after the short client deregisters, then 3 solo
    flushes — the threaded PredictionBroker's decomposition, counter for
    counter."""
    stream = _forest_data(seed=3)[0]
    counts = [4, 2, 7]

    def requests(ci):
        return [stream[(ci * 31 + i * 3) % 80:(ci * 31 + i * 3) % 80 + 2]
                for i in range(counts[ci])]

    def drive(make_client, broker):
        outs = {}

        def run_client(ci):
            client = make_client()
            try:
                for i, X in enumerate(requests(ci)):
                    (outs[(ci, i)],) = client.submit([(model, X)])
            finally:
                client.done()

        threads = [threading.Thread(target=run_client, args=(ci,))
                   for ci in range(len(counts))]
        for t in threads:
            t.start()
        _join(threads)
        return outs

    with AsyncBroker(policy="barrier", device=CPU) as server:
        addr = server.serve()
        server.add_clients(len(counts))
        served = drive(lambda: BrokerClient(addr, server.loop,
                                            request_timeout_s=WAIT_S),
                       server)
        stats = server.stats()
    threaded = PredictionBroker(device=CPU)
    threaded.add_clients(len(counts))
    drive(lambda: threaded, threaded)
    assert stats["flushes"] == 7
    assert stats == {**threaded.stats(), "policy": "barrier"}
    for (ci, i), out in served.items():
        assert np.array_equal(out, _want(model, requests(ci)[i]))


def test_empty_submit_short_circuits_client_side():
    with AsyncBroker(policy="barrier", device=CPU) as server:
        addr = server.serve()
        server.add_clients(1)
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S)
        try:
            assert client.submit([]) == []   # no wire traffic, no round
        finally:
            client.done()
            client.close()
        assert server.stats()["requests"] == 0


def test_depth_policy_broker_serves_the_mirror(model):
    """PredictionBroker's queue-depth policy: the outputs of each request
    equal its scalar scores however the batches closed, and a short tail
    flushes on the deadline timer."""
    stream = _forest_data(seed=9)[0]
    broker = PredictionBroker(device=CPU, policy="depth", depth=16,
                              max_delay=0.002)
    broker.add_clients(3)
    outs = {}

    def run_client(ci):
        try:
            for i in range(6):
                X = stream[10 * ci + i:10 * ci + i + 1 + i % 3]
                (outs[(ci, i)],) = broker.submit([(model, X)])
                assert np.array_equal(outs[(ci, i)], _want(model, X))
        finally:
            broker.done()

    threads = [threading.Thread(target=run_client, args=(ci,))
               for ci in range(3)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(outs) == 18
    stats = broker.stats()
    assert stats["policy"] == "depth" and stats["requests"] == 18
    assert broker.n_deadline_flushes >= 1
    with pytest.raises(ValueError, match="policy"):
        PredictionBroker(device=CPU, policy="vt")


# ---------------------------------------------------------------------------
# SLO safety valve + error propagation + unknown ops
# ---------------------------------------------------------------------------

def test_slo_safety_valve_flushes_parked_request(model):
    """The wall-clock valve is defense in depth — the idle drain normally
    beats it — so its mechanics are exercised directly: a request parked on
    the queue with an armed deadline must flush when the deadline passes."""
    X = _forest_data(seed=4)[0][:3]

    class FakeComm:
        closed = False

        def __init__(self):
            self.sent = []

        async def send(self, msg):
            self.sent.append(msg)

    comm = FakeComm()
    server = AsyncBroker(policy="vt", device=CPU).start()
    try:
        def park():
            server._queue.append(_Req(comm, 1, [(model, X)], 3, 1, None))
            server._queued_rows = 3
            server._arm_slo(time.perf_counter() + 0.02)

        server.loop.call_soon_threadsafe(park)
        deadline = time.time() + 5
        while not comm.sent and time.time() < deadline:
            time.sleep(0.01)
    finally:
        server.stop()
    assert comm.sent and server.n_deadline_flushes == 1
    assert np.array_equal(comm.sent[0]["probs"][0], _want(model, X))


def test_errors_propagate_to_the_client_and_the_loop_survives(model):
    class Broken:
        def predict_proba(self, X):
            raise RuntimeError("boom")

    stream = _forest_data(seed=5)[0]
    with AsyncBroker({"map": model}, policy="vt", device=CPU) as server:
        addr = server.serve()
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S)
        try:
            with pytest.raises(RuntimeError, match="unknown kind"):
                client.predict("nope", stream[:2])
            with pytest.raises(RuntimeError, match="boom"):
                client.submit([(Broken(), stream[:2])])
            # an error is an answer, not an outage: a predictor behind the
            # client raises it instead of falling back to p = 1.0
            bp = BrokerPredictor(broker=client, device=CPU)
            with pytest.raises(RuntimeError, match="boom"):
                bp._flush([(Broken(), stream[:2])])
            assert not bp.degraded and bp.n_fallbacks == 0
            assert client.n_retries == 0
            # the serving loop survives: a good request still works
            assert np.array_equal(client.predict("map", stream[:2]),
                                  _want(model, stream[:2]))
        finally:
            client.close()

        async def unknown():
            comm = await connect(addr)
            await comm.send({"op": "nope", "id": 5})
            reply = await comm.recv()
            await comm.send({"op": "ping"})
            pong = await comm.recv()
            await comm.close()
            return reply, pong

        reply, pong = asyncio.run_coroutine_threadsafe(
            unknown(), server.loop).result(WAIT_S)
    assert reply == {"id": 5, "error": "unknown op 'nope'"}
    assert pong == {"op": "pong"}


def test_device_rule_and_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        AsyncBroker(policy="depth", device=CPU)
    server = AsyncBroker(device=CPU)
    assert server.device.type == "cpu" and server.impl is None


# ---------------------------------------------------------------------------
# Telemetry frames over the transport
# ---------------------------------------------------------------------------

def test_telemetry_frames_reach_the_sink_with_wire_accounting():
    class Sink:
        def __init__(self):
            self.frames = []

        def emit(self, frame):
            self.frames.append(frame)

    sink = Sink()
    frames = [{"t": i, "gauges": {"x": i * 2}} for i in range(5)]
    with AsyncBroker(policy="vt", device=CPU) as server:
        server.telemetry_sink = sink
        addr = server.serve()

        async def produce():
            comm = await connect(addr)
            for n, f in enumerate(frames[:3], 1):
                await comm.send({"op": "telemetry", "frame": f,
                                 "source": "cell", "n": n})
            # a batch that skips n = 4, then a restart from n = 1
            await comm.send({"op": "telemetry", "source": "cell",
                             "frames": [{"frame": frames[3], "n": 5},
                                        {"frame": frames[4], "n": 1}]})
            await comm.send({"op": "ping"})
            await comm.recv()            # every frame before it was routed
            await comm.close()

        asyncio.run_coroutine_threadsafe(produce(),
                                         server.loop).result(WAIT_S)
        stats = server.telemetry_stats()
    assert sink.frames == frames         # inproc: the very same dicts
    assert stats["frames"] == 5
    src = stats["sources"]["cell"]
    assert (src["frames"], src["last_n"], src["gaps"], src["reconnects"]) \
        == (5, 1, 1, 1)


# ---------------------------------------------------------------------------
# Open-loop bench path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,arrivals", [("inproc", "poisson"),
                                              ("inproc", "bursty"),
                                              ("tcp", "poisson")])
def test_open_loop_parity_and_tail_metrics(model, backend, arrivals):
    from repro_torch.online.bench import _parity_mod, run_open_loop

    class _P:
        def model_for_kind(self, kind):
            return model

    stream = _forest_data(seed=6)[0]
    requests = [("map", stream[i:i + 1 + (i % 3)]) for i in range(0, 120, 3)]
    scalar = [_want(model, X) for _, X in requests]
    run = run_open_loop(_P(), requests, backend=backend, arrivals=arrivals,
                        clients=3, rate_rps=3000.0, slo_ms=50.0, seed=0,
                        device=CPU)
    assert _parity_mod(scalar, run["outputs"])
    assert run["rows"] == sum(X.shape[0] for _, X in requests)
    lm = run["latency_ms"]
    assert 0 <= lm["p50"] <= lm["p95"] <= lm["p99"]
    assert 0.0 <= run["slo_violation_rate"] <= 1.0
    assert run["flushes"] >= 1
    assert sum(run["flush_causes"].values()) == run["flushes"]


# ---------------------------------------------------------------------------
# Crash recovery from a registry the JAX package wrote
# ---------------------------------------------------------------------------

def test_from_registry_scores_like_the_reference(tmp_path):
    mx, my = _forest_data(seed=4)
    pred = JPredictor(min_samples=40, max_train=400)
    assert pred.fit_datasets((mx, my), (mx, my))
    JRegistry(tmp_path).publish("outcome", pred.snapshot())

    X = _forest_data(seed=5)[0][:16]
    want = pred.predict_batch("map", X)
    with AsyncBroker.from_registry(tmp_path, "outcome", device=CPU) as server:
        assert set(server.models) == {"map", "reduce"}
        addr = server.serve("tcp://127.0.0.1:0")
        client = BrokerClient(addr, server.loop, request_timeout_s=WAIT_S)
        try:
            out = client.predict("map", X)
        finally:
            client.close()
    assert np.array_equal(out, want)     # the replacement broker serves the
    #                                      reference's exact floats
