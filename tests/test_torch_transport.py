"""The port's comm layer (repro_torch.online.transport) against the JAX
package's on the CPU: the reference's transport cases run against the
port, the two packages encode a message to the same frame bytes under JSON
and msgpack, and a frame either package encodes decodes in the other.
Every wait is bounded."""

import asyncio
import concurrent.futures
import struct
import threading
import time

import numpy as np
import pytest

from repro.online import transport as jtransport
from repro_torch.online import transport as ttransport
from repro_torch.online.transport import (CommClosedError, FrameTooLargeError,
                                          SyncComm, connect, dumps, listen,
                                          loads, parse_address)

SERIALIZERS = ["json", "msgpack"]
WAIT_S = 10.0


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


async def _echo(comm):
    try:
        while True:
            await comm.send(await comm.recv())
    except CommClosedError:
        pass


async def _until(cond):
    for _ in range(int(WAIT_S / 0.01)):
        if cond():
            return
        await asyncio.sleep(0.01)


def _message():
    return {"op": "predict", "id": 3, "flag": True, "none": None,
            "X": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"w": [np.float32(1.5), 2, "s"],
                       "p64": np.arange(4, dtype=np.float64),
                       "i32": np.array([[7, -1]], np.int32)}}


def _need(serializer):
    if serializer == "msgpack":
        pytest.importorskip("msgpack")


# ---------------------------------------------------------------------------
# Serialization: round trip, and the same frames as the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serializer", SERIALIZERS)
def test_frame_roundtrip_ndarrays_and_scalars(serializer):
    _need(serializer)
    msg = _message()
    out = loads(*dumps(msg, serializer))
    assert out["op"] == "predict" and out["id"] == 3 and out["flag"] is True
    assert out["none"] is None
    assert np.array_equal(out["X"], msg["X"])
    assert out["X"].dtype == np.float32          # dtype survives the wire
    assert np.array_equal(out["nested"]["p64"], msg["nested"]["p64"])
    assert out["nested"]["p64"].dtype == np.float64
    assert out["nested"]["i32"].dtype == np.int32
    assert out["nested"]["w"][0] == 1.5 and out["nested"]["w"][2] == "s"


@pytest.mark.parametrize("serializer", SERIALIZERS)
def test_frame_bytes_equal_the_reference(serializer):
    _need(serializer)
    for msg in (_message(), {"op": "ping"}, {"id": 9, "probs": [
            np.linspace(0, 1, 7, dtype=np.float32), np.zeros(0, np.float32)]},
            {"op": "done", "id": 4, "client": "c1-0"}):
        assert ttransport.dumps(msg, serializer) \
            == jtransport.dumps(msg, serializer)
    assert ttransport.dumps({"op": "ping"}) == jtransport.dumps({"op": "ping"})


@pytest.mark.parametrize("serializer", SERIALIZERS)
def test_frames_decode_across_packages(serializer):
    _need(serializer)
    msg = _message()
    for enc, dec in ((ttransport, jtransport), (jtransport, ttransport)):
        out = dec.loads(*enc.dumps(msg, serializer))
        assert np.array_equal(out["X"], msg["X"])
        assert out["X"].dtype == msg["X"].dtype
        assert np.array_equal(out["nested"]["i32"], msg["nested"]["i32"])


def test_torch_tensors_are_refused_on_the_wire():
    torch = pytest.importorskip("torch")
    for serializer in SERIALIZERS:
        if serializer == "msgpack" and ttransport.msgpack is None:
            continue
        with pytest.raises(TypeError):
            dumps({"X": torch.zeros(2)}, serializer)


def test_json_frame_without_msgpack(monkeypatch):
    monkeypatch.setattr(ttransport, "msgpack", None)
    fmt, payload = dumps(_message())               # "auto" picks JSON
    assert fmt == b"J"
    assert np.array_equal(loads(fmt, payload)["X"], _message()["X"])
    with pytest.raises(RuntimeError, match="msgpack"):
        dumps({"a": 1}, "msgpack")


def test_parse_address_rejects_unknown_schemes():
    assert parse_address("inproc://x") == ("inproc", "x")
    assert parse_address("tcp://127.0.0.1:0") == ("tcp", "127.0.0.1:0")
    for bad in ("udp://x", "no-scheme", "inproc:/oops"):
        with pytest.raises(ValueError):
            parse_address(bad)


# ---------------------------------------------------------------------------
# Echo round-trips
# ---------------------------------------------------------------------------

def test_inproc_echo_is_zero_copy():
    async def go():
        lst = await listen("inproc://tt-echo", _echo)
        comm = await connect("inproc://tt-echo")
        X = np.random.rand(4, 3).astype(np.float32)
        await comm.send({"X": X})
        reply = await comm.recv()
        assert reply["X"] is X           # the object itself crossed, no copy
        await comm.close()
        await lst.stop()
    _run(go())


def test_inproc_connect_without_listener_raises():
    async def go():
        with pytest.raises(CommClosedError):
            await connect("inproc://tt-never-bound")
    _run(go())


@pytest.mark.parametrize("serializer", SERIALIZERS)
def test_tcp_echo_ndarray_lossless(serializer):
    _need(serializer)

    async def go():
        lst = await listen("tcp://127.0.0.1:0", _echo, serializer=serializer)
        assert lst.address.startswith("tcp://127.0.0.1:")
        comm = await connect(lst.address, serializer=serializer)
        X = np.linspace(-1, 1, 10, dtype=np.float64).reshape(2, 5)
        await comm.send({"op": "echo", "X": X, "n": 7})
        r = await comm.recv()
        assert np.array_equal(r["X"], X) and r["X"].dtype == X.dtype
        assert r["X"] is not X           # crossed the real socket stack
        assert r["n"] == 7
        await comm.close()
        await lst.stop()
    _run(go())


# ---------------------------------------------------------------------------
# Failure semantics
# ---------------------------------------------------------------------------

def test_tcp_oversized_outgoing_frame_rejected_sender_side():
    async def go():
        lst = await listen("tcp://127.0.0.1:0", _echo)
        comm = await connect(lst.address, max_frame=1024)
        with pytest.raises(FrameTooLargeError):
            await comm.send({"X": np.zeros(100000, np.float32)})
        # the refused send wrote nothing: the comm stays usable
        await comm.send({"ok": 1})
        assert (await comm.recv())["ok"] == 1
        await comm.close()
        await lst.stop()
    _run(go())


async def _raw_peer(handler, frame: bytes, **kw):
    """Listen with ``handler``, write ``frame`` from a raw socket, and
    return the errors the handler saw once it saw one."""
    errs = []

    async def wrapped(comm):
        try:
            await handler(comm)
        except Exception as e:                     # noqa: BLE001 (asserted)
            errs.append(e)

    lst = await listen("tcp://127.0.0.1:0", wrapped, **kw)
    host, port = lst.address.split("://")[1].rsplit(":", 1)
    _, writer = await asyncio.open_connection(host, int(port))
    writer.write(frame)
    await writer.drain()
    await _until(lambda: errs)
    writer.close()
    await lst.stop()
    return errs


def test_tcp_oversized_incoming_header_rejected_without_allocating():
    # a raw peer claims a 1 GiB frame: the reader must refuse on the header
    # alone instead of trying to buffer it
    errs = _run(_raw_peer(lambda c: c.recv(),
                          b"M" + struct.pack("!I", 1 << 30), max_frame=512))
    assert errs and isinstance(errs[0], FrameTooLargeError)


def test_tcp_mid_message_disconnect_raises_comm_closed():
    async def go():
        errs = []

        async def handler(comm):
            try:
                await comm.recv()
            except CommClosedError as e:
                errs.append(e)

        lst = await listen("tcp://127.0.0.1:0", handler)
        host, port = lst.address.split("://")[1].rsplit(":", 1)
        _, writer = await asyncio.open_connection(host, int(port))
        # promise 1000 payload bytes, deliver 10, vanish
        writer.write(b"J" + struct.pack("!I", 1000) + b"0123456789")
        await writer.drain()
        writer.close()
        await _until(lambda: errs)
        assert errs and isinstance(errs[0], CommClosedError)
        await lst.stop()
    _run(go())


def test_tcp_undecodable_payload_raises_comm_closed_not_decode_error():
    # well-formed header, garbage payload: the decode failure must surface
    # as CommClosedError (the stream can no longer be trusted), never as a
    # raw json/msgpack/struct error from the codec
    errs = _run(_raw_peer(lambda c: c.recv(),
                          b"J" + struct.pack("!I", 4) + b"\xff\x00{["))
    assert errs and isinstance(errs[0], CommClosedError)


def test_tcp_clean_peer_close_raises_comm_closed_between_frames():
    async def go():
        async def handler(comm):
            await comm.recv()
            await comm.close()

        lst = await listen("tcp://127.0.0.1:0", handler)
        comm = await connect(lst.address)
        await comm.send({"bye": 1})
        with pytest.raises(CommClosedError):
            await comm.recv()
        assert comm.closed
        await lst.stop()
    _run(go())


def test_tcp_abrupt_close_mid_frame_raises_comm_closed_client_side():
    async def go():
        async def slam(comm):
            # read the request, then vanish mid-reply: header promises a
            # payload that never arrives before the transport drops
            await comm.recv()
            comm._writer.write(b"J" + struct.pack("!I", 500) + b"{\"par")
            await comm._writer.drain()
            comm._writer.close()

        lst = await listen("tcp://127.0.0.1:0", slam)
        comm = await connect(lst.address)
        await comm.send({"op": "x"})
        with pytest.raises(CommClosedError):
            await comm.recv()
        assert comm.closed
        await lst.stop()
    _run(go())


@pytest.mark.parametrize("client_closes", [False, True],
                         ids=["peer_open", "peer_gone"])
def test_tcp_listener_stop_severs_its_connections(client_closes):
    """Stopping a TCP listener returns whether its accepted connections are
    still open (a handler parked in recv) or half-closed by a peer that left
    (the handler saw EOF): from Python 3.12 on ``wait_closed`` waits for
    every accepted connection, so either would otherwise hold ``stop``."""
    async def go():
        entered = []

        async def parked(comm):
            entered.append(comm)
            try:
                await comm.recv()
            except CommClosedError:
                pass

        lst = await listen("tcp://127.0.0.1:0", parked)
        comm = await connect(lst.address)
        await _until(lambda: entered)
        if client_closes:
            await comm.close()
            await _until(lambda: entered[0].closed)
        await asyncio.wait_for(lst.stop(), WAIT_S)
        assert entered[0].closed
        if not client_closes:
            with pytest.raises(CommClosedError):
                await asyncio.wait_for(comm.recv(), WAIT_S)
            await comm.close()
    _run(go())


def test_tcp_listener_stop_severs_a_connection_it_has_not_handed_over():
    """A client on another thread's loop connects and the listener stops at
    once, before its handler may have started: ``stop`` must sever that
    connection too, or ``wait_closed`` waits on it forever.  Twenty rounds,
    each bounded, since the handler's start races the stop."""
    async def parked(comm):
        try:
            await comm.recv()
        except CommClosedError:
            pass

    loops = [asyncio.new_event_loop() for _ in range(2)]
    threads = [threading.Thread(target=lp.run_forever, daemon=True)
               for lp in loops]
    for t in threads:
        t.start()
    server_loop, client_loop = loops
    try:
        for _ in range(20):
            lst = asyncio.run_coroutine_threadsafe(
                listen("tcp://127.0.0.1:0", parked), server_loop
            ).result(WAIT_S)
            comm = SyncComm.connect(lst.address, client_loop)
            asyncio.run_coroutine_threadsafe(lst.stop(), server_loop) \
                .result(WAIT_S)
            comm.close(timeout=WAIT_S)
    finally:
        for lp, t in zip(loops, threads):
            lp.call_soon_threadsafe(lp.stop)
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
            lp.close()


def test_inproc_close_wakes_parked_reader():
    async def go():
        lst = await listen("inproc://tt-close", _echo)
        comm = await connect("inproc://tt-close")

        async def close_soon():
            await asyncio.sleep(0.02)
            await comm.close()

        closer = asyncio.ensure_future(close_soon())
        with pytest.raises(CommClosedError):
            await comm.recv()            # parked with nothing queued
        await closer
        await lst.stop()
    _run(go())


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------

def test_inproc_backpressure_parks_fast_sender_behind_slow_consumer():
    async def go():
        drained = []

        async def slow(comm):
            try:
                while True:
                    drained.append(await comm.recv())
                    await asyncio.sleep(0.005)
            except CommClosedError:
                pass

        lst = await listen("inproc://tt-bp", slow, capacity=4)
        comm = await connect("inproc://tt-bp")
        t0 = time.perf_counter()
        for i in range(12):
            await comm.send({"i": i})
        dt = time.perf_counter() - t0
        # 12 sends into a capacity-4 channel drained at 5 ms/message: the
        # sender must have parked for ~8 drain intervals, not raced ahead
        assert dt > 0.02
        await comm.close()
        await lst.stop()
        assert [m["i"] for m in drained] == list(range(len(drained)))
    _run(go())


# ---------------------------------------------------------------------------
# SyncComm facade
# ---------------------------------------------------------------------------

@pytest.fixture
def loop_thread():
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    try:
        yield loop
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(5)
        assert not t.is_alive()
        loop.close()


def test_sync_comm_recv_timeout_cancels_and_raises(loop_thread):
    async def silent(comm):
        try:
            while True:
                await comm.recv()        # absorb, never reply
        except CommClosedError:
            pass

    lst = asyncio.run_coroutine_threadsafe(
        listen("inproc://tt-sync-timeout", silent), loop_thread).result(10)
    sc = SyncComm.connect("inproc://tt-sync-timeout", loop_thread, timeout=10)
    sc.send({"op": "x"}, timeout=10)
    with pytest.raises(concurrent.futures.TimeoutError):
        sc.recv(timeout=0.1)
    sc.close()                           # timed-out comm still closes cleanly
    asyncio.run_coroutine_threadsafe(lst.stop(), loop_thread).result(10)


@pytest.mark.parametrize("address", ["inproc://tt-sync", "tcp://127.0.0.1:0"])
def test_sync_comm_blocking_roundtrip_from_foreign_thread(loop_thread,
                                                          address):
    lst = asyncio.run_coroutine_threadsafe(
        listen(address, _echo), loop_thread).result(10)
    sc = SyncComm.connect(lst.address, loop_thread, timeout=10)
    for i in range(5):
        sc.send({"i": i, "X": np.full(3, i, np.float32)}, timeout=10)
        r = sc.recv(timeout=10)
        assert r["i"] == i and np.array_equal(r["X"],
                                              np.full(3, i, np.float32))
    sc.close()
    asyncio.run_coroutine_threadsafe(lst.stop(), loop_thread).result(10)
