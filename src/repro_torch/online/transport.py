"""Connector/listener comm abstraction — the broker's wire layer.

The serving stack needs one request/reply surface that works both for
same-process fleet cells (zero copy, no serialization) and for independent
clients across a socket.  This module is that surface, in the style of
dask.distributed's comm core: an address string picks a backend,

    inproc://<name>     same-process channel: deque + asyncio.Event per
                        direction, payload objects pass through BY REFERENCE
                        (a numpy feature block is never copied, a model
                        object rides along untouched)
    tcp://host:port     asyncio streams; each message is one length-prefixed
                        frame, msgpack-encoded when msgpack is importable and
                        JSON otherwise (numpy arrays round-trip losslessly in
                        both — raw bytes under msgpack, base64 under JSON)

and every backend hands back the same five-method ``Comm``:

    comm = await connect("tcp://127.0.0.1:9815")
    await comm.send({"op": "predict", "kind": "map", "X": rows})
    reply = await comm.recv()
    await comm.close()

    listener = await listen("inproc://broker", handler)   # handler(comm)
    await listener.stop()

Failure semantics are explicit and tested: ``recv()`` on a peer-closed comm
raises ``CommClosedError`` (a clean EOF between frames) and a connection cut
mid-frame raises the same (the length prefix promised bytes that never came);
a frame above ``max_frame`` raises ``FrameTooLargeError`` on the *sender* for
outgoing frames and on the receiver for incoming headers, so a corrupt or
hostile prefix can never make the reader allocate unbounded memory.
Backpressure is built in: an inproc channel holds at most ``capacity``
messages and ``send`` awaits a slow consumer; TCP relies on the kernel socket
buffer via ``writer.drain()``.

A dead TCP comm closes its socket at once (a peer's EOF, a cut frame, an
undecodable payload), and stopping a TCP listener severs the connections
it accepted: from Python 3.12 on, ``Server.wait_closed`` waits for every
accepted connection, so a half-open one would hold ``stop`` forever.

Frames carry numpy arrays and Python scalars only: a ``torch.Tensor``
is refused by both encoders (``TypeError``), so a caller copies scores to
the host before it replies.  msgpack is optional; without it ``tcp://``
sends the JSON frame.

Everything here is event-loop-local.  Synchronous callers (a fleet cell
thread blocking on its own prediction) wrap a comm in ``SyncComm``, which
schedules the coroutines onto the loop's thread and blocks on the result.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import concurrent.futures
import json
import struct

import numpy as np

try:                                    # optional: the binary frame encoding
    import msgpack
except ImportError:                     # pragma: no cover - baked into CI image
    msgpack = None


class CommClosedError(IOError):
    """The peer closed (or the connection died) before/while a message moved."""


class FrameTooLargeError(ValueError):
    """A frame exceeded ``max_frame`` (outgoing payload or incoming header)."""


DEFAULT_MAX_FRAME = 64 * 1024 * 1024    # 64 MiB: far above any sane flush

# wire header: 1 format byte (J/M) + 4-byte big-endian payload length
_HEADER = struct.Struct("!cI")
_FMT_JSON = b"J"
_FMT_MSGPACK = b"M"
_ND_EXT = 0x4E                          # msgpack ExtType code for ndarrays


# ---------------------------------------------------------------------------
# Serialization: python structures + numpy arrays <-> one frame payload
# ---------------------------------------------------------------------------

def _nd_pack(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    head = json.dumps([a.dtype.str, list(a.shape)]).encode()
    return struct.pack("!I", len(head)) + head + a.tobytes()


def _nd_unpack(b: bytes) -> np.ndarray:
    (hlen,) = struct.unpack_from("!I", b, 0)
    dtype, shape = json.loads(b[4:4 + hlen].decode())
    return np.frombuffer(b[4 + hlen:], dtype=np.dtype(dtype)).reshape(shape)


def _msgpack_default(o):
    if isinstance(o, np.ndarray):
        return msgpack.ExtType(_ND_EXT, _nd_pack(o))
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(f"unserializable message field: {type(o).__name__}")


def _msgpack_ext_hook(code, data):
    if code == _ND_EXT:
        return _nd_unpack(data)
    return msgpack.ExtType(code, data)      # pragma: no cover


class _JSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            return {"__nd__": [a.dtype.str, list(a.shape),
                               base64.b64encode(a.tobytes()).decode()]}
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return super().default(o)


def _json_object_hook(d):
    nd = d.get("__nd__")
    if nd is not None and len(d) == 1:
        dtype, shape, data = nd
        return np.frombuffer(base64.b64decode(data),
                             dtype=np.dtype(dtype)).reshape(shape)
    return d


def dumps(msg, serializer: str = "auto") -> tuple[bytes, bytes]:
    """Encode one message -> (format byte, payload bytes)."""
    if serializer == "auto":
        serializer = "msgpack" if msgpack is not None else "json"
    if serializer == "msgpack":
        if msgpack is None:
            raise RuntimeError("msgpack serializer requested but unavailable")
        return _FMT_MSGPACK, msgpack.packb(msg, default=_msgpack_default,
                                           use_bin_type=True)
    if serializer == "json":
        return _FMT_JSON, json.dumps(msg, cls=_JSONEncoder,
                                     separators=(",", ":")).encode()
    raise ValueError(f"unknown serializer {serializer!r}")


def loads(fmt: bytes, payload: bytes):
    """Decode one (format byte, payload) frame back into a message."""
    if fmt == _FMT_MSGPACK:
        if msgpack is None:
            raise RuntimeError("received a msgpack frame but msgpack is "
                               "unavailable")
        return msgpack.unpackb(payload, ext_hook=_msgpack_ext_hook, raw=False,
                               strict_map_key=False)
    if fmt == _FMT_JSON:
        return json.loads(payload.decode(), object_hook=_json_object_hook)
    raise CommClosedError(f"unknown frame format byte {fmt!r}")


# ---------------------------------------------------------------------------
# Comm protocol
# ---------------------------------------------------------------------------

class Comm:
    """One established bidirectional message channel."""

    local_addr: str = "?"
    peer_addr: str = "?"

    async def send(self, msg) -> None:
        raise NotImplementedError

    async def recv(self):
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError

    def __repr__(self):
        state = "closed" if self.closed else "open"
        return (f"<{type(self).__name__} {self.local_addr} -> "
                f"{self.peer_addr} [{state}]>")


class Listener:
    """A bound endpoint invoking ``handler(comm)`` per accepted connection."""

    address: str = "?"

    async def stop(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# inproc backend: deque + event per direction, zero-copy payloads
# ---------------------------------------------------------------------------

class _Channel:
    """One direction of an inproc comm: a bounded deque of message objects.

    ``asyncio.Event`` pairs signal data-available / space-available; a full
    channel parks the sender until the consumer drains (bounded-queue
    backpressure with zero copies — the object itself is the payload)."""

    def __init__(self, capacity: int):
        self.q: collections.deque = collections.deque()
        self.capacity = capacity
        self.readable = asyncio.Event()
        self.writable = asyncio.Event()
        self.writable.set()
        self.closed = False

    async def put(self, msg):
        while len(self.q) >= self.capacity and not self.closed:
            self.writable.clear()
            await self.writable.wait()
        if self.closed:
            raise CommClosedError("inproc peer closed")
        self.q.append(msg)
        self.readable.set()

    async def get(self):
        while not self.q:
            if self.closed:
                raise CommClosedError("inproc peer closed")
            self.readable.clear()
            await self.readable.wait()
        msg = self.q.popleft()
        if len(self.q) < self.capacity:
            self.writable.set()
        return msg

    def close(self):
        self.closed = True
        self.readable.set()            # wake any parked reader/writer
        self.writable.set()


class InProcComm(Comm):
    def __init__(self, rx: _Channel, tx: _Channel, local: str, peer: str):
        self._rx, self._tx = rx, tx
        self.local_addr, self.peer_addr = local, peer
        self._closed = False

    async def send(self, msg):
        if self._closed:
            raise CommClosedError("comm already closed")
        await self._tx.put(msg)

    async def recv(self):
        if self._closed:
            raise CommClosedError("comm already closed")
        return await self._rx.get()

    async def close(self):
        self._closed = True
        self._rx.close()
        self._tx.close()

    @property
    def closed(self) -> bool:
        return self._closed


class _InProcListener(Listener):
    def __init__(self, name: str, handler, capacity: int):
        self.address = f"inproc://{name}"
        self._name = name
        self._handler = handler
        self._capacity = capacity
        self._tasks: set = set()

    def _connect(self) -> InProcComm:
        a, b = _Channel(self._capacity), _Channel(self._capacity)
        server_side = InProcComm(a, b, self.address, "inproc://client")
        client_side = InProcComm(b, a, "inproc://client", self.address)
        t = asyncio.ensure_future(self._handler(server_side))
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return client_side

    async def stop(self):
        _INPROC.pop(self._name, None)
        for t in list(self._tasks):
            t.cancel()
        # let cancellations unwind so handler tasks never leak across tests
        await asyncio.gather(*self._tasks, return_exceptions=True)


_INPROC: dict[str, _InProcListener] = {}


# ---------------------------------------------------------------------------
# tcp backend: asyncio streams, length-prefixed frames
# ---------------------------------------------------------------------------

class TCPComm(Comm):
    def __init__(self, reader, writer, *, serializer: str = "auto",
                 max_frame: int = DEFAULT_MAX_FRAME):
        self._reader, self._writer = reader, writer
        self.serializer = serializer
        self.max_frame = max_frame
        self._closed = False
        peer = writer.get_extra_info("peername") or ("?", "?")
        sock = writer.get_extra_info("sockname") or ("?", "?")
        self.peer_addr = f"tcp://{peer[0]}:{peer[1]}"
        self.local_addr = f"tcp://{sock[0]}:{sock[1]}"

    def _abort(self):
        """The stream can no longer be trusted: mark the comm dead and close
        its socket (``writer.close`` is idempotent and does not wait)."""
        self._closed = True
        self._writer.close()

    async def send(self, msg):
        if self._closed:
            raise CommClosedError("comm already closed")
        fmt, payload = dumps(msg, self.serializer)
        if len(payload) > self.max_frame:
            raise FrameTooLargeError(
                f"frame of {len(payload)} bytes exceeds max_frame="
                f"{self.max_frame}")
        try:
            self._writer.write(_HEADER.pack(fmt, len(payload)))
            self._writer.write(payload)
            await self._writer.drain()       # kernel-buffer backpressure
        except (OSError, RuntimeError) as e:
            # OSError covers ConnectionError plus the rest of the socket
            # failure surface (ETIMEDOUT, EPIPE via os-level writes, ...)
            self._abort()
            raise CommClosedError(str(e)) from e

    async def recv(self):
        if self._closed:
            raise CommClosedError("comm already closed")
        try:
            head = await self._reader.readexactly(_HEADER.size)
        except (asyncio.IncompleteReadError, OSError) as e:
            self._abort()
            if isinstance(e, asyncio.IncompleteReadError) and not e.partial:
                raise CommClosedError("peer closed") from e
            raise CommClosedError("connection lost mid-header") from e
        fmt, length = _HEADER.unpack(head)
        if length > self.max_frame:
            self._abort()
            raise FrameTooLargeError(
                f"incoming frame header claims {length} bytes "
                f"(max_frame={self.max_frame})")
        try:
            payload = await self._reader.readexactly(length)
        except (asyncio.IncompleteReadError, OSError) as e:
            self._abort()
            raise CommClosedError("connection lost mid-frame") from e
        try:
            return loads(fmt, payload)
        except CommClosedError:
            self._abort()
            raise
        except Exception as e:
            # an abrupt peer death can hand us a length-complete but garbage
            # payload (e.g. RST after a partial kernel buffer flush); decode
            # failures from any codec (struct/json/base64/msgpack) are a dead
            # connection to the caller, never a bare parser exception
            self._abort()
            raise CommClosedError(f"undecodable frame: {e!r}") from e

    async def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except (OSError, RuntimeError):   # peer already gone
            pass

    @property
    def closed(self) -> bool:
        return self._closed


class _TCPListener(Listener):
    def __init__(self, server, address: str, comms: set, stopping: list):
        self._server = server
        self.address = address
        self._comms = comms              # accepted comms whose handler runs
        self._stopping = stopping        # [bool], read by the accept path

    async def stop(self):
        # a connection accepted but not yet handed to its handler is not in
        # _comms: the flag makes the accept path sever it instead, or
        # wait_closed would wait for its handler forever
        self._stopping[0] = True
        self._server.close()
        for comm in list(self._comms):   # wait_closed waits for them
            comm._abort()
        await self._server.wait_closed()


# ---------------------------------------------------------------------------
# Address routing
# ---------------------------------------------------------------------------

def parse_address(address: str) -> tuple[str, str]:
    scheme, sep, rest = address.partition("://")
    if not sep or scheme not in ("inproc", "tcp"):
        raise ValueError(f"bad address {address!r} "
                         "(want inproc://<name> or tcp://host:port)")
    return scheme, rest


async def connect(address: str, *, serializer: str = "auto",
                  max_frame: int = DEFAULT_MAX_FRAME,
                  capacity: int = 1024) -> Comm:
    """Open a client comm to a listening address."""
    scheme, rest = parse_address(address)
    if scheme == "inproc":
        listener = _INPROC.get(rest)
        if listener is None:
            raise CommClosedError(f"no inproc listener at {address!r}")
        return listener._connect()
    host, _, port = rest.rpartition(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    return TCPComm(reader, writer, serializer=serializer, max_frame=max_frame)


async def listen(address: str, handler, *, serializer: str = "auto",
                 max_frame: int = DEFAULT_MAX_FRAME,
                 capacity: int = 1024) -> Listener:
    """Bind ``address`` and invoke ``await handler(comm)`` per connection.

    ``tcp://host:0`` binds an ephemeral port; read the bound address back
    from ``listener.address``."""
    scheme, rest = parse_address(address)
    if scheme == "inproc":
        if rest in _INPROC:
            raise ValueError(f"inproc listener {address!r} already bound")
        lst = _InProcListener(rest, handler, capacity)
        _INPROC[rest] = lst
        return lst

    comms: set = set()
    stopping = [False]

    async def on_connect(reader, writer):
        comm = TCPComm(reader, writer, serializer=serializer,
                       max_frame=max_frame)
        if stopping[0]:
            comm._abort()
            return
        comms.add(comm)
        try:
            await handler(comm)
        finally:
            # the handler is the comm's only user: once it returns, the
            # connection is over, whether or not the handler closed it
            comms.discard(comm)
            comm._abort()

    host, _, port = rest.rpartition(":")
    server = await asyncio.start_server(on_connect, host, int(port))
    bound = server.sockets[0].getsockname()
    return _TCPListener(server, f"tcp://{bound[0]}:{bound[1]}", comms,
                        stopping)


# ---------------------------------------------------------------------------
# Sync facade: blocking send/recv for client threads outside the loop
# ---------------------------------------------------------------------------

class SyncComm:
    """Blocking wrapper around a Comm living on another thread's event loop.

    This is how a fleet-cell thread (synchronous simulator code) talks to the
    AsyncBroker: every call schedules the coroutine onto the loop thread and
    blocks on its result, so the calling thread sees ordinary synchronous
    request/reply semantics."""

    def __init__(self, comm: Comm, loop: asyncio.AbstractEventLoop):
        self.comm = comm
        self.loop = loop

    @classmethod
    def connect(cls, address: str, loop: asyncio.AbstractEventLoop,
                timeout: float | None = 30.0, **kw) -> "SyncComm":
        fut = asyncio.run_coroutine_threadsafe(connect(address, **kw), loop)
        return cls(fut.result(timeout), loop)

    def _run(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            # .result(timeout) does NOT cancel the scheduled coroutine; an
            # orphaned recv would later consume a reply meant for the next
            # request and desync the stream.  Cancel, and let the caller
            # treat the comm as dead (retry layers reconnect).
            fut.cancel()
            raise

    def send(self, msg, timeout: float | None = None):
        return self._run(self.comm.send(msg), timeout)

    def recv(self, timeout: float | None = None):
        return self._run(self.comm.recv(), timeout)

    def close(self, timeout: float | None = 10.0):
        if not self.comm.closed and self.loop.is_running():
            self._run(self.comm.close(), timeout)
