"""Live telemetry HTTP server: ``/snapshot``, ``/delta``, HTML views.

The serving half of the live wire (the fold half is
:mod:`repro_torch.obs.collector`).  Stdlib ``http.server`` only, no new
deps:

* ``GET /snapshot``          full state (seq + aggregates + health), JSON
* ``GET /delta?since=<seq>`` gapless monotonic increments after ``seq``
* ``GET /``                  HTML source index (links per cell)
* ``GET /view?source=<id>``  self-refreshing dashboard for one source,
                             re-rendered from the collector's in-memory
                             frame window (no file reads) through the same
                             chart core the static CLI uses

``python -m repro_torch.obs.live --listen tcp://0.0.0.0:9500 --http :8787``
stands up a telemetry-only :class:`~repro_torch.online.server.AsyncBroker`
with a collector attached plus this HTTP server — point fleet cells at it
with ``fleet --obs-live tcp://<host>:9500`` and watch the run arrive.  The
broker readies its flush path on ``--device`` (CUDA unless told otherwise,
raising without a GPU; ``--device cpu`` on the CPU), as every serving entry
point of the port does.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.collector import TelemetryCollector
from repro_torch.obs.render import render_broker_html, render_html

__all__ = ["LiveServer", "TelemetryCollector", "main"]


def _index_html(collector: TelemetryCollector, refresh: float) -> str:
    from repro_torch.obs.render import render_page
    snap = collector.snapshot()
    rows = []
    for name in sorted(snap["aggregates"]):
        agg = snap["aggregates"][name]
        h = snap["health"]["sources"].get(name, {})
        sim = agg.get("sim") or {}
        rows.append(
            f'<tr><td><a href="/view?source={name}">{name}</a></td>'
            f'<td>{agg["frames"]}</td>'
            f'<td>{sim.get("occupancy", {}).get("last", "—")}</td>'
            f'<td>{sim.get("failures", "—")}</td>'
            f'<td>{h.get("lag_s", "—")}</td>'
            f'<td>{"done" if agg.get("done") else "live"}</td></tr>')
    body = (
        "<h1>repro live telemetry</h1>"
        f'<div class="sub">{len(rows)} sources · seq {snap["seq"]} · '
        f'{snap["health"]["frames_per_s"]} frames/s · '
        f'<a href="/snapshot">/snapshot</a> · '
        f'<a href="/delta?since=0">/delta</a></div>'
        '<div class="card"><h2>Sources</h2>'
        '<p class="note">one row per producing cell</p>'
        "<table><tr><th>source</th><th>frames</th><th>occ</th>"
        "<th>failures</th><th>lag (s)</th><th>state</th></tr>"
        + "".join(rows) + "</table></div>")
    return render_page("repro live telemetry", body, refresh=refresh)


def _make_handler(collector: TelemetryCollector, refresh: float,
                  handler_timeout: float = 10.0):
    class Handler(BaseHTTPRequestHandler):
        # ThreadingHTTPServer spawns a thread per request; the collector
        # lock is the only shared state these handlers touch.

        # socketserver applies this to the connection in setup(): a client
        # that connects and then stalls (half-open socket, wedged poller)
        # hits socket.timeout instead of parking this handler thread —
        # and its keep-alive connection — forever
        timeout = handler_timeout

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode("utf-8"),
                       "application/json")

        def _html(self, doc: str, code=200):
            self._send(code, doc.encode("utf-8"), "text/html; charset=utf-8")

        def do_GET(self):  # noqa: N802 (http.server API)
            u = urlparse(self.path)
            try:
                if u.path == "/snapshot":
                    self._json(collector.snapshot())
                elif u.path == "/delta":
                    q = parse_qs(u.query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        self._json({"error": "since must be an int"}, 400)
                        return
                    self._json(collector.delta(since))
                elif u.path == "/":
                    self._html(_index_html(collector, refresh))
                elif u.path == "/view":
                    q = parse_qs(u.query)
                    name = q.get("source", [""])[0]
                    frames = collector.frames_for(name)
                    data = [f for f in frames if f.get("type") == "frame"]
                    flushes = [f for f in frames if f.get("type") == "flush"]
                    if data:
                        self._html(render_html(
                            frames, broker_frames=flushes or None,
                            title=f"live · {name}", refresh=refresh))
                    elif flushes:
                        self._html(render_broker_html(
                            flushes, title=f"live · {name}",
                            refresh=refresh))
                    else:
                        self._json({"error": f"unknown source {name!r}",
                                    "sources": collector.source_names()},
                                   404)
                else:
                    self._json({"error": "not found",
                                "endpoints": ["/", "/snapshot",
                                              "/delta?since=N",
                                              "/view?source=NAME"]}, 404)
            except (BrokenPipeError, TimeoutError):
                # client went away mid-write, or stalled past the socket
                # timeout mid-response: drop the connection
                self.close_connection = True

        def log_message(self, *a):     # quiet by default
            pass

    return Handler


class LiveServer:
    """Threaded HTTP front-end over a :class:`TelemetryCollector`.

    ``port=0`` binds an ephemeral port; the resolved base URL is in
    ``.address`` after construction.  ``start()``/``stop()`` manage the
    ``serve_forever`` thread; usable as a context manager."""

    def __init__(self, collector: TelemetryCollector, *,
                 host: str = "127.0.0.1", port: int = 0,
                 refresh: float = 2.0, handler_timeout: float = 10.0):
        self.collector = collector
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(collector, refresh,
                                        handler_timeout))
        self.address = f"http://{host}:{self.httpd.server_address[1]}"
        self._thread: threading.Thread | None = None

    def start(self) -> "LiveServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="obs-live-http")
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self.httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False


def main(argv=None) -> int:
    from repro_torch.online.server import AsyncBroker

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.live",
        description="Stand up a live telemetry collector: a telemetry-only "
                    "AsyncBroker on --listen plus an HTTP dashboard on "
                    "--http.")
    ap.add_argument("--listen", default="tcp://127.0.0.1:0",
                    help="transport address cells stream frames to "
                         "(default tcp://127.0.0.1:0)")
    ap.add_argument("--http", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="HTTP bind for /snapshot, /delta and the views")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="HTML view auto-refresh seconds (default 2)")
    ap.add_argument("--device", default=None,
                    help="where the broker's flush path is readied (default: "
                         "cuda, which needs a GPU; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    host, _, port = args.http.rpartition(":")
    collector = TelemetryCollector()
    broker = AsyncBroker(device=args.device).start()
    broker.collector = collector
    addr = broker.serve(args.listen)
    http = LiveServer(collector, host=host or "127.0.0.1",
                      port=int(port or 0), refresh=args.refresh).start()
    print(json.dumps({"listen": addr, "http": http.address}), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()
        broker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
