"""repro_torch.obs — live fleet observability.

A numpy-backed columnar metrics core (``metrics``), streaming per-tick frame
sinks (``sink``), instrumentation observers for the simulator / broker /
drift loop (``instrument``), a shared chart core (``render``), a
self-contained HTML ops dashboard (``dashboard``, also
``python -m repro_torch.obs.dashboard``), and the live wire consumer: a
``TelemetryCollector`` folding multi-cell telemetry into rolling aggregates
plus an HTTP ``/snapshot`` / ``/delta`` server with self-refreshing views
(``collector`` / ``live``, also ``python -m repro_torch.obs.live``).

The JAX package's ``repro.obs`` (see docs/OBSERVABILITY.md for the metric
catalog, sink protocol, live-mode topology and the overhead budget that keeps
this layer always-on), ported as its own copy: numpy and the standard library
on the host, the transport and the serving broker from ``repro_torch.online``.
Frames, NDJSON files, roll-ups, collector aggregates and dashboard HTML are
byte-for-byte the JAX package's on the same runs, and carry no device or
wall-clock value, so they are equal on the card and on the CPU.
"""

from repro_torch.obs.collector import TelemetryCollector
from repro_torch.obs.instrument import BrokerObserver, SimObserver
from repro_torch.obs.metrics import MetricsRegistry, percentile_from_hist
from repro_torch.obs.render import render_html
from repro_torch.obs.sink import (MemorySink, NDJSONSink, Sink, TeeSink,
                                  TransportSink, read_ndjson)


def __getattr__(name):
    # lazy: importing repro_torch.obs.live eagerly here makes
    # ``python -m repro_torch.obs.live`` warn about double execution (runpy)
    if name == "LiveServer":
        from repro_torch.obs.live import LiveServer
        return LiveServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BrokerObserver", "SimObserver", "MetricsRegistry",
    "percentile_from_hist", "MemorySink", "NDJSONSink", "Sink", "TeeSink",
    "TransportSink", "read_ndjson", "TelemetryCollector", "LiveServer",
    "render_html",
]
