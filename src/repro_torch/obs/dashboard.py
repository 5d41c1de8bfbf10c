"""Static HTML ops dashboard CLI over an NDJSON frame stream.

``python -m repro_torch.obs.dashboard frames.ndjson -o dashboard.html``
turns the telemetry a :class:`repro_torch.obs.SimObserver` streamed during a
run into one static HTML file: fleet occupancy timeline, per-node failure
heatmap, broker queue-depth / flush-size histograms, drift timeline annotated
with promote/rollback markers, and the job ledger.  Inline SVG only — no JS
libraries, no network — so the artifact ships anywhere a browser opens.

The chart core lives in :mod:`repro_torch.obs.render` and is shared with
the live server (:mod:`repro_torch.obs.live`); this module is just the
post-hoc file-reading entry point.  The HTML is byte-for-byte the JAX
package's from the same frames (titles included); nothing here touches a
device.  Tail-follow safe: a trailing line truncated mid-write by
``NDJSONSink``'s batched flush is skipped, not fatal.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.render import render_html
from repro_torch.obs.sink import read_ndjson

__all__ = ["render_html", "main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dashboard",
        description="Render an NDJSON telemetry stream into a "
                    "self-contained HTML ops dashboard.")
    ap.add_argument("frames", help="frames .ndjson from SimObserver")
    ap.add_argument("--broker", help="flush .ndjson from BrokerObserver")
    ap.add_argument("--events", help="model registry events.jsonl")
    ap.add_argument("-o", "--out", default="dashboard.html")
    ap.add_argument("--title", default="repro ops dashboard")
    args = ap.parse_args(argv)

    frames, n_partial = read_ndjson(args.frames, return_partial=True)
    if n_partial:
        print(f"note: skipped {n_partial} truncated trailing line in "
              f"{args.frames}", file=sys.stderr)
    if not any(f.get("type") == "frame" for f in frames):
        print(f"error: no telemetry frames in {args.frames}",
              file=sys.stderr)
        return 2
    broker = read_ndjson(args.broker) if args.broker else None
    events = read_ndjson(args.events) if args.events else None
    doc = render_html(frames, broker_frames=broker, registry_events=events,
                      title=args.title)
    with open(args.out, "w") as f:
        f.write(doc)
    n = sum(1 for f in frames if f.get("type") == "frame")
    print(json.dumps({"frames": n, "out": args.out,
                      "bytes": len(doc.encode("utf-8"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
