"""Chart core shared by the static dashboard and the live view.

Everything that turns a frame stream into inline-SVG HTML lives here:
``repro_torch.obs.dashboard`` (the static CLI) and ``repro_torch.obs.live``
(the incremental HTTP view) both call :func:`render_html` — one render path,
two consumers, so a chart added here shows up in both.  The live server passes
``refresh=`` to get a self-refreshing document re-rendered from the
collector's in-memory frame window (incremental re-render: no file reads).

Color/spec discipline follows the repo's viz rules: categorical slots in
fixed order, a single-hue sequential ramp for the heatmap, text in ink
tokens (never series colors), hairline gridlines, light/dark via CSS custom
properties, and a table twin under every chart.
"""

from __future__ import annotations

import html

# reference palette (validated): categorical slots, sequential blue ramp,
# status steps, chrome ink.  Light / dark pairs swap via CSS custom props.
_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--text-1);
}
.viz-root {
  --page: #f9f9f7; --surface-1: #fcfcfb;
  --text-1: #0b0b0b; --text-2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7;
  --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --status-good: #0ca30c; --status-critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    --page: #0d0d0d; --surface-1: #1a1a19;
    --text-1: #ffffff; --text-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835;
    --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --status-good: #0ca30c; --status-critical: #d03b3b;
  }
}
h1 { font-size: 20px; margin: 0 0 4px; }
.sub { color: var(--text-2); font-size: 13px; margin-bottom: 20px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 20px; }
.tile {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; min-width: 120px;
}
.tile .v { font-size: 28px; font-weight: 600; }
.tile .k { font-size: 12px; color: var(--text-2); margin-top: 2px; }
.card {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 16px; margin-bottom: 20px;
}
.card h2 { font-size: 14px; margin: 0 0 2px; }
.card .note { font-size: 12px; color: var(--text-2); margin: 0 0 10px; }
.legend { font-size: 12px; color: var(--text-2); margin: 6px 0 0;
          display: flex; gap: 16px; flex-wrap: wrap; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 2px; margin-right: 5px;
              vertical-align: baseline; }
svg { display: block; max-width: 100%; }
svg text { font-family: inherit; font-size: 11px; fill: var(--muted); }
details { margin-top: 10px; font-size: 12px; }
details summary { color: var(--text-2); cursor: pointer; }
table { border-collapse: collapse; margin-top: 8px; font-size: 12px; }
th, td { text-align: right; padding: 3px 10px;
         border-bottom: 1px solid var(--grid);
         font-variant-numeric: tabular-nums; }
th { color: var(--text-2); font-weight: 600; }
td:first-child, th:first-child { text-align: left; }
a { color: var(--series-1); }
"""

# sequential blue ramp, light -> dark = low -> high (steps 100..700)
_SEQ = ("#cde2fb", "#9ec5f4", "#6da7ec", "#3987e5",
        "#256abf", "#1c5cab", "#104281", "#0d366b")


def _fmt(v, nd=2) -> str:
    """Compact number label: trims trailing zeros, SI-suffixes thousands."""
    if v is None:
        return "—"
    a = abs(v)
    if a >= 1e6:
        return f"{v / 1e6:.1f}M".replace(".0M", "M")
    if a >= 1e4:
        return f"{v / 1e3:.1f}k".replace(".0k", "k")
    s = f"{v:.{nd}f}".rstrip("0").rstrip(".")
    return s if s not in ("", "-") else "0"


def _ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """~n 'nice' tick positions covering [lo, hi]."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** len(str(int(raw))) / 10 if raw >= 1 else 1.0
    while mag > raw:
        mag /= 10
    step = next(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    t, out = (int(lo / step)) * step, []
    while t <= hi + 1e-9:
        if t >= lo - 1e-9:
            out.append(round(t, 10))
        t += step
    return out or [lo]


class _Plot:
    """Shared frame: margins, linear scales, gridlines, axis labels."""

    def __init__(self, w=680, h=220, ml=48, mr=12, mt=10, mb=26):
        self.w, self.h = w, h
        self.ml, self.mr, self.mt, self.mb = ml, mr, mt, mb
        self.pw, self.ph = w - ml - mr, h - mt - mb
        self.parts: list[str] = []

    def scales(self, x0, x1, y0, y1):
        x0, x1 = (x0, x1 + 1) if x1 <= x0 else (x0, x1)
        y0, y1 = (y0, y1 + 1) if y1 <= y0 else (y0, y1)
        self.sx = lambda v: self.ml + (v - x0) / (x1 - x0) * self.pw
        self.sy = lambda v: self.mt + (1 - (v - y0) / (y1 - y0)) * self.ph
        self.xlim, self.ylim = (x0, x1), (y0, y1)

    def grid(self, x_unit="", y_fmt=_fmt):
        for ty in _ticks(*self.ylim, 4):
            y = self.sy(ty)
            self.parts.append(
                f'<line x1="{self.ml}" y1="{y:.1f}" x2="{self.ml + self.pw}"'
                f' y2="{y:.1f}" stroke="var(--grid)" stroke-width="1"/>'
                f'<text x="{self.ml - 6}" y="{y + 3.5:.1f}"'
                f' text-anchor="end">{y_fmt(ty)}</text>')
        for tx in _ticks(*self.xlim, 6):
            x = self.sx(tx)
            self.parts.append(
                f'<text x="{x:.1f}" y="{self.h - 8}" text-anchor="middle">'
                f'{_fmt(tx)}{x_unit}</text>')
        base = self.mt + self.ph
        self.parts.append(
            f'<line x1="{self.ml}" y1="{base}" x2="{self.ml + self.pw}"'
            f' y2="{base}" stroke="var(--axis)" stroke-width="1"/>')

    def line(self, xs, ys, color, *, width=2, title=None):
        pts = " ".join(f"{self.sx(x):.1f},{self.sy(y):.1f}"
                       for x, y in zip(xs, ys))
        t = f"<title>{html.escape(title)}</title>" if title else ""
        self.parts.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}"'
            f' stroke-width="{width}" stroke-linejoin="round"'
            f' stroke-linecap="round">{t}</polyline>')

    def vmarker(self, x, color, label):
        px = self.sx(x)
        self.parts.append(
            f'<line x1="{px:.1f}" y1="{self.mt}" x2="{px:.1f}"'
            f' y2="{self.mt + self.ph}" stroke="{color}" stroke-width="1.5"'
            f' stroke-dasharray="3 3"><title>{html.escape(label)}</title>'
            f'</line>')

    def svg(self) -> str:
        return (f'<svg viewBox="0 0 {self.w} {self.h}" role="img">'
                + "".join(self.parts) + "</svg>")


def _legend(items) -> str:
    rows = "".join(
        f'<span><span class="sw" style="background:{c}"></span>'
        f'{html.escape(n)}</span>' for n, c in items)
    return f'<div class="legend">{rows}</div>'


def _table(headers, rows, cap=None) -> str:
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r)
        + "</tr>" for r in rows)
    note = (f'<div class="note">showing first {cap} rows</div>'
            if cap else "")
    return (f'<details><summary>table view</summary>{note}'
            f"<table><tr>{head}</tr>{body}</table></details>")


def _card(title, note, body) -> str:
    return (f'<div class="card"><h2>{html.escape(title)}</h2>'
            f'<p class="note">{html.escape(note)}</p>{body}</div>')


def render_page(title: str, body: str, *, refresh: float | None = None) -> str:
    """The document shell: CSS, light/dark tokens, optional auto-refresh.

    ``refresh`` (seconds) adds a ``<meta http-equiv="refresh">`` — the live
    server's self-refreshing view; the static dashboard omits it."""
    meta = (f'<meta http-equiv="refresh" content="{refresh:g}">'
            if refresh else "")
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"{meta}<title>{html.escape(title)}</title>"
            f"<style>{_CSS}</style></head>"
            '<body><div class="viz-root">' + body
            + "</div></body></html>")


# --------------------------------------------------------------- charts
def _occupancy_chart(frames) -> str:
    ts = [f["t"] for f in frames]
    occ = [f["occ"] for f in frames]
    p = _Plot()
    p.scales(min(ts), max(ts), 0.0, max(1.0, max(occ)))
    p.grid(x_unit="s")
    p.line(ts, occ, "var(--series-1)", title="fleet occupancy")
    rows = [(_fmt(t), _fmt(o, 4), f["running"], f["pending"],
             f["running_jobs"]) for t, o, f in zip(ts, occ, frames)][:200]
    table = _table(["t (s)", "occupancy", "running", "pending", "jobs"],
                   rows, cap=200 if len(frames) > 200 else None)
    return _card("Fleet occupancy", "fraction of task slots busy, per frame",
                 p.svg() + table)


def _queue_chart(frames) -> str:
    ts = [f["t"] for f in frames]
    pend = [f["pending"] for f in frames]
    pen = [f["penalty_box"] for f in frames]
    p = _Plot()
    p.scales(min(ts), max(ts), 0.0, max(max(pend), max(pen), 1))
    p.grid(x_unit="s")
    p.line(ts, pend, "var(--series-1)", title="pending tasks")
    p.line(ts, pen, "var(--series-2)", title="penalty box")
    legend = _legend([("pending tasks", "var(--series-1)"),
                      ("penalty box", "var(--series-2)")])
    rows = [(_fmt(t), a, b) for t, a, b in zip(ts, pend, pen)][:200]
    table = _table(["t (s)", "pending", "penalty box"], rows,
                   cap=200 if len(frames) > 200 else None)
    return _card("Scheduler queues", "pending task backlog and penalty-box "
                 "size over time", p.svg() + legend + table)


def _ramp(v: float, vmax: float) -> str:
    if v <= 0:
        return "var(--surface-1)"
    i = min(int(v / vmax * len(_SEQ)), len(_SEQ) - 1)
    return _SEQ[i]


def _heatmap(frames, meta) -> str:
    """Per-node failure heatmap: frame bins x nodes, darker = more fails."""
    n_nodes = len(frames[0]["node_fail"])
    max_cols, max_rows = 120, 48
    col_bin = max(1, -(-len(frames) // max_cols))
    row_bin = max(1, -(-n_nodes // max_rows))
    cols = -(-len(frames) // col_bin)
    rows = -(-n_nodes // row_bin)
    grid = [[0.0] * cols for _ in range(rows)]
    for fi, f in enumerate(frames):
        c = fi // col_bin
        for ni, v in enumerate(f["node_fail"]):
            grid[ni // row_bin][c] += v
    vmax = max(max(r) for r in grid) or 1.0
    cw, ch = 680 // max(cols, 1), max(4, min(12, 480 // rows))
    ml, mt = 48, 8
    w, h = ml + cols * cw + 12, mt + rows * ch + 26
    cells = []
    for r in range(rows):
        for c in range(cols):
            v = grid[r][c]
            t0 = frames[min(c * col_bin, len(frames) - 1)]["t"]
            hi_node = min((r + 1) * row_bin, n_nodes) - 1
            node = (f"node {r * row_bin}" if row_bin == 1 else
                    f"nodes {r * row_bin}-{hi_node}")
            cells.append(
                f'<rect x="{ml + c * cw}" y="{mt + r * ch}" width="{cw}"'
                f' height="{ch}" fill="{_ramp(v, vmax)}"'
                f' stroke="var(--surface-1)" stroke-width="1">'
                f'<title>{node}, t={_fmt(t0)}s: {_fmt(v, 0)} failures'
                f'</title></rect>')
    for r in range(0, rows, max(1, rows // 8)):
        lbl = (f"n{r * row_bin}" if row_bin == 1 else f"n{r * row_bin}+")
        cells.append(f'<text x="{ml - 6}" y="{mt + r * ch + ch / 2 + 3:.0f}"'
                     f' text-anchor="end">{lbl}</text>')
    for c in range(0, cols, max(1, cols // 6)):
        t0 = frames[min(c * col_bin, len(frames) - 1)]["t"]
        cells.append(f'<text x="{ml + c * cw}" y="{h - 8}"'
                     f' text-anchor="middle">{_fmt(t0)}s</text>')
    sw = "".join(f'<span class="sw" style="background:{c}"></span>'
                 for c in _SEQ)
    legend = (f'<div class="legend"><span>0</span><span>{sw}</span>'
              f'<span>{_fmt(vmax, 0)} failures / cell</span></div>')
    totals = [0.0] * rows
    for r in range(rows):
        totals[r] = sum(grid[r])
    top = sorted(range(rows), key=lambda r: -totals[r])[:20]
    table = _table(["node (row)", "failures"],
                   [(f"n{r * row_bin}" + ("" if row_bin == 1 else "+"),
                     _fmt(totals[r], 0)) for r in top if totals[r] > 0]
                   or [("—", 0)])
    note = "failures per node per frame bin"
    if col_bin > 1 or row_bin > 1:
        note += f" (binned {col_bin} frames × {row_bin} nodes)"
    body = (f'<svg viewBox="0 0 {w} {h}" role="img">'
            + "".join(cells) + "</svg>" + legend + table)
    return _card("Per-node failures", note, body)


def _drift_chart(frames, markers) -> str:
    pts = {"map": [], "reduce": []}
    for f in frames:
        for kind, sig in f.get("drift", {}).items():
            if sig and sig.get("psi") is not None:
                pts[kind].append((f["t"], sig["psi"]))
    series = [(k, v) for k, v in pts.items() if v]
    if not series and not markers:
        return ""
    ts = [t for _, v in series for t, _ in v] or [f["t"] for f in frames]
    ys = [y for _, v in series for _, y in v] or [0.0]
    p = _Plot()
    p.scales(min(ts), max(max(ts), min(ts) + 1), 0.0, max(max(ys), 0.1))
    p.grid(x_unit="s", y_fmt=lambda v: _fmt(v, 3))
    colors = {"map": "var(--series-1)", "reduce": "var(--series-2)"}
    for kind, v in series:
        p.line([t for t, _ in v], [y for _, y in v], colors[kind],
               title=f"{kind} PSI")
    for t, ev, label in markers:
        color = ("var(--status-good)" if ev == "promote"
                 else "var(--status-critical)" if ev == "rollback"
                 else "var(--muted)")
        p.vmarker(t, color, label)
    legend = _legend(
        [(f"{k} PSI", colors[k]) for k, _ in series]
        + [("▲ promote", "var(--status-good)"),
           ("▼ rollback", "var(--status-critical)")])
    rows = ([(_fmt(t), ev, label) for t, ev, label in markers]
            or [("—", "—", "no lifecycle events")])
    table = _table(["t (s)", "event", "detail"], rows)
    return _card("Model drift & lifecycle",
                 "population-stability index per task kind; dashed markers "
                 "are registry promote/rollback events", p.svg() + legend
                 + table)


def _flush_hist_chart(edges, counts, title, note, unit="") -> str:
    p = _Plot(h=200, mb=30)
    n = len(counts)
    p.scales(0, n, 0, max(max(counts), 1))
    for ty in _ticks(0, max(max(counts), 1), 4):
        y = p.sy(ty)
        p.parts.append(
            f'<line x1="{p.ml}" y1="{y:.1f}" x2="{p.ml + p.pw}" y2="{y:.1f}"'
            f' stroke="var(--grid)" stroke-width="1"/>'
            f'<text x="{p.ml - 6}" y="{y + 3.5:.1f}" text-anchor="end">'
            f'{_fmt(ty)}</text>')
    bw = p.pw / max(n, 1)
    base = p.mt + p.ph
    labels = [f"≤{_fmt(e)}" for e in edges] + [f">{_fmt(edges[-1])}"]
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        x, y = p.ml + i * bw + 1, p.sy(c)
        hh = max(base - y, 1)
        p.parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{bw - 2:.1f}"'
            f' height="{hh:.1f}" rx="2" fill="var(--series-1)">'
            f'<title>{labels[i]}{unit}: {_fmt(c, 0)} flushes</title></rect>')
    step = max(1, n // 8)
    for i in range(0, n, step):
        p.parts.append(
            f'<text x="{p.ml + (i + .5) * bw:.1f}" y="{p.h - 8}"'
            f' text-anchor="middle">{labels[i]}</text>')
    p.parts.append(
        f'<line x1="{p.ml}" y1="{base}" x2="{p.ml + p.pw}" y2="{base}"'
        f' stroke="var(--axis)" stroke-width="1"/>')
    table = _table(["bucket", "count"],
                   [(labels[i] + unit, int(c))
                    for i, c in enumerate(counts) if c > 0] or [("—", 0)])
    return _card(title, note, p.svg() + table)


def _broker_cards(broker_frames) -> str:
    flushes = [f for f in broker_frames if f.get("type") == "flush"]
    if not flushes:
        return ""
    out = []
    xs = list(range(len(flushes)))
    depth = [f["requests"] for f in flushes]
    p = _Plot(h=200)
    p.scales(0, max(xs[-1], 1), 0, max(max(depth), 1))
    p.grid()
    p.line(xs, depth, "var(--series-1)", title="queue depth at flush")
    rows = [(i, f["requests"], f["rows"], f["dispatches"],
             f.get("latency_ms", "—")) for i, f in enumerate(flushes)][:200]
    table = _table(["flush #", "requests", "rows", "dispatches", "ms"],
                   rows, cap=200 if len(flushes) > 200 else None)
    out.append(_card("Broker queue depth",
                     "requests coalesced per flush, in flush order",
                     p.svg() + table))
    # rows-per-flush histogram, rebuilt from the flush stream
    from repro_torch.obs.instrument import FLUSH_ROW_EDGES
    counts = [0] * (len(FLUSH_ROW_EDGES) + 1)
    for f in flushes:
        r, b = f["rows"], 0
        while b < len(FLUSH_ROW_EDGES) and r > FLUSH_ROW_EDGES[b]:
            b += 1
        counts[b] += 1
    out.append(_flush_hist_chart(
        list(FLUSH_ROW_EDGES), counts, "Broker flush size",
        "rows scored per flush (batching efficiency)", unit=" rows"))
    return "".join(out)


def _jobs_chart(final) -> str:
    jobs = (final or {}).get("jobs") or []
    done = [j for j in jobs if j.get("end") is not None]
    if not done:
        return ""
    done.sort(key=lambda j: (j["submit"], str(j.get("job", ""))))
    show = done[:60]
    t0 = min(j["submit"] for j in show)
    t1 = max(j["end"] for j in show)
    p = _Plot(h=max(120, 14 * len(show) + 40), ml=60)
    p.ph = p.h - p.mt - p.mb
    p.scales(t0, t1, 0, 1)
    for tx in _ticks(t0, t1, 6):
        x = p.sx(tx)
        p.parts.append(
            f'<line x1="{x:.1f}" y1="{p.mt}" x2="{x:.1f}"'
            f' y2="{p.mt + p.ph}" stroke="var(--grid)" stroke-width="1"/>'
            f'<text x="{x:.1f}" y="{p.h - 8}" text-anchor="middle">'
            f'{_fmt(tx)}s</text>')
    bh = min(10, max(4, (p.ph - 8) // max(len(show), 1) - 2))
    for i, j in enumerate(show):
        y = p.mt + 4 + i * (p.ph - 8) / max(len(show), 1)
        x0, x1 = p.sx(j["submit"]), p.sx(j["end"])
        dur = j["end"] - j["submit"]
        p.parts.append(
            f'<rect x="{x0:.1f}" y="{y:.1f}" width="{max(x1 - x0, 2):.1f}"'
            f' height="{bh}" rx="2" fill="var(--series-1)">'
            f'<title>{html.escape(str(j.get("job", i)))}: '
            f'{_fmt(j["submit"])}s → {_fmt(j["end"])}s '
            f'({_fmt(dur)}s, {j.get("tasks", "?")} tasks)</title></rect>')
    note = f"{len(done)} completed jobs"
    if len(done) > len(show):
        note += f", first {len(show)} shown"
    rows = [(str(j.get("job", "")), _fmt(j["submit"]), _fmt(j["end"]),
             _fmt(j["end"] - j["submit"]), j.get("tasks", "—"),
             j.get("failed_attempts", 0)) for j in done[:200]]
    table = _table(["job", "submit (s)", "end (s)", "duration (s)", "tasks",
                    "failed attempts"], rows,
                   cap=200 if len(done) > 200 else None)
    return _card("Job timeline", note, p.svg() + table)


def _tiles(frames, final, meta) -> str:
    summary = (final or {}).get("summary") or {}
    last = frames[-1]
    items = [
        (_fmt(last["t"]) + "s", "simulated time"),
        (str(meta.get("n_nodes", len(last["node_occ"]))), "nodes"),
        (_fmt(summary.get("occupancy_mean", 0), 3), "mean occupancy"),
        (_fmt(summary.get("failures", sum(sum(f["node_fail"])
                                          for f in frames)), 0),
         "task failures"),
        (str(len((final or {}).get("jobs") or []) or "—"), "jobs traced"),
    ]
    rate = summary.get("memo_hit_rate")
    if rate:
        items.append((_fmt(rate * 100, 1) + "%", "memo hit rate"))
    # fault-tolerance tiles: nonzero only when the serving path actually
    # degraded/retried (the summary omits the keys on clean runs, and the
    # live path carries them in the last frame's pred block)
    pred = last.get("pred") or {}
    for key, label in (("fallbacks", "predictor fallbacks"),
                       ("retries", "broker retries"),
                       ("reconnects", "broker reconnects")):
        v = summary.get(key, pred.get(key, 0))
        if v:
            items.append((_fmt(v, 0), label))
    tiles = "".join(f'<div class="tile"><div class="v">{html.escape(v)}'
                    f'</div><div class="k">{html.escape(k)}</div></div>'
                    for v, k in items)
    return f'<div class="tiles">{tiles}</div>'


def _lifecycle_markers(frames, registry_events) -> list[tuple]:
    """(t, event, label) from in-frame events + registry events.jsonl."""
    markers = []
    for f in frames:
        for ev in f.get("events", ()):
            markers.append((ev["t"], ev["event"],
                            f"{ev['event']} @ {_fmt(ev['t'])}s "
                            + str({k: v for k, v in ev.items()
                                   if k not in ("t", "event")} or "")))
    for ev in registry_events or ():
        kind = ev.get("event")
        if kind not in ("promote", "rollback"):
            continue
        t = (ev.get("meta") or {}).get("sim_now")
        if t is None:
            continue
        markers.append(
            (t, kind,
             f"{kind} {ev.get('family', '')} v{ev.get('version', '?')} "
             f"@ {_fmt(t)}s"))
    seen, out = set(), []
    for m in sorted(markers):
        key = (round(m[0], 2), m[1])
        if key not in seen:
            seen.add(key)
            out.append(m)
    return out


def render_html(frames: list[dict], *, broker_frames=None,
                registry_events=None, title="repro ops dashboard",
                refresh: float | None = None) -> str:
    """Render a frame stream (plus optional broker flush stream and model
    registry event ledger) into one self-contained HTML document.

    ``refresh`` (seconds) makes the document self-refreshing — the live
    server re-renders from its in-memory window on every reload."""
    meta = next((f for f in frames if f.get("type") == "meta"), {})
    final = next((f for f in frames if f.get("type") == "final"), None)
    data = [f for f in frames if f.get("type") == "frame"]
    if not data:
        raise ValueError("no telemetry frames in input")
    markers = _lifecycle_markers(data, registry_events)
    sub = (f"scheduler={meta.get('scheduler', '?')} · "
           f"{meta.get('n_nodes', '?')} nodes · {len(data)} frames · "
           f"frame_every={meta.get('frame_every', '?')}s")
    if refresh:
        sub += f" · refreshing every {refresh:g}s"
    body = [
        f"<h1>{html.escape(title)}</h1>",
        f'<div class="sub">{html.escape(sub)}</div>',
        _tiles(data, final, meta),
        _occupancy_chart(data),
        _heatmap(data, meta),
        _queue_chart(data),
        _drift_chart(data, markers),
        _broker_cards(broker_frames or []),
        _jobs_chart(final),
    ]
    return render_page(title, "".join(body), refresh=refresh)


def render_broker_html(flush_frames: list[dict], *,
                       title="repro broker telemetry",
                       refresh: float | None = None) -> str:
    """A broker-only document for sources that stream flush frames without
    sim frames (``online/bench --obs-live``)."""
    body = [f"<h1>{html.escape(title)}</h1>",
            f'<div class="sub">{len(flush_frames)} flush frames'
            + (f" · refreshing every {refresh:g}s" if refresh else "")
            + "</div>",
            _broker_cards(flush_frames)
            or _card("Broker", "no flush frames yet", "")]
    return render_page(title, "".join(body), refresh=refresh)
