"""Adaptive heartbeat controller (§4.2): if more than 1/3 of TaskTrackers failed
within one heartbeat window, halve the interval (floor: min_interval); otherwise
grow it back (cap: max_interval) to save JT<->TT control traffic.  Runs alongside
ATLAS, adjusting on the fly."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HeartbeatController:
    min_interval: float = 120.0     # paper: 2 min floor
    max_interval: float = 600.0     # paper: 10 min default
    grow: float = 1.25
    fail_frac_threshold: float = 1.0 / 3.0

    window_start: float = 0.0
    adjustments: int = 0

    def on_heartbeat(self, sim):
        interval = sim.heartbeat_interval
        if sim.now - self.window_start < interval:
            return
        frac = sim.hb_failures_window / max(len(sim.nodes), 1)
        if frac > self.fail_frac_threshold:
            new = max(self.min_interval, interval / 2.0)
        else:
            new = min(self.max_interval, interval * self.grow)
        if new != interval:
            self.adjustments += 1
        sim.heartbeat_interval = new
        sim.hb_failures_window = 0
        self.window_start = sim.now
