"""FPS accounting: ``FpsCounter`` of
pointcloud_depthfusion_tpu/utils/profiling.py (whose module imports jax),
without its sink and publish gate, which only the config tree's nodes use.

The reference's FPS telemetry strings ({"FPS": x, "lastCurrMSec": y},
camera_node.cpp:388-434). The stage timers are not ported yet (ROADMAP
A11).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class FpsCounter:
    """FPS over a sliding window: ``tick`` returns the reference's JSON
    string once per report window (the `<name>/fps` topic's message), else
    None."""

    def __init__(self, name: str = "FPS", report_every_s: float = 1.0):
        self.name = name
        self.report_every_s = report_every_s
        self.frame_count = 0
        self.elapsed = 0.0
        self._last = time.perf_counter()
        self.last_fps = 0.0
        self.last_frame_ms = 0.0

    def tick(self) -> Optional[str]:
        now = time.perf_counter()
        frame_ms = (now - self._last) * 1e3
        self._last = now
        self.frame_count += 1
        self.elapsed += frame_ms
        self.last_frame_ms = frame_ms
        if self.elapsed >= self.report_every_s * 1e3:
            self.last_fps = 1000.0 * self.frame_count / self.elapsed
            msg = json.dumps(
                {self.name: round(self.last_fps, 2), "lastCurrMSec": round(frame_ms, 2)}
            )
            self.frame_count = 0
            self.elapsed = 0.0
            return msg
        return None
