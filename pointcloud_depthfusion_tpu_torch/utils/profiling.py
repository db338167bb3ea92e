"""Profiling and telemetry: stage timers, FPS accounting, CSV logs. A copy
of pointcloud_depthfusion_tpu/utils/profiling.py (whose module imports
jax), with the stage timer fenced by ``torch.cuda.synchronize``.

The reference's tracing mechanisms (SURVEY.md §5): per-op GPU timers
(frameset.cpp:213-237) → :class:`StageTimer`; the fusion stage CSV
(fusion_node.hpp:197-204) → :class:`StageLog`; the FPS telemetry strings
({"FPS": x, "lastCurrMSec": y}, camera_node.cpp:388-434) →
:class:`FpsCounter`.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import torch

FUSION_STAGE_FIELDS = [
    "loop",
    "callback",
    "prep",
    "project",
    "publish",
    "latency",
    "diff",
    "copy_to_gpu",
    "copy_from_gpu",
    "filter_image",
]
"""The fusion profiling schema: the reference's (fusion_node.hpp:198-200)
with its filter, deproject, transform_right, fuse and transform stages
folded into ``prep``, since the port runs them in one launch (kernel B3).
FusionPipeline.process_profiled fills the device stages; FusionNodeApp
fills the host ones (callback, publish, latency, diff, copy_to_gpu, loop)."""


class StageTimer:
    """Wall-clock stage timer with device fences.

    ``lap(name, *tensors)`` waits for the card when any of ``tensors`` lies
    on it (``torch.cuda.synchronize``, the analogue of the reference's
    cudaDeviceSynchronize in getTiming, fusion_node.cpp:620-631), then
    records the milliseconds since the previous lap. CPU tensors need no
    fence: their operations have finished when they return."""

    def __init__(self):
        self.laps: Dict[str, float] = {}
        self._t = time.perf_counter()

    def reset(self) -> None:
        self.laps = {}
        self._t = time.perf_counter()

    def lap(self, name: str, *fence: torch.Tensor) -> float:
        cards = {t.device for t in fence if t.is_cuda}
        for dev in cards:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        ms = (now - self._t) * 1e3
        self.laps[name] = self.laps.get(name, 0.0) + ms
        self._t = now
        return ms


class StageLog:
    """Per-frame stage rows, flushed to CSV every ``log_size`` rows (the
    reference writes ``<node>_profiling.txt`` the same way)."""

    def __init__(self, path: str, fields: Optional[List[str]] = None, log_size: int = 400):
        self.path = path
        self.fields = fields or FUSION_STAGE_FIELDS
        self.log_size = log_size
        self.rows: List[List[float]] = []
        self._header_written = False

    def add(self, laps: Dict[str, float]) -> None:
        self.rows.append([laps.get(f, 0.0) for f in self.fields])
        if len(self.rows) >= self.log_size:
            self.flush()

    def flush(self) -> None:
        if not self.rows:
            return
        # Append across flush windows, header once.
        mode = "a" if self._header_written else "w"
        with open(self.path, mode) as fh:
            if not self._header_written:
                fh.write(",".join(self.fields) + "\n")
                self._header_written = True
            for row in self.rows:
                fh.write(",".join(f"{v:.4f}" for v in row) + "\n")
        self.rows = []


class FpsCounter:
    """FPS over a sliding window: ``tick`` returns the reference's JSON
    string once per report window (the `<name>/fps` topic's message), else
    None, and hands it to ``sink`` while ``publish`` is on (the reference's
    ``profiling.publish_fps``, config.cpp:132-134)."""

    def __init__(self, name: str = "FPS", report_every_s: float = 1.0,
                 sink: Optional[Callable[[str], None]] = None):
        self.name = name
        self.report_every_s = report_every_s
        self.sink = sink
        self.publish = True
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
            if self.sink and self.publish:
                self.sink(msg)
            return msg
        return None


def get_current_rss_bytes() -> int:
    """Resident set size (Utils.h GetCurrentRSS equivalent); 0 where
    /proc is not there."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        import resource  # noqa: PLC0415

        return pages * resource.getpagesize()
    except Exception:  # noqa: BLE001 - no /proc: report nothing
        return 0
