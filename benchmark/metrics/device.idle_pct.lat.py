"""The reader of device.idle_pct.fps, moving the paced cell's latency."""

import pathlib

from benchmark.harness import metric_module

UNIT = "%"
MOVES = "latency_p95_ms"
TRACE = True

_BENCH = pathlib.Path(__file__).resolve().parents[1]
read = metric_module("device.idle_pct.fps", _BENCH).read
