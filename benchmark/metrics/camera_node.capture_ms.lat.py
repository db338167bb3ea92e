"""The reader of camera_node.capture_ms.fps, moving the paced cell's latency."""

import pathlib

from benchmark.harness import metric_module

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True

_BENCH = pathlib.Path(__file__).resolve().parents[1]
read = metric_module("camera_node.capture_ms.fps", _BENCH).read
