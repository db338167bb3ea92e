"""Mean time from the rig step's return to its image at the subscriber: the
step's kernels still running, the synchronous readback and the publish
(node.hold_ms.lat's reader over the rig step's end)."""

import pathlib

from benchmark.harness import metric_module

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True

_BENCH = pathlib.Path(__file__).resolve().parents[1]
read = metric_module("node.hold_ms.lat", _BENCH).read
