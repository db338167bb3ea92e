"""The rig step's kernels (B3 over every camera, the resolve, the colour
kernel) against their memory-bound roofline: frame_kernels_roofline's
reader over the rig driver's kernels."""

import pathlib

from benchmark.harness import metric_module

UNIT = "%"
MOVES = "latency_p95_ms"
TRACE = True

_BENCH = pathlib.Path(__file__).resolve().parents[1]
read = metric_module("frame_kernels_roofline", _BENCH).read
