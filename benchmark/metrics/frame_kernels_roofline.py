"""The frame's kernels (B3, the resolve, the colour kernel) against their
memory-bound roofline: the sum of their bounds over the sum of their device
times in the profiler's trace."""

from benchmark.metrics import _roofline

UNIT = "%"
MOVES = "fps"
TRACE = True


def read(rec):
    return None if rec.trace is None else _roofline.roofline_pct(rec.trace, rec.kernels)
