"""The 95th percentile, over every pair due in the window, of the time from
the instant both cameras' frames are due to the fused image in host memory
at the subscriber; a pair dropped or never published counts as missing any
limit."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = False


def read(rec):
    if not rec.clock.open_loop:
        return None
    return _stats.percentile(rec.latencies_ms(), 95)
