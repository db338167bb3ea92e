"""Mean time a pair waits in the feeder's queue: its dequeue by the node less
the program's enqueue_time."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("feeder.wait_ms"))
