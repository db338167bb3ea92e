"""Mean time a set waits in the rig feeder's queue: its dequeue by the node
less the program's RigBatch.enqueue_time."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("rig_feeder.wait_ms"))
