"""Mean time of a set's captures on the rig feeder's thread: every camera
node's capture, in series, without the sources' waits for the set to fall
due."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("rig_feeder.capture_ms"))
