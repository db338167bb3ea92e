"""Mean of the program's own upload time of a set (RigBatch.upload_ms):
staging every camera into the pinned buffers, the stacked copy, the colour
packed on the device and the fence."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("rig_feeder.upload_ms"))
