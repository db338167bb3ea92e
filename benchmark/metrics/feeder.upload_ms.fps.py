"""Mean of the program's own upload time of a pair (DevicePair.upload_ms):
staging into pinned buffers, the copies and their fence."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "fps"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("feeder.upload_ms"))
