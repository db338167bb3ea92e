"""Mean time of the camera node's capture (the temporal filter on the host),
a frame, without the source's wait for its frame to fall due."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "fps"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("camera_node.capture_ms"))
