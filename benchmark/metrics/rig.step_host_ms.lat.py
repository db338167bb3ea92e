"""Mean host time of the rig step (the node's rig_fuse call): the launches'
host cost, with no synchronisation."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("rig.step_host_ms"))
