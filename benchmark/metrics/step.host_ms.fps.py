"""Mean host time of the fusion step (FusionPipeline.process): the
launches' host cost, with no synchronisation."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "fps"
TRACE = True


def read(rec):
    return _stats.mean(rec.window_spans("step.host_ms"))
