"""The median of the due-to-publication latencies that latency_p95_ms takes
its 95th percentile of."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    return _stats.percentile(rec.latencies_ms(), 50) if rec.clock.open_loop else None
