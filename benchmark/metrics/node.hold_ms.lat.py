"""Mean time from the end of a pair's fusion step to its image at the
subscriber: the readback, and the async readback's hold until the next
pair is processed."""

from benchmark.metrics import _stats

UNIT = "ms"
MOVES = "latency_p95_ms"
TRACE = True


def read(rec):
    end, pub = rec.process_end, rec.published
    cut = rec.span_cut if rec.span_cut is not None else rec.clock.t_end
    return _stats.mean([(pub[k] - end[k]) * 1e3 for k in end
                        if k >= 0 and k in pub and end[k] < cut])
