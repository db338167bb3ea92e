"""Fused images that reach the node's subscriber in the window, over the
window's seconds (closed loop: the fusion host's capacity)."""

UNIT = "frames/s"
MOVES = "fps"
TRACE = False


def read(rec):
    t0, t1 = rec.clock.t0, rec.clock.t_end
    return sum(1 for t in rec.published.values() if t0 <= t <= t1) / rec.clock.seconds
