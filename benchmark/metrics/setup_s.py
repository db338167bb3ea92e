"""Seconds from process start to the window's first timed frame: imports, the
CUDA context, the kernel library (built on a checkout's first run),
rendering the inputs, building the node and the warm-up frames."""

UNIT = "s"
MOVES = "setup_s"
TRACE = False


def read(rec):
    return rec.clock.t0 - rec.t_start
