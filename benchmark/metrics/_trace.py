"""Reading a ``torch.profiler`` trace of a run's last seconds.

The harness marks the traced window with two annotations,
``bench.trace.begin`` and ``bench.trace.end``; everything here is clipped
to them. Device operations are the trace's kernels, copies and fills. Busy
time is their union; an idle gap is a stretch between two of them, named
by the host range that overlaps it most: the benchmark's own spans first
(the layers' calls), then the program's operators.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC",
            "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel")


def kernel_id(name: str) -> str:
    """A kernel's function name: ``void ns::k<T>(args)`` -> ``k``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _attribute(g0: float, g1: float, host) -> Dict[str, float]:
    """Seconds of the idle gap [g0, g1] by what the host was doing: each
    stretch goes to the innermost traced range that covers it, the
    benchmark's spans before the program's operators; the rest is
    untraced host time (threads the profiler does not see)."""
    for starts, evs, longest in host:
        found = [(max(g0, float(e["ts"])), min(g1, float(e["ts"]) + float(e.get("dur", 0))),
                  e["name"])
                 for e in evs[bisect.bisect_left(starts, g0 - longest):
                              bisect.bisect_left(starts, g1)]]
        found = [f for f in found if f[1] > f[0]]
        if found:
            break
    cuts = sorted({g0, g1, *(x for f in found for x in f[:2])})
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        cover = [f for f in found if f[0] <= a and f[1] >= b]
        label = max(cover, key=lambda f: f[0])[2] if cover else "untraced host time"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def summarize_events(events: List[dict]) -> dict:
    """The summary of chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = {e["name"]: float(e["ts"]) for e in xs if e.get("name", "").startswith("bench.trace.")}
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "complete": False,
                "breakdown": {"device_ops": [], "idle_gaps": []}, "marks": sorted(marks),
                "events": {}}
    t_a = marks.get("bench.trace.begin", min(float(e["ts"]) for e in dev))
    t_b = marks.get("bench.trace.end", max(float(e["ts"]) + float(e.get("dur", 0)) for e in dev))
    spans, kernels, ops = [], {}, {}
    for e in dev:
        s = float(e["ts"])
        d = float(e.get("dur", 0.0))
        if not t_a <= s < t_b:
            continue
        spans.append((s, min(s + d, t_b)))
        label = kernel_id(e["name"]) if e["cat"] == "kernel" else e["name"]
        ops[label] = ops.get(label, 0.0) + d * 1e-6
        if e["cat"] == "kernel":
            c, sec = kernels.get(label, (0, 0.0))
            kernels[label] = (c + 1, sec + d * 1e-6)
    busy = _merge(spans)
    launches = sum(1 for e in xs if e.get("name") in LAUNCHES and t_a <= float(e["ts"]) < t_b)
    n_kernels = sum(c for c, _ in kernels.values())
    host = []  # per category: (starts, events sorted by start, longest duration)
    for cat in ("user_annotation", "cpu_op"):
        evs = sorted((e for e in xs if e.get("cat") == cat
                      and not e["name"].startswith("bench.trace.")), key=lambda e: float(e["ts"]))
        host.append(([float(e["ts"]) for e in evs], evs,
                     max((float(e.get("dur", 0)) for e in evs), default=0.0)))
    idle: Dict[str, float] = {}
    edges = [t_a] + [x for iv in busy for x in iv] + [t_b]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            for label, sec in _attribute(g0, g1, host).items():
                idle[label] = idle.get(label, 0.0) + sec
    busy_s = sum(b - a for a, b in busy) * 1e-6
    cats: Dict[str, int] = {}
    for e in xs:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    return {
        "busy_s": busy_s, "window_s": (t_b - t_a) * 1e-6, "kernels": kernels,
        "launches": launches, "complete": n_kernels >= launches, "events": cats,
        "marks": sorted(marks),
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[f"idle while {k}", v]
                          for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def summarize(prof) -> dict:
    """Summary of a stopped ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize_events(events)
