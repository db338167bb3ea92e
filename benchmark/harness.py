"""The benchmark harness: runs one cell of ``BENCHMARK.json`` once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name the manifest gives:

- ``configs/<config>.json``: the deployment as run (sizes, node settings,
  the host's heap, scene, the limits of the output check); its ``driver``
  names ``drivers/<driver>.py``, which builds the node on the benchmark's
  cameras and works out its reference images;
- ``traffic/<mix>.json``: the mix's parameters, read by
  ``traffic/generator.py``;
- ``metrics/<metric>.py``: the metric's reader, ``read(record)``, which
  returns a number or None (nothing to read: the metric is left out), and
  its ``UNIT``, ``MOVES`` and ``TRACE`` (whether it reads the traced run).

A run: render the cell's frame pool on the device from the seed, move it to
host memory, hand it to the node through the traffic's camera sources, warm
up, open the window for ``seconds``, close it, read the memory peak, free
the node, then compare a seeded sample of the published images with the
plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = pathlib.Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pointcloud_depthfusion_tpu")
#: Published images kept for the output check (a seeded uniform sample).
SAMPLE_IMAGES = 32
#: Seconds of steady state at the end of a traced run's window under the
#: profiler; the per-layer spans are read before it starts.
TRACE_SECONDS = 3.0


# -- finding things by name ------------------------------------------------------


def load_manifest(repo: pathlib.Path = REPO_DIR) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, bench: pathlib.Path = BENCH_DIR):
    return _module(bench / "metrics" / f"{name}.py", f"bench_metric_{name}")


def driver_module(name: str, bench: pathlib.Path = BENCH_DIR):
    return _module(bench / "drivers" / f"{name}.py", f"bench_driver_{name}")


def load_config(manifest: dict, name: str, repo: pathlib.Path = REPO_DIR) -> dict:
    entry = next(c for c in manifest["configs"] if c["name"] == name)
    return json.loads((repo / entry["file"]).read_text())


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones without
    tracing, its per-layer ones with it. A metric with ``workloads`` is
    reported in those cells; an end-to-end one without, in every cell; a
    per-layer one without, in every cell that reports what it moves."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


# -- what a run observed ------------------------------------------------------


class Record:
    """What one run saw, for the metric readers and the output check."""

    def __init__(self, cell: dict, config: dict, mix: dict, clock, seed: int, t_start: float,
                 tracing: bool):
        self.cell, self.config, self.mix, self.clock = cell, config, mix, clock
        self.seed, self.t_start, self.tracing = seed, t_start, tracing
        self.sources: list = []
        self.published: Dict[int, float] = {}
        self.samples: Dict[int, np.ndarray] = {}
        self.spans: Dict[str, list] = {}
        self.process_end: Dict[int, float] = {}
        self.warm_images = 0
        self.last_image_t = time.perf_counter()
        self.trace = None
        self.span_cut: Optional[float] = None
        self.kernels: list = []
        self._seen = 0
        self._rng = random.Random(seed)
        self._profiler = None
        self._trace_marks = 0
        self.trace_timing = {}

    # spans

    def span(self, name: str, t: float, ms: float) -> None:
        self.spans.setdefault(name, []).append((t, ms))

    def window_spans(self, name: str) -> List[float]:
        """The span's values that began inside the window, before the
        profiler started."""
        t0 = self.clock.t0
        cut = self.span_cut if self.span_cut is not None else self.clock.t_end
        return [v for t, v in self.spans.get(name, ()) if t0 <= t < cut]

    # images

    def on_image(self, image: np.ndarray, stamp: float) -> None:
        """The subscriber: every fused image the node publishes."""
        t = time.perf_counter()
        self.last_image_t = t
        k = self.clock.frame_of(stamp)
        if k < 0:
            self.warm_images += 1
            return
        self.published[k] = t
        # Reservoir sample of the window's images, drawn from the seed.
        self._seen += 1
        if len(self.samples) < SAMPLE_IMAGES:
            self.samples[k] = image
        else:
            j = self._rng.randrange(self._seen)
            if j < SAMPLE_IMAGES:
                del self.samples[self._rng.choice(sorted(self.samples))]
                self.samples[k] = image
        if self.tracing:
            self._drive_profiler(t)

    def _drive_profiler(self, t: float) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

        t_end = self.clock.t_end
        if self._profiler is None and t >= t_end - TRACE_SECONDS:
            self.span_cut = t
            self._profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._profiler.start()
            self.trace_timing["start_ms"] = (time.perf_counter() - t) * 1e3
            with record_function("bench.trace.begin"):
                pass
            self._trace_marks = 1
        elif self._trace_marks == 1 and t >= t_end:
            with record_function("bench.trace.end"):
                pass
            self._trace_marks = 2

    def finish_trace(self) -> None:
        if self._profiler is None:
            return
        from benchmark.metrics import _trace  # noqa: PLC0415

        t = time.perf_counter()
        self._profiler.stop()
        self.trace_timing["stop_ms"] = (time.perf_counter() - t) * 1e3
        self.trace = _trace.summarize(self._profiler)
        self._profiler = None

    def prime_profiler(self, device) -> None:
        """Trace one operation before the window: the profiler's first
        start sets up its device tracing, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        t = time.perf_counter()
        with profile(activities=acts):
            torch.ones(8, device=device).add_(1).sum().item()
        self.trace_timing["prime_ms"] = (time.perf_counter() - t) * 1e3

    # the window

    def window_frames(self) -> List[int]:
        """The pairs the window attempted: every frame due in it (open
        loop), or every frame each camera handed out in it (closed)."""
        if self.clock.open_loop:
            return list(range(self.clock.frames))
        counts = [sum(1 for k in s.handed if k >= 0) for s in self.sources]
        return list(range(min(counts)))

    def latencies_ms(self) -> List[float]:
        """Due-to-publication latency of every pair due in the window; a
        pair never published counts as the longer of the window and the
        slowest published pair, above any limit a run can meet."""
        got = [(self.published[k] - self.clock.due(k)) * 1e3
               for k in range(self.clock.frames) if k in self.published]
        missing = self.clock.frames - len(got)
        return got + [max([self.clock.seconds * 1e3] + got)] * missing


# -- running a cell ------------------------------------------------------------


def _open_when_warm(rec: Record, held: int, stop: threading.Event) -> None:
    """Open the window once the warm-up is through: every warm-up image
    published (but the ``held`` ones the node keeps back), or the cameras
    done and the node quiet for 0.5 s (warm-up pairs dropped)."""
    clock = rec.clock
    target = clock.warmup - held
    while not stop.is_set() and clock.t0 is None:
        done = rec.sources[0].next_k >= 0  # the first camera waits for the window
        if rec.warm_images >= target or (
                done and time.perf_counter() - rec.last_image_t > 0.5):
            clock.open()
            return
        time.sleep(0.002)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             repo: pathlib.Path = REPO_DIR, bench: pathlib.Path = BENCH_DIR,
             config_hook: Optional[Callable[[dict], dict]] = None) -> dict:
    """Run one cell once; returns the result line's fields (without
    ``device``) and the record. ``config_hook`` rewrites the configuration
    (the CPU tests shrink it)."""
    from benchmark.traffic import generator  # noqa: PLC0415

    manifest = load_manifest(repo)
    cell = next(w for w in manifest["workloads"] if w["name"] == cell_name)
    config = load_config(manifest, cell["config"], repo)
    if config_hook is not None:
        config = config_hook(config)
    mix = generator.load_mix(cell["traffic"], bench / "traffic")
    driver = driver_module(config["driver"], bench)
    metrics = [(m, metric_module(m["name"], bench)) for m in cell_metrics(manifest, cell_name,
                                                                          trace)]
    for m, mod in metrics:
        if (mod.UNIT, mod.MOVES, mod.TRACE) != (m["unit"], m.get("moves", m["name"]), trace):
            raise ValueError(f"metrics/{m['name']}.py declares another unit, end-to-end "
                             "metric or run than BENCHMARK.json")

    from benchmark.scene.render import render_pool  # noqa: PLC0415
    pool = render_pool(config, int(mix["pool_frames"]), seed, device)
    # The cameras deliver from host memory, and the pool waits there for the
    # reference: the device's peak is the program's alone.
    depth16, color = pool["depth"].to(torch.int16).cpu(), pool["color"].cpu()
    host_depth, host_color = depth16.numpy().view(np.uint16), color.numpy()
    pool = dict(pool, depth=None, color=None)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    clock = generator.Clock(mix, seconds, config["fps"])
    rec = Record(cell, config, mix, clock, seed, t_start, trace)
    if trace:
        rec.prime_profiler(device)
    node = driver.build(config, pool, rec, device,
                        lambda intr, c: generator.CameraSource(
                            clock, host_depth[c], host_color[c], intr, config["depth_scale"],
                            config.get("frames_queue_size", 1), driver.host_frameset()))
    rec.sources = node.sources
    rec.kernels = node.kernels
    stop = threading.Event()
    opener = threading.Thread(target=_open_when_warm, args=(rec, node.held, stop), daemon=True)
    opener.start()
    try:
        node.run()
    finally:
        stop.set()
        clock.stop()
        opener.join(timeout=5.0)
    rec.finish_trace()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec.drops = node.drops()
    node.close()
    del node
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    values = {}
    for entry, mod in metrics:
        v = mod.read(rec)
        if v is not None:
            values[entry["name"]] = {"value": float(v), "unit": entry["unit"]}

    frames = rec.window_frames()
    failed = sum(1 for k in frames if k not in rec.published)
    t_ref = time.perf_counter()
    pool.update(depth=depth16.to(device).to(torch.int32) & 0xFFFF, color=color.to(device))
    refs = driver.reference_images(config, pool, rec, sorted(rec.samples), device)
    worst = 0.0
    for k, img in rec.samples.items():
        got = torch.from_numpy(np.ascontiguousarray(img)).to(refs[k].device)
        worst = max(worst, image_mismatch_share(got, refs[k]))
    limit = float(config["check"]["image_mismatch_share"])
    checks = {"image_mismatch_share": {"value": worst, "limit": limit}}
    correct = worst <= limit and bool(rec.samples)
    return {
        "correct": bool(correct), "attempted": len(frames), "failed": failed,
        "metrics": values, "memory_peak_bytes": int(memory_peak), "checks": checks,
        "record": rec, "reference_s": time.perf_counter() - t_ref,
    }


def image_mismatch_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of pixels where any channel differs; 1.0 when the shapes
    differ."""
    if got.shape != ref.shape:
        return 1.0
    return float((got != ref).any(-1).to(torch.float64).mean())


# -- the environment -----------------------------------------------------------


def _version(cmd: List[str]) -> Optional[str]:
    """The line of ``cmd``'s output that names its release (else its
    first line), or None when it cannot run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in (out.stdout or out.stderr).splitlines() if ln.strip()]
    return next((ln for ln in lines if "release" in ln), lines[0] if lines else None)


def environment(device) -> dict:
    """Toolchain and card: torch, CUDA, nvcc, the host compiler, the card's
    name and power limit."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    env = {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "numpy": np.__version__,
        "nvcc": _version([nvcc if os.path.exists(nvcc) else "nvcc", "--version"]),
        "cxx": _version([cxx, "--version"]), "cpus": os.cpu_count(),
    }
    if torch.device(device).type == "cuda":
        env["device"] = torch.cuda.get_device_name(device)
        env["power_limit"] = _version(["nvidia-smi", "--query-gpu=name,power.limit",
                                          "--format=csv,noheader"])
    return env


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's own name starts with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def result_line(out: dict, cell: dict, device) -> dict:
    """The last line of standard output; ``checks`` comes last."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"],
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": out["memory_peak_bytes"]}}
    trace = out["record"].trace
    if trace is not None:
        line["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = trace["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(args, t_start: float, heap: Optional[dict] = None) -> int:
    manifest = load_manifest()
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import pointcloud_depthfusion_tpu_torch as port  # noqa: PLC0415

    if REPO_DIR not in pathlib.Path(port.__file__).resolve().parents:
        print(f"the program under test is not this checkout's: {port.__file__}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print("bench.env " + json.dumps(dict(environment(device), heap=heap or {})),
          file=sys.stderr, flush=True)
    out = run_cell(args.workload, args.seed, float(args.seconds), bool(args.trace), device,
                   t_start)
    rec = out["record"]
    late = sorted(x for s in rec.sources for x in s.wake_late_s)
    print("bench.generator " + json.dumps({
        "wakeups": len(late),
        "late_p50_ms": late[len(late) // 2] * 1e3 if late else None,
        "late_max_ms": late[-1] * 1e3 if late else None,
        "sensor_dropped": sum(s.dropped for s in rec.sources),
        "node_drops": rec.drops, "reference_s": out["reference_s"],
        "trace": None if rec.trace is None else {
            k: rec.trace.get(k) for k in ("complete", "launches", "events", "marks", "window_s")},
        "trace_timing_ms": rec.trace_timing,
    }), file=sys.stderr, flush=True)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(out, cell, device)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
