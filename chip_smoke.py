#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_depthfusion_tpu_torch/csrc``
(nvcc, into ``build/torch_kernels/``) and holds each kernel against its plain
PyTorch version at the main paths' shapes, on the card and on the CPU: among
them the z-resolve (phase 2: B1/B2, their masked feed and the depth-only
resolve on synthetic entries, on the real entries of a warm ``tiled`` frame
at both sizes, on 100,000 entries over 64 pixels and through growing and
shrinking n_px on one persistent key buffer), B4's image kernel (the fused
frame's whole color tail in one launch, phase 3), B3 and the u32
scatter-min (phase 10: B3's masked feed and packed keys for every camera of
a frame in one launch, at both dual sizes and on the 8-camera rig, with
undistorting intrinsics and ROIs; the scatter-min in every variant, through
growing and shrinking n_slots on the same persistent buffer) and B5 (phase
7). Then it drives the two services
the shipped deployment runs, each against the same pipeline on the CPU at
dual 848×480 and dual 1280×720, with every launch counter set to 0 just
before and read just after:

  [4-5] the dual-camera fused frame, ``FusionPipeline.process``;
  [8]   the registration service, ``RegistrationPipeline.tick``, with the
        settings of configs/registration_default.yaml;
  [11]  the fused frame in the other render modes (exact, indexed, packed,
        pallas) and with depth→color alignment;
  [12]  the N-camera rig: kernel B7 against its plain version, ``rig_fuse``
        at 4 and 8 cameras of 848×480 and 4 of 1280×720 in every rig mode
        against the CPU, ``batched_rig_fuse`` against per-stream
        ``rig_fuse``, and ``RigFusionNodeApp.run`` (4 cameras, inline
        calibration sweeps) against the CPU, and against the rig's truth at
        the deployment's 424×240;
  [13]  kernel B6 against its plain versions (1, 2 and 4 passes a launch;
        the fused ``filter_depth`` with morphology, ROIs on every edge),
        ``filter_depth`` with morphology against the CPU (1 B6 launch a
        call), the spatial filter's row-scan kernel against its plain
        version (holes_fill 0-5, magnitude 1-3, disparity; 2 launches a
        magnitude), the other depth filters against the CPU, the native
        host runtime (the C++ renderer and host filters, built by g++, held
        bit for bit against their numpy versions and timed), the dual
        deployment ``launch.run_deployment`` with native synthetic cameras
        (CameraNode → DeviceFeeder → FusionNodeApp with RegistrationNodeApp
        ticks → ImageNode) on the card and against the CPU, the same
        deployment replayed from recordings made by ``CameraNode.main``,
        ``FusionNodeApp.run`` over prerendered frames, timed, and (13g) the
        two-host deployment: two camera-host processes
        (``python -m pointcloud_depthfusion_tpu_torch.io.network``, raw and
        then png) serve ``run_deployment``'s ``tcp://`` cameras over TCP at
        1280×720, card against CPU on the pairs the card fused, the hosts
        never initialising CUDA; ``serve:`` with a remote client; and the
        demo as a process of its own on the card;
  [14]  the multi-GPU tier on the one card: ``rig_fuse_sharded`` over 2 and
        4 shards on ``cuda:0`` (8×848×480, per-camera intrinsics and ROIs,
        tiled with the z-buffer and packed) bit-exact to ``rig_fuse`` and
        against the CPU, ``RigFusionNodeApp(mesh=)``,
        ``gicp_register_sharded`` against ``gicp_register`` on the dual
        1280×720 clouds, ``gicp_register_batched`` and
        ``register_rig_pairs`` bit-identical to sequential solves, the
        ``parallel.multihost`` worker as one NCCL process, ``PointCloud``
        at 1280×720 against the CPU, and ``solver="matrix"`` against the
        planar solver.

It times frames, ticks and kernels with CUDA events and a host clock ending
in ``synchronize()`` (the resolve, B3 and the scatter-min also by the
profiler's device time and by their bare launches), profiles one warm tick
and warm frames, and fails a profiled frame whose device ops exceed
FRAME_OPS_CEILING. Any failure raises and exits non-zero; there is no
result without a CUDA device.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

DEVICE = "cuda"
PIXEL_BUDGET = 1e-3  # fraction of pixels (the parity gate's cross-backend budget)
ZMAX = float(np.finfo(np.float32).max)
REPLACES = {
    "zresolve_winner_rgb": "pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py:182",
    "zresolve_sorted_entries": "pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py:112",
    "zresolve_sorted_entries_legacy": "pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py:53",
    "gauss3x3_image": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:69",
    "median3x3_image": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:41",
    # Not a Pallas kernel: the image kernel with no filter replaces the XLA
    # decode of the resolve's winner (and the stack of the planes).
    "color_image": "pointcloud_depthfusion_tpu/ops/render.py:138",
    "segsum_sorted": "pointcloud_depthfusion_tpu/ops/pallas/segsum_pallas.py:42",
    "fuse_prep": "pointcloud_depthfusion_tpu/ops/pallas/fuse_prep_pallas.py:43",
    "zresolve_sorted_streams": "pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py:500",
    "morph_plane": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:158",
    # Not a Pallas kernel: the lax.scan of the spatial filter's sweeps.
    "spatial_filter": "pointcloud_depthfusion_tpu/ops/filters.py:489",
    # Not a Pallas kernel: the XLA scatter-min of the packed, indexed and
    # pallas modes, which torch cannot compute on uint32 keys.
    "scatter_min_u32": "pointcloud_depthfusion_tpu/ops/render.py:218",
}
SOURCES = {
    "zresolve_winner_rgb": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "zresolve_sorted_entries": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "zresolve_sorted_entries_legacy": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "gauss3x3_image": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "median3x3_image": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "color_image": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "segsum_sorted": "pointcloud_depthfusion_tpu_torch/csrc/segsum.cu",
    "fuse_prep": "pointcloud_depthfusion_tpu_torch/csrc/fuse_prep.cu",
    "zresolve_sorted_streams": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "morph_plane": "pointcloud_depthfusion_tpu_torch/csrc/morph.cu",
    "spatial_filter": "pointcloud_depthfusion_tpu_torch/csrc/spatial.cu",
    "scatter_min_u32": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
}
# The H100 SXM's published peaks (NVIDIA's data sheet): device memory and
# the f32 rate outside the tensor cores, which bounds these kernels' integer
# and f32 operations alike.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Registration: the solver's transform bar against the CPU run
# (tpu_check.py:459-464) and the quality bar against the rig's truth
# (tests/test_registration_pipeline.py:46-50).
TRANSFORM_ATOL = 5e-3
TRUTH_M, TRUTH_DEG = 0.02, 1.5
# The fitness gate's near-tie band, relative. On a static scene the steady
# ticks' fitness values lie within a fraction of a percent of the gate's
# threshold (phase 8 prints each tick's margin), and the card's and the
# CPU's roundings (reduction order, arccos, exp, sin, cos) move a tick's
# fitness by about as much, so there the discard decision is rounding's.
# Outside the band the card's and the CPU's decisions must agree.
GATE_TIE = 0.01
REG_SIZES = ((848, 480), (1280, 720))
REG_TICKS = 8
# The quantizing modes' bars against the CPU (tpu_check.py:417-451):
# coverage and z beyond two quantization steps on at most PIXEL_BUDGET of
# pixels, color on at most COLOR_BUDGET; pallas against packed on the card
# within PALLAS_VS_PACKED of pixels (tests/test_pallas_prep.py:94-95).
COLOR_BUDGET = 1e-2
PALLAS_VS_PACKED = 2e-3
MODES = ("exact", "indexed", "packed", "pallas", "tiled+align")
# A 1.5 cm depth→color baseline and a depth camera with 0.8× the color
# focal length, for the aligned frames.
ALIGN_T = (0.015, 0.0, 0.001)
ALIGN_FOCAL = 0.8
# Phase 12, the N-camera rig: the node's fusion settings (rig_node.py:90-97),
# then each case's FusionConfig fields, multi_stream, and per-camera
# intrinsics (with RIG_ROIS).
RIG_CONFIG = dict(vertical_image=False, mirror_image=False, filter_fused_color=False)
RIG_CASES = {
    "tiled_image_only": (dict(emit_zbuf=False), False, False),
    "tiled_zbuf": ({}, False, False),
    "multi_stream": ({}, True, False),
    "packed": (dict(render_mode="packed"), False, False),
    "per_camera_gauss": (dict(filter_fused_color=True), False, True),
}
# (cameras, width, height) and the cases run there, RIG_FRAMES frames each.
RIG_RUNS = (
    ((4, 848, 480), ("tiled_image_only", "tiled_zbuf", "multi_stream", "packed",
                     "per_camera_gauss")),
    ((8, 848, 480), ("tiled_image_only", "multi_stream")),
    ((4, 1280, 720), ("tiled_image_only",)),
)
RIG_FRAMES = 2
RIG_CAMERAS = 4  # of the per-camera intrinsics and of the node
RIG_BC_COEFFS = (0.06, -0.02, 0.001, -0.0015, 0.004)
RIG_ROIS = [(40, 20, 760, 420), None, (-1, -1, -1, -1), (100, 0, 700, 480)]
RIG_BATCHED = ((8, 848, 480), 2)  # the rig whose cameras make B streams, and B
RIG_STREAMS_TIMED = (8, 848, 480)  # B7 is timed on this rig's entries
RIG_PROFILED = ((8, 848, 480, "tiled_image_only"), (4, 848, 480, "packed"))
# Device ops of a profiled warm frame: the dual tiled frame (image only,
# Gauss tail), pallas and packed frames at both sizes, and the rig's
# unfiltered 8×848×480 tiled and 4×848×480 packed frames. Each is the count
# that B3's one launch for all cameras and the one-launch scatter-min
# measured (PERF.md §5); a frame above its ceiling fails the run.
FRAME_OPS_CEILING = {"dual": 3, "dual pallas": 3, "dual packed": 3, "rig tiled_image_only": 3,
                     "rig packed": 3}
B7_SHAPES = ((8, 407_040), (4, 921_600))  # (S, N = n_px)
# The node: RigFusionNodeApp.run on RIG_CAMERAS synthetic cameras, inline
# sweeps every NODE_EVERY frames, on the card and on the CPU, at each size
# of NODE_RUNS: (width, height, truth, timed). With ``truth`` each adjacent
# pair on both devices is held to the truth bar of
# tests/test_nodes.py:641-642: at configs/deployment_rig4.yaml's 424×240.
# Without it the card's cam_to_virtual is held within TRANSFORM_ATOL of the
# CPU's: at 848×480, where the sweeps miss the truth bar on the card and the
# CPU alike (ROADMAP queue C). Each run logs both measures. ``timed`` adds a
# card run without sweeps for frames/s.
NODE_RUNS = ((424, 240, True, False), (848, 480, False, True))
NODE_FRAMES = 16
NODE_EVERY = 4
NODE_TRUTH_M, NODE_TRUTH_DEG = 0.03, 1.5
# The node's starting guesses, (yaw degrees, x metres) per camera index off
# the truth: the node test's perturbation, which the cold sweeps replace by
# annealing from identity (tests/test_nodes.py:604-614), and a small one
# loaded as a trusted calibration, which the warm sweeps refine.
NODE_COLD_GUESS = (2.0, 0.03)
NODE_LOADED_GUESS = (0.5, 0.01)
# Phase 13, the dual deployment: run_deployment of configs/deployment_dual.yaml
# at each size for DEPLOY_FRAMES frames with registration every
# DEPLOY_EVERY (its own cadence, 15), then card-vs-CPU runs of
# DEPLOY_CMP_FRAMES frames with registration off and every DEPLOY_CMP_EVERY;
# the viewer saves every DEPLOY_SAVE_EVERY-th frame. FusionNodeApp.run over
# prerendered frames is timed over REPLAY_FRAMES frames.
# Phase 13, B6: the pass sequences of one launch, and the small planes
# (H, W) beside the scenes'; the spatial filter's crops (W, H) of the
# 848×480 scene's depth, held against its plain version. The spatial
# filter's dependency chain: dependent f32 operations a step (multiply,
# add, add, floor, select), their latency, and the H100 SXM's boost clock.
MORPH_PASSES = ((False,), (True,), (False, True), (True, False), (False, True, True, False))
MORPH_SMALL = ((1, 1), (1, 848), (480, 1), (33, 31))
SPATIAL_SHAPES = ((64, 48), (37, 23), (97, 1), (1, 61))
CHAIN_OPS = 5
F32_LATENCY_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
DEPLOY_SIZES = ((848, 480), (1280, 720))
DEPLOY_FRAMES = 30
DEPLOY_EVERY = 15
DEPLOY_CMP_FRAMES = 3
DEPLOY_CMP_EVERY = 2
DEPLOY_SAVE_EVERY = 8
REPLAY_FRAMES = 30
# Phase 13e, the native host runtime and recorded sources: the C++ renderer
# against the numpy SyntheticSource for one camera frame at each of
# RENDER_SIZES (RENDER_ITERS native calls, RENDER_NUMPY_ITERS numpy ones,
# host clock); the native spatial and decimation filters against their
# numpy versions on a FILTER_SIZE frame (FILTER_ITERS / FILTER_NUMPY_ITERS);
# then both cameras recorded by CameraNode.main at RECORD_SIZE for
# DEPLOY_FRAMES frames and replayed through run_deployment.
RENDER_SIZES = ((848, 480), (1280, 720))
RENDER_ITERS, RENDER_NUMPY_ITERS = 10, 2
FILTER_SIZE = (848, 480)
FILTER_ITERS, FILTER_NUMPY_ITERS = 10, 2
RECORD_SIZE = (1280, 720)
# Phase 13g, the two-host deployment: two camera-host processes (io.network's
# main, the native synthetic camera at TWO_HOST_SIZE, paced at 30 FPS,
# TWO_HOST_FRAMES frames to each client, TWO_HOST_QUEUE frames queued per
# client so that none is dropped) serve the fusion host's run_deployment over
# TCP, with each codec; TWO_HOST_CMP_PAIRS of the fused pairs are fused again
# on the CPU; then a manifest with serve: on both cameras and a remote client,
# and the demo as a process of its own. HOST_START_S bounds a camera host's
# start.
TWO_HOST_SIZE = (1280, 720)
TWO_HOST_FRAMES = 30
TWO_HOST_QUEUE = 32
TWO_HOST_CMP_PAIRS = 3
TWO_HOST_CODECS = ("raw", "png")
HOST_START_S = 120.0
DEMO_ARGS = ("--frames", "30", "--width", "1280", "--height", "720", "--sway", "0.05")
# Phase 14, the multi-GPU tier on one card: rig_fuse_sharded on the
# SHARD_RIG rig (every camera with intrinsics of its own and RIG_ROIS) over
# make_camera_mesh(s) for s in SHARD_COUNTS, SHARD_FRAMES frames, tiled with
# the z-buffer and packed; RigFusionNodeApp over a SHARD_NODE_MESH-shard mesh
# on SHARD_NODE_FRAMES prerendered frames of the SHARD_NODE rig;
# gicp_register_sharded over SHARD_SOLVE shards on the dual 1280×720 clouds
# with the shipped settings' fine stage; gicp_register_batched and
# register_rig_pairs on the BATCHED_RIG rig's cameras; the multihost worker as
# one NCCL process at MULTIHOST_SIZE; PointCloud at POINTCLOUD_SIZE; and the
# matrix solver against the planar one on the dual 1280×720 clouds.
SHARD_RIG = (8, 848, 480)
SHARD_COUNTS = (2, 4)
SHARD_FRAMES = 2
SHARD_NODE = (4, 848, 480)
SHARD_NODE_MESH = 2
SHARD_NODE_FRAMES = 8
SHARD_SOLVE = 2
BATCHED_RIG = (4, 848, 480)
MULTIHOST_SIZE = (1280, 720)
MULTIHOST_BACKEND = "nccl"  # one process on the card; "gloo": one CPU shard
POINTCLOUD_SIZE = (1280, 720)
# Phase 3: the image kernel's (H, W): the fused frames' (vertical) and
# landscape shapes at both sizes, odd widths, and images under 3×3; its
# modes by launch counter.
IMAGE_SIZES = ((848, 480), (480, 848), (1280, 720), (720, 1280), (13, 7), (7, 129), (131, 33),
               (2, 5), (5, 2), (1, 1))
IMAGE_MODES = {None: "color_image", "gauss": "gauss3x3_image", "median": "median3x3_image"}
REPO = os.path.dirname(os.path.abspath(__file__))
# torch.profiler: traces of one call (or one loop of calls) whose device
# events may come back incomplete, and the margin slept inside each traced
# window on either side of the call. Past the first minute of a run,
# traces came back with none or only some of the kernels (10 of 20, 0 of
# 3) for seconds at a time, while the host's records of the launches came
# back whole; margins of up to 1 s did not bring them back. A trace counts
# as complete when it holds one kernel for each kernel launch the host
# made; an incomplete one is taken again, each retry doubling the margin,
# up to PROFILE_MARGIN_MAX_S, and so the wait.
PROFILE_TRIES = 10
PROFILE_MARGIN_S = 0.02
PROFILE_MARGIN_MAX_S = 1.0
# The CUDA runtime calls that launch a kernel, and those that copy or fill
# (the port's kernels and PyTorch's go through the runtime).
LAUNCH_CALL = re.compile(r"^cudaLaunch(Cooperative)?Kernel\w*$")
COPY_CALL = re.compile(r"^cudaMem(cpy|set)\w*$")


def profile_margin(tries: int) -> float:
    """Seconds slept on either side of the call in trace ``tries`` (1 on)."""
    return min(PROFILE_MARGIN_S * 2 ** (tries - 1), PROFILE_MARGIN_MAX_S)


def kernel_name(event) -> str:
    """"void (anonymous namespace)::place<true>(int const*, ...)" → "place"."""
    match = re.search(r"::([A-Za-z_]\w*)[<(]", event.name)
    return match.group(1) if match else event.name[:32]


@dataclasses.dataclass
class Trace:
    """One traced call: its profile, wall ms (ending in synchronize()),
    device events, and the host's kernel launches and copy or fill calls."""
    prof: object
    wall: float
    device: list
    launches: int
    copy_calls: int

    @property
    def kernels(self) -> int:
        return sum(1 for e in self.device if not e.name.startswith(("Memcpy", "Memset")))

    @property
    def complete(self) -> bool:
        # A rehearsal on the CPU (DEVICE "cpu") has no device to trace.
        return DEVICE != "cuda" or self.kernels == self.launches > 0

    def counts(self) -> str:
        return (f"{self.kernels} kernels for {self.launches} launches, "
                f"{len(self.device) - self.kernels} copies or fills for {self.copy_calls} calls")


def traced(fn, tries: int) -> Trace:
    """``fn()`` under torch.profiler, host and device, with
    ``profile_margin(tries)`` slept on either side."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(profile_margin(tries))
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(profile_margin(tries))
    events = prof.events()
    host = [e.name for e in events if not str(e.device_type).endswith("CUDA")]
    return Trace(prof, wall, [e for e in events if str(e.device_type).endswith("CUDA")],
                 sum(1 for n in host if LAUNCH_CALL.match(n)),
                 sum(1 for n in host if COPY_CALL.match(n)))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def host_clock_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of host code ``fn`` (perf_counter)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, calls: int = 20) -> tuple:
    """Device time of ``fn`` under torch.profiler, after a warm call: (ms
    per call of all its device work, {kernel, copy or fill name: ms per
    call}), or (None, {}) when none of PROFILE_TRIES traces is complete.
    Unlike CUDA events around a loop of calls it leaves out the host's time
    between launches."""
    fn()
    for tries in range(1, PROFILE_TRIES + 1):
        trace = traced(lambda: [fn() for _ in range(calls)], tries)
        if trace.complete:
            by_name: dict = {}
            for e in trace.device:
                name = kernel_name(e)
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
            return sum(by_name.values()), by_name
    log(f"      (no complete trace in {PROFILE_TRIES}, the last with {trace.counts()}: device "
        "time not measured)")
    return None, {}


def device_text(ms: Optional[float], parts: Optional[dict] = None) -> str:
    """:func:`device_time`'s result for a log line."""
    if ms is None:
        return "not measured"
    inner = ", ".join(f"{m} {v:.5f}" for m, v in (parts or {}).items())
    return f"{ms:.5f} ms" + (f" ({inner})" if inner else "")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): each input byte read once and
    each output byte written once at the memory rate, against the
    operations at the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _counters() -> tuple:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import (
        filters_cuda, fuse_prep_cuda, morph_cuda, segsum_cuda, spatial_cuda, zresolve_cuda,
    )

    return (zresolve_cuda.launches, filters_cuda.launches, segsum_cuda.launches,
            fuse_prep_cuda.launches, morph_cuda.launches, spatial_cuda.launches)


def reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


# -- phase 2: resolve kernels ----------------------------------------------


def resolve_entries(n: int, n_px: int, seed: int, device):
    """Entries like the render's: duplicate pixels, z ties, empty pixels,
    invalid ids with MAX fields, and ids past the image."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INT32_MAX, INVALID_PIX

    g = torch.Generator(device=device).manual_seed(seed)
    pix = torch.randint(0, n_px - n_px // 8, (n,), generator=g, device=device, dtype=torch.int32)
    z_tie = torch.randint(1, 64, (n,), generator=g, device=device, dtype=torch.int32)
    z_wide = torch.randint(1, 1 << 30, (n,), generator=g, device=device, dtype=torch.int32)
    coin = torch.rand(n, generator=g, device=device)
    z = torch.where(coin < 0.5, z_tie, z_wide)
    rgb = torch.randint(0, 1 << 24, (n,), generator=g, device=device, dtype=torch.int32)
    invalid = torch.rand(n, generator=g, device=device) < 0.15
    pix = torch.where(invalid, INVALID_PIX, pix)
    z = torch.where(invalid, INT32_MAX, z)
    rgb = torch.where(invalid, INT32_MAX, rgb)
    pix = torch.where(torch.rand(n, generator=g, device=device) < 0.01, -1, pix)
    return pix, z, rgb


def real_resolve_feed(scene: Scene) -> tuple:
    """The resolve's arguments in a warm dual ``tiled`` frame (vertical,
    mirrored, with the z-buffer) of ``scene``, recorded from
    ``FusionPipeline.process``: the masked feed (idx, z, ok, rgb24) as flat
    tensors, and n_px. The entries lie in camera-pixel order, as the render
    makes them."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
    from pointcloud_depthfusion_tpu_torch.ops import render as R

    intr, fs = framesets(scene, DEVICE)
    cfg = FusionConfig.create(vertical_image=True, mirror_image=True, device=DEVICE)
    pipe = FusionPipeline(intr, cfg, device=DEVICE)
    pipe.set_right_transform(scene.t_rl)
    left, right = fs[0]
    pipe.process(left, right)
    seen = []
    inner = R._resolve_exact

    def record(idx, zc, ok, rgb24, n_px, need_zbuf):
        seen.append((idx, zc, ok, rgb24, n_px))
        return inner(idx, zc, ok, rgb24, n_px, need_zbuf)

    R._resolve_exact = record
    try:
        pipe.process(left, right)
    finally:
        R._resolve_exact = inner
    torch.cuda.synchronize()
    idx, zc, ok, rgb24, n_px = seen[-1]
    return (idx.reshape(-1).contiguous(), zc.reshape(-1).contiguous(),
            ok.reshape(-1).contiguous(), rgb24.reshape(-1).contiguous(), n_px)


def masked_entries(idx, zc, ok, rgb24) -> tuple:
    """The JAX API's (pix, zbits, rgb) of a masked feed: the ``torch.where``
    composition the render ran before the masked kernel (INVALID_PIX and
    INT32_MAX where ``ok`` is off)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INT32_MAX, INVALID_PIX

    return (torch.where(ok, idx, INVALID_PIX), torch.where(ok, zc.view(torch.int32), INT32_MAX),
            torch.where(ok, rgb24, INT32_MAX))


def synthetic_feed(n: int, n_px: int, seed: int) -> tuple:
    """:func:`resolve_entries` as a masked feed (idx, z, ok, rgb24, n_px):
    ``ok`` off on the invalid entries, whose :func:`masked_entries` are
    then the entries themselves."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INVALID_PIX

    pix, z, rgb = resolve_entries(n, n_px, seed, DEVICE)
    return pix, z.view(torch.float32), pix != INVALID_PIX, rgb, n_px


def contention_feed(n: int, n_px: int, seed: int) -> tuple:
    """A masked feed of ``n`` entries on ``n_px`` pixels (many a pixel), z
    from four values so that rgb breaks most ties, a tenth masked off."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(0, n_px, (n,), generator=g, device=DEVICE, dtype=torch.int32)
    z = torch.randint(1, 5, (n,), generator=g, device=DEVICE, dtype=torch.int32) << 23
    rgb = torch.randint(0, 1 << 24, (n,), generator=g, device=DEVICE, dtype=torch.int32)
    ok = torch.rand(n, generator=g, device=DEVICE) >= 0.1
    return idx, z.view(torch.float32), ok, rgb, n_px


def keys_clean() -> bool:
    """Every key buffer of the resolve all-ones, as each call must leave it."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    torch.cuda.synchronize()
    return all(bool((k == -1).all()) for k in Z._key_buffers.values())


# The kernel line's row of each resolve that is not a JAX API wrapper.
ERR_ROWS = {"depth-only": "zresolve_sorted_entries", "masked B2": "zresolve_sorted_entries",
            "masked B1": "zresolve_winner_rgb"}


def check_feed(label: str, feed: tuple, errs: dict) -> None:
    """Every resolve of a masked feed against its plain version on the card
    and on the CPU, bit for bit: B2, B2-legacy, B1 and the depth-only B2 on
    the JAX API's entries (:func:`masked_entries`), and B1/B2 on the masked
    feed itself; then every key buffer must be all-ones again."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    idx, zf, ok, rgb24, n_px = feed
    pix, z, rgb = masked_entries(idx, zf, ok, rgb24)
    host = [t.cpu() for t in (pix, z, rgb)]
    host_feed = [t.cpu() for t in (idx, zf, ok, rgb24)]
    cases = {
        "zresolve_sorted_entries": (lambda e: Z.zresolve_sorted_entries(*e, n_px), (pix, z, rgb),
                                    host, lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px)),
        "zresolve_sorted_entries_legacy": (
            lambda e: Z.zresolve_sorted_entries(*e, n_px, legacy_feed=True), (pix, z, rgb), host,
            lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px)),
        "zresolve_winner_rgb": (lambda e: (Z.zresolve_winner_rgb(*e, n_px),), (pix, z, rgb), host,
                                lambda: (Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px),)),
        "depth-only": (lambda e: Z.zresolve_sorted_entries(e[0], e[1], None, n_px), (pix, z, rgb),
                       host, lambda: Z.zresolve_sorted_entries_plain(pix, z, None, n_px)),
        "masked B2": (lambda e: Z.zresolve_masked(*e, n_px, True), (idx, zf, ok, rgb24),
                      host_feed, lambda: Z.zresolve_masked_plain(idx, zf, ok, rgb24, n_px, True)),
        "masked B1": (lambda e: Z.zresolve_masked(*e, n_px, False)[:1], (idx, zf, ok, rgb24),
                      host_feed, lambda: Z.zresolve_masked_plain(idx, zf, ok, rgb24, n_px, False)[:1]),
    }
    worst, results = {}, {}
    for name, (run, card_in, cpu_in, plain) in cases.items():
        got, want, cpu = run(card_in), plain(), run(cpu_in)
        results[name] = got
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst[name] = err
        if not all(torch.equal(a, b) and torch.equal(a.cpu(), c)
                   for a, b, c in zip(got, want, cpu)):
            raise AssertionError(f"resolve {name} on {label} differs from plain: {err}")
        row = ERR_ROWS.get(name, name)
        errs[row] = max(errs[row], err)
    if not keys_clean():
        raise AssertionError(f"resolve on {label} left a key buffer dirty")
    n_in = int(((pix >= 0) & (pix < n_px)).sum())
    empty = float((results["zresolve_sorted_entries"][0] == Z.INT32_MAX).float().mean())
    log(f"[2] resolve {label} (N={pix.numel()} n_px={n_px}, {n_in} entries inside, empty "
        f"fraction {empty:.4f}): {', '.join(f'{k} {v}' for k, v in worst.items())} max_abs_err; "
        f"each bit-exact to its plain version on the card and to the CPU; key buffers all-ones")


def phase_resolve(scenes, errs: dict) -> None:
    """B1/B2 (and the masked feed, B2-legacy, the depth-only resolve) on
    synthetic entries at both fused sizes, on the real entries of a warm
    ``tiled`` frame of each scene, on 100,000 entries over 64 pixels, on
    entries all invalid, and through a sequence of growing and shrinking
    n_px over one stream's persistent key buffer."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INVALID_PIX

    for n_px in (407_040, 921_600):
        check_feed(f"synthetic n_px={n_px}", synthetic_feed(2 * n_px, n_px, seed=n_px), errs)
    for scene in scenes:
        check_feed(f"real dual {scene.w}x{scene.h} tiled frame", real_resolve_feed(scene), errs)
    check_feed("contention (100,000 entries on 64 pixels)", contention_feed(100_000, 64, 64), errs)
    idx, zf, ok, rgb24, _ = synthetic_feed(4096, 1000, seed=11)
    check_feed("all invalid", (torch.full_like(idx, INVALID_PIX), zf, ok, rgb24, 1000), errs)
    # Grow, shrink, grow: every call on the one buffer, with other entries.
    for k, n_px in enumerate((1000, 407_040, 5000, 921_600, 64, 407_040, 1_000_000)):
        check_feed(f"grow/shrink step {k}", synthetic_feed(2 * n_px + 3, n_px, seed=100 + k), errs)


# -- phase 3: 3×3 filter kernel ----------------------------------------------


def phase_filters(errs: dict) -> None:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    g = torch.Generator(device=DEVICE).manual_seed(3)
    for h, w in ((480, 848), (848, 480), (720, 1280), (1280, 720), (1, 1), (2, 5)):
        planes = {
            "random": torch.randint(0, 256, (h, w), generator=g, device=DEVICE, dtype=torch.uint8),
            "ties": torch.randint(0, 2, (h, w), generator=g, device=DEVICE, dtype=torch.uint8),
            "zeros": torch.zeros((h, w), device=DEVICE, dtype=torch.uint8),
            "full": torch.full((h, w), 255, device=DEVICE, dtype=torch.uint8),
        }
        for kind, p in planes.items():
            for name, kernel, plain in (
                ("gauss3x3_image", B4.gauss3x3_plane, B4.gauss3x3_plane_plain),
                ("median3x3_image", B4.median3x3_plane, B4.median3x3_plane_plain),
            ):
                got, want = kernel(p), plain(p)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs[name] = max(errs[name], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs from plain on {kind} {h}x{w}: {err}")
        log(f"[3] per-plane B4 {h}x{w}: gauss and median bit-exact on random/ties/zeros/full")
    phase_image_filters(errs)


def image_inputs(h: int, w: int, g: torch.Generator) -> tuple:
    """The image kernel's inputs at h×w: packed winners (h·w,) int32 with
    uncovered pixels (INT32_MAX) and channels in {0, 1} on a third of the
    pixels (Gauss rounding ties), and an (h, w, 3) u8 image."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    n = h * w
    wide = torch.randint(0, 1 << 24, (n,), generator=g, device=DEVICE, dtype=torch.int32)
    bits = torch.randint(0, 8, (n,), generator=g, device=DEVICE, dtype=torch.int32)
    ties = ((bits >> 2) << 16) | (((bits >> 1) & 1) << 8) | (bits & 1)
    coin = torch.rand(n, generator=g, device=DEVICE)
    mrgb = torch.where(coin < 0.3, ties, wide)
    mrgb = torch.where(torch.rand(n, generator=g, device=DEVICE) < 0.2, B4.INT32_MAX, mrgb)
    img = torch.randint(0, 256, (h, w, 3), generator=g, device=DEVICE, dtype=torch.uint8)
    return mrgb, img


def phase_image_filters(errs: dict) -> None:
    """B4's image kernel in every input form and mode against its plain
    version on the card and on the CPU, bit for bit: the fused frames'
    shapes at both sizes (vertical and landscape), odd widths, and images
    under 3×3."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    g = torch.Generator(device=DEVICE).manual_seed(31)
    for h, w in IMAGE_SIZES:
        mrgb, img = image_inputs(h, w, g)
        planes = [img[..., c].contiguous() for c in range(3)]

        def winner(t, mode, fn=B4.winner_image):
            return fn(t, h, w, mode)

        def winner_plain(t, mode):
            return B4.winner_image_plain(t, h, w, mode)

        cases = {
            "winner": (winner, winner_plain, mrgb),
            # data 4 B past a 16 B boundary: the kernel's scalar loads
            "winner +4 B": (winner, winner_plain, torch.cat([mrgb[:1], mrgb])[1:]),
            "winner batch of 2": (winner, winner_plain, torch.stack([mrgb, mrgb.flip(0)])),
            "planes": (B4.planes_image, B4.planes_image_plain, planes),
            "interleaved C=3": (B4.interleaved_image, B4.interleaved_image_plain, img),
            "interleaved C=2": (B4.interleaved_image, B4.interleaved_image_plain,
                                img[..., 1:].contiguous()),
            "interleaved C=4": (B4.interleaved_image, B4.interleaved_image_plain,
                                torch.cat([img, planes[0][..., None]], dim=-1)),
            "plane C=1": (B4.interleaved_image, B4.interleaved_image_plain, planes[1]),
        }
        for what, (kernel, plain, x) in cases.items():
            host_x = [t.cpu() for t in x] if isinstance(x, list) else x.cpu()
            for mode, name in IMAGE_MODES.items():
                got, want, host = kernel(x, mode), plain(x, mode), kernel(host_x, mode)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs[name] = max(errs[name], err)
                if not (torch.equal(got, want) and torch.equal(got.cpu(), host)):
                    raise AssertionError(f"{name} differs from plain: {what} {h}x{w}: {err}")
        log(f"[3] image kernel {h}x{w}: {', '.join(cases)}; copy, gauss and median bit-exact to "
            f"the plain version on the card and to the CPU")


# -- phases 4-5: the main path ---------------------------------------------


@dataclasses.dataclass
class Scene:
    w: int
    h: int
    frames: list  # [(left HostFrameset, right HostFrameset)]
    t_rl: np.ndarray
    t_rl2: np.ndarray


def yaw_bump(deg: float, m: float) -> np.ndarray:
    """A 4×4 that turns by ``deg`` of yaw (about y) and shifts by ``m``
    along x."""
    a = np.deg2rad(deg)
    out = np.eye(4)
    out[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    out[0, 3] = m
    return out


def build_scene(w: int, h: int, n_pairs: int = 2) -> Scene:
    """The bench scene: fx = 631·w/848, baseline 0.6, toe-in 10°, noise
    0.002, holes 0.01; pair k uses seeds (2k, 2k+1)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.io.synthetic import (
        SyntheticScene, right_to_left_transform, two_camera_rig,
    )

    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    frames = [
        tuple(scene.render(intr, pose, depth_noise_std=0.002, hole_fraction=0.01,
                           seed=2 * k + i, timestamp=k / 30.0)
              for i, pose in enumerate((wl, wr)))
        for k in range(n_pairs)
    ]
    t_rl = right_to_left_transform(wl, wr).astype(np.float32)
    # A registration update partway: 1 cm and 0.5° of yaw.
    return Scene(w, h, frames, t_rl, (yaw_bump(0.5, 0.01) @ t_rl).astype(np.float32))


def framesets(scene: Scene, device: str, aligned: bool = False, n_pairs: Optional[int] = None):
    """(color intrinsics, [(left, right) Framesets]): the scene's pairs, or
    ``n_pairs`` of them cycling through the scene, each pair new Framesets
    (new frame and depth-scale tensors, as the feeders deliver them) of one
    calibration; ``aligned``: the depth comes from a depth camera of its own
    (ALIGN_FOCAL, ALIGN_T)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset

    fx = 631.0 * scene.w / 848.0
    intr = Intrinsics.create(scene.w, scene.h, fx=fx, fy=fx, ppx=scene.w / 2,
                             ppy=scene.h / 2, device=device)
    calib = {}
    if aligned:
        calib = dict(
            depth_intrinsics=Intrinsics.create(
                scene.w, scene.h, fx=ALIGN_FOCAL * fx, fy=ALIGN_FOCAL * fx,
                ppx=scene.w / 2 + 1.5, ppy=scene.h / 2 - 1.0, device=device),
            depth_to_color=Extrinsics.create(np.eye(3), ALIGN_T, device=device))
    pairs = scene.frames if n_pairs is None else [
        scene.frames[k % len(scene.frames)] for k in range(n_pairs)]
    return intr, [
        tuple(Frameset.create(f.depth, f.color, intr, depth_scale=f.depth_scale,
                              timestamp=f.timestamp, device=device, **calib) for f in pair)
        for pair in pairs
    ]


def mismatch(gpu, cpu):
    """(image, coverage, z-outside-ulp-envelope, z-bitwise) mismatch
    fractions of a GPU result against the CPU one."""
    img = float((gpu.image.cpu() != cpu.image).any(-1).float().mean())
    zg, zc = gpu.zbuf.cpu().numpy(), cpu.zbuf.numpy()
    cov = float(((zg == ZMAX) != (zc == ZMAX)).mean())
    z_env = float((~np.isclose(zg, zc, rtol=2e-6, atol=1e-6)).mean())
    z_bits = float((zg != zc).mean())
    return img, cov, z_env, z_bits


def drive_main_path(scene: Scene, n_frames: int, n_median: int, tag: str) -> dict:
    """Run ``n_frames`` through FusionPipeline.process on the GPU (with and
    without the z-buffer) and on the CPU, with a registration update
    halfway, then ``n_median`` frames with the median filter. Returns the
    expected launch counts."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    intr_g, fs_g = framesets(scene, DEVICE)
    intr_c, fs_c = framesets(scene, "cpu")
    worst = [0.0, 0.0, 0.0, 0.0]
    for median, count in ((False, n_frames), (True, n_median)):
        cfg = FusionConfig.create(vertical_image=True, mirror_image=True, use_median_filter=median,
                                  device=DEVICE)
        gpu = FusionPipeline(intr_g, cfg, device=DEVICE)
        gpu_img = FusionPipeline(intr_g, dataclasses.replace(cfg, emit_zbuf=False), device=DEVICE)
        cpu = FusionPipeline(intr_c, cfg, device="cpu")
        for k in range(count):
            t = scene.t_rl if k < count // 2 else scene.t_rl2
            for p in (gpu, gpu_img, cpu):
                p.set_right_transform(t)
            (gl, gr), (cl, cr) = fs_g[k % len(fs_g)], fs_c[k % len(fs_c)]
            rg = gpu.process(gl, gr)
            ri = gpu_img.process(gl, gr)
            rc = cpu.process(cl, cr)
            torch.cuda.synchronize()
            if rg.image.shape != (scene.w, scene.h, 3) or rg.image.dtype != torch.uint8:
                raise AssertionError(f"fused image {tuple(rg.image.shape)} {rg.image.dtype}")
            if not torch.equal(ri.image, rg.image) or ri.zbuf is not None:
                raise AssertionError(f"{tag} frame {k}: emit_zbuf=False image differs")
            zb = rg.zbuf[rg.zbuf < ZMAX]
            coverage = zb.numel() / rg.zbuf.numel()
            if coverage < 0.5 or not bool(torch.isfinite(zb).all()) or not bool((zb > 0).all()):
                raise AssertionError(f"{tag} frame {k}: coverage {coverage} or bad depths")
            fr = mismatch(rg, rc)
            worst = [max(a, b) for a, b in zip(worst, fr)]
            log(f"[main {tag}] frame {k} median={median}: coverage={coverage:.4f} "
                f"vs CPU: image={fr[0]:.6g} coverage={fr[1]:.6g} z_outside_ulp={fr[2]:.6g} "
                f"z_bitwise={fr[3]:.6g}; emit_zbuf False/True images identical")
            if max(fr[:3]) > PIXEL_BUDGET:
                raise AssertionError(f"{tag} frame {k}: GPU vs CPU mismatch {fr}")
    log(f"[main {tag}] worst GPU-vs-CPU mismatch: image={worst[0]:.6g} coverage={worst[1]:.6g} "
        f"z_outside_ulp={worst[2]:.6g} z_bitwise={worst[3]:.6g} (budget {PIXEL_BUDGET})")
    return {
        "zresolve_sorted_entries": n_frames + n_median,
        "zresolve_winner_rgb": n_frames + n_median,
        # The prep of both cameras and the color tail: one launch each a
        # frame.
        "fuse_prep": 2 * (n_frames + n_median),
        "gauss3x3_image": 2 * n_frames,
        "median3x3_image": 2 * n_median,
    }


# -- phase 10: the fused prep (B3) and the u32 scatter-min --------------------


def dual_prep(scene: Scene, t_rl: np.ndarray, mirror: bool) -> tuple:
    """B3's inputs for the first frame pair of ``scene`` under ``t_rl``, as
    FusionPipeline.process passes them (the two framesets' frames as
    separate tensors): (depth, color, depth_scale, cam_to_virtual), the
    cameras, and the fused pixel count."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import (
        FusionConfig, _z_range, fused_poses,
    )
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    intr, fs = framesets(scene, DEVICE)
    cfg = FusionConfig.create(vertical_image=True, mirror_image=mirror, device=DEVICE)
    fi = fused_virtual_intrinsics(intr, True)
    poses = fused_poses(cfg, torch.as_tensor(t_rl, device=DEVICE))
    left, right = fs[0]
    cams = B3.prep_cameras((left.color_intrinsics, right.color_intrinsics), fi, cfg.min_depth,
                           cfg.max_depth, mirror, z_near=_z_range(cfg)[0],
                           z_far=_z_range(cfg)[1])
    args = ((left.depth, right.depth), (left.color, right.color),
            (left.depth_scale, right.depth_scale), poses)
    return args, cams, fi.width * fi.height


def rig_prep(rig: Rig, per_camera: bool, offsets: int = 0) -> tuple:
    """B3's inputs for frame 0 of ``rig`` as rig_fuse passes them: its
    stacked (N, H, W) frames and the cameras; ``per_camera`` gives the first
    RIG_CAMERAS of them the per-camera inverse Brown-Conrady intrinsics and
    RIG_ROIS; camera i's pixel offset is i·``offsets``."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    n = RIG_CAMERAS if per_camera else rig.n
    args = [t[:n].contiguous() for t in rig_args(rig, 0, DEVICE)]
    intr = rig_intrinsics(rig.w, rig.h, per_camera, device=DEVICE)
    ref = intr[0] if per_camera else intr
    cfg = FusionConfig.create(device=DEVICE, **RIG_CONFIG)
    cams = B3.prep_cameras(intr if per_camera else (intr,) * n,
                           fused_virtual_intrinsics(ref, False), cfg.min_depth, cfg.max_depth,
                           False, rois=RIG_ROIS if per_camera else None,
                           pix_offsets=[i * offsets for i in range(n)])
    return args, cams


def host_cams(cams):
    """The same cameras with every tensor on the CPU."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    return B3.prep_cameras([i.to("cpu") for i in cams.intrinsics], cams.fused.to("cpu"),
                           cams.min_depth.cpu(), cams.max_depth.cpu(), cams.mirror,
                           rois=cams.rois, pix_offsets=cams.pix_offsets, z_near=cams.z_near.cpu(),
                           z_far=cams.z_far.cpu(), device="cpu")


def on_host(args):
    return [t.cpu() if isinstance(t, torch.Tensor) else [u.cpu() for u in t] for t in args]


def check_prep(label: str, args, cams, errs: dict, feed: bool = True,
               per_stream: bool = False) -> tuple:
    """B3 (output (b) with ``feed``, else (a)) against its plain version on
    the card and on the CPU, bit for bit; returns the kernel's outputs."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    if feed:
        got = B3.fuse_prep_feed(*args, cams, per_stream)
        want = B3.fuse_prep_feed_plain(*args, cams, per_stream)
        cpu = B3.fuse_prep_feed(*on_host(args), host_cams(cams), per_stream)
    else:
        got = B3.fuse_prep_keys(*args, cams)
        want = B3.fuse_prep_keys_plain(*args, cams)
        cpu = B3.fuse_prep_keys(*on_host(args), host_cams(cams))
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    exact = all(torch.equal(a, b) and torch.equal(a.cpu(), c) for a, b, c in zip(got, want, cpu))
    ok = got[2] if feed else got[1] != -1
    log(f"[10] fuse_prep ({'b' if feed else 'a'}) {label} (N={cams.n}): max_abs_err={err} "
        f"bit-exact to plain on the card and the CPU: {exact}; entries kept "
        f"{float(ok.float().mean()):.4f}, valid {float(got[-1].float().mean()):.4f}")
    if not exact:
        raise AssertionError(f"B3 {label} differs from its plain version")
    errs["fuse_prep"] = max(errs["fuse_prep"], err)
    return got


def check_scatter(label: str, feed: tuple, n_slots: int, errs: dict, rig_span: bool = False):
    """Every scatter-min variant on a masked feed against its plain version
    on the card and on the CPU, bit for bit: the packed keys built by the
    kernel (raw, decoded, decoded with the z-buffer) and given (the same
    three); then the key buffer must be all-ones again."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    zparams = Z.packed_zparams(0.25, 4.5, DEVICE, span=4.25 if rig_span else None)
    key = Z.packed_keys_plain(*feed[1:], zparams)
    host_feed, host_key, host_z = [t.cpu() for t in feed], key.cpu(), zparams.cpu()
    variants = {}
    for planes, need_zbuf, name in ((False, False, "raw"), (True, False, "planes"),
                                    (True, True, "planes+zbuf")):
        variants[f"feed {name}"] = (
            lambda f, z, p=planes, nz=need_zbuf: Z.scatter_min_packed(*f[:4], n_slots, z, p, nz),
            lambda p=planes, nz=need_zbuf: Z.scatter_min_packed_plain(*feed, n_slots, zparams,
                                                                      p, nz))
        variants[f"keys {name}"] = (
            lambda f, z, p=planes, nz=need_zbuf: Z.scatter_min_u32(f[0], f[4], n_slots, z, p,
                                                                   nz),
            lambda p=planes, nz=need_zbuf: Z.scatter_min_u32_plain(feed[0], key, n_slots,
                                                                   zparams, p, nz))
    worst = 0
    for name, (run, plain) in variants.items():
        got = run((*feed, key), zparams)
        want, cpu = plain(), run((*host_feed, host_key), host_z)
        torch.cuda.synchronize()
        got, want, cpu = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, want, cpu))
        err = max((max_abs_err(a, b) for a, b in zip(got, want) if a is not None), default=0)
        same = all((a is None and b is None and c is None)
                   or (torch.equal(a, b) and torch.equal(a.cpu(), c))
                   for a, b, c in zip(got, want, cpu))
        if not same:
            raise AssertionError(f"scatter-min {name} on {label} differs from plain: {err}")
        worst = max(worst, err)
    if not keys_clean():
        raise AssertionError(f"scatter-min on {label} left the key buffer dirty")
    errs["scatter_min_u32"] = max(errs["scatter_min_u32"], worst)
    n_in = int((feed[2] & (feed[0] >= 0) & (feed[0] < n_slots)).sum())
    log(f"[10] scatter_min_u32 {label} (N={feed[0].numel()} n_slots={n_slots}, {n_in} kept, "
        f"{'rig' if rig_span else 'dual'} span): {len(variants)} variants bit-exact to their "
        f"plain versions on the card and the CPU, max_abs_err {worst}; key buffer all-ones")


def packed_feed(n: int, n_slots: int, seed: int, ok_frac: float = 0.85) -> tuple:
    """A masked feed for the scatter-min: slots with duplicates, ids past
    the slots, z across and beyond the packed range, rgb24 over 24 bits."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(-1, n_slots + n_slots // 8, (n,), generator=g, device=DEVICE,
                        dtype=torch.int32)
    z = torch.rand(n, generator=g, device=DEVICE) * 5.0 + 0.05
    ok = torch.rand(n, generator=g, device=DEVICE) < ok_frac
    rgb24 = torch.randint(0, 1 << 24, (n,), generator=g, device=DEVICE, dtype=torch.int32)
    return idx, z, ok, rgb24


def phase_prep(scenes, errs: dict) -> Rig:
    """B3 and the scatter-min against their plain versions, bit for bit.
    B3's feed (b) on both cameras of each dual size under both registration
    transforms, mirror on and off, and on the 8-camera 848×480 rig (flat,
    per-stream with pixel offsets, and its first RIG_CAMERAS cameras with
    inverse Brown-Conrady intrinsics and RIG_ROIS); its packed keys (a) for
    both cameras in one launch and through the one-camera JAX API. The
    scatter-min in every variant on synthetic entries, on the real feed and
    keys of each dual frame, on 100,000 entries over 64 slots, on entries
    all invalid, on none, and through growing and shrinking n_slots on one
    key buffer. Returns the rig (for phase 6)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    for scene in scenes:
        size = f"dual {scene.w}x{scene.h}"
        for t_rl, t_name in ((scene.t_rl, "t_rl"), (scene.t_rl2, "t_rl2")):
            for mirror in (False, True):
                args, cams, n_px = dual_prep(scene, t_rl, mirror)
                label = f"{size} mirror={mirror} pose {t_name}"
                feed = check_prep(label, args, cams, errs)
                idx, key, _ = check_prep(label, args, cams, errs, feed=False)
                # The one-camera JAX API: one launch each, the same keys.
                for i in range(2):
                    one = [t[i] for t in args]
                    got = B3.fuse_prep(one[0], one[1], one[2], cams.min_depth, cams.max_depth,
                                       cams.intrinsics[i], one[3], cams.fused, mirror,
                                       cams.z_near, cams.z_far)
                    want = B3.fuse_prep_plain(one[0], one[1], one[2], cams.min_depth,
                                              cams.max_depth, cams.intrinsics[i], one[3],
                                              cams.fused, mirror, cams.z_near, cams.z_far)
                    sl = slice(i * idx.numel() // 2, (i + 1) * idx.numel() // 2)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a.reshape(-1), b.reshape(-1))
                               for a, b in zip(got, want)) or not torch.equal(
                                   got[1].reshape(-1), key[sl]):
                        raise AssertionError(f"fuse_prep one camera {label} differs")
                if mirror and t_name == "t_rl":
                    check_scatter(f"real {size} feed", feed[:4], n_px, errs)
    rig = build_rig(8, 848, 480, n_frames=1)
    args, cams = rig_prep(rig, False)
    check_prep("rig 8x848x480", args, cams, errs)
    args, cams = rig_prep(rig, False, offsets=407_040 // 8)
    check_prep("rig 8x848x480 per-stream, pixel offsets", args, cams, errs, per_stream=True)
    args, cams = rig_prep(rig, True)
    check_prep(f"rig {RIG_CAMERAS}x848x480 inverse Brown-Conrady, ROIs", args, cams, errs)
    n_px = 848 * 480
    check_scatter("synthetic 848x480", packed_feed(2 * n_px, n_px, 5), n_px, errs)
    check_scatter("synthetic 848x480", packed_feed(2 * n_px, n_px, 6), n_px, errs, rig_span=True)
    check_scatter("contention (100,000 entries on 64 slots)", packed_feed(100_000, 64, 64), 64,
                  errs)
    check_scatter("all invalid", packed_feed(4096, 1000, 11, ok_frac=0.0), 1000, errs)
    check_scatter("no entries", packed_feed(0, 1000, 12), 1000, errs)
    for k, n_slots in enumerate((1000, 407_040, 5000, 921_600, 64, 407_040, 1_000_000)):
        check_scatter(f"grow/shrink step {k}", packed_feed(2 * n_slots + 3, n_slots, 100 + k),
                      n_slots, errs)
    return rig


def phase_align(scenes) -> None:
    """The depth→color alignment alone (B2 on the card, its plain version on
    the CPU) on every frame of the aligned framesets: the fraction of
    aligned depth pixels that differ, within PIXEL_BUDGET."""
    from pointcloud_depthfusion_tpu_torch.ops.align import align_depth_to_color

    for scene in scenes:
        (_, fs_g), (_, fs_c) = framesets(scene, DEVICE, True), framesets(scene, "cpu", True)
        for k, (pair_g, pair_c) in enumerate(zip(fs_g, fs_c)):
            for side, g, c in zip(("left", "right"), pair_g, pair_c):
                a_g, a_c = (align_depth_to_color(f.depth, f.depth_scale, f.depth_intrinsics,
                                                 f.color_intrinsics, f.depth_to_color, "auto")
                            for f in (g, c))
                torch.cuda.synchronize()
                frac = float((a_g.cpu() != a_c).float().mean())
                log(f"[10] align dual {scene.w}x{scene.h} pair {k} {side}: aligned depth card vs "
                    f"CPU differs on {frac:.6g} of pixels; nonzero {float((a_c > 0).float().mean()):.4f}")
                if frac > PIXEL_BUDGET:
                    raise AssertionError(f"align card vs CPU {frac} > {PIXEL_BUDGET}")


# -- phase 11: the other render modes and alignment ---------------------------


def mode_config(mode: str, **kw):
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig

    render = "tiled" if mode == "tiled+align" else mode
    return FusionConfig.create(vertical_image=True, mirror_image=True, render_mode=render,
                               align_frames=mode == "tiled+align", **kw)


def qstep(mode: str, n_pts: int) -> float:
    """One depth quantization step at the default window (z_near 0.25 m,
    z_far 4 m): 14 bits, or what the indexed key leaves of 32."""
    bits = 14 if mode != "indexed" else 32 - max(1, n_pts.bit_length())
    return 3.75 / ((1 << bits) - 1)


def envelope(gpu, cpu, step: float) -> tuple:
    """(coverage, z beyond two steps, color) mismatch fractions
    (tpu_check.py:417-451)."""
    zg, zc = gpu.zbuf.cpu().numpy(), cpu.zbuf.numpy()
    cg, cc = zg != ZMAX, zc != ZMAX
    both = cg & cc
    z_bad = float((np.abs(zg[both] - zc[both]) > 2 * step).mean()) if both.any() else 0.0
    color = float((gpu.image.cpu() != cpu.image).any(-1).float().mean())
    return float((cg != cc).mean()), z_bad, color


def drive_modes(scene: Scene, n_frames: int, tag: str) -> dict:
    """``n_frames`` frames of each mode of MODES through
    FusionPipeline.process on the card and on the CPU, with a registration
    update halfway; the exact frames also run tiled on the card. Returns the
    expected launch counts."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionPipeline

    sets = {aligned: (framesets(scene, DEVICE, aligned), framesets(scene, "cpu", aligned))
            for aligned in (False, True)}
    n_pts = 2 * scene.w * scene.h
    packed_images = {}
    for mode in MODES:
        (intr_g, fs_g), (intr_c, fs_c) = sets[mode == "tiled+align"]
        gpu = FusionPipeline(intr_g, mode_config(mode, device=DEVICE), device=DEVICE)
        cpu = FusionPipeline(intr_c, mode_config(mode, device="cpu"), device="cpu")
        tiled = FusionPipeline(intr_g, mode_config("tiled", device=DEVICE), device=DEVICE)
        worst = [0.0, 0.0, 0.0]
        for k in range(n_frames):
            t = scene.t_rl if k < n_frames // 2 else scene.t_rl2
            for p in (gpu, cpu, tiled):
                p.set_right_transform(t)
            (gl, gr), (cl, cr) = fs_g[k % len(fs_g)], fs_c[k % len(fs_c)]
            rg = gpu.process(gl, gr)
            rc = cpu.process(cl, cr)
            rt = tiled.process(gl, gr) if mode == "exact" else None
            torch.cuda.synchronize()
            if rg.image.shape != (scene.w, scene.h, 3) or rg.zbuf.shape != (scene.w, scene.h):
                raise AssertionError(f"{mode}: image {tuple(rg.image.shape)}")
            zb = rg.zbuf[rg.zbuf < ZMAX]
            coverage = zb.numel() / rg.zbuf.numel()
            if coverage < 0.5 or not bool(torch.isfinite(zb).all()) or not bool((zb > 0).all()):
                raise AssertionError(f"{tag} {mode} frame {k}: coverage {coverage} or bad depths")
            extra = ""
            if mode in ("exact", "tiled+align"):
                fr = mismatch(rg, rc)[:3]
                ok = max(fr) <= PIXEL_BUDGET
                names = ("image", "coverage", "z_outside_ulp")
                if rt is not None:
                    same = torch.equal(rt.image, rg.image) and torch.equal(rt.zbuf, rg.zbuf)
                    extra = f"; bit-identical to tiled on the card: {same}"
                    ok &= same
            else:
                fr = envelope(rg, rc, qstep(mode, n_pts))
                ok = fr[0] <= PIXEL_BUDGET and fr[1] <= PIXEL_BUDGET and fr[2] <= COLOR_BUDGET
                names = ("coverage", "z_beyond_2_steps", "color")
                if mode == "packed":
                    packed_images[k] = rg.image
                if mode == "pallas":
                    vs = float((packed_images[k] != rg.image).any(-1).float().mean())
                    extra = f"; image vs packed on the card {vs:.6g} (bar {PALLAS_VS_PACKED})"
                    ok &= vs <= PALLAS_VS_PACKED
            worst = [max(a, b) for a, b in zip(worst, fr)]
            log(f"[11 {tag}] {mode} frame {k}: coverage={coverage:.4f} vs CPU: "
                + " ".join(f"{n}={v:.6g}" for n, v in zip(names, fr)) + extra)
            if not ok:
                raise AssertionError(f"{tag} {mode} frame {k}: card vs CPU {fr}{extra}")
        log(f"[11 {tag}] {mode} worst vs CPU: "
            + " ".join(f"{n}={v:.6g}" for n, v in zip(names, worst)))
    n = n_frames
    return {
        # exact: B2, and B2 again in its tiled twin; tiled+align: two B2
        # aligns and the tiled resolve.
        "zresolve_sorted_entries": 2 * n + 3 * n,
        "scatter_min_u32": 3 * n,
        # One B3 launch a frame in every mode, and in exact's tiled twin.
        "fuse_prep": (len(MODES) + 1) * n,
        "gauss3x3_image": (len(MODES) + 1) * n,
    }


# -- phase 6: timing ---------------------------------------------------------


def time_pipeline(scene: Scene, card: str, warmup: int = 5, iters: int = 30) -> dict:
    """ms/frame of the dual tiled frame, image only and with the z-buffer:
    every frame new Framesets, as the feeders deliver them."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    out = {}
    for zbuf in (False, True):
        cfg = FusionConfig.create(vertical_image=True, mirror_image=True, emit_zbuf=zbuf,
                                  device=DEVICE)
        intr, fs = framesets(scene, DEVICE, n_pairs=iters + warmup)
        pipe = FusionPipeline(intr, cfg, device=DEVICE)
        pipe.set_right_transform(scene.t_rl)
        pairs = iter(fs)
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: pipe.process(*next(pairs)), iters, warmup)
        host_ms = (time.perf_counter() - t0) * 1e3 / (iters + warmup)
        key = f"dual_{scene.w}x{scene.h}_{'zbuf' if zbuf else 'image_only'}"
        out[key] = ms
        log(f"[6] process {key}: {ms:.4f} ms/frame (CUDA events, {iters} new frame pairs after "
            f"{warmup} warm-up; host wall incl. warm-up {host_ms:.4f} ms/frame) on {card}")
    return out


def turns(kernel, plain, iters: int = 20) -> tuple:
    """(kernel ms, plain ms, each turn) timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def resolve_feeds(scenes) -> dict:
    """{label: masked feed (idx, z, ok, rgb24, n_px)}: the synthetic entries
    at dual 848×480 (uniformly random pixels; the kernel table's inputs
    since its first row), the real entries of a warm ``tiled`` frame of
    each scene, and 100,000 entries on 64 pixels (contention)."""
    n_px = 480 * 848
    feeds = {"synthetic 848x480": synthetic_feed(2 * n_px, n_px, seed=7)}
    for scene in scenes:
        feeds[f"real {scene.w}x{scene.h}"] = real_resolve_feed(scene)
    feeds["contention 100000 on 64"] = contention_feed(100_000, 64, 64)
    return feeds


def bare_resolve(pix, z, ok, rgb, n_px: int, minz, mrgb):
    """One launch of the resolve on prebuilt outputs and the stream's key
    buffer, with no checks: the launch alone, as the wrapper makes it."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    keys = Z._key_buffer(pix.device, stream, n_px)
    args = (pix.data_ptr(), z.data_ptr(), None if ok is None else ok.data_ptr(),
            None if rgb is None else rgb.data_ptr(), pix.numel(), ok is not None,
            rgb is not None, keys.data_ptr(), n_px, None if minz is None else minz.data_ptr(),
            None if mrgb is None else mrgb.data_ptr(), stream)
    return lambda: lib.zresolve_launch(*args)


def time_resolve(scenes, card: str) -> dict:
    """B1, B2, B2-legacy, the depth-only resolve and the masked feed's B1
    and B2 on each feed of :func:`resolve_feeds`: the wrapper (CUDA events
    around a loop of calls, in turns with the plain version), the
    profiler's device time by kernel, and the bare launch; beside the bound
    and ``scatter_reduce_``'s time on the same entries. Returns the
    synthetic feed's {name: (ms, plain_ms, library_ms, bound_ms, bound_by)}
    (the kernel table's row) and logs every feed."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    rows = {}
    for label, (idx, zf, ok, rgb24, n_px) in resolve_feeds(scenes).items():
        pix, z, rgb = masked_entries(idx, zf, ok, rgb24)
        n = pix.numel()
        # The library's resolve: one scatter_reduce_(amin) of prebuilt int64
        # keys (z bits high, rgb low) into a dump-slotted pixel buffer.
        slot = torch.where((pix >= 0) & (pix < n_px), pix, n_px).to(torch.int64)
        keys = (z.to(torch.int64) << 32) | (rgb.to(torch.int64) + (1 << 31))
        buf = torch.full((n_px + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                         device=DEVICE)
        library = cuda_ms(lambda: buf.scatter_reduce_(0, slot, keys, "amin", include_self=True),
                          20)
        minz = torch.empty(n_px, dtype=torch.int32, device=DEVICE)
        mrgb = torch.empty_like(minz)
        valid = float(((pix >= 0) & (pix < n_px)).float().mean())
        # 12 B in per entry (8 B depth-only, 13 B masked), 4-8 B out per
        # pixel; a compare and an atomic per entry.
        cases = {
            "zresolve_winner_rgb": (lambda: Z.zresolve_winner_rgb(pix, z, rgb, n_px),
                                    lambda: Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px),
                                    bare_resolve(pix, z, None, rgb, n_px, None, mrgb),
                                    bound(12 * n + 4 * n_px, 2 * n)),
            "zresolve_sorted_entries": (
                lambda: Z.zresolve_sorted_entries(pix, z, rgb, n_px),
                lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
                bare_resolve(pix, z, None, rgb, n_px, minz, mrgb), bound(12 * n + 8 * n_px, 2 * n)),
            "zresolve_sorted_entries_legacy": (
                lambda: Z.zresolve_sorted_entries(pix, z, rgb, n_px, legacy_feed=True),
                lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
                bare_resolve(pix, z, None, rgb, n_px, minz, mrgb), bound(12 * n + 8 * n_px, 2 * n)),
            "depth-only": (lambda: Z.zresolve_sorted_entries(pix, z, None, n_px),
                           lambda: Z.zresolve_sorted_entries_plain(pix, z, None, n_px),
                           bare_resolve(pix, z, None, None, n_px, minz, None),
                           bound(8 * n + 4 * n_px, 2 * n)),
            "masked B1": (lambda: Z.zresolve_masked(idx, zf, ok, rgb24, n_px, False),
                          lambda: Z.zresolve_masked_plain(idx, zf, ok, rgb24, n_px, False),
                          bare_resolve(idx, zf, ok, rgb24, n_px, None, mrgb),
                          bound(13 * n + 4 * n_px, 2 * n)),
            "masked B2": (lambda: Z.zresolve_masked(idx, zf, ok, rgb24, n_px, True),
                          lambda: Z.zresolve_masked_plain(idx, zf, ok, rgb24, n_px, True),
                          bare_resolve(idx, zf, ok, rgb24, n_px, minz, mrgb),
                          bound(13 * n + 8 * n_px, 2 * n)),
        }
        for name, (kernel, plain, bare, (b_ms, b_by)) in cases.items():
            k, p, each = turns(kernel, plain)
            dk, parts = device_time(kernel)
            bare_ms = cuda_ms(bare, 50)
            if label.startswith("synthetic") and name in REPLACES:
                rows[name] = (k, p, library, b_ms, b_by)
            log(f"[6] {name} on the {label} entries (N={n} n_px={n_px}, {valid:.4f} valid): "
                f"wrapper {k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}), device "
                f"{device_text(dk, parts)}, bare launch {bare_ms:.5f} ms, plain {p:.5f} ms "
                f"({each[2]:.5f}, "
                f"{each[3]:.5f}), library {library:.5f} ms (scatter_reduce_ amin), bound "
                f"{b_ms:.5f} ms by {b_by} on {card}")
    if not keys_clean():
        raise AssertionError("the timed resolves left a key buffer dirty")
    return rows


def time_kernels(card: str) -> dict:
    """The image kernel and its plain version at a vertical dual 848×480
    frame's shape: {name: (ms, plain_ms, library_ms or None, bound_ms,
    bound_by)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    pairs = {}
    # The image kernel on the packed winner of a vertical dual 848×480
    # frame ((H, W) = (848, 480)): 4 B in and 3 B out per pixel; about 5
    # operations a pixel to decode, 60 more for the Gauss of three channels
    # or 114 min/max for their medians.
    fh, fw = 848, 480
    mrgb, _ = image_inputs(fh, fw, torch.Generator(device=DEVICE).manual_seed(13))
    n_img = fh * fw
    for mode, name in IMAGE_MODES.items():
        ops = {None: 5, "gauss": 65, "median": 119}[mode]
        pairs[name] = (lambda m=mode: B4.winner_image(mrgb, fh, fw, m),
                       lambda m=mode: B4.winner_image_plain(mrgb, fh, fw, m), None,
                       bound(7 * n_img, ops * n_img))
    out = {}
    for name, (kernel, plain, lib_ms, (b_ms, b_by)) in pairs.items():
        k, p, each = turns(kernel, plain)
        out[name] = (k, p, lib_ms, b_ms, b_by)
        log(f"[6] {name} at {fh}x{fw} packed winner: kernel {k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}), "
            f"plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), library "
            f"none, bound {b_ms:.5f} ms by {b_by} on {card}")
    return out


def time_color_tail(card: str) -> dict:
    """B4's image kernel at both fused frames' (vertical) shapes, in both
    input forms: (a) the packed winner, (b) three u8 planes; by CUDA events
    around its wrapper and by its device time alone (:func:`device_time`).
    {"<form> <mode> <h>x<w>": (ms, device ms)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    g = torch.Generator(device=DEVICE).manual_seed(19)
    out = {}
    for h, w in ((848, 480), (1280, 720)):
        mrgb, img = image_inputs(h, w, g)
        planes = [img[..., c].contiguous() for c in range(3)]
        for mode in IMAGE_MODES:
            forms = {"winner": lambda m=mode: B4.winner_image(mrgb, h, w, m)}
            if mode is not None:
                forms["planes"] = lambda m=mode: B4.planes_image(planes, m)
            for form, fn in forms.items():
                ms = cuda_ms(fn, 20)
                dk, _ = device_time(fn)
                key = f"{form} {mode or 'copy'} {h}x{w}"
                out[key] = (ms, dk)
                log(f"[6] color tail, {key}: image kernel {ms:.5f} ms (device "
                    f"{device_text(dk)}) on {card}")
    return out


def profile_frame(scene: Scene, card: str, mode: str = "tiled", limit: bool = True) -> int:
    """One warm dual frame under the profiler, ``tiled`` (image only, Gauss
    tail) or the ``pallas`` or ``packed`` mode, on new Framesets as the
    feeders deliver them: its device ops. Fails above its FRAME_OPS_CEILING
    when ``limit``."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    # A pair for the warm-up and one for each trace profiled() may take.
    intr, fs = framesets(scene, DEVICE, n_pairs=PROFILE_TRIES + 1)
    cfg = (FusionConfig.create(vertical_image=True, mirror_image=True, emit_zbuf=False,
                               device=DEVICE) if mode == "tiled" else mode_config(mode, device=DEVICE))
    pipe = FusionPipeline(intr, cfg, device=DEVICE)
    pipe.set_right_transform(scene.t_rl)
    pairs = iter(fs)
    pipe.process(*next(pairs))
    wall, busy, ops = profiled(lambda: pipe.process(*next(pairs)), "[6]", top=4)
    key = "dual" if mode == "tiled" else f"dual {mode}"
    ceiling = FRAME_OPS_CEILING.get(key) if limit else None
    log(f"[6] profiled warm frame (dual {scene.w}x{scene.h} {mode}"
        f"{' image only' if mode == 'tiled' else ''}): wall {wall:.3f} ms, device busy "
        f"{busy_text(busy, wall)}, {ops} device ops"
        f"{'' if ceiling is None else f' (ceiling {ceiling})'} "
        f"on {card}")
    if ceiling is not None and ops > ceiling:
        raise AssertionError(f"dual {scene.w}x{scene.h} {mode} frame: {ops} device ops, "
                             f"ceiling {ceiling}")
    return ops


def time_modes(scene: Scene, card: str, warmup: int = 3, iters: int = 20) -> dict:
    """ms/frame of each mode of MODES (with the z-buffer, as every one of
    them but tiled always emits it), every frame new Framesets."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionPipeline

    out = {}
    for mode in MODES:
        intr, fs = framesets(scene, DEVICE, aligned=mode == "tiled+align", n_pairs=iters + warmup)
        pipe = FusionPipeline(intr, mode_config(mode, device=DEVICE), device=DEVICE)
        pipe.set_right_transform(scene.t_rl)
        pairs = iter(fs)
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: pipe.process(*next(pairs)), iters, warmup)
        host_ms = (time.perf_counter() - t0) * 1e3 / (iters + warmup)
        key = f"dual_{scene.w}x{scene.h}_{mode}"
        out[key] = ms
        log(f"[6] process {key}: {ms:.4f} ms/frame (CUDA events, {iters} new frame pairs after "
            f"{warmup} warm-up; host wall incl. warm-up {host_ms:.4f} ms/frame) on {card}")
    return out


def bare_prep(args, cams, feed: bool):
    """One launch of B3 on prebuilt outputs, with no checks: the launch
    alone, as the wrapper makes it."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    depth, color = args[:2]
    h, w = (depth if isinstance(depth, torch.Tensor) else depth[0]).shape[-2:]
    n, dev = cams.n, cams.device
    d_ptr, d_stride, _ = B3._cameras(depth, n, (h, w), torch.int32, "depth", dev)
    c_ptr, c_stride, _ = B3._cameras(color, n, (h, w, 3), torch.uint8, "color", dev)
    s_ptr, s_stride, _ = B3._rows(args[2], n, 1, "depth_scale", dev)
    p_ptr, p_stride, _ = B3._rows(args[3], n, 16, "cam_to_virtual", dev)
    outs = [torch.empty(n * h * w, dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.float32, torch.bool, torch.int32,
                       torch.bool)]
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    ptrs = [o.data_ptr() for o in outs]
    call = (d_ptr, d_stride, c_ptr, c_stride, 0, p_ptr, p_stride, s_ptr, s_stride,
            cams.static.data_ptr(), cams.ints.data_ptr(), n, h, w, cams.fused.width,
            cams.fused.height, int(cams.mirror), int(feed), *ptrs[:5], int(feed), ptrs[5], stream)
    return lambda: lib.fuse_prep_launch(*call)


def bare_scatter(feed: tuple, key, n_slots: int, zparams, planes: bool, need_zbuf: bool):
    """One launch of the scatter-min on prebuilt outputs and the stream's
    key buffer, with no checks."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    idx, z, ok, rgb24 = feed
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    keys = Z._key_buffer(idx.device, stream, (n_slots + 1) // 2)
    bits = torch.empty(n_slots, dtype=torch.int32, device=DEVICE)
    out = torch.empty((3, n_slots), dtype=torch.uint8, device=DEVICE)
    zbuf = torch.empty(n_slots, dtype=torch.float32, device=DEVICE)
    given = key is not None
    call = (idx.data_ptr(), key.data_ptr() if given else None, z.data_ptr(), ok.data_ptr(),
            rgb24.data_ptr(), zparams.data_ptr(), idx.numel(), int(not given), keys.data_ptr(),
            n_slots, int(planes), bits.data_ptr(), *(p.data_ptr() for p in out), zbuf.data_ptr(),
            int(need_zbuf), stream)
    return lambda: lib.scatter_min_u32_launch(*call)


def time_one(name: str, label: str, kernel, plain, bare, b_ms: float, b_by: str,
             library, card: str, phase: str = "6") -> tuple:
    """A kernel's wrapper (CUDA events around 20 calls, in turns with its
    plain version), its device time by the profiler and its bare launch:
    (ms, plain_ms, library_ms, bound_ms, bound_by), logged."""
    k, p, each = turns(kernel, plain)
    dk, parts = device_time(kernel)
    bare_ms = cuda_ms(bare, 50)
    log(f"[{phase}] {name} {label}: wrapper {k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}), device "
        f"{device_text(dk, parts)}, bare launch {bare_ms:.5f} ms, plain {p:.5f} ms "
        f"({each[2]:.5f}, {each[3]:.5f}), "
        f"library {'none' if library is None else f'{library:.5f} ms (scatter_reduce_ amin)'}, "
        f"bound {b_ms:.5f} ms by {b_by} on {card}")
    return k, p, library, b_ms, b_by


def time_prep_kernels(scenes, rig: Rig, card: str) -> dict:
    """B3 and the scatter-min at the main paths' shapes: B3's feed (b) and
    keys (a) for both cameras of each dual frame and its feed for the
    8-camera rig; the scatter-min in the packed mode's variant (the feed,
    decoded with the z-buffer), the pallas mode's (given keys, decoded) and
    the raw one on each dual frame's entries, and the packed variant on
    100,000 entries over 64 slots. Returns the kernel table's rows (dual
    848×480): {name: (ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    rows = {}
    preps = {f"dual {s.w}x{s.h}": dual_prep(s, s.t_rl, True) for s in scenes}
    first = f"dual {scenes[0].w}x{scenes[0].h}"
    rig_args_, rig_cams = rig_prep(rig, False)
    preps[f"rig {rig.n}x{rig.w}x{rig.h}"] = (rig_args_, rig_cams, None)
    for label, (args, cams, n_px) in preps.items():
        n_cam = cams.n * args[0][0].numel()
        # 4 B depth + 3 B color in; (b) 14 B out a pixel, (a) 9 B; about 60
        # f32 operations a pixel.
        for feed, out_b in ((True, 14), (False, 9)):
            if not feed and n_px is None:
                continue
            b_ms, b_by = bound((7 + out_b) * n_cam, 60 * n_cam)
            if feed:
                kernel = lambda: B3.fuse_prep_feed(*args, cams)  # noqa: E731
                plain = lambda: B3.fuse_prep_feed_plain(*args, cams)  # noqa: E731
            else:
                kernel = lambda: B3.fuse_prep_keys(*args, cams)  # noqa: E731
                plain = lambda: B3.fuse_prep_keys_plain(*args, cams)  # noqa: E731
            row = time_one("fuse_prep", f"({'b' if feed else 'a'}) {label}", kernel, plain,
                           bare_prep(args, cams, feed), b_ms, b_by, None, card)
            if feed and label == first:
                rows["fuse_prep"] = row
        if n_px is None:
            continue
        feed = B3.fuse_prep_feed(*args, cams)[:4]
        zparams = Z.packed_zparams(cams.z_near, cams.z_far, DEVICE)
        row = time_scatter(label, feed, n_px, zparams, card)
        if label == first:
            rows["scatter_min_u32"] = row
    time_scatter("contention 100000 on 64", packed_feed(100_000, 64, 64), 64,
                 Z.packed_zparams(0.25, 4.5, DEVICE), card)
    return rows


def time_scatter(label: str, feed: tuple, n_slots: int, zparams, card: str) -> tuple:
    """The scatter-min's variants on one feed: the packed mode's (the feed,
    decoded with the z-buffer), the pallas mode's (its keys given, decoded
    with the z-buffer) and the raw bits of given keys; beside the bound and
    ``scatter_reduce_``'s time on the same keys. Returns the packed
    variant's row."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    idx = feed[0]
    n = idx.numel()
    key = Z.packed_keys_plain(*feed[1:], zparams)
    # The library's scatter-min: one scatter_reduce_(amin) of prebuilt int64
    # key values into a dump-slotted buffer.
    slot = torch.where((idx >= 0) & (idx < n_slots), idx, n_slots).to(torch.int64)
    key64 = Z.u32_value(key)
    buf = torch.full((n_slots + 1,), 0xFFFFFFFF, dtype=torch.int64, device=DEVICE)
    library = cuda_ms(lambda: buf.scatter_reduce_(0, slot, key64, "amin", include_self=True), 20)
    # In: 13 B an entry from the feed, 8 B given keys; out: 7 B a slot
    # decoded with the z-buffer, 4 B raw; a compare and an atomic an entry.
    cases = {
        "feed, planes+zbuf (packed)": (
            lambda: Z.scatter_min_packed(*feed, n_slots, zparams, True, True),
            lambda: Z.scatter_min_packed_plain(*feed, n_slots, zparams, True, True),
            bare_scatter(feed, None, n_slots, zparams, True, True), 13 * n + 7 * n_slots),
        "given keys, planes+zbuf (pallas)": (
            lambda: Z.scatter_min_u32(idx, key, n_slots, zparams, True, True),
            lambda: Z.scatter_min_u32_plain(idx, key, n_slots, zparams, True, True),
            bare_scatter(feed, key, n_slots, zparams, True, True), 8 * n + 7 * n_slots),
        "given keys, raw": (
            lambda: Z.scatter_min_u32(idx, key, n_slots),
            lambda: Z.scatter_min_u32_plain(idx, key, n_slots),
            bare_scatter(feed, key, n_slots, zparams, False, False), 8 * n + 4 * n_slots),
    }
    rows = {}
    for name, (kernel, plain, bare, n_bytes) in cases.items():
        b_ms, b_by = bound(n_bytes, 2 * n)
        rows[name] = time_one("scatter_min_u32", f"{name} on the {label} entries (N={n} "
                              f"n_slots={n_slots})", kernel, plain, bare, b_ms, b_by, library,
                              card)
    if not keys_clean():
        raise AssertionError("the timed scatter-mins left the key buffer dirty")
    return rows["feed, planes+zbuf (packed)"]


# -- phase 7: segment-sum kernel ---------------------------------------------


def segsum_tolerance(slot, values, n_slots: int) -> torch.Tensor:
    """Per-entry bound on |kernel - plain on the card| of the sums: rtol
    1e-5 of the slot's sum of magnitudes plus atol 1e-6 (the parity gate's
    bar for voxel means, tpu_check.py:389-397). The plain version's
    ``index_add_`` on the card adds with atomics, in an order that changes
    from run to run; counts (a channel of ones) and the representative
    index stay exact. Against the plain version on the CPU, which adds in
    entry order as the kernel does, the kernel is bit-exact."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5

    mag, _ = B5.segsum_sorted_plain(slot, values.abs(), n_slots)
    return 1e-5 * mag + 1e-6


def check_segsum(slot, values, n_slots: int, what: str, counts: bool = True) -> float:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5

    ks, kr = B5.segsum_sorted(slot, values, n_slots)
    again, _ = B5.segsum_sorted(slot, values, n_slots)
    ps, pr = B5.segsum_sorted_plain(slot, values, n_slots)
    cs, cr = B5.segsum_sorted_plain(slot.cpu(), values.cpu(), n_slots)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max()) if ks.numel() else 0.0
    host_exact = torch.equal(ks.cpu(), cs) and torch.equal(kr.cpu(), cr)
    ok = (torch.equal(kr, pr) and (not counts or torch.equal(ks[:, 0], ps[:, 0]))
          and bool(((ks - ps).abs() <= segsum_tolerance(slot, values, n_slots)).all())
          and host_exact and torch.equal(again, ks))
    occupied = int((pr != B5.INT32_MAX).sum())
    inside = slot[(slot >= 0) & (slot < n_slots)].to(torch.int64)
    longest = int(torch.bincount(inside).max()) if inside.numel() else 0
    log(f"[7] segsum {what}: N={slot.shape[0]} C={values.shape[1]} n_slots={n_slots} "
        f"occupied={occupied} longest run={longest} rep exact={torch.equal(kr, pr)} "
        f"max_abs_err(sums) vs plain on "
        f"the card={err:.6g}; bit-exact vs plain on the CPU={host_exact}; two runs "
        f"identical={torch.equal(again, ks)}")
    if not ok:
        raise AssertionError(f"segsum kernel differs from plain: {what}")
    return err


def registration_cloud(scene: Scene):
    """The left camera's registration cloud of ``scene``: the tick's own
    cloud program (filtered, 2× decimated, deprojected), (points (N, 3),
    valid (N,))."""
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline

    intr, _ = framesets(scene, DEVICE)
    pipe = RegistrationPipeline(intr, intr, device=DEVICE)
    depth = torch.from_numpy(scene.frames[0][0].depth.astype(np.int32)).to(DEVICE)
    pts, val, _ = pipe._cloud_fn("left")(depth, torch.tensor(0.001, device=DEVICE))
    return pts, val


def cloud_inputs(scene: Scene, resolution: float, table_size: int = 1 << 15):
    """Kernel B5's inputs for the registration cloud of ``scene`` hashed at
    ``resolution``: (slot, channels)."""
    from pointcloud_depthfusion_tpu_torch.ops import voxel as V

    pts, val = registration_cloud(scene)
    res = torch.tensor(resolution, dtype=torch.float32, device=DEVICE)
    return V.grid_channels(pts, val, V.voxel_coords(pts, res), table_size)


def phase_segsum(scenes, errs: dict) -> None:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5

    worst = 0.0
    for scene in scenes:
        for res in (0.1, 0.01):
            slot, chans = cloud_inputs(scene, res)
            worst = max(worst, check_segsum(slot, chans, 1 << 15,
                                            f"dual {scene.w}x{scene.h} cloud at {res} m"))
    # Long runs: the largest cloud at 0.1 m hashed into 64 slots, thousands
    # of entries a slot.
    big = scenes[-1]
    slot, chans = cloud_inputs(big, 0.1, table_size=64)
    worst = max(worst, check_segsum(slot, chans, 64,
                                    f"dual {big.w}x{big.h} cloud at 0.1 m in 64 slots"))
    g = torch.Generator(device=DEVICE).manual_seed(17)
    for n, c, n_slots in ((230_400, 1, 1 << 15), (230_400, 16, 1 << 15), (4099, 16, 1000)):
        slot = torch.randint(0, n_slots, (n,), generator=g, device=DEVICE, dtype=torch.int32)
        slot[::7] = B5.padded_slots(n_slots)
        vals = torch.randn((n, c), generator=g, device=DEVICE)
        worst = max(worst, check_segsum(slot, vals, n_slots, f"random C={c}", counts=False))
    ones = torch.ones((101_760, 10), device=DEVICE)
    dropped = torch.full((101_760,), B5.padded_slots(1 << 15), dtype=torch.int32, device=DEVICE)
    worst = max(worst, check_segsum(dropped, ones, 1 << 15, "all invalid"))
    worst = max(worst, check_segsum(torch.zeros_like(dropped), ones, 1, "one slot"))
    errs["segsum_sorted"] = max(errs["segsum_sorted"], worst)


def time_segsum(scenes, card: str) -> dict:
    """B5 kernel vs plain vs ``index_add_`` (the sums half alone), and its
    device time by kernel, on the registration clouds at the coarse and the
    fine resolution and on the second call of a tick (the 2^15-entry
    downsampled table)."""
    from pointcloud_depthfusion_tpu_torch.ops import voxel as V
    from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5

    n_slots = 1 << 15
    out = {}
    for scene in scenes:
        for res in (0.1, 0.01):
            slot, chans = cloud_inputs(scene, res)
            inputs = [(f"dual {scene.w}x{scene.h} cloud at {res} m", slot, chans)]
            if res == 0.01:
                mean, occ = V.voxel_downsample(*registration_cloud(scene), 0.01)
                inputs.append((f"dual {scene.w}x{scene.h} downsampled table at {res} m",
                               *V.grid_channels(mean, occ, V.voxel_coords(mean, 0.01), n_slots)))
            for what, slot, chans in inputs:
                n, c = chans.shape
                idx = torch.where((slot >= 0) & (slot < n_slots), slot, n_slots).to(torch.int64)
                acc = torch.zeros((n_slots + 1, c), device=DEVICE)
                lib = cuda_ms(lambda: acc.index_add_(0, idx, chans), 20)
                k, p, each = turns(lambda: B5.segsum_sorted(slot, chans, n_slots),
                                   lambda: B5.segsum_sorted_plain(slot, chans, n_slots))
                b_ms, b_by = bound(4 * n + 4 * n * c + 4 * n_slots * c + 4 * n_slots, 2 * n * c)
                dk, parts = device_time(lambda: B5.segsum_sorted(slot, chans, n_slots))
                out[what] = (k, p, lib, b_ms, b_by, dk)
                log(f"[9] segsum_sorted {what} (N={n} C={c} n_slots={n_slots}): kernel "
                    f"{k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}; device {device_text(dk, parts)}), "
                    f"plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), index_add_ (sums "
                    f"only) {lib:.5f} ms, bound {b_ms:.5f} ms by {b_by} on {card}")
    return out


# -- phase 8: the registration service ---------------------------------------


def truth_error(t: np.ndarray, t_true: np.ndarray) -> tuple:
    """(translation error m, rotation error degrees) of a right→left 4×4."""
    err_t = float(np.linalg.norm(t[:3, 3] - t_true[:3, 3]))
    dr = t[:3, :3].astype(np.float64) @ t_true[:3, :3].T
    return err_t, float(np.rad2deg(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))))


def flags(pipe) -> list:
    return [(t.discarded, t.guess_reset, t.target_grid_rebuilt) for t in pipe.telemetry]


@contextlib.contextmanager
def arccos_one_ulp_up():
    """Every ``torch.arccos`` result moved one ulp up: a rounding change of
    the size by which the card's and the CPU's arccos differ."""
    orig = torch.arccos
    torch.arccos = lambda x: torch.nextafter(orig(x), torch.full_like(x, 4.0))
    try:
        yield
    finally:
        torch.arccos = orig


def gate_margin(fitness: float, best_before: float) -> float:
    """How far this tick's fitness lies from the gate's threshold, relative."""
    return abs(fitness / best_before - 1.0) if np.isfinite(best_before) else np.inf


def drive_registration(scene: Scene, settings, tag: str) -> tuple:
    """REG_TICKS ticks from identity: on the card (twice, and once more with
    arccos moved one ulp) and on the CPU. Returns (the second card
    pipeline, per-tick host ms of that run, expected B5 launches)."""
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline

    intr_g, _ = framesets(scene, DEVICE)
    intr_c, _ = framesets(scene, "cpu")
    dl, dr = (f.depth for f in scene.frames[0])
    card = RegistrationPipeline(intr_g, intr_g, settings, device=DEVICE)
    again = RegistrationPipeline(intr_g, intr_g, settings, device=DEVICE)
    ulp = RegistrationPipeline(intr_g, intr_g, settings, device=DEVICE)
    cpu = RegistrationPipeline(intr_c, intr_c, settings, device="cpu")
    host_ms = []
    worst = same = moved = 0.0
    identical = True
    ties = flips = ulp_flips = 0
    for k in range(REG_TICKS):
        res = card.current_resolution
        best_g, best_c = card.best_fitness, cpu.best_fitness
        tg = card.tick(dl, dr).copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ta = again.tick(dl, dr).copy()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        with arccos_one_ulp_up():
            tu = ulp.tick(dl, dr).copy()
        tc = cpu.tick(dl, dr).copy()
        diff = float(np.abs(tg - tc).max())
        worst = max(worst, diff)
        same = max(same, float(np.abs(tg - ta).max()))
        moved = max(moved, float(np.abs(tg - tu).max()))
        identical &= bool(np.array_equal(tg, ta))
        g, c = card.telemetry[-1], cpu.telemetry[-1]
        # The fitness gate (fitness < best) is a near tie when this tick's
        # fitness lies within GATE_TIE of the threshold on either device:
        # rounding alone decides it there (see GATE_TIE).
        margin = min(gate_margin(g.fitness, best_g), gate_margin(c.fitness, best_c))
        tie = settings.discard_transform and margin < GATE_TIE
        ties += tie
        flips += g.discarded != c.discarded
        ulp_flips += g.discarded != ulp.telemetry[-1].discarded
        log(f"[8 {tag}] tick {k}: resolution {res:.3g} m, card-vs-CPU max|dT|={diff:.3g} "
            f"iterations card={g.iterations} cpu={c.iterations} fitness card={g.fitness:.9g} "
            f"cpu={c.fitness:.9g} gate margin={margin:.3g}{' (near tie)' if tie else ''} "
            f"flags card={flags(card)[-1]} cpu={flags(cpu)[-1]}; card run 2 {host_ms[-1]:.3f} ms "
            f"{'identical' if np.array_equal(tg, ta) else 'differs by %.3g' % np.abs(tg - ta).max()}; "
            f"arccos +1 ulp moves it {np.abs(tg - tu).max():.3g}")
        if not np.all(np.isfinite(tg)) or tg.shape != (4, 4):
            raise AssertionError(f"{tag} tick {k}: transform {tg}")
        if diff > TRANSFORM_ATOL:
            raise AssertionError(f"{tag} tick {k}: card vs CPU transform {diff} > {TRANSFORM_ATOL}")
        if flags(card)[-1][1:] != flags(cpu)[-1][1:] or (
                not tie and g.discarded != c.discarded):
            raise AssertionError(f"{tag} tick {k}: flags {flags(card)[-1]} vs {flags(cpu)[-1]} "
                                 f"(gate margin {margin})")
    log(f"[8 {tag}] card vs CPU worst max|dT|={worst:.3g} (bar {TRANSFORM_ATOL}); gate near ties "
        f"{ties}, discard flags that differ card vs CPU {flips}, card vs card with arccos +1 ulp "
        f"{ulp_flips} (max|dT| {moved:.3g}); two card runs: bit-identical={identical}, "
        f"max|dT|={same:.3g}")
    (gt, ga), (ct, ca) = truth_error(tg, scene.t_rl), truth_error(tc, scene.t_rl)
    log(f"[8 {tag}] final vs truth: card {gt:.6f} m {ga:.5f} deg, CPU {ct:.6f} m {ca:.5f} deg "
        f"(bar {TRUTH_M} m, {TRUTH_DEG} deg)")
    if ct < TRUTH_M and ca < TRUTH_DEG:
        if not (gt < TRUTH_M and ga < TRUTH_DEG):
            raise AssertionError(f"{tag}: the CPU run meets the truth bar and the card does not")
    elif abs(gt - ct) > TRANSFORM_ATOL or abs(ga - ca) > np.rad2deg(TRANSFORM_ATOL):
        raise AssertionError(f"{tag}: card error ({gt}, {ga}) not within {TRANSFORM_ATOL} of "
                             f"the CPU's ({ct}, {ca})")
    expected = sum(4 if t.target_grid_rebuilt else 2
                   for pipe in (card, again, ulp) for t in pipe.telemetry)
    return again, host_ms, expected


def profiled(fn, tag: str, top: int = 12) -> tuple:
    """``fn()`` once under torch.profiler, ending in synchronize(): (wall
    ms, device busy ms, device ops); logs the ops that take the device's
    time under ``tag``. An incomplete trace is taken again, up to
    PROFILE_TRIES times. If none is complete, the device ops are the
    host's launches, copies and fills of the last trace, and the busy time
    is None (not measured); a trace without them raises (no unmeasured 0
    is counted)."""
    for tries in range(1, PROFILE_TRIES + 1):
        trace = traced(fn, tries)
        if trace.complete:
            break
        log(f"{tag}   (trace {tries}, margins {profile_margin(tries):.2f} s: "
            f"{trace.counts()}; incomplete)")
    else:
        if not trace.launches + trace.copy_calls:
            raise RuntimeError(f"{tag}: {PROFILE_TRIES} profiler traces came back without "
                               "device events or launches: device ops not measured")
        log(f"{tag}   no complete trace: device ops from the host's launches, copies and "
            "fills, device busy not measured")
        return trace.wall, None, trace.launches + trace.copy_calls
    if len(trace.device) - trace.kernels != trace.copy_calls:
        log(f"{tag}   ({trace.counts()})")
    rows = sorted(trace.prof.key_averages(),
                  key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in rows[:top]:
        log(f"{tag}   {getattr(e, 'self_device_time_total', 0) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return trace.wall, sum(e.time_range.elapsed_us() for e in trace.device) / 1e3, len(trace.device)


def busy_text(busy: Optional[float], wall: float) -> str:
    """Device busy ms and its share of ``wall``, or "not measured"."""
    return "not measured" if busy is None else f"{busy:.3f} ms ({100 * busy / wall:.1f}%)"


def profile_tick(pipe, scene: Scene, card: str) -> dict:
    """One warm tick under torch.profiler: device busy share, kernel
    launches, and the ops that take the device's time."""
    dl, dr = (f.depth for f in scene.frames[0])
    wall, busy, n_ops = profiled(lambda: pipe.tick(dl, dr), "[9]")
    iters = pipe.telemetry[-1].iterations
    log(f"[9] profiled warm tick (dual {scene.w}x{scene.h}): wall {wall:.3f} ms, device busy "
        f"{busy_text(busy, wall)}, {n_ops} device ops (kernels, copies, "
        f"fills), {iters} iterations ({n_ops / max(iters, 1):.1f} per iteration) on {card}")
    return {"wall_ms": wall, "busy_ms": busy, "kernels": n_ops, "iterations": iters}


# -- phase 12: the N-camera rig ----------------------------------------------


@dataclasses.dataclass
class Rig:
    n: int
    w: int
    h: int
    frames: list  # [(depth (n, h, w) int32, color (n, h, w, 3) uint8)], numpy
    c2v: list  # [(n, 4, 4) float32 camera→virtual], one per frame
    poses: np.ndarray  # (n, 4, 4) camera→world truth


def rig_intrinsics(w: int, h: int, per_camera: bool = False, device="cpu",
                   n: int = RIG_CAMERAS):
    """The bench camera (fx = 631·w/848), or ``n`` per-camera variants of
    it under the inverse Brown-Conrady model, camera 1 with real
    coefficients (the heterogeneous rig of tests/test_torch_rig.py)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics

    fx = 631.0 * w / 848.0
    if not per_camera:
        return Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device=device)
    return [Intrinsics.create(w, h, fx=fx * (1 + 0.02 * i), fy=fx * (1 + 0.015 * i),
                              ppx=w / 2 + 1.5 * (i - 1), ppy=h / 2 - i,
                              model=Distortion.INVERSE_BROWN_CONRADY,
                              coeffs=RIG_BC_COEFFS if i == 1 else (0.0,) * 5, device=device)
            for i in range(n)]


def render_arc(n: int, w: int, h: int, n_frames: int, seed0: int, seed_step: int) -> tuple:
    """n cameras of rig_intrinsics(w, h) on the arc of
    configs/deployment_rig4.yaml (span 0.8 m, 37.5°/m toe-in), noise 0.002,
    holes 0.01, frame k stamped k/30 s and camera i of it seeded
    seed0 + seed_step·k + i: (camera→world poses (n, 4, 4),
    [[HostFrameset of camera i] of frame k])."""
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses

    intr = rig_intrinsics(w, h)
    poses = np.stack(rig_arc_poses(n, span=0.8, toe_in_deg_per_m=37.5))
    scene = SyntheticScene()
    return poses, [[scene.render(intr, poses[i], depth_noise_std=0.002, hole_fraction=0.01,
                                 seed=seed0 + seed_step * k + i, timestamp=k / 30.0)
                    for i in range(n)] for k in range(n_frames)]


def perturbed(poses: np.ndarray, deg: float, m: float) -> np.ndarray:
    """Each camera→virtual pose moved by ``yaw_bump(deg·i, m·i)``, i its
    camera index."""
    return np.stack([p @ yaw_bump(deg * i, m * i) for i, p in enumerate(poses)]).astype(np.float32)


def build_rig(n: int, w: int, h: int, n_frames: int = RIG_FRAMES) -> Rig:
    """The arc rig (render_arc), camera i of frame k seeded 100·k + i.
    cam_to_virtual is the truth, moved on frame k ≥ 1 by 1 cm and 0.5° of
    yaw per camera index (a sweep's update)."""
    poses, rendered = render_arc(n, w, h, n_frames, 0, 100)
    frames = [(np.stack([f.depth for f in fs]).astype(np.int32), np.stack([f.color for f in fs]))
              for fs in rendered]
    c2v = [perturbed(poses, 0.5 * k, 0.01 * k) for k in range(n_frames)]
    return Rig(n, w, h, frames, c2v, poses)


def rig_args(rig: Rig, k: int, device, batch: int = 0):
    """Frame k as rig_fuse's (depth, color, depth_scale, cam_to_virtual) on
    ``device``; ``batch`` > 0 splits the cameras into that many streams."""
    depth, color = rig.frames[k]
    arrays = (depth, color, np.full((rig.n,), 0.001, np.float32), rig.c2v[k])
    out = [torch.from_numpy(a).to(device) for a in arrays]
    if batch:
        out = [t.reshape(batch, rig.n // batch, *t.shape[1:]) for t in out]
    return out


def fresh_rig_args(rig: Rig, count: int, device, batch: int = 0):
    """An iterator over ``count`` new copies of frame 0's rig_args (new
    depth-scale and cam_to_virtual tensors each, as the rig node builds
    them every batch)."""
    return iter([rig_args(rig, 0, device, batch) for _ in range(count)])


def profile_rig_frame(rig: Rig, case: str, card: str, limit: bool = True) -> int:
    """One warm rig frame of ``case`` under the profiler, on new tensors:
    its device ops. Fails above its FRAME_OPS_CEILING when ``limit``."""
    fn, _ = rig_case(rig, case, DEVICE)
    frames = fresh_rig_args(rig, PROFILE_TRIES + 1, DEVICE)
    fn(*next(frames))
    wall, busy, ops = profiled(lambda: fn(*next(frames)), "[12]", top=6)
    ceiling = FRAME_OPS_CEILING.get(f"rig {case}") if limit else None
    log(f"[12] profiled warm frame ({rig.n}x{rig.w}x{rig.h} {case}): wall {wall:.3f} ms, "
        f"device busy {busy_text(busy, wall)}, {ops} device ops"
        f"{'' if ceiling is None else f' (ceiling {ceiling})'} on {card}")
    if ceiling is not None and ops > ceiling:
        raise AssertionError(f"rig {rig.n}x{rig.w}x{rig.h} {case}: {ops} device ops, "
                             f"ceiling {ceiling}")
    return ops


def rig_case(rig: Rig, case: str, device):
    """(rig_fuse step, render mode) of one RIG_CASES case on ``device``."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse

    fields, multi, per_camera = RIG_CASES[case]
    cfg = FusionConfig.create(device=device, **{**RIG_CONFIG, **fields})
    intr = rig_intrinsics(rig.w, rig.h, per_camera)
    ref = intr[0] if per_camera else intr
    fn = rig_fuse(intr, fused_virtual_intrinsics(ref, False), cfg, multi_stream=multi,
                  rois=RIG_ROIS if per_camera else None, device=device)
    return fn, cfg.render_mode


def rig_expected(case: str, n: int, frames: int) -> dict:
    """The launches of ``frames`` frames of one case on the card."""
    fields, multi, _ = RIG_CASES[case]
    out = {"fuse_prep": frames}
    if fields.get("render_mode") == "packed":
        out["scatter_min_u32"] = frames
    elif multi and n >= 2:
        out["zresolve_sorted_streams"] = frames
    elif fields.get("emit_zbuf", True):
        out["zresolve_sorted_entries"] = frames
    else:
        out["zresolve_winner_rgb"] = frames
    # The color tail: one image launch a frame, filtering or not.
    if fields.get("filter_fused_color", RIG_CONFIG["filter_fused_color"]):
        out["median3x3_image" if fields.get("use_median_filter") else "gauss3x3_image"] = frames
    else:
        out["color_image"] = frames
    return out


def rig_mismatch(gpu: torch.Tensor, cpu: torch.Tensor, mode: str) -> tuple:
    """(names, fractions, ok) of a card image against the CPU's: the image
    within PIXEL_BUDGET for the exact modes; coverage within PIXEL_BUDGET and
    color within COLOR_BUDGET for packed."""
    g = gpu.cpu()
    color = float((g != cpu).any(-1).float().mean())
    if mode != "packed":
        return ("image",), (color,), color <= PIXEL_BUDGET
    cov = float((g.any(-1) != cpu.any(-1)).float().mean())
    return ("coverage", "color"), (cov, color), cov <= PIXEL_BUDGET and color <= COLOR_BUDGET


def drive_rig(rig: Rig, cases, tag: str) -> dict:
    """Every case of ``cases`` on the card and on the CPU, frame by frame;
    multi_stream against its default on the card, bit for bit. Returns the
    expected launches."""
    expected: dict = {}
    images = {}
    for case in cases:
        gpu, mode = rig_case(rig, case, DEVICE)
        cpu, _ = rig_case(rig, case, "cpu")
        images[case] = []
        for k in range(len(rig.frames)):
            ig = gpu(*rig_args(rig, k, DEVICE))
            ic = cpu(*rig_args(rig, k, "cpu"))
            torch.cuda.synchronize()
            if ig.shape != (rig.h, rig.w, 3) or ig.dtype != torch.uint8:
                raise AssertionError(f"{tag} {case}: image {tuple(ig.shape)} {ig.dtype}")
            coverage = float(ig.any(-1).float().mean())
            names, fr, ok = rig_mismatch(ig, ic, mode)
            log(f"[12 {tag}] {case} frame {k}: coverage={coverage:.4f} vs CPU: "
                + " ".join(f"{n}={v:.6g}" for n, v in zip(names, fr)))
            if coverage < 0.5 or not ok:
                raise AssertionError(f"{tag} {case} frame {k}: coverage {coverage}, vs CPU {fr}")
            images[case].append(ig)
        for name, v in rig_expected(case, rig.n, len(rig.frames)).items():
            expected[name] = expected.get(name, 0) + v
    for default in ("tiled_zbuf", "tiled_image_only"):
        if "multi_stream" in images and default in images:
            same = all(torch.equal(a, b) for a, b in zip(images["multi_stream"], images[default]))
            log(f"[12 {tag}] multi_stream bit-identical to {default} on the card: {same}")
            if not same:
                raise AssertionError(f"{tag}: multi_stream differs from {default} on the card")
    return expected


def drive_batched(rig: Rig, batch: int, tag: str) -> dict:
    """batched_rig_fuse over ``batch`` streams of the rig's cameras against
    rig_fuse on each stream, on the card, tiled and packed."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import batched_rig_fuse, rig_fuse

    cams = rig.n // batch
    intr = rig_intrinsics(rig.w, rig.h)
    fused = fused_virtual_intrinsics(intr, False)
    expected: dict = {}
    for mode in ("tiled", "packed"):
        cfg = FusionConfig.create(render_mode=mode, device=DEVICE, **RIG_CONFIG)
        fb = batched_rig_fuse(intr, fused, cfg, batch, cams, device=DEVICE)
        one = rig_fuse(intr, fused, cfg, device=DEVICE)
        for k in range(len(rig.frames)):
            out = fb(*rig_args(rig, k, DEVICE, batch))
            streams = rig_args(rig, k, DEVICE, batch)
            want = [one(*(t[b] for t in streams)) for b in range(batch)]
            torch.cuda.synchronize()
            same = out.shape == (batch, rig.h, rig.w, 3) and all(
                torch.equal(out[b], want[b]) for b in range(batch))
            log(f"[12 {tag}] batched {mode} B={batch}x{cams} frame {k}: equal to per-stream "
                f"rig_fuse on the card: {same}")
            if not same:
                raise AssertionError(f"{tag}: batched {mode} differs from per-stream")
        # The prep, the resolve and the color tail: one launch each for the
        # batch and for each stream of the per-stream reference.
        for name in ("fuse_prep", "scatter_min_u32" if mode == "packed"
                     else "zresolve_sorted_entries", "color_image"):
            expected[name] = expected.get(name, 0) + (1 + batch) * len(rig.frames)
    return expected


class ReplaySource:
    """A finite camera stream of prerendered HostFramesets."""

    def __init__(self, frames, intr):
        self._frames = list(frames)
        self._intr = intr

    @property
    def intrinsics(self):
        return self._intr

    def next_frame(self):
        return self._frames.pop(0) if self._frames else None


def pair_truth_errors(c2v: np.ndarray, poses: np.ndarray) -> list:
    """[(translation m, rotation deg)] of each adjacent pair's relative
    transform against the truth."""
    out = []
    for i in range(len(poses) - 1):
        est = np.linalg.inv(c2v[i].astype(np.float64)) @ c2v[i + 1]
        out.append(truth_error(est, np.linalg.inv(poses[i]) @ poses[i + 1]))
    return out


def run_node(streams, intr, init, dev, every: int, loaded: bool, label: str, card: str):
    """One RigFusionNodeApp.run over the prerendered ``streams``; ``loaded``
    starts it from ``init`` as a loaded (trusted) calibration, so the sweeps
    refine it instead of annealing from identity. Returns (app, wall s,
    upload_ms per set, fused images)."""
    import tempfile

    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp

    app = RigFusionNodeApp([ReplaySource(s, intr) for s in streams], intr, init,
                           registration_every=every, registration_async=False, device=dev)
    if loaded:
        with tempfile.TemporaryDirectory() as tmp:
            app.save_calibration(f"{tmp}/rig_calibration.txt")
            if not app.load_calibration(f"{tmp}/rig_calibration.txt"):
                raise AssertionError("node: calibration round trip failed")
    uploads, images = [], []
    fuse_one = app.process_batch

    def process(batch):
        uploads.append(batch.upload_ms)
        images.append(fuse_one(batch))
        return images[-1]

    app.process_batch = process
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = app.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, (h, w) = len(streams), images[0].shape[:2]
    coverage = min(float(img.any(-1).mean()) for img in images)
    log(f"[12 node] {label}: {done} frames of {n}x{w}x{h} in {wall:.3f} s ({done / wall:.3f} "
        f"frames/s incl. {app.registration_ticks} inline sweeps), min coverage {coverage:.4f}, "
        f"upload_ms mean {np.mean(uploads):.4f} min {np.min(uploads):.4f} max "
        f"{np.max(uploads):.4f}" + (f" on {card}" if dev == DEVICE else ""))
    if done != NODE_FRAMES or coverage < 0.5:
        raise AssertionError(f"node {label}: {done} frames, coverage {coverage}")
    if app.registration_ticks != (-(-NODE_FRAMES // every) if every else 0):
        raise AssertionError(f"node {label}: {app.registration_ticks} sweeps")
    return app, wall, uploads, images


def drive_node(w: int, h: int, truth: bool, timed: bool, card: str) -> tuple:
    """RigFusionNodeApp.run over NODE_FRAMES frames of RIG_CAMERAS cameras
    at w×h with inline sweeps every NODE_EVERY frames, on the card and on
    the CPU: from perturbed guesses that the sweeps replace (cold: annealing
    from identity) and from a small guess loaded as a trusted calibration
    (warm refinement). With ``truth`` every adjacent pair on both devices
    within the node test's truth bar, else the card's cam_to_virtual within
    TRANSFORM_ATOL of the CPU's (the warm sweeps slide along the scene's
    flat directions by amounts that rounding sets, so the two measures need
    not hold together); with ``timed`` once more on the card without
    sweeps. Returns (expected launches, {metric: value})."""
    n = RIG_CAMERAS
    intr = rig_intrinsics(w, h)
    poses, rendered = render_arc(n, w, h, NODE_FRAMES, 1000, 10)
    streams = [[fs[i] for fs in rendered] for i in range(n)]
    inits = {"cold": perturbed(poses, *NODE_COLD_GUESS),
             "loaded": perturbed(poses, *NODE_LOADED_GUESS)}
    size = f"{n}x{w}x{h}"
    runs = {}
    for start, init in inits.items():
        for dev, side in ((DEVICE, "card"), ("cpu", "cpu")):
            runs[side, start] = run_node(streams, intr, init, dev, NODE_EVERY, start == "loaded",
                                         f"{size} {side}, {start}", card)
    if timed:
        runs["card", "no sweeps"] = run_node(streams, intr, inits["cold"], DEVICE, 0, False,
                                             f"{size} card, no sweeps", card)
    metrics = {}
    for start in ("cold", "loaded"):
        (card_app, _, _, card_img), (cpu_app, _, _, cpu_img) = (
            runs["card", start], runs["cpu", start])
        diff = float(np.abs(card_app.cam_to_virtual - cpu_app.cam_to_virtual).max())
        frames_differ = max(float((a != b).any(-1).mean()) for a, b in zip(card_img, cpu_img))
        errs = {k: pair_truth_errors(a.cam_to_virtual, poses)
                for k, a in (("card", card_app), ("cpu", cpu_app))}
        meets = {k: [t < NODE_TRUTH_M and a < NODE_TRUTH_DEG for t, a in e]
                 for k, e in errs.items()}
        flips = sum(a != b for pg, pc in zip(card_app._pair_pipes, cpu_app._pair_pipes)
                    for a, b in zip(flags(pg), flags(pc)))
        log(f"[12 node] {size} {start}: card vs CPU cam_to_virtual max|d|={diff:.3g} (bar "
            f"{TRANSFORM_ATOL}{', logged only' if truth else ''}); pair ticks whose gating flags "
            f"differ card vs CPU {flips} of {sum(len(p.telemetry) for p in cpu_app._pair_pipes)}; "
            f"fused frames card vs CPU differ on at most {frames_differ:.6g} "
            f"of pixels (each fuses its own calibration); pairs vs truth (m, deg): card "
            f"{[(round(t, 5), round(a, 4)) for t, a in errs['card']]} CPU "
            f"{[(round(t, 5), round(a, 4)) for t, a in errs['cpu']]} (bar {NODE_TRUTH_M} m, "
            f"{NODE_TRUTH_DEG} deg{'' if truth else ', logged only'}): card meets it "
            f"{meets['card']}, CPU {meets['cpu']}")
        for app in (card_app, cpu_app):
            if not np.array_equal(app.cam_to_virtual[0], inits[start][0]):
                raise AssertionError(f"node {size} {start}: camera 0 moved")
        if not truth and diff > TRANSFORM_ATOL:
            raise AssertionError(f"node {size} {start}: card vs CPU cam_to_virtual {diff}")
        if truth and not all(meets["card"] + meets["cpu"]):
            raise AssertionError(f"node {size} {start}: pairs vs truth: card {errs['card']}, "
                                 f"CPU {errs['cpu']}")
        metrics[f"node_{size}_cam_to_virtual_card_vs_cpu_{start}"] = diff
        metrics[f"node_{size}_worst_pair_vs_truth_{start}"] = [
            max(e[0] for e in errs["card"]), max(e[1] for e in errs["card"])]
    card_runs = [k for k in runs if k[0] == "card"]
    segsum = sum(4 if t.target_grid_rebuilt else 2
                 for k in card_runs for pipe in runs[k][0]._pair_pipes or ()
                 for t in pipe.telemetry)
    expected = {"fuse_prep": len(card_runs) * NODE_FRAMES,
                "zresolve_winner_rgb": len(card_runs) * NODE_FRAMES,
                "color_image": len(card_runs) * NODE_FRAMES, "segsum_sorted": segsum}
    uploads = [u for k in card_runs for u in runs[k][2]]
    metrics[f"node_{size}_upload_ms_mean"] = float(np.mean(uploads))
    metrics[f"node_{size}_upload_ms_max"] = float(np.max(uploads))
    metrics[f"node_{size}_fps_with_sweeps"] = NODE_FRAMES / runs["card", "cold"][1]
    if timed:
        metrics[f"node_{size}_fps"] = NODE_FRAMES / runs["card", "no sweeps"][1]
    return expected, metrics


def phase_streams(errs: dict) -> None:
    """B7 against its plain version on the card, bit-exact, at the 8-camera
    848×480 rig's shape and the 4-camera 1280×720 one."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    for s, n_px in B7_SHAPES:
        pix, z, rgb = (t.reshape(s, n_px) for t in resolve_entries(s * n_px, n_px, s + n_px,
                                                                    DEVICE))
        got = Z.zresolve_sorted_streams(pix, z, rgb, n_px)
        want = Z.zresolve_sorted_streams_plain(pix, z, rgb, n_px)
        d_got = Z.zresolve_sorted_streams(pix, z, None, n_px)
        d_want = Z.zresolve_sorted_streams_plain(pix, z, None, n_px)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip((*got, *d_got), (*want, *d_want)))
        exact = all(torch.equal(a, b) for a, b in zip((*got, *d_got), (*want, *d_want)))
        log(f"[12] B7 zresolve_sorted_streams S={s} N={n_px} n_px={n_px}: max_abs_err={err} "
            f"bit-exact={exact} empty_fraction={float((got[0] == Z.INT32_MAX).float().mean()):.4f}")
        if not exact:
            raise AssertionError(f"B7 differs from plain at S={s} n_px={n_px}")
        errs["zresolve_sorted_streams"] = max(errs["zresolve_sorted_streams"], err)


def time_rig(rigs: dict, card: str, iters: int = 10, warmup: int = 2) -> dict:
    """ms/frame of every rig case and of the batched rig (CUDA events),
    every frame new tensors."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import batched_rig_fuse

    out = {}
    for (n, w, h), cases in RIG_RUNS:
        rig = rigs[(n, w, h)]
        for case in cases:
            fn, _ = rig_case(rig, case, DEVICE)
            frames = fresh_rig_args(rig, iters + warmup, DEVICE)
            key = f"rig_{n}x{w}x{h}_{case}"
            out[key] = cuda_ms(lambda: fn(*next(frames)), iters, warmup)
    rig = rigs[RIG_BATCHED[0]]
    batch = RIG_BATCHED[1]
    intr = rig_intrinsics(rig.w, rig.h)
    for mode in ("tiled", "packed"):
        cfg = FusionConfig.create(render_mode=mode, device=DEVICE, **RIG_CONFIG)
        fb = batched_rig_fuse(intr, fused_virtual_intrinsics(intr, False), cfg, batch,
                              rig.n // batch, device=DEVICE)
        frames = fresh_rig_args(rig, iters + warmup, DEVICE, batch)
        out[f"batched_{batch}x{rig.n // batch}x{rig.w}x{rig.h}_{mode}"] = cuda_ms(
            lambda: fb(*next(frames)), iters, warmup)
    for key, ms in out.items():
        log(f"[12] {key}: {ms:.4f} ms/frame (CUDA events, {iters} frames after {warmup} "
            f"warm-up) on {card}")
    return out


def time_streams(rig: Rig, card: str) -> tuple:
    """B7 on the rig's own per-camera entries (frame 0, multi_stream's
    feed): (ms, plain_ms, library_ms, bound_ms, bound_by)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z
    from pointcloud_depthfusion_tpu_torch.parallel import mesh as M

    intr = rig_intrinsics(rig.w, rig.h)
    fused = fused_virtual_intrinsics(intr, False).to(DEVICE)
    cfg = FusionConfig.create(device=DEVICE, **RIG_CONFIG)
    calib = M._RigCalibration(intr, None, torch.device(DEVICE))
    entries_all = M._tiled_rig_body(calib, fused, cfg)[1]
    pix, z, rgb = entries_all(*rig_args(rig, 0, DEVICE), per_stream=True)
    s, n = pix.shape
    n_px = fused.width * fused.height
    # The library's resolve: one scatter_reduce_(amin) of prebuilt int64
    # keys (z bits high, rgb low) into a dump-slotted pixel buffer.
    flat = pix.reshape(-1)
    idx = torch.where((flat >= 0) & (flat < n_px), flat, n_px).to(torch.int64)
    keys = (z.reshape(-1).to(torch.int64) << 32) | (rgb.reshape(-1).to(torch.int64) + (1 << 31))
    buf = torch.full((n_px + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=DEVICE)
    library = cuda_ms(lambda: buf.scatter_reduce_(0, idx, keys, "amin", include_self=True), 20)
    k, p, each = turns(lambda: Z.zresolve_sorted_streams(pix, z, rgb, n_px),
                       lambda: Z.zresolve_sorted_streams_plain(pix, z, rgb, n_px))
    # 12 B in per entry, 8 B out per pixel; a compare and an atomic per entry.
    b_ms, b_by = bound(12 * s * n + 8 * n_px, 2 * s * n)
    valid = float((flat != Z.INVALID_PIX).float().mean())
    log(f"[12] zresolve_sorted_streams at the {rig.n}x{rig.w}x{rig.h} rig's entries "
        f"(S={s} N={n} n_px={n_px}, {valid:.4f} valid): kernel {k:.5f} ms ({each[0]:.5f}, "
        f"{each[1]:.5f}), plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), library {library:.5f} "
        f"ms (scatter_reduce_ amin), bound {b_ms:.5f} ms by {b_by} on {card}")
    return k, p, library, b_ms, b_by


def phase_rig(card: str, errs: dict) -> tuple:
    """Phase 12: B7 against its plain version, then the rig's main path with
    the launch counts set to 0 just before and read just after, then its
    timing. Returns (launches, B7's timing row, {metric: value})."""
    phase_streams(errs)
    rigs = {key: build_rig(*key) for key, _ in RIG_RUNS}
    reset_launches()
    expected = {k: 0 for k in read_launches()}

    def add(counts):
        for name, v in counts.items():
            expected[name] += v

    for (n, w, h), cases in RIG_RUNS:
        add(drive_rig(rigs[(n, w, h)], cases, f"{n}x{w}x{h}"))
    key, batch = RIG_BATCHED
    add(drive_batched(rigs[key], batch, f"{key[0]}x{key[1]}x{key[2]}"))
    metrics = {}
    for w, h, truth, timed in NODE_RUNS:
        node_expected, node_metrics = drive_node(w, h, truth, timed, card)
        add(node_expected)
        metrics.update(node_metrics)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[12] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    frame_ms = time_rig(rigs, card)
    for key in RIG_PROFILED:
        profile_rig_frame(rigs[key[:3]], key[3], card)
    streams = time_streams(rigs[RIG_STREAMS_TIMED], card)
    log(f"[12] summary ms/frame {json.dumps(frame_ms)} node {json.dumps(metrics)} on {card}")
    return launches, streams, {**frame_ms, **metrics}


# -- phase 13: morphology (B6), the depth filters, the dual deployment ---------


def morph_masks(scene: Scene, g: torch.Generator) -> dict:
    """B6's inputs at the scene's size: a random mask, the scene's own
    depth-validity masks (the filter's input, with holes), and the edge
    cases: all 0, all 1, single-pixel rows and columns."""
    h, w = scene.h, scene.w
    depth = torch.from_numpy(scene.frames[0][0].depth.astype(np.int32)).to(DEVICE)
    lines = torch.zeros((h, w), dtype=torch.uint8, device=DEVICE)
    lines[h // 2, :] = 1
    lines[:, w // 3] = 1
    lines[0, :] = 1
    lines[:, w - 1] = 1
    return {
        "random": torch.randint(0, 2, (h, w), generator=g, device=DEVICE, dtype=torch.uint8),
        "depth>0": (depth > 0).to(torch.uint8),
        "depth in 0.5-3 m": ((depth >= 500) & (depth <= 3000)).to(torch.uint8),
        "zeros": torch.zeros((h, w), dtype=torch.uint8, device=DEVICE),
        "ones": torch.ones((h, w), dtype=torch.uint8, device=DEVICE),
        "lines": lines,
    }


def fused_box(w: int, h: int, roi) -> Optional[tuple]:
    """``roi`` as ``filter_depth`` hands it to B6's fused call: the clamped
    (x0, y0, x1, y1), ends exclusive, or None."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    if roi is None:
        return None
    x0, y0, rw, rh = F._clamped_roi(h, w, roi)
    return x0, y0, x0 + rw, y0 + rh


def morph_rois(w: int, h: int) -> tuple:
    """B6's ROIs at w×h: none, an inner box, boxes on the left, top, right
    (clipped there) and bottom edges, one pixel, and the negative box (the
    whole image)."""
    return (None, (40, 20, w - 120, h - 60), (0, h // 4, w // 3, h // 2),
            (w // 3, 0, w // 2, h // 4), (w - 50, h // 3, w, h // 3), (w // 4, h - 30, w // 2, 30),
            (w // 2, h // 2, 1, 1), (-1, -1, -1, -1))


def phase_morph(scenes, errs: dict) -> tuple:
    """(a) B6 bit-exact to its plain versions on the card: 1, 2 and 4
    passes in one launch against the chain of single passes, on the scenes'
    masks and on planes of 1×1, 1×W, H×1 and 33×31 (u8 planes and bool
    masks); the fused ``filter_depth(use_morphology=True)`` against its
    plain version on the scenes' depth with every ROI of
    :func:`morph_rois` and on the small planes. (b) That call on the card
    bit-identical to the CPU with one B6 launch a call, the launch counts
    of (b) alone (:func:`time_morph` traces a call for its device ops).
    Returns (B6's launches in (b), the number of card calls)."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6

    def check(label, got, want):
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        errs["morph_plane"] = max(errs["morph_plane"], err)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"B6 differs from its plain version on {label}: {err}")

    g = torch.Generator(device=DEVICE).manual_seed(13)
    masks = {f"{kind} {s.w}x{s.h}": m for s in scenes for kind, m in morph_masks(s, g).items()}
    for h, w in MORPH_SMALL:
        masks[f"random {w}x{h}"] = torch.randint(0, 2, (h, w), generator=g, device=DEVICE,
                                                 dtype=torch.uint8)
        masks[f"u8 values {w}x{h}"] = torch.randint(0, 256, (h, w), generator=g, device=DEVICE,
                                                    dtype=torch.uint8)
    for label, m in masks.items():
        for passes in MORPH_PASSES:
            want = B6.morph_passes_plain(m, passes)
            check(f"{label} passes {passes}", (B6.morph_passes(m, passes),), (want,))
            if not label.startswith("u8 values"):
                check(f"{label} as a bool mask, passes {passes}",
                      (B6.mask_passes(m.bool(), passes),), (want.view(torch.bool),))
    log(f"[13a] morph_passes and, on the 0/1 planes as bool masks, mask_passes (erode, dilate, "
        f"open, close, open+close) in one launch each, bit-exact to the chain of single passes "
        f"on {len(masks)} planes ({', '.join(masks)})")
    planes = []
    for s in scenes:
        for f in (s.frames[0][0], s.frames[1][1]):
            planes.append((f"{s.w}x{s.h}", torch.from_numpy(f.depth.astype(np.int32)).to(DEVICE),
                           torch.tensor(f.depth_scale, device=DEVICE), morph_rois(s.w, s.h)))
    for h, w in MORPH_SMALL:
        d = torch.randint(0, 3500, (h, w), generator=g, device=DEVICE, dtype=torch.int32)
        planes.append((f"{w}x{h}", d, torch.tensor(0.001, device=DEVICE),
                       (None, (w // 2, h // 2, 1, 1))))
    lo, hi = torch.tensor(0.5, device=DEVICE), torch.tensor(3.0, device=DEVICE)
    for size, depth, scale, rois in planes:
        h, w = depth.shape
        for roi in rois:
            check(f"filter_depth {size} roi={roi}",
                  F.filter_depth(depth, scale, lo, hi, roi, use_morphology=True),
                  B6.filter_depth_open_close_plain(depth, scale, lo, hi, fused_box(w, h, roi)))
    log(f"[13a] filter_depth(use_morphology=True), one launch, bit-exact to its plain version on "
        f"{len(planes)} depth planes ({', '.join(p[0] for p in planes)}) with ROIs on every edge "
        f"and of one pixel")
    reset_launches()
    calls = 0
    for scene in scenes:
        rois = (None, (40, 20, scene.w - 120, scene.h - 60), (scene.w // 2, scene.h // 2, 1, 1))
        for roi in rois:
            for k, pair in enumerate(scene.frames):
                for f in pair:
                    before = read_launches()["morph_plane"]
                    out = {}
                    for dev in (DEVICE, "cpu"):
                        out[dev] = F.filter_depth(
                            torch.from_numpy(f.depth.astype(np.int32)).to(dev),
                            torch.tensor(f.depth_scale, device=dev),
                            torch.tensor(0.5, device=dev), torch.tensor(3.0, device=dev), roi,
                            use_morphology=True)
                    torch.cuda.synchronize()
                    calls += 1
                    n = read_launches()["morph_plane"] - before
                    (dg, vg), (dc, vc) = out[DEVICE], out["cpu"]
                    same = torch.equal(dg.cpu(), dc) and torch.equal(vg.cpu(), vc)
                    closed_holes = int((vc & (dc == 0)).sum())
                    if not same or n != 1:
                        raise AssertionError(f"filter_depth(use_morphology=True) "
                                             f"{scene.w}x{scene.h} roi={roi}: card==CPU {same}, "
                                             f"{n} B6 launches")
            log(f"[13b] filter_depth(use_morphology=True) dual {scene.w}x{scene.h} roi={roi}: "
                f"card bit-identical to the CPU on {2 * len(scene.frames)} frames, 1 B6 launch "
                f"each; valid {float(vc.float().mean()):.4f}, closed-in pixels with depth 0 "
                f"{closed_holes} (the JAX order, reproduced)")
    launches = read_launches()
    log(f"[13b] launches {launches}, expected morph_plane {calls} and no other")
    if launches["morph_plane"] != calls or sum(launches.values()) != calls:
        raise AssertionError(f"[13b] launch counts {launches}")
    return launches["morph_plane"], calls


def device_ops_of_one_call(label: str, fn, launches: int) -> None:
    """Fails unless one traced ``fn()`` makes exactly ``launches`` kernel
    launches and no copy or fill: no device op but the kernel's (an eager
    op is a launch of its own)."""
    fn()
    trace = traced(fn, 1)
    log(f"[13] {label}: one call makes {trace.launches} kernel launches and {trace.copy_calls} "
        f"copies or fills (host records; device: {trace.counts()})")
    if DEVICE == "cuda" and (trace.launches != launches or trace.copy_calls):
        raise AssertionError(f"{label}: {trace.launches} launches and {trace.copy_calls} copies "
                             f"a call, expected {launches} and 0")


def bare_filter_depth(depth, scale, lo, hi, box):
    """One launch of B6's fused filter_depth on prebuilt outputs, with no
    checks: the launch alone, as the wrapper makes it."""
    import ctypes

    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6

    h, w = depth.shape
    d_out = torch.empty((h, w), dtype=torch.int32, device=depth.device)
    m_out = torch.empty((h, w), dtype=torch.bool, device=depth.device)
    bits = sum(1 << p for p, dilate in enumerate(B6.OPEN_CLOSE) if dilate)
    zero = ctypes.c_float(0.0)
    x0, y0, x1, y1 = box or (0, 0, w, h)
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    call = (depth.data_ptr(), B6.DEPTH_KINDS[depth.dtype], d_out.data_ptr(), m_out.data_ptr(), h,
            w, len(B6.OPEN_CLOSE), bits, scale.data_ptr(), zero, lo.data_ptr(), zero, hi.data_ptr(),
            zero, x0, y0, x1, y1, stream)
    return lambda: lib.filter_depth_morph_launch(*call)


def time_morph(scenes, card: str) -> tuple:
    """B6 at each size: the fused ``filter_depth(use_morphology=True)``
    (wrapper, device and bare launch, against its plain version on the
    card), and one pass against its plain version and the nearest library
    composition (max_pool2d over 3×5 and 5×3, then maximum: no one PyTorch
    call has the 21-point element, nor the fused call). Returns (the fused
    call's row at the last size, {size: filter_depth ms})."""
    import torch.nn.functional as NF

    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6

    row, filter_ms = None, {}
    for scene in scenes:
        f = scene.frames[0][0]
        depth = torch.from_numpy(f.depth.astype(np.int32)).to(DEVICE)
        n = depth.numel()
        scale, lo, hi = (torch.tensor(v, device=DEVICE) for v in (f.depth_scale, 0.5, 3.0))
        roi = (40, 20, scene.w - 120, scene.h - 60)
        box = fused_box(scene.w, scene.h, roi)
        size = f"{scene.w}x{scene.h}"
        device_ops_of_one_call(f"filter_depth(use_morphology=True) {size}",
                               lambda: F.filter_depth(depth, scale, lo, hi, roi,
                                                      use_morphology=True), 1)
        # 4 B of depth in, 4 B of depth and 1 B of mask out a pixel; about 20
        # min/max a pass and 8 operations for the window a pixel.
        b_ms, b_by = bound(9 * n, (20 * len(B6.OPEN_CLOSE) + 8) * n)
        row = time_one("morph_plane", f"filter_depth(use_morphology=True) {size}",
                       lambda: F.filter_depth(depth, scale, lo, hi, roi, use_morphology=True),
                       lambda: B6.filter_depth_open_close_plain(depth, scale, lo, hi, box),
                       bare_filter_depth(depth, scale, lo, hi, box), b_ms, b_by, None, card, "13")
        filter_ms[size] = row[0]
        mask = (depth > 0).to(torch.uint8)
        try:
            NF.max_pool2d(mask[None, None], (3, 5), 1, (1, 2))
            lib_in, lib_dtype = mask[None, None], "uint8"
        except RuntimeError:
            lib_in, lib_dtype = mask[None, None].float(), "float32 (uint8 not taken)"

        def library():
            return torch.maximum(NF.max_pool2d(lib_in, (3, 5), 1, (1, 2)),
                                 NF.max_pool2d(lib_in, (5, 3), 1, (2, 1)))

        same = torch.equal(library()[0, 0].to(torch.uint8), B6.morph_plane(mask, True))
        lib_ms = cuda_ms(library, 50)
        k, p, each = turns(lambda: B6.morph_plane(mask, True),
                           lambda: B6.morph_plane_plain(mask, True), iters=50)
        dk, parts = device_time(lambda: B6.morph_plane(mask, True))
        # 1 B in and 1 B out per pixel; 20 min/max per pixel.
        one_ms, one_by = bound(2 * n, 20 * n)
        log(f"[13] morph_plane, one pass at one {size} u8 mask: kernel {k:.5f} ms "
            f"({each[0]:.5f}, {each[1]:.5f}), device {device_text(dk, parts)}, plain {p:.5f} ms "
            f"({each[2]:.5f}, {each[3]:.5f}), library {lib_ms:.5f} ms (3 calls: max_pool2d 3x5 "
            f"and 5x3, maximum; on {lib_dtype}; equal to B6's dilation: {same}), bound "
            f"{one_ms:.5f} ms by {one_by} on {card}")
    return row, filter_ms


def phase_spatial(scene: Scene, errs: dict) -> int:
    """The spatial filter's row-scan kernel bit-exact to its plain version
    on the card: holes_fill 0-5 and magnitude 1-3 on crops of the scene's
    depth of odd and one-pixel shapes (int32, and uint16 and int64 for some),
    and on their f32 disparity; ``2 · magnitude`` launches a call and no
    other device op. Returns the launches of these calls."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import spatial_cuda as S

    depth = torch.from_numpy(scene.frames[0][0].depth.astype(np.int32)).to(DEVICE)
    fx = 631.0 * scene.w / 848.0
    planes = {f"{w}x{h}": depth[:h, :w].contiguous() for w, h in SPATIAL_SHAPES}
    calls = []
    for label, d in planes.items():
        for holes_fill in range(6):
            for magnitude in (1, 2, 3):
                calls.append((f"{label} holes_fill {holes_fill} magnitude {magnitude}", d,
                              (0.55, 20.0, magnitude, holes_fill)))
        calls.append((f"{label} uint16", d.to(torch.uint16), (0.55, 20.0, 2, 3)))
        calls.append((f"{label} int64", d.to(torch.int64), (0.55, 20.0, 2, 5)))
        for holes_fill in (0, 3):
            calls.append((f"{label} disparity holes_fill {holes_fill}",
                          F.depth_to_disparity(d, 0.001, fx), (0.5, 8.0, 2, holes_fill)))
    reset_launches()
    expected = 0
    for label, d, args in calls:
        got = S.spatial_filter(d, *args)
        want = S.spatial_filter_plain(d, *args)
        torch.cuda.synchronize()
        expected += 2 * args[2]
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
        errs["spatial_filter"] = max(errs["spatial_filter"], err)
        if got.dtype != d.dtype or not torch.equal(got, want):
            raise AssertionError(f"spatial kernel differs from its plain version on {label}: {err}")
    launches = read_launches()
    log(f"[13c] spatial_filter kernel bit-exact to its plain version in {len(calls)} calls "
        f"({', '.join(planes)}: holes_fill 0-5 x magnitude 1-3, uint16, int64, disparity); "
        f"launches {launches}, expected spatial_filter {expected} (2 a magnitude) and no other")
    if launches["spatial_filter"] != expected or sum(launches.values()) != expected:
        raise AssertionError(f"[13c] launch counts {launches}")
    for magnitude in (1, 2, 3):
        device_ops_of_one_call(f"spatial_filter {scene.w}x{scene.h} magnitude {magnitude}",
                               lambda: S.spatial_filter(depth, 0.55, 20.0, magnitude, 3),
                               2 * magnitude)
    return expected


def bare_spatial(depth, alpha, delta, magnitude, holes_fill):
    """One call of the spatial kernels' C entry on prebuilt outputs, with no
    checks."""
    import ctypes

    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import spatial_cuda as S

    h, w = depth.shape
    out = torch.empty_like(depth)
    floating = depth.dtype == torch.float32
    work = out if floating else torch.empty((h, w), dtype=torch.float32, device=depth.device)
    kind = S.KINDS[depth.dtype]
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    call = (depth.data_ptr(), kind, work.data_ptr(), out.data_ptr(), kind, h, w, magnitude,
            ctypes.c_float(alpha), ctypes.c_float(1.0 - alpha), ctypes.c_float(delta),
            int(not floating), S.spatial_holes_radius(holes_fill, w), stream)
    return lambda: lib.spatial_launch(*call)


def time_spatial(scene: Scene, card: str) -> tuple:
    """The spatial filter at the scene's size, in the three settings phase
    13c compares with the CPU: the kernel bit-exact to its plain version on
    the card, its wrapper (CUDA events, 20 calls, in turns with the plain
    version's single calls: the plain loop takes ~1 s), device time and
    bare launch, beside both bounds: bytes and operations, and the
    dependency chain. Returns the holes_fill 0 row."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import spatial_cuda as S

    depth = torch.from_numpy(scene.frames[0][0].depth.astype(np.int32)).to(DEVICE)
    disp = F.depth_to_disparity(depth, 0.001, 631.0 * scene.w / 848.0)
    h, w = depth.shape
    n = depth.numel()
    row = None
    for label, d, args in (("holes_fill 0", depth, (0.55, 20.0, 2, 0)),
                           ("holes_fill 3", depth, (0.55, 20.0, 2, 3)),
                           ("disparity", disp, (0.5, 8.0, 1, 0))):
        kernel = lambda d=d, args=args: S.spatial_filter(d, *args)  # noqa: E731
        plain = lambda d=d, args=args: S.spatial_filter_plain(d, *args)  # noqa: E731
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f"spatial kernel differs from its plain version at {w}x{h} "
                                 f"{label}")
        p1 = cuda_ms(plain, 1, 0)
        k1, k2 = cuda_ms(kernel, 20), cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 1, 0)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        dk, parts = device_time(kernel, 10)
        bare_ms = cuda_ms(bare_spatial(d, *args), 20)
        magnitude = args[2]
        # 4 B in and 4 B out a pixel; about 10 f32 operations a pixel a sweep.
        b_ms, b_by = bound(8 * n, 40 * magnitude * n)
        steps = magnitude * 2 * ((w - 1) + (h - 1))
        chain_ms = steps * CHAIN_OPS * F32_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3
        log(f"[13] spatial_filter {w}x{h} {label} (magnitude {magnitude}): wrapper {k:.5f} ms "
            f"({k1:.5f}, {k2:.5f}), device {device_text(dk, parts)}, bare launch {bare_ms:.5f} ms, "
            f"plain {p:.5f} ms ({p1:.5f}, {p2:.5f}), library none, bound {b_ms:.5f} ms by {b_by}, "
            f"dependency chain {chain_ms:.5f} ms ({steps} steps x {CHAIN_OPS} dependent f32 ops "
            f"x {F32_LATENCY_CYCLES} cycles at {SM_CLOCK_HZ / 1e9:.2f} GHz) on {card}")
        if row is None:
            row = (k, p, None, b_ms, b_by)
    return row


def phase_depth_filters(scene: Scene, card: str) -> dict:
    """(c) Every other A10 function on the card and on the CPU on the
    scene's depth: bit-identical, except the bilateral filter (the card's
    expf may round differently from the CPU's: ±1 raw unit on at most
    PIXEL_BUDGET of pixels). Times each on the card: {name: ms}."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    d0, d1 = (f.depth.astype(np.int32) for f in (scene.frames[0][0], scene.frames[1][0]))
    color = scene.frames[0][0].color
    fx = 631.0 * scene.w / 848.0
    cases = {
        "mask_count": lambda d, p, c: F.mask_count(d > 0),
        "median_filter 5x5 u16": lambda d, p, c: F.median_filter(d, 2, interior_roi=False),
        "median_filter 3x3 u16 interior": lambda d, p, c: F.median_filter(d, 1),
        "gauss_filter 5x5 u16": lambda d, p, c: F.gauss_filter(d, 5, interior_roi=False),
        "gauss_filter 5x5 u8 color": lambda d, p, c: F.gauss_filter(c, 5),
        "temporal_filter": lambda d, p, c: F.temporal_filter(d, p)[0],
        "hole_fill left": lambda d, p, c: F.hole_fill(d, "left"),
        "hole_fill farthest": lambda d, p, c: F.hole_fill(d, "farthest"),
        "hole_fill nearest": lambda d, p, c: F.hole_fill(d, "nearest"),
        "decimation_filter 2": lambda d, p, c: F.decimation_filter(d, 2),
        "depth_to_disparity": lambda d, p, c: F.depth_to_disparity(d, 0.001, fx),
        "disparity_to_depth": lambda d, p, c: F.disparity_to_depth(
            F.depth_to_disparity(d, 0.001, fx), 0.001, fx),
        "spatial_filter": lambda d, p, c: F.spatial_filter(d),
        "spatial_filter holes_fill 3": lambda d, p, c: F.spatial_filter(d, holes_fill=3),
        "spatial_filter disparity": lambda d, p, c: F.spatial_filter(
            F.depth_to_disparity(d, 0.001, fx), 0.5, 8.0, 1),
        "bilateral_filter_depth": lambda d, p, c: F.bilateral_filter_depth(d),
    }
    inputs = {dev: (torch.from_numpy(d0).to(dev), torch.from_numpy(d1).to(dev),
                    torch.from_numpy(color).to(dev)) for dev in (DEVICE, "cpu")}
    out = {}
    for name, fn in cases.items():
        got = fn(*inputs[DEVICE])
        torch.cuda.synchronize()
        want = fn(*inputs["cpu"])
        diff = (got.cpu().to(torch.float64) - want.to(torch.float64)).abs()
        share = float((diff > 0).float().mean()) if diff.numel() else 0.0
        slow = name == "bilateral_filter_depth"
        ms = cuda_ms(lambda: fn(*inputs[DEVICE]), 1 if slow else 10, 1 if slow else 3)
        out[name] = ms
        log(f"[13c] {name} {scene.w}x{scene.h}: card vs CPU max|d|={float(diff.max()):.6g} on "
            f"{share:.6g} of outputs; {ms:.5f} ms on {card}")
        if name == "bilateral_filter_depth":
            if float(diff.max()) > 1 or share > PIXEL_BUDGET:
                raise AssertionError(f"{name}: card vs CPU {float(diff.max())} on {share}")
        elif share:
            raise AssertionError(f"{name}: card differs from the CPU on {share} of outputs")
    return out


def deployment_manifest(w: int, h: int, frames: int, every: int, out_dir: str,
                        overrides: dict = None) -> dict:
    """configs/deployment_dual.yaml at w×h, ``frames`` frames, registration
    every ``every`` (0: off), the viewer in ``out_dir``; ``overrides``
    {"cameras"|"fusion"|"registration": override yaml path} for those
    config tiers."""
    from pointcloud_depthfusion_tpu_torch.nodes.launch import load_manifest

    m = dict(load_manifest(os.path.join(REPO, "configs", "deployment_dual.yaml")))
    overrides = overrides or {}
    if "cameras" in overrides:
        m["cameras"] = [dict(c, config=overrides["cameras"]) for c in m["cameras"]]
    if "fusion" in overrides:
        m["fusion"] = {"config": overrides["fusion"]}
    reg = {"every_n_frames": every}
    if "registration" in overrides:
        reg["config"] = overrides["registration"]
    m.update(width=w, height=h, frames=frames, registration=reg,
             viewer={"out_dir": out_dir, "every_n": DEPLOY_SAVE_EVERY})
    return m


def run_deployment_recorded(manifest: dict, dev, cams: Optional[list] = None,
                            pairs: Optional[list] = None) -> tuple:
    """``run_deployment`` on ``dev``, recording every fused image the viewer
    receives: (summary, [(stamp, image)], wall s ending in synchronize,
    [class name of each camera's source]). ``cams`` collects the camera
    nodes built, ``pairs`` the (left, right) host frames of every pair the
    fusion node fused."""
    from pointcloud_depthfusion_tpu_torch.nodes import fusion_node, image_node, launch

    seen, sources = [], []
    orig, orig_build = image_node.ImageNode.__call__, launch._build_camera
    orig_process = fusion_node.FusionNodeApp.process_pair

    def record(self, image, ts):
        seen.append((ts, np.array(image)))
        orig(self, image, ts)

    def build(*args):
        cam = orig_build(*args)
        sources.append(type(cam.source).__name__)
        if cams is not None:
            cams.append(cam)
        return cam

    def process(self, pair):
        if pairs is not None:
            pairs.append((pair.host_left, pair.host_right))
        return orig_process(self, pair)

    image_node.ImageNode.__call__ = record
    launch._build_camera = build
    fusion_node.FusionNodeApp.process_pair = process
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = launch.run_deployment(manifest, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        image_node.ImageNode.__call__ = orig
        launch._build_camera = orig_build
        fusion_node.FusionNodeApp.process_pair = orig_process
    return summary, seen, wall, sources


def deployment_expected(summary: dict) -> dict:
    """A card deployment's launches: B3, B2 and one B4 image per fused frame
    (fusion_default.yaml: tiled with the z-buffer, Gauss tail); B5 4 per
    rebuilt target grid and 2 per cached tick."""
    frames, ticks, rebuilds = (summary[k] for k in ("frames", "registration_ticks",
                                                    "registration_grid_rebuilds"))
    return {"fuse_prep": frames, "zresolve_sorted_entries": frames, "gauss3x3_image": frames,
            "segsum_sorted": 4 * rebuilds + 2 * (ticks - rebuilds)}


def fusion_keep_all(tmp: str) -> str:
    """A fusion override config with the QoS lifespan off: the fusion tier
    keeps every pair, so the CPU's slower frames drop none."""
    path = os.path.join(tmp, "fusion_keep_all.yaml")
    with open(path, "w") as fh:
        fh.write("fusion_node:\n  qos: {lifespan_s: 0}\n")
    return path


def phase_deployment(tmp: str, card: str) -> tuple:
    """(d) ``run_deployment`` with the dual manifest at each size: on the
    card for DEPLOY_FRAMES frames with registration every DEPLOY_EVERY
    (every frame fused, the summary sane, PNGs written); with registration
    off, card and CPU from the same seeds, fused images within
    PIXEL_BUDGET; with registration on (every DEPLOY_CMP_EVERY), the last
    transform within TRANSFORM_ATOL of the CPU run's. The comparison runs
    use override configs: the fusion tier keeps every pair (QoS lifespan
    off, so the CPU's slower frames drop none); for the registration
    comparison the cameras render without noise or holes, so the pair the
    registration node ticks on (the latest the feeder thread has captured,
    which differs run to run) does not matter, and the stereo angle gate
    is off (the rig's 10° toe-in fails it, as in phase 8), so the compared
    transform is the solver's and not the identity kept by a discard.
    Returns (expected launches, {metric: value})."""
    fusion_yaml = fusion_keep_all(tmp)
    reg_yaml = os.path.join(tmp, "registration_no_angle_gate.yaml")
    with open(reg_yaml, "w") as fh:
        fh.write("registration_node:\n  angle_gate: false\n")
    clean_yaml = os.path.join(tmp, "cameras_clean.yaml")
    with open(clean_yaml, "w") as fh:
        fh.write("".join(f"{n}:\n  sensor:\n    depth: {{depth_noise_std: 0.0, "
                         f"hole_fraction: 0.0}}\n" for n in ("camera_left", "camera_right")))
    expected = {}
    metrics = {}

    def add(summary):
        for k, v in deployment_expected(summary).items():
            expected[k] = expected.get(k, 0) + v

    for w, h in DEPLOY_SIZES:
        size = f"{w}x{h}"
        out_dir = os.path.join(tmp, f"live_{size}")
        summary, seen, wall, sources = run_deployment_recorded(
            deployment_manifest(w, h, DEPLOY_FRAMES, DEPLOY_EVERY, out_dir), DEVICE)
        add(summary)
        pngs = sorted(os.listdir(out_dir))
        coverage = min(float(img.any(-1).mean()) for _, img in seen)
        log(f"[13d] run_deployment dual {size} on the card: {json.dumps(summary)}; "
            f"{len(seen)} frames in {wall:.3f} s ({len(seen) / wall:.3f} frames/s live, "
            f"cameras {'/'.join(sources)}), min coverage {coverage:.4f}, {len(pngs)} PNGs on "
            f"{card}")
        if sources != ["NativeSyntheticSource"] * 2:
            raise AssertionError(f"deployment {size}: camera sources {sources}")
        if (summary["frames"] != DEPLOY_FRAMES or len(seen) != DEPLOY_FRAMES
                or summary["fused_shape"] != [w, h, 3] or coverage < 0.5
                or summary["registration_ticks"] != -(-DEPLOY_FRAMES // DEPLOY_EVERY)
                or not np.isfinite(summary["registration_fitness"])
                or len(pngs) != summary["saved_pngs"] or not pngs):
            raise AssertionError(f"deployment {size}: {summary}, {len(seen)} frames, "
                                 f"{len(pngs)} PNGs")
        metrics[f"deployment_{size}_fps_live"] = len(seen) / wall
        runs = {}
        for dev in (DEVICE, "cpu"):
            runs[dev] = run_deployment_recorded(deployment_manifest(
                w, h, DEPLOY_CMP_FRAMES, 0, os.path.join(tmp, f"off_{size}_{dev}"),
                {"fusion": fusion_yaml}), dev)
        add(runs[DEVICE][0])
        worst = 0.0
        for (tg, ig), (tc, ic) in zip(runs[DEVICE][1], runs["cpu"][1]):
            if tg != tc:
                raise AssertionError(f"deployment {size}: card frame {tg} vs CPU frame {tc}")
            worst = max(worst, float((ig != ic).any(-1).mean()))
        log(f"[13d] registration off, {DEPLOY_CMP_FRAMES} frames, card vs CPU: fused images "
            f"differ on at most {worst:.6g} of pixels (budget {PIXEL_BUDGET})")
        if len(runs[DEVICE][1]) != DEPLOY_CMP_FRAMES or worst > PIXEL_BUDGET:
            raise AssertionError(f"deployment {size}: card vs CPU {worst}")
        metrics[f"deployment_{size}_card_vs_cpu_pixels"] = worst
        runs = {}
        for dev in (DEVICE, "cpu"):
            runs[dev] = run_deployment_recorded(deployment_manifest(
                w, h, DEPLOY_CMP_FRAMES, DEPLOY_CMP_EVERY, os.path.join(tmp, f"on_{size}_{dev}"),
                {"fusion": fusion_yaml, "cameras": clean_yaml, "registration": reg_yaml}), dev)
        add(runs[DEVICE][0])
        tg, tc = (np.asarray(runs[d][0]["registration_transform"]) for d in (DEVICE, "cpu"))
        diff = float(np.abs(tg - tc).max())
        frames_differ = max(float((a != b).any(-1).mean())
                            for (_, a), (_, b) in zip(runs[DEVICE][1], runs["cpu"][1]))
        log(f"[13d] registration every {DEPLOY_CMP_EVERY}, {DEPLOY_CMP_FRAMES} frames, clean "
            f"cameras, no angle gate: last transform card vs CPU max|d|={diff:.3g} (bar "
            f"{TRANSFORM_ATOL}), its distance from the identity {np.abs(tc - np.eye(4)).max():.3g}; "
            f"fitness card {runs[DEVICE][0]['registration_fitness']:.9g} CPU "
            f"{runs['cpu'][0]['registration_fitness']:.9g}; fused frames differ on at most "
            f"{frames_differ:.6g} of pixels")
        if diff > TRANSFORM_ATOL:
            raise AssertionError(f"deployment {size}: card vs CPU transform {diff}")
        metrics[f"deployment_{size}_transform_card_vs_cpu"] = diff
    return expected, metrics


def phase_node_timing(scenes, tmp: str, card: str) -> tuple:
    """(f) FusionNodeApp.run over prerendered frames replayed through
    CameraNodes, REPLAY_FRAMES frames at each size: frames/s with
    async_readback on and off, then one profiled pass (process_profiled)
    with its stage laps and upload_ms. Returns (expected launches,
    {metric: value})."""
    import os

    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu_torch.utils.factory import fusion_config

    from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset

    metrics, frames = {}, 0
    for scene in scenes:
        size = f"{scene.w}x{scene.h}"
        intr, _ = framesets(scene, "cpu")
        # The scene's frame pairs in a loop, stamped k/30 s.
        streams = [[HostFrameset(f.depth, f.color, k / 30.0, f.depth_scale)
                    for k in range(REPLAY_FRAMES)
                    for f in [scene.frames[k % len(scene.frames)][i]]] for i in range(2)]
        for mode in ("sync readback", "async readback", "profiled"):
            cams = [CameraNode(name, ReplaySource(streams[i], intr))
                    for i, name in enumerate(("camera_left", "camera_right"))]
            cfg, _ = fusion_config(device=DEVICE)
            prof = os.path.join(tmp, f"profile_{size}.csv") if mode == "profiled" else None
            app = FusionNodeApp(*cams, config=cfg, device=DEVICE,
                                async_readback=mode == "async readback", profiling_path=prof)
            app.on_transform(scene.t_rl)
            uploads = []
            process = app.process_pair

            def timed(pair, process=process, uploads=uploads):
                uploads.append(pair.upload_ms)
                return process(pair)

            app.process_pair = timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = app.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            frames += done
            if done != REPLAY_FRAMES:
                raise AssertionError(f"node {size} {mode}: {done} frames")
            fps = done / wall
            metrics[f"node_{size}_{mode.replace(' ', '_')}_fps"] = fps
            log(f"[13f] FusionNodeApp.run {size} {mode}: {done} frames in {wall:.3f} s "
                f"({fps:.3f} frames/s), upload_ms mean {np.mean(uploads):.4f} min "
                f"{np.min(uploads):.4f} max {np.max(uploads):.4f} on {card}")
            metrics[f"node_{size}_{mode.replace(' ', '_')}_upload_ms_mean"] = float(np.mean(uploads))
            if prof:
                with open(prof) as fh:
                    rows = [line.strip().split(",") for line in fh]
                head, vals = rows[0], np.asarray(rows[2:], np.float64)  # skip the first frame
                laps = {k: float(v) for k, v in zip(head, vals.mean(0))}
                log(f"[13f] process_profiled {size}, mean of frames 2-{len(rows) - 1} (ms): "
                    + " ".join(f"{k}={v:.4f}" for k, v in laps.items()) + f" on {card}")
                metrics[f"node_{size}_laps_ms"] = laps
    # Each fused frame, profiled or not: B3, B2 and one B4 image (tiled with
    # the z-buffer).
    return ({"fuse_prep": frames, "zresolve_sorted_entries": frames, "gauss3x3_image": frames},
            metrics)


def phase_host_runtime(card: str) -> dict:
    """(e, a-b) The native host runtime: built by g++ from the checkout's
    ``csrc/host/pdf_runtime.cpp`` (a failed build raises with the
    compiler's output, so the run fails); the renderer timed against the
    numpy SyntheticSource for one camera frame at each of RENDER_SIZES,
    with the deployment's noise and holes, and held bit for bit against it
    on noise-free frames; the spatial filter (u16 depth, with and without
    holes_fill, and f32 disparity) and the decimation filter timed against
    their numpy versions on a FILTER_SIZE frame and held bit for bit against
    them. Host times on the card machine's CPU. Returns {metric: value}."""
    from pointcloud_depthfusion_tpu_torch import runtime
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.io.feeder import NativeSyntheticSource, SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.ops import host_filters as HF
    from pointcloud_depthfusion_tpu_torch.runtime import bindings
    from pointcloud_depthfusion_tpu_torch.utils.factory import camera_config

    t0 = time.perf_counter()
    lib = runtime.load_library()
    log(f"[13e] host runtime {os.path.relpath(lib._name, REPO)} loaded in "
        f"{time.perf_counter() - t0:.3f} s ({'built' if bindings.build_log else 'no'} compiler "
        f"output; g++ {' '.join(bindings.CXX_FLAGS)}), {os.cpu_count()} host CPUs")
    for line in bindings.build_log.splitlines()[-5:]:
        log(f"[13e] g++: {line}")
    if not runtime.is_available():
        raise AssertionError("the native host runtime is not available")
    metrics = {}
    wl, _ = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    for w, h in RENDER_SIZES:
        fx = 631.0 * w / 848.0
        intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
        clean = dict(depth_noise_std=0.0, hole_fraction=0.0, seed=1)
        a = NativeSyntheticSource(SyntheticScene(), intr, wl, **clean).next_frame()
        b = SyntheticSource(SyntheticScene(), intr, wl, **clean).next_frame()
        same = np.array_equal(a.depth, b.depth) and np.array_equal(a.color, b.color)
        native = host_clock_ms(
            NativeSyntheticSource(SyntheticScene(), intr, wl, seed=10).next_frame, RENDER_ITERS)
        plain = host_clock_ms(SyntheticSource(SyntheticScene(), intr, wl, seed=10).next_frame,
                              RENDER_NUMPY_ITERS, warmup=0)
        # One camera's whole capture as the deployment runs it: the native
        # render and the host filters its config turns on (the temporal one).
        node = CameraNode("camera_left", NativeSyntheticSource(SyntheticScene(), intr, wl,
                                                               seed=10))
        node.attach_config(camera_config("camera_left"))
        capture = host_clock_ms(node.capture, RENDER_ITERS)
        log(f"[13e] render one camera frame {w}x{h}: native {native:.4f} ms, numpy {plain:.4f} "
            f"ms ({plain / native:.1f}x); noise-free frames bit-identical: {same}; "
            f"CameraNode.capture (native render, temporal filter) {capture:.4f} ms (host CPU of "
            f"the machine of {card})")
        if not same:
            raise AssertionError(f"native render {w}x{h} differs from the numpy renderer")
        metrics[f"render_{w}x{h}_ms"] = {"native": native, "numpy": plain, "capture": capture}
    w, h = FILTER_SIZE
    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
    depth = NativeSyntheticSource(SyntheticScene(), intr, wl, seed=10).next_frame().depth
    disp = HF.depth_to_disparity_np(depth, 0.001, fx)
    cases = {
        "spatial u16": (lambda: runtime.spatial_filter_native(depth),
                        lambda: HF._spatial_filter_numpy(depth)),
        "spatial u16 holes_fill 3": (lambda: runtime.spatial_filter_native(depth, holes_fill=3),
                                     lambda: HF._spatial_filter_numpy(depth, holes_fill=3)),
        "spatial f32 disparity": (lambda: runtime.spatial_filter_native(disp, 0.5, 8.0, 1),
                                  lambda: HF._spatial_filter_numpy(disp, 0.5, 8.0, 1)),
        "decimation 2": (lambda: runtime.decimation_filter_native(depth, 2),
                         lambda: HF._decimation_filter_numpy(depth, 2)),
    }
    for name, (native_fn, plain_fn) in cases.items():
        got, want = native_fn(), plain_fn()
        same = got.dtype == want.dtype and np.array_equal(got, want)
        native = host_clock_ms(native_fn, FILTER_ITERS)
        plain = host_clock_ms(plain_fn, FILTER_NUMPY_ITERS, warmup=0)
        log(f"[13e] {name} {w}x{h}: native {native:.4f} ms, numpy {plain:.4f} ms "
            f"({plain / native:.1f}x); bit-identical: {same} (host CPU of the machine of {card})")
        if not same:
            raise AssertionError(f"native {name} differs from its numpy version")
        metrics[f"{name.replace(' ', '_')}_{w}x{h}_ms"] = {"native": native, "numpy": plain}
    return metrics


def phase_recorded(tmp: str, card: str) -> tuple:
    """(e, c-d) Both cameras recorded by the port's CameraNode.main at
    RECORD_SIZE for DEPLOY_FRAMES frames as ``.npz``, and the left one again
    as ``.pdfe`` (its frames decoded equal to the ``.npz`` ones); then
    run_deployment with the two recordings as sources: on the card for
    DEPLOY_FRAMES frames with registration every DEPLOY_EVERY (every frame
    fused, coverage at least 0.5, a finite fitness), and with registration
    off on the card and the CPU for DEPLOY_CMP_FRAMES frames, the fused
    images within PIXEL_BUDGET. Returns (expected launches, {metric:
    value})."""
    from pointcloud_depthfusion_tpu_torch.io.encoded import read_encoded_stream
    from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource
    from pointcloud_depthfusion_tpu_torch.nodes import camera_node

    w, h = RECORD_SIZE
    size = f"{w}x{h}"
    args = ["--width", str(w), "--height", str(h), "--frames", str(DEPLOY_FRAMES)]
    paths = {}
    for name, ext in (("camera_left", "npz"), ("camera_right", "npz"), ("camera_left", "pdfe")):
        path = paths[name, ext] = os.path.join(tmp, f"{name}.{ext}")
        t0 = time.perf_counter()
        camera_node.main(["--name", name, *args, "--out", path])
        log(f"[13e] CameraNode.main --name {name} {size} --frames {DEPLOY_FRAMES} --out "
            f"{name}.{ext}: {time.perf_counter() - t0:.3f} s, {os.path.getsize(path)} bytes")
    t0 = time.perf_counter()
    rec = RecordedSource(paths["camera_left", "npz"])
    load_s = time.perf_counter() - t0
    log(f"[13e] RecordedSource(camera_left.npz) loads {len(rec)} frames in {load_s:.3f} s "
        "(inside each replayed run_deployment's wall, once a camera)")
    decoded = read_encoded_stream(paths["camera_left", "pdfe"])
    if len(rec) != DEPLOY_FRAMES or len(decoded) != DEPLOY_FRAMES:
        raise AssertionError(f"recordings hold {len(rec)} and {len(decoded)} frames")
    for got in decoded:
        want = rec.next_frame()
        if not (np.array_equal(got.depth, want.depth) and np.array_equal(got.color, want.color)
                and (got.timestamp, got.depth_scale) == (want.timestamp, want.depth_scale)):
            raise AssertionError("the .pdfe frames differ from the .npz recording's")
    cams = [{"name": n, "source": paths[n, "npz"]} for n in ("camera_left", "camera_right")]

    def manifest(frames, every, out_dir, fusion=None):
        m = deployment_manifest(w, h, frames, every, os.path.join(tmp, out_dir),
                                {"fusion": fusion} if fusion else None)
        m["cameras"] = cams
        return m

    summary, seen, wall, sources = run_deployment_recorded(
        manifest(DEPLOY_FRAMES, DEPLOY_EVERY, "replay"), DEVICE)
    expected = deployment_expected(summary)
    coverage = min(float(img.any(-1).mean()) for _, img in seen)
    fps = len(seen) / wall
    log(f"[13e] run_deployment dual {size} replayed on the card: {json.dumps(summary)}; "
        f"{len(seen)} frames in {wall:.3f} s ({fps:.3f} frames/s replayed, cameras "
        f"{'/'.join(sources)}), min coverage {coverage:.4f} on {card}")
    if (sources != ["RecordedSource"] * 2 or summary["frames"] != DEPLOY_FRAMES
            or len(seen) != DEPLOY_FRAMES or summary["fused_shape"] != [w, h, 3]
            or coverage < 0.5 or summary["registration_ticks"] != -(-DEPLOY_FRAMES // DEPLOY_EVERY)
            or not np.isfinite(summary["registration_fitness"])):
        raise AssertionError(f"replayed deployment: {summary}, {len(seen)} frames, {sources}")
    runs = {dev: run_deployment_recorded(manifest(DEPLOY_CMP_FRAMES, 0, f"replay_off_{dev}",
                                                  fusion_keep_all(tmp)), dev)
            for dev in (DEVICE, "cpu")}
    for k, v in deployment_expected(runs[DEVICE][0]).items():
        expected[k] += v
    worst = 0.0
    for (tg, ig), (tc, ic) in zip(runs[DEVICE][1], runs["cpu"][1]):
        if tg != tc:
            raise AssertionError(f"replayed deployment: card frame {tg} vs CPU frame {tc}")
        worst = max(worst, float((ig != ic).any(-1).mean()))
    log(f"[13e] replayed, registration off, {DEPLOY_CMP_FRAMES} frames, card vs CPU: fused "
        f"images differ on at most {worst:.6g} of pixels (budget {PIXEL_BUDGET})")
    if len(runs[DEVICE][1]) != DEPLOY_CMP_FRAMES or worst > PIXEL_BUDGET:
        raise AssertionError(f"replayed deployment: card vs CPU {worst}")
    return expected, {f"deployment_{size}_fps_replayed": fps,
                      f"deployment_{size}_replayed_card_vs_cpu_pixels": worst,
                      f"recording_{size}_load_s": load_s}


def read_line(proc, timeout: float) -> str:
    """The next line of ``proc``'s stdout, waiting at most ``timeout`` s."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        raise AssertionError(f"no output from {proc.args} within {timeout} s")
    return proc.stdout.readline()


def stop_camera_hosts(hosts: list, check: bool = True) -> list:
    """SIGINT to each camera host, then its exit JSON line (frames sent and
    dropped, whether CUDA was initialised); ``check=False`` only reaps."""
    import signal

    for _, proc, _ in hosts:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
    stats = []
    for name, proc, _ in hosts:
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if check:
            lines = out.strip().splitlines()
            if proc.returncode != 0 or not lines or not lines[-1].startswith("{"):
                raise AssertionError(f"camera host {name}: exit {proc.returncode}, stdout "
                                     f"{out[-2000:]!r}, stderr {err[-2000:]!r}")
            stats.append(json.loads(lines[-1]))
    return stats


def start_camera_hosts(codec: str, w: int, h: int) -> list:
    """The two camera hosts of phase 13g as processes: [[name, process,
    port]], each on a free port it reports."""
    hosts = []
    try:
        for name in ("camera_left", "camera_right"):
            cmd = [sys.executable, "-m", "pointcloud_depthfusion_tpu_torch.io.network", "--name",
                   name, "--host", "127.0.0.1", "--port", "0", "--width", str(w), "--height",
                   str(h), "--frames", str(TWO_HOST_FRAMES), "--codec", codec, "--queue-size",
                   str(TWO_HOST_QUEUE)]
            hosts.append([name, subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True), None])
        for host in hosts:
            line = read_line(host[1], HOST_START_S)
            port = re.search(r":(\d+) \(", line)
            if port is None:
                raise AssertionError(f"camera host {host[0]} printed {line!r}")
            host[2] = int(port.group(1))
    except BaseException:
        stop_camera_hosts(hosts, check=False)
        raise
    return hosts


def two_host_manifest(hosts: list, every: int, out_dir: str) -> dict:
    w, h = TWO_HOST_SIZE
    m = deployment_manifest(w, h, TWO_HOST_FRAMES, every, out_dir)
    m["cameras"] = [{"name": name, "source": f"tcp://127.0.0.1:{port}"} for name, _, port in hosts]
    return m


def fuse_pairs_on_cpu(pairs: list, intrs: list) -> list:
    """[(stamp, image)] of FusionNodeApp on the CPU over the given host pairs
    (already filtered by the card run's camera nodes, so no filter here),
    with the shipped fusion config and every pair kept."""
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu_torch.utils import factory

    cams = [CameraNode(name, ReplaySource([p[i] for p in pairs], intrs[i]),
                       temporal_filter=False)
            for i, name in enumerate(("camera_left", "camera_right"))]
    cfg, tree = factory.fusion_config(device="cpu")
    kwargs = dict(factory.fusion_node_kwargs_from_tree(tree), lifespan_s=None)
    app = FusionNodeApp(*cams, config=cfg, device="cpu", **kwargs)
    out = []
    app.subscribe_fused(lambda img, ts: out.append((ts, np.array(img))))
    if app.run() != len(pairs):
        raise AssertionError(f"the CPU fused {len(out)} of {len(pairs)} pairs")
    return out


def check_two_host_summary(label: str, summary: dict, seen: list, sources: list, every: int,
                           out_dir: Optional[str]) -> float:
    """The two-host and served runs' bar: every frame fused, the shape, the
    coverage, the ticks and a finite fitness (when registration runs), and
    the PNGs; returns the least coverage."""
    w, h = TWO_HOST_SIZE
    coverage = min(float(img.any(-1).mean()) for _, img in seen) if seen else 0.0
    pngs = sorted(os.listdir(out_dir)) if out_dir else []
    ok = (summary["frames"] == TWO_HOST_FRAMES and len(seen) == TWO_HOST_FRAMES
          and summary["fused_shape"] == [w, h, 3] and coverage >= 0.5
          and len(pngs) == summary["saved_pngs"] and pngs)
    if every:
        ok = ok and summary["registration_ticks"] == -(-TWO_HOST_FRAMES // every) \
            and np.isfinite(summary["registration_fitness"])
    if not ok:
        raise AssertionError(f"{label}: {summary}, {len(seen)} frames, sources {sources}, "
                             f"coverage {coverage}, {len(pngs)} PNGs")
    return coverage


def phase_two_host(tmp: str, card: str) -> tuple:
    """(g) The two-host deployment at TWO_HOST_SIZE with the shipped fusion
    and registration configs. For each codec, two camera-host processes
    (``python -m pointcloud_depthfusion_tpu_torch.io.network``) serve the
    fusion host's ``run_deployment`` (tcp:// cameras, registration every
    DEPLOY_EVERY, the PNG sink) on the card: every frame fused, coverage at
    least 0.5, a finite fitness; the fusion host's frames/s and its receive
    and decode time per frame, each host's frames sent and dropped (0), and
    no host initialised CUDA. With the raw codec a second run on the same
    hosts has registration off, and TWO_HOST_CMP_PAIRS of the pairs it fused
    are fused again on the CPU: within PIXEL_BUDGET. Then serve: on both
    synthetic cameras of a card deployment with a NetworkSource client on
    one served port: the deployment fuses every frame and the client
    receives frames. Returns (expected launches, {metric: value})."""
    from pointcloud_depthfusion_tpu_torch.io import network
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode

    w, h = TWO_HOST_SIZE
    size = f"{w}x{h}"
    expected, metrics = {}, {}

    def add(summary):
        for k, v in deployment_expected(summary).items():
            expected[k] = expected.get(k, 0) + v

    for codec in TWO_HOST_CODECS:
        t0 = time.perf_counter()
        hosts = start_camera_hosts(codec, w, h)
        start_s = time.perf_counter() - t0
        runs = 1
        bank_s, orig_bank = [], CameraNode._apply_filter_bank

        def bank(self, fs):
            t = time.perf_counter()
            out = orig_bank(self, fs)
            bank_s.append(time.perf_counter() - t)
            return out

        try:
            cams = []
            out_dir = os.path.join(tmp, f"two_host_{codec}")
            CameraNode._apply_filter_bank = bank  # the fusion host's filters, timed
            try:
                summary, seen, wall, sources = run_deployment_recorded(
                    two_host_manifest(hosts, DEPLOY_EVERY, out_dir), DEVICE, cams=cams)
            finally:
                CameraNode._apply_filter_bank = orig_bank
            add(summary)
            coverage = check_two_host_summary(f"two-host {codec}", summary, seen, sources,
                                              DEPLOY_EVERY, out_dir)
            if sources != ["NetworkSource"] * 2:
                raise AssertionError(f"two-host {codec}: camera sources {sources}")
            nets = [c.source for c in cams]
            recv = [1e3 * n.recv_s / n.frames_received for n in nets]
            decode = [1e3 * n.decode_s / n.frames_received for n in nets]
            fps = len(seen) / wall
            log(f"[13g] two hosts, {codec}, {size}: run_deployment on the card "
                f"{json.dumps(summary)}; {len(seen)} frames in {wall:.3f} s ({fps:.3f} frames/s), "
                f"min coverage {coverage:.4f}; fusion host per frame: receive "
                f"{recv[0]:.3f} | {recv[1]:.3f} ms (waits included), decode {decode[0]:.3f} | "
                f"{decode[1]:.3f} ms (left | right), the camera node's filter bank (temporal) "
                f"{1e3 * np.mean(bank_s):.3f} ms a capture; frames received "
                f"{[n.frames_received for n in nets]}; hosts started in {start_s:.3f} s, on "
                f"{card}")
            metrics[f"two_host_{codec}_{size}_fps"] = fps
            metrics[f"two_host_{codec}_{size}_recv_ms"] = recv
            metrics[f"two_host_{codec}_{size}_decode_ms"] = decode
            metrics[f"two_host_{codec}_{size}_filter_ms"] = 1e3 * float(np.mean(bank_s))
            if codec == "raw":
                runs += 1
                pairs, cams = [], []
                off, seen_off, _, _ = run_deployment_recorded(
                    two_host_manifest(hosts, 0, os.path.join(tmp, "two_host_off")), DEVICE,
                    cams=cams, pairs=pairs)
                add(off)
                if off["frames"] != TWO_HOST_FRAMES or len(pairs) != TWO_HOST_FRAMES:
                    raise AssertionError(f"two-host, registration off: {off}, {len(pairs)} pairs")
                step = TWO_HOST_FRAMES // TWO_HOST_CMP_PAIRS
                chosen = pairs[::step][:TWO_HOST_CMP_PAIRS]
                card_by_stamp = dict(seen_off)
                worst = 0.0
                for ts, img in fuse_pairs_on_cpu(chosen, [c.source.intrinsics for c in cams]):
                    worst = max(worst, float((card_by_stamp[ts] != img).any(-1).mean()))
                log(f"[13g] two hosts, raw, registration off: {len(chosen)} of the "
                    f"{len(pairs)} fused pairs fused again on the CPU: the card's images "
                    f"differ on at most {worst:.6g} of pixels (budget {PIXEL_BUDGET})")
                if worst > PIXEL_BUDGET:
                    raise AssertionError(f"two-host card vs CPU {worst}")
                metrics[f"two_host_{size}_card_vs_cpu_pixels"] = worst
        except BaseException:
            stop_camera_hosts(hosts, check=False)
            raise
        stats = stop_camera_hosts(hosts)
        per_frame = [{k: 1e3 * st[k] / (st["frames_sent"] + st["frames_dropped"])
                      for k in ("capture_s", "encode_s")} for st in stats]
        log(f"[13g] camera hosts ({codec}) at exit: {json.dumps(stats)}; per frame (ms, the "
            f"machine's host CPU): {json.dumps(per_frame)}")
        for st in stats:
            if (st["cuda_initialized"] or st["frames_dropped"]
                    or st["frames_sent"] != runs * TWO_HOST_FRAMES):
                raise AssertionError(f"camera host {st}")
        metrics[f"two_host_{codec}_hosts"] = stats
        metrics[f"two_host_{codec}_host_ms"] = per_frame

    # serve: on both cameras, and a remote client on the first served port.
    ports, received, readers = [], [], []
    orig_start = network.FramesetStreamServer.start

    def read(client):
        try:
            while (fs := client.next_frame()) is not None:
                received.append(fs)
        except ConnectionError:
            pass  # stop() at the deployment's end may cut the stream

    def start(self):
        orig_start(self)
        ports.append(self.port)
        if len(ports) == 1:
            reader = threading.Thread(target=read, args=(network.NetworkSource(
                "127.0.0.1", self.port, timeout_s=60.0),), daemon=True)
            reader.start()
            readers.append(reader)
        return self

    out_dir = os.path.join(tmp, "served")
    manifest = deployment_manifest(w, h, TWO_HOST_FRAMES, DEPLOY_EVERY, out_dir)
    manifest["cameras"] = [dict(c, serve="127.0.0.1:0") for c in manifest["cameras"]]
    network.FramesetStreamServer.start = start
    try:
        summary, seen, wall, sources = run_deployment_recorded(manifest, DEVICE)
    finally:
        network.FramesetStreamServer.start = orig_start
    for reader in readers:
        reader.join(timeout=60.0)
    add(summary)
    coverage = check_two_host_summary("served", summary, seen, sources, DEPLOY_EVERY, out_dir)
    log(f"[13g] serve: on both cameras, {size}: run_deployment on the card "
        f"{json.dumps(summary)}; {len(seen)} frames in {wall:.3f} s "
        f"({len(seen) / wall:.3f} frames/s), min coverage {coverage:.4f}; the remote client on "
        f"port {ports[0]} received {len(received)} frames on {card}")
    if (summary["served_ports"] != ports or len(ports) != 2 or not received
            or any(r.is_alive() for r in readers)
            or any(fs.depth.shape != (h, w) for fs in received)):
        raise AssertionError(f"served deployment: {summary}, ports {ports}, "
                             f"{len(received)} frames received")
    metrics[f"served_{size}_fps"] = len(seen) / wall
    metrics[f"served_{size}_client_frames"] = len(received)
    return expected, metrics


def phase_demo(tmp: str, card: str) -> dict:
    """(g) The demo as its own process on the card: exit 0, the card named,
    the summary JSON last with every frame fused and a finite fitness, and
    its PNGs written."""
    out = os.path.join(tmp, "demo")
    cmd = [sys.executable, "-m", "pointcloud_depthfusion_tpu_torch.nodes.demo", *DEMO_ARGS,
           "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    pngs = sorted(os.listdir(out)) if os.path.isdir(out) else []
    log(f"[13g] demo {' '.join(DEMO_ARGS)}: exit {proc.returncode} in {wall:.3f} s (the "
        f"process's start and build included); {lines[0] if lines else ''}; {json.dumps(summary)}; "
        f"{len(pngs)} PNGs on {card}")
    frames = int(DEMO_ARGS[DEMO_ARGS.index("--frames") + 1])
    if (proc.returncode != 0 or summary.get("frames") != frames
            or not np.isfinite(summary.get("registration_fitness") or np.nan)
            or summary.get("saved_pngs") != len(pngs) or not pngs
            or torch.cuda.get_device_name(0) not in lines[0]):
        raise AssertionError(f"demo: exit {proc.returncode}, {summary}, {len(pngs)} PNGs, "
                             f"stdout {proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]!r}")
    return {"demo_wall_s": wall, "demo_fused_ms_p50": summary["fused_ms_p50"]}


def phase_filters_and_deployment(scenes, card: str, errs: dict) -> tuple:
    """Phase 13. Returns (launches of each kernel on its main paths here,
    B6's and the spatial filter's timing rows, {metric: value})."""
    import tempfile

    morph_launches, calls = phase_morph(scenes, errs)
    spatial_launches = phase_spatial(scenes[0], errs)
    filter_ms = phase_depth_filters(scenes[0], card)
    host_metrics = phase_host_runtime(card)  # before 13d: its cameras render natively
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        expected = {k: 0 for k in read_launches()}
        dep_expected, metrics = phase_deployment(tmp, card)
        rec_expected, rec_metrics = phase_recorded(tmp, card)
        node_expected, node_metrics = phase_node_timing(scenes, tmp, card)
        t0 = time.perf_counter()
        two_host_expected, two_host_metrics = phase_two_host(tmp, card)
        two_host_metrics.update(phase_demo(tmp, card))
        two_host_metrics["phase_13g_s"] = time.perf_counter() - t0
        log(f"[13g] phase wall {two_host_metrics['phase_13g_s']:.3f} s")
        for part in (dep_expected, rec_expected, node_expected, two_host_expected):
            for k, v in part.items():
                expected[k] += v
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"[13d-g] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    launches["morph_plane"] = morph_launches
    launches["spatial_filter"] = spatial_launches
    rows = {"morph_plane": None, "spatial_filter": time_spatial(scenes[0], card)}
    rows["morph_plane"], fd_ms = time_morph(scenes, card)
    metrics.update(rec_metrics)
    metrics.update(node_metrics)
    metrics.update(two_host_metrics)
    log(f"[13] summary filters ms {json.dumps(filter_ms)} filter_depth+morphology ms "
        f"{json.dumps(fd_ms)} deployment {json.dumps(metrics)} on {card}")
    log(f"[13e] summary host runtime ms (the machine's host CPU) {json.dumps(host_metrics)}; "
        + ", ".join(f"{k} {v:.3f}" for k, v in metrics.items()
                    if k.endswith(("_fps_live", "_fps_replayed", "_fps")))
        + f" frames/s on {card}")
    return launches, rows, metrics


# -- phase 14: the multi-GPU tier on one card ---------------------------------


def card_mesh(shards: int, device, axis: str = "cam"):
    """make_camera_mesh(shards): on the card its default (every shard on
    the one card's ``cuda:0``), elsewhere on ``device``."""
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import make_camera_mesh

    if device == "cuda":
        return make_camera_mesh(shards, axis)
    return make_camera_mesh(shards, axis, device=device)


def sharded_step(rig: Rig, mode: str, device, shards: int):
    """The per-camera rig step of ``rig`` (RIG_ROIS on every camera, tiled
    with the z-buffer or packed): rig_fuse_sharded over ``shards`` shards,
    or rig_fuse with ``shards`` = 0."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse, rig_fuse_sharded

    cfg = FusionConfig.create(render_mode=mode, device=device, **RIG_CONFIG)
    intr = rig_intrinsics(rig.w, rig.h, True, n=rig.n)
    fused = fused_virtual_intrinsics(intr[0], False)
    rois = (RIG_ROIS * rig.n)[:rig.n]
    if not shards:
        return rig_fuse(intr, fused, cfg, rois=rois, device=device)
    return rig_fuse_sharded(card_mesh(shards, device), intr, fused, cfg, rois=rois)


def drive_sharded_rig(rig: Rig, tag: str) -> dict:
    """(a) rig_fuse_sharded over each mesh of SHARD_COUNTS, tiled and
    packed: bit-exact to rig_fuse on the card, and against the CPU's
    sharded step within the rig's bars. Returns the expected launches."""
    expected: dict = {}

    def add(name, v):
        expected[name] = expected.get(name, 0) + v

    for mode in ("tiled", "packed"):
        resolve = "scatter_min_u32" if mode == "packed" else "zresolve_sorted_entries"
        one = sharded_step(rig, mode, DEVICE, 0)
        cpu = sharded_step(rig, mode, "cpu", SHARD_COUNTS[0])
        steps = {s: sharded_step(rig, mode, DEVICE, s) for s in SHARD_COUNTS}
        for k in range(len(rig.frames)):
            want = one(*rig_args(rig, k, DEVICE))
            ic = cpu(*rig_args(rig, k, "cpu"))
            for name in ("fuse_prep", resolve, "color_image"):
                add(name, 1)
            for s, fn in steps.items():
                ig = fn(*rig_args(rig, k, DEVICE))
                torch.cuda.synchronize()
                same = torch.equal(ig, want)
                names, fr, ok = rig_mismatch(ig, ic, mode)
                coverage = float(ig.any(-1).float().mean())
                log(f"[14a {tag}] {mode} over {s} shards frame {k}: coverage={coverage:.4f}, "
                    f"bit-exact to rig_fuse on the card: {same}; vs CPU: "
                    + " ".join(f"{n}={v:.6g}" for n, v in zip(names, fr)))
                if not same or not ok or coverage < 0.5:
                    raise AssertionError(f"sharded {tag} {mode} s={s} frame {k}: equal {same}, "
                                         f"vs CPU {fr}, coverage {coverage}")
                for name in ("fuse_prep", resolve):
                    add(name, s)
                add("color_image", 1)
    return expected


def time_sharded_rig(rig: Rig, card: str, iters: int = 10, warmup: int = 2) -> dict:
    """ms/frame of rig_fuse and of rig_fuse_sharded over each mesh (CUDA
    events), each frame new tensors."""
    out = {}
    for mode in ("tiled", "packed"):
        for s in (0, *SHARD_COUNTS):
            fn = sharded_step(rig, mode, DEVICE, s)
            frames = fresh_rig_args(rig, iters + warmup, DEVICE)
            key = f"{'rig_fuse' if not s else f'sharded_{s}'}_{rig.n}x{rig.w}x{rig.h}_{mode}"
            out[key] = cuda_ms(lambda: fn(*next(frames)), iters, warmup)
    log(f"[14a] ms/frame (CUDA events, {iters} frames after {warmup} warm-up) "
        f"{json.dumps(out)} on {card}")
    return out


def drive_sharded_node(card: str) -> tuple:
    """(b) RigFusionNodeApp(mesh=) over SHARD_NODE_FRAMES prerendered frames:
    every fused image equal to rig_fuse's (z-buffer) on the same host
    frames. Returns (expected launches, {metric: value})."""
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse

    n, w, h = SHARD_NODE
    intr = rig_intrinsics(w, h)
    poses, rendered = render_arc(n, w, h, SHARD_NODE_FRAMES, 2000, 10)
    streams = [[fs[i] for fs in rendered] for i in range(n)]
    app = RigFusionNodeApp([ReplaySource(s, intr) for s in streams], intr,
                           poses.astype(np.float32), mesh=card_mesh(SHARD_NODE_MESH, DEVICE))
    images, host = [], []
    fuse_one = app.process_batch

    def process(batch):
        host.append(batch.host_frames)
        images.append(fuse_one(batch))
        return images[-1]

    app.process_batch = process
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = app.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = rig_fuse(intr, app.fused_intrinsics, app.config, device=DEVICE)
    c2v = torch.from_numpy(poses.astype(np.float32)).to(DEVICE)
    same = []
    for img, frames in zip(images, host):
        d = torch.from_numpy(np.stack([f.depth for f in frames]).astype(np.int32)).to(DEVICE)
        c = torch.from_numpy(np.stack([f.color for f in frames])).to(DEVICE)
        s = torch.tensor([f.depth_scale for f in frames], dtype=torch.float32, device=DEVICE)
        same.append(np.array_equal(img, one(d, c, s, c2v).cpu().numpy()))
    log(f"[14b] RigFusionNodeApp over a {SHARD_NODE_MESH}-shard mesh: {done} frames of "
        f"{n}x{w}x{h} in {wall:.3f} s ({done / wall:.3f} frames/s, no sweeps), z-buffer "
        f"{app.config.emit_zbuf}, each frame equal to rig_fuse on the card: {all(same)} on {card}")
    if done != SHARD_NODE_FRAMES or not all(same) or not app.config.emit_zbuf:
        raise AssertionError(f"sharded node: {done} frames, equal {same}")
    per = {"fuse_prep": SHARD_NODE_MESH + 1, "zresolve_sorted_entries": SHARD_NODE_MESH + 1,
           "color_image": 2}
    return ({k: v * done for k, v in per.items()},
            {f"sharded_node_{n}x{w}x{h}_fps": done / wall})


def registration_pair_clouds(scene: Scene, settings) -> tuple:
    """The dual scene's right and left registration clouds (the tick's own
    cloud program) and the shipped settings' fine-stage GICPConfig."""
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline

    fine = dataclasses.replace(settings, adjust_resolution=False)
    intr, _ = framesets(scene, DEVICE)
    pipe = RegistrationPipeline(intr, intr, fine, device=DEVICE)
    scale = torch.tensor(0.001, device=DEVICE)
    clouds = [pipe._cloud_fn(side)(torch.from_numpy(f.depth.astype(np.int32)).to(DEVICE),
                                   scale)[:2]
              for side, f in (("right", scene.frames[0][1]), ("left", scene.frames[0][0]))]
    return clouds, pipe._make_config()


def solve_timed(fn) -> tuple:
    """(result, host ms ending in synchronize, B5 launches)."""
    before = read_launches()["segsum_sorted"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, read_launches()["segsum_sorted"] - before


def result_text(res) -> str:
    return (f"iterations {int(res.iterations)}, converged {bool(res.converged)}, fitness "
            f"{float(res.fitness):.6g}, correspondences {int(res.num_correspondences)}")


def drive_sharded_solve(scene: Scene, settings, card: str) -> tuple:
    """(c) gicp_register_sharded over SHARD_SOLVE shards against
    gicp_register on the card (within TRANSFORM_ATOL), and (f) the matrix
    solver against the planar one with direct1. Returns (B5 launches,
    {metric: value})."""
    from pointcloud_depthfusion_tpu_torch.registration.distributed import gicp_register_sharded
    from pointcloud_depthfusion_tpu_torch.registration.gicp import gicp_register

    (src, sval), (tgt, tval) = registration_pair_clouds(scene, settings)[0]
    cfg = registration_pair_clouds(scene, settings)[1]
    init = torch.from_numpy(scene.t_rl2).to(DEVICE)
    size = f"{scene.w}x{scene.h}"
    metrics, n_b5 = {}, 0
    for rep in range(2):  # the first call of each warms the allocator
        single, single_ms, b5_single = solve_timed(
            lambda: gicp_register(src, sval, tgt, tval, init, cfg))
        sharded, sharded_ms, b5_sharded = solve_timed(lambda: gicp_register_sharded(
            card_mesh(SHARD_SOLVE, DEVICE, "pt"), src, sval, tgt, tval, init, cfg))
        n_b5 += b5_single + b5_sharded
    diff = float((sharded.transform - single.transform).abs().max())
    t_err = truth_error(sharded.transform.cpu().numpy(), scene.t_rl)
    log(f"[14c] gicp_register_sharded over {SHARD_SOLVE} shards, dual {size} clouds "
        f"({src.shape[0]} and {tgt.shape[0]} points, {cfg.neighbor_search}, resolution "
        f"{float(cfg.resolution)}): max|d| vs gicp_register on the card {diff:.3g} (bar "
        f"{TRANSFORM_ATOL}); sharded {result_text(sharded)}; single {result_text(single)}; "
        f"vs truth {t_err}; {sharded_ms:.3f} ms against {single_ms:.3f} ms (host clock ending in "
        f"synchronize, second call); B5 launches {b5_sharded} and {b5_single} on {card}")
    if diff > TRANSFORM_ATOL or b5_sharded != b5_single or b5_single < 1:
        raise AssertionError(f"sharded solve: max|d| {diff}, B5 {b5_sharded} vs {b5_single}")
    metrics.update({f"sharded_solve_{size}_ms": sharded_ms, f"single_solve_{size}_ms": single_ms,
                    f"sharded_solve_{size}_max_diff": diff})
    direct1 = dataclasses.replace(cfg, neighbor_search="direct1")
    matrix_cfg = dataclasses.replace(direct1, solver="matrix")
    planar, planar_ms, b5_planar = solve_timed(
        lambda: gicp_register(src, sval, tgt, tval, init, direct1))
    matrix, matrix_ms, b5_matrix = solve_timed(
        lambda: gicp_register(src, sval, tgt, tval, init, matrix_cfg))
    n_b5 += b5_planar + b5_matrix
    diff = float((matrix.transform - planar.transform).abs().max())
    log(f"[14f] solver=matrix vs planar (direct1) on the card, dual {size}: max|d| {diff:.3g} "
        f"(bar {TRANSFORM_ATOL}); matrix {result_text(matrix)}, {matrix_ms:.3f} ms; planar "
        f"{result_text(planar)}, {planar_ms:.3f} ms (host clock ending in synchronize) on {card}")
    if diff > TRANSFORM_ATOL or b5_matrix != b5_planar:
        raise AssertionError(f"matrix solver: max|d| {diff}, B5 {b5_matrix} vs {b5_planar}")
    metrics.update({f"matrix_solve_{size}_ms": matrix_ms, f"matrix_vs_planar_{size}": diff})
    return n_b5, metrics


def drive_batched_solves(settings, card: str) -> tuple:
    """(c) gicp_register_batched and register_rig_pairs over 4 shards on the
    BATCHED_RIG rig's adjacent pairs, each bit-identical to sequential
    gicp_register calls on the card. Returns (B5 launches, {metric:
    value})."""
    from pointcloud_depthfusion_tpu_torch.registration.distributed import (
        gicp_register_batched, register_rig_pairs,
    )
    from pointcloud_depthfusion_tpu_torch.registration.gicp import GICPResult, gicp_register
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline

    n, w, h = BATCHED_RIG
    rig = build_rig(n, w, h, n_frames=1)
    intr = rig_intrinsics(w, h, device=DEVICE)
    pipe = RegistrationPipeline(intr, intr, dataclasses.replace(settings, adjust_resolution=False),
                                device=DEVICE)
    scale = torch.tensor(0.001, device=DEVICE)
    pts, val = zip(*(pipe._cloud_fn("left")(torch.from_numpy(d).to(DEVICE), scale)[:2]
                     for d in rig.frames[0][0]))
    clouds, valids = torch.stack(pts), torch.stack(val)
    cfg = pipe._make_config()
    inits = torch.from_numpy(np.stack([
        np.linalg.inv(rig.poses[i]) @ rig.poses[(i + 1) % n] @ yaw_bump(0.5, 0.01)
        for i in range(n)]).astype(np.float32)).to(DEVICE)
    src, sval = torch.roll(clouds, -1, 0), torch.roll(valids, -1, 0)
    mesh = card_mesh(n, DEVICE, "pair")
    # The sequential reference first: its first solve also warms the path.
    seq, seq_ms, b5_seq = solve_timed(lambda: [
        gicp_register(src[i], sval[i], clouds[i], valids[i], inits[i], cfg) for i in range(n)])
    batched, batched_ms, b5_batched = solve_timed(
        lambda: gicp_register_batched(mesh, src, sval, clouds, valids, inits, cfg))
    rig_res, rig_ms, b5_rig = solve_timed(
        lambda: register_rig_pairs(mesh, clouds, valids, cfg, inits, cyclic=False))
    fields = [f.name for f in dataclasses.fields(GICPResult)]
    same = all(torch.equal(getattr(batched, f)[i], getattr(seq[i], f))
               for f in fields for i in range(n))
    same_rig = all(torch.equal(rig_res.transform[i], seq[i].transform) for i in range(n))
    wrap = not bool(rig_res.converged[n - 1])
    log(f"[14c] gicp_register_batched over {n} shards, {n} pairs of {w}x{h} clouds "
        f"({clouds.shape[1]} points): bit-identical to sequential gicp_register: {same}; "
        f"register_rig_pairs(cyclic=False) transforms identical {same_rig}, wrap pair "
        f"unconverged {wrap}; iterations {[int(r.iterations) for r in seq]}; sequential "
        f"{seq_ms:.3f} ms (the first, warming), batched {batched_ms:.3f} ms, rig pairs "
        f"{rig_ms:.3f} ms (host clock ending in synchronize, one call each); B5 launches "
        f"{b5_seq}, {b5_batched}, {b5_rig} (sequential, batched, rig pairs) "
        f"on {card}")
    if not (same and same_rig and wrap) or not b5_batched == b5_rig == b5_seq > 0:
        raise AssertionError(f"batched solves: identical {same}/{same_rig}, wrap {wrap}, B5 "
                             f"{b5_batched}/{b5_rig}/{b5_seq}")
    return b5_batched + b5_rig + b5_seq, {f"batched_{n}x{w}x{h}_ms": batched_ms,
                                          f"sequential_{n}x{w}x{h}_ms": seq_ms}


def drive_multihost(tmp: str, card: str) -> tuple:
    """(d) The multihost worker as one NCCL process on the card at
    MULTIHOST_SIZE: its image equals this process's rig_fuse_sharded over
    the same one-shard mesh. Returns (expected launches, {metric:
    value})."""
    import socket

    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse_sharded
    from pointcloud_depthfusion_tpu_torch.parallel.multihost import rig_poses

    w, h = MULTIHOST_SIZE
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    out = os.path.join(tmp, "multihost.npy")
    cmd = [sys.executable, "-m", "pointcloud_depthfusion_tpu_torch.parallel.multihost",
           "--coordinator", f"localhost:{port}", "--num-processes", "1", "--process-id", "0",
           "--local-devices", "0" if MULTIHOST_BACKEND == "nccl" else "1",
           "--width", str(w), "--height", str(h), "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    host = Intrinsics.create(w, h, fx=50.0 * w / 64, fy=50.0 * w / 64, ppx=w / 2, ppy=h / 2,
                             device="cpu")
    pose = rig_poses(0, 1, 1)[0]
    f = SyntheticScene().render(host, pose)
    cfg = FusionConfig.create(vertical_image=False, mirror_image=False, filter_fused_color=False,
                              device=DEVICE)
    intr = host.to(DEVICE)
    want = rig_fuse_sharded(card_mesh(1, DEVICE), intr, intr, cfg)(
        torch.from_numpy(f.depth.astype(np.int32)[None]).to(DEVICE),
        torch.from_numpy(f.color[None]).to(DEVICE),
        torch.full((1,), 0.001, device=DEVICE), torch.from_numpy(pose[None]).to(DEVICE))
    same = proc.returncode == 0 and np.array_equal(np.load(out), want.cpu().numpy())
    log(f"[14d] multihost worker ({' '.join(cmd[3:-2])}): exit "
        f"{proc.returncode} in {wall:.3f} s (process start included); {json.dumps(summary)}; "
        f"image equal to the single-process sharded step: {same} on {card}")
    if not same or summary.get("backend") != MULTIHOST_BACKEND:
        raise AssertionError(f"multihost: exit {proc.returncode}, {summary}, equal {same}, "
                             f"stdout {proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]!r}")
    return ({"fuse_prep": 1, "zresolve_sorted_entries": 1, "color_image": 1},
            {"multihost_nccl_wall_s": wall})


def drive_pointcloud(scene: Scene, card: str) -> dict:
    """(e) PointCloud at the scene's size: deproject (0.5–3 m), transform
    by the scene's right→left pose and project (exact, packed) on the card
    against the CPU. Returns the expected launches."""
    from pointcloud_depthfusion_tpu_torch.core.pointcloud import PointCloud

    (intr, pairs), (intr_c, pairs_c) = framesets(scene, DEVICE), framesets(scene, "cpu")
    t = scene.t_rl
    clouds = [PointCloud.deproject(p[0][0], 0.5, 3.0).transform(t) for p in (pairs, pairs_c)]
    (gc, cc) = clouds
    pts_err = float((gc.points.cpu() - cc.points).abs().max())
    same_valid = torch.equal(gc.valid.cpu(), cc.valid)
    parts = [f"{int(gc.count())} of {gc.capacity} points valid (CPU {int(cc.count())}), points "
             f"max|d| {pts_err:.3g}, masks equal {same_valid}"]
    ok = same_valid and pts_err <= 1e-4
    expected = {}
    for mode in ("exact", "packed"):
        ig, zg = gc.project(intr, mode=mode)
        ic, zc = cc.project(intr_c, mode=mode)
        torch.cuda.synchronize()
        names, fr, good = rig_mismatch(ig, ic, "packed" if mode == "packed" else "tiled")
        cov = float(((zg.cpu() == ZMAX) != (zc == ZMAX)).float().mean())
        parts.append(f"{mode}: " + " ".join(f"{n}={v:.6g}" for n, v in zip(names, fr))
                     + f" zbuf coverage={cov:.6g}, coverage {float(ig.any(-1).float().mean()):.4f}")
        ok = ok and good and cov <= PIXEL_BUDGET
        name = "scatter_min_u32" if mode == "packed" else "zresolve_sorted_entries"
        expected[name] = expected.get(name, 0) + 1
    log(f"[14e] PointCloud {scene.w}x{scene.h} card vs CPU: " + "; ".join(parts) + f" on {card}")
    if not ok:
        raise AssertionError("PointCloud card vs CPU: " + "; ".join(parts))
    return expected


def phase_sharded(scenes, settings, card: str) -> tuple:
    """Phase 14: the multi-GPU tier on one card, with the launch counts set
    to 0 just before and read just after; then its timing. Returns
    (launches, {metric: value})."""
    import tempfile

    t0 = time.perf_counter()
    rig = build_rig(*SHARD_RIG)
    scene_720 = next(s for s in scenes if (s.w, s.h) == POINTCLOUD_SIZE)
    reset_launches()
    expected = {k: 0 for k in read_launches()}

    def add(counts):
        for name, v in counts.items():
            expected[name] += v

    add(drive_sharded_rig(rig, "{}x{}x{}".format(*SHARD_RIG)))
    node_expected, metrics = drive_sharded_node(card)
    add(node_expected)
    n_b5, solve_metrics = drive_sharded_solve(scene_720, settings, card)
    expected["segsum_sorted"] += n_b5
    metrics.update(solve_metrics)
    n_b5, batched_metrics = drive_batched_solves(settings, card)
    expected["segsum_sorted"] += n_b5
    metrics.update(batched_metrics)
    with tempfile.TemporaryDirectory() as tmp:
        mh_expected, mh_metrics = drive_multihost(tmp, card)
    add(mh_expected)
    metrics.update(mh_metrics)
    add(drive_pointcloud(scene_720, card))
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[14] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    metrics.update(time_sharded_rig(rig, card))
    metrics["phase_14_s"] = time.perf_counter() - t0
    log(f"[14] summary {json.dumps(metrics)} on {card}")
    return launches, metrics


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.utils.factory import registration_settings

    # [0] device
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[0] device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} nvcc={nvcc_ver} "
        f"python={sys.version.split()[0]}")

    # [1] build
    t0 = time.perf_counter()
    _build.load()
    log(f"[1] build: {time.perf_counter() - t0:.2f} s (done at {time.perf_counter() - t_start:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[1] ptxas: {line.strip()}")

    errs = {name: 0 for name in REPLACES}
    # [2], [3], [10] kernels against their plain versions
    scene_848 = build_scene(848, 480)
    scene_720 = build_scene(1280, 720)
    phase_resolve((scene_848, scene_720), errs)
    phase_filters(errs)
    rig_8 = phase_prep((scene_848, scene_720), errs)
    phase_align((scene_848, scene_720))

    # [4], [5] the fused frame; the launch counts cover exactly these phases.
    reset_launches()
    expected = {k: 0 for k in read_launches()}
    for scene, n_frames, n_median, tag in ((scene_848, 10, 2, "4: dual 848x480"),
                                           (scene_720, 4, 2, "5: dual 1280x720")):
        for k, v in drive_main_path(scene, n_frames, n_median, tag).items():
            expected[k] += v
    torch.cuda.synchronize()
    fusion_launches = read_launches()
    log(f"[4-5] launches {fusion_launches}, expected {expected}")
    if fusion_launches != expected:
        raise AssertionError(f"launch counts {fusion_launches} != expected {expected}")

    # [11] the other render modes and alignment; the launch counts cover
    # exactly this phase.
    reset_launches()
    expected = {k: 0 for k in read_launches()}
    for scene, n_frames, tag in ((scene_848, 2, "dual 848x480"), (scene_720, 2, "dual 1280x720")):
        for k, v in drive_modes(scene, n_frames, tag).items():
            expected[k] += v
    torch.cuda.synchronize()
    mode_launches = read_launches()
    log(f"[11] launches {mode_launches}, expected {expected}")
    if mode_launches != expected:
        raise AssertionError(f"launch counts {mode_launches} != expected {expected}")

    # [6] device ops of warm dual frames, profiled here: late in the run the
    # profiler's traces come back without device events far more often.
    frame_ops = {f"dual {s.w}x{s.h} {mode}": profile_frame(s, card, mode)
                 for s in (scene_848, scene_720) for mode in ("tiled", "pallas", "packed")}
    log(f"[11] done at {time.perf_counter() - t_start:.1f} s")
    # [7] B5 against its plain version on the registration clouds
    reg_scenes = [s for s in (scene_848, scene_720) if (s.w, s.h) in REG_SIZES]
    phase_segsum(reg_scenes, errs)

    # [8] the registration service with the shipped settings; the launch
    # counts cover exactly this phase.
    settings, _ = registration_settings()
    settings = dataclasses.replace(settings, angle_gate=False)
    log(f"[8] settings from configs/registration_default.yaml with angle_gate=False "
        f"(the toed-in rig's true yaw fails the stereo angle prior): {settings}")
    reset_launches()
    expected = {k: 0 for k in read_launches()}
    timed = {}
    for scene in reg_scenes:
        tag = f"dual {scene.w}x{scene.h}"
        pipe, host_ms, n_b5 = drive_registration(scene, settings, tag)
        expected["segsum_sorted"] += n_b5
        timed[tag] = (scene, pipe, host_ms)
    torch.cuda.synchronize()
    reg_launches = read_launches()
    log(f"[8] launches {reg_launches}, expected {expected} (B5: 4 per rebuilt grid, 2 per "
        f"cached tick)")
    if reg_launches != expected or reg_launches["segsum_sorted"] < 1:
        raise AssertionError(f"launch counts {reg_launches} != expected {expected}")

    log(f"[8] done at {time.perf_counter() - t_start:.1f} s")
    # [12] the N-camera rig: B7, rig_fuse, batched_rig_fuse and the rig node;
    # the launch counts cover exactly its main path.
    rig_launches, streams_timing, _ = phase_rig(card, errs)
    log(f"[12] done at {time.perf_counter() - t_start:.1f} s")

    # [13] B6, filter_depth with morphology, the other depth filters, and the
    # dual deployment; the launch counts cover exactly its main paths.
    filt_launches, filter_timing, _ = phase_filters_and_deployment((scene_848, scene_720), card,
                                                                   errs)
    log(f"[13] done at {time.perf_counter() - t_start:.1f} s")

    # [14] the multi-GPU tier on one card: the sharded rig and its node, the
    # sharded and batched solves, multihost, PointCloud and the matrix
    # solver; the launch counts cover exactly its main paths.
    shard_launches, _ = phase_sharded((scene_848, scene_720), settings, card)
    log(f"[14] done at {time.perf_counter() - t_start:.1f} s")

    # [6], [9] timing
    frame_ms = {**time_pipeline(scene_848, card), **time_pipeline(scene_720, card),
                **time_modes(scene_848, card), **time_modes(scene_720, card)}
    kernel_ms = {**time_kernels(card), **time_resolve((scene_848, scene_720), card),
                 **time_prep_kernels((scene_848, scene_720), rig_8, card)}
    tail_ms = time_color_tail(card)
    log(f"[6] summary color tail (ms, device ms) {json.dumps(tail_ms)}; device ops per warm "
        f"frame {json.dumps(frame_ops)} on {card}")
    log(f"[6] summary ms/frame {json.dumps(frame_ms)} on {card}")
    tick_ms = {}
    for tag, (scene, pipe, host_ms) in timed.items():
        cold, warm = host_ms[:3], host_ms[3:]
        its = [t.iterations for t in pipe.telemetry[:REG_TICKS]]
        tick_ms[tag] = {"cold_ms": sum(cold) / len(cold), "warm_ms": sum(warm) / len(warm)}
        log(f"[9] tick {tag}: cold (annealing) {tick_ms[tag]['cold_ms']:.3f} ms, warm "
            f"{tick_ms[tag]['warm_ms']:.3f} ms; per tick {[round(t, 3) for t in host_ms]} ms, "
            f"iterations {its} (host clock ending in synchronize, second card run) on {card}")
        tick_ms[tag]["profile"] = profile_tick(pipe, scene, card)
    seg = time_segsum(reg_scenes, card)
    log(f"[9] summary ms/tick {json.dumps(tick_ms)} on {card}")
    log(f"[6], [9] done at {time.perf_counter() - t_start:.1f} s")
    k, p, _, b_ms, b_by = seg[f"dual {reg_scenes[-1].w}x{reg_scenes[-1].h} cloud at 0.01 m"][:5]

    launches = {k: fusion_launches[k] + mode_launches[k] + reg_launches[k] + rig_launches[k]
                + filt_launches[k] + shard_launches[k] for k in fusion_launches}
    # No one PyTorch call computes both halves of B5 (the sums and the
    # representative); index_add_'s time for the sums alone is logged above.
    timing = {**kernel_ms, "segsum_sorted": (k, p, None, b_ms, b_by),
              "zresolve_sorted_streams": streams_timing, **filter_timing}
    log(card)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name][0], "plain_ms": timing[name][1], "bound_ms": timing[name][3],
         "bound_by": timing[name][4], "library_ms": timing[name][2]}
        for name in REPLACES
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
