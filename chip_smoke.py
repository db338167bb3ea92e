#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_depthfusion_tpu_torch/csrc``
(nvcc, into ``build/torch_kernels/``) and holds each kernel against its plain
PyTorch version at the main paths' shapes: among them B4's image kernel (the
fused frame's whole color tail in one launch, phase 3) and B5's own grouping
(phase 7), each also timed against the design it replaced. Then it drives the two services
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
  [13]  kernel B6 against its plain version, ``filter_depth`` with
        morphology (4 B6 launches a call) and the other depth filters
        against the CPU, the dual deployment ``launch.run_deployment``
        (CameraNode → DeviceFeeder → FusionNodeApp with RegistrationNodeApp
        ticks → ImageNode) on the card and against the CPU, and
        ``FusionNodeApp.run`` over prerendered frames, timed.

It times frames, ticks and kernels with CUDA events and a host clock ending
in ``synchronize()``, and profiles one warm tick. Any failure raises and
exits non-zero; there is no result without a CUDA device.

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
import time

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
DEPLOY_SIZES = ((848, 480), (1280, 720))
DEPLOY_FRAMES = 30
DEPLOY_EVERY = 15
DEPLOY_CMP_FRAMES = 3
DEPLOY_CMP_EVERY = 2
DEPLOY_SAVE_EVERY = 8
REPLAY_FRAMES = 30
# Phase 3: the image kernel's (H, W): the fused frames' (vertical) and
# landscape shapes at both sizes, odd widths, and images under 3×3; its
# modes by launch counter.
IMAGE_SIZES = ((848, 480), (480, 848), (1280, 720), (720, 1280), (13, 7), (7, 129), (131, 33),
               (2, 5), (5, 2), (1, 1))
IMAGE_MODES = {None: "color_image", "gauss": "gauss3x3_image", "median": "median3x3_image"}
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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
    call}). Unlike CUDA events around a loop of calls it leaves out the
    host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    # A trace now and then comes back without its device events: try again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                # "void (anonymous namespace)::place<true>(int const*, ...)" → "place"
                match = re.search(r"::([A-Za-z_]\w*)[<(]", e.name)
                name = match.group(1) if match else e.name[:32]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        if by_name:
            return sum(by_name.values()), by_name
    raise RuntimeError("three profiler traces came back without device events: device time "
                       "not measured")


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
        filters_cuda, fuse_prep_cuda, morph_cuda, segsum_cuda, zresolve_cuda,
    )

    return (zresolve_cuda.launches, filters_cuda.launches, segsum_cuda.launches,
            fuse_prep_cuda.launches, morph_cuda.launches)


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


def phase_resolve(errs: dict) -> None:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    for n_px in (407_040, 921_600):
        n = 2 * n_px
        pix, z, rgb = resolve_entries(n, n_px, seed=n_px, device=DEVICE)
        kz, kr = Z.zresolve_sorted_entries(pix, z, rgb, n_px)
        pz, pr = Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px)
        kd, kd2 = Z.zresolve_sorted_entries(pix, z, None, n_px)
        pd, _ = Z.zresolve_sorted_entries_plain(pix, z, None, n_px)
        kw = Z.zresolve_winner_rgb(pix, z, rgb, n_px)
        pw = Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px)
        lz, lr = Z.zresolve_sorted_entries(pix, z, rgb, n_px, legacy_feed=True)
        torch.cuda.synchronize()
        b2 = max(max_abs_err(kz, pz), max_abs_err(kr, pr), max_abs_err(kd, pd))
        b1 = max_abs_err(kw, pw)
        legacy = max(max_abs_err(lz, pz), max_abs_err(lr, pr))
        exact = (torch.equal(kz, pz) and torch.equal(kr, pr) and torch.equal(kd, pd)
                 and torch.equal(kd2, kd) and torch.equal(kw, pw)
                 and torch.equal(lz, pz) and torch.equal(lr, pr))
        empty = float((kz == Z.INT32_MAX).float().mean())
        log(f"[2] resolve N={n} n_px={n_px}: B2 max_abs_err={b2} B2-legacy max_abs_err={legacy} "
            f"B1 max_abs_err={b1} bit-exact={exact} empty_fraction={empty:.4f}")
        if not exact:
            raise AssertionError(f"resolve kernel differs from plain at n_px={n_px}")
        errs["zresolve_sorted_entries"] = max(errs["zresolve_sorted_entries"], b2)
        errs["zresolve_sorted_entries_legacy"] = max(errs["zresolve_sorted_entries_legacy"], legacy)
        errs["zresolve_winner_rgb"] = max(errs["zresolve_winner_rgb"], b1)


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


def legacy_planes_tail(planes, mode):
    """The color tail of u8 planes before the image kernel: one B4 launch
    per channel plane (the per-plane API), then a stack."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    if mode is None:
        return torch.stack(list(planes), dim=-1)
    f = B4.median3x3_plane if mode == "median" else B4.gauss3x3_plane
    return torch.stack([f(p) for p in planes], dim=-1)


def legacy_winner_tail(mrgb, h: int, w: int, mode):
    """The color tail of a packed winner before the image kernel: the
    coverage compare and ``decode_winner_planes`` (a where, then shifts,
    masks and casts per channel), then :func:`legacy_planes_tail`."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    planes = [p.reshape(h, w) for p in B4.decode_winner_planes(mrgb != B4.INT32_MAX, mrgb)]
    return legacy_planes_tail(planes, mode)


@contextlib.contextmanager
def legacy_color_tail():
    """Within the block every color tail of the package runs as it did
    before the image kernel (one unbatched image per call)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    saved = B4.winner_image, B4.planes_image
    B4.winner_image, B4.planes_image = legacy_winner_tail, legacy_planes_tail
    try:
        yield
    finally:
        B4.winner_image, B4.planes_image = saved


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


def framesets(scene: Scene, device: str, aligned: bool = False):
    """(color intrinsics, [(left, right) Framesets]); ``aligned``: the depth
    comes from a depth camera of its own (ALIGN_FOCAL, ALIGN_T), one
    calibration shared by every frame."""
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
    return intr, [
        tuple(Frameset.create(f.depth, f.color, intr, depth_scale=f.depth_scale,
                              timestamp=f.timestamp, device=device, **calib) for f in pair)
        for pair in scene.frames
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
        # The color tail: one image launch a frame.
        "gauss3x3_image": 2 * n_frames,
        "median3x3_image": 2 * n_median,
    }


# -- phase 10: the fused prep (B3) and the u32 scatter-min --------------------


def prep_inputs(scene: Scene, t_rl: np.ndarray, mirror: bool):
    """B3's inputs for both cameras of the first frame pair of ``scene``
    under the registration transform ``t_rl``: [(args for fuse_prep), ...]
    and the fused pixel count."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, fused_poses

    intr, fs = framesets(scene, DEVICE)
    cfg = FusionConfig.create(vertical_image=True, mirror_image=mirror, device=DEVICE)
    fi = fused_virtual_intrinsics(intr, True)
    poses = fused_poses(cfg, torch.as_tensor(t_rl, device=DEVICE))
    z_near, z_far = 0.5 * cfg.min_depth, cfg.max_depth + 1.0
    return [(f.depth, f.color, f.depth_scale, cfg.min_depth, cfg.max_depth, f.color_intrinsics,
             pose, fi, mirror, z_near, z_far) for f, pose in zip(fs[0], poses)], fi.width * fi.height


def pose_of(args) -> torch.Tensor:
    """B3's pose parameters for one camera's ``prep_inputs`` arguments."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

    _, _, _, lo, hi, _, pose, fi, _, z_near, z_far = args
    return B3.pose_params(pose, fi, lo, hi, z_near, z_far, DEVICE)


def phase_prep(scenes, errs: dict) -> None:
    """B3 on both cameras, both registration transforms, mirror on and off,
    and the scatter-min on their keys: bit-exact to the plain versions."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    for scene in scenes:
        for t_rl in (scene.t_rl, scene.t_rl2):
            for mirror in (False, True):
                cams, n_px = prep_inputs(scene, t_rl, mirror)
                got = [B3.fuse_prep(*a) for a in cams]
                want = [B3.fuse_prep_plain(*a) for a in cams]
                # As FusionPipeline launches it: with the pose parameters built once.
                posed = [B3.fuse_prep(*a, pose=pose_of(a)) for a in cams]
                idx = torch.cat([i.reshape(-1) for i, _ in got])
                key = torch.cat([k.reshape(-1) for _, k in got])
                buf = Z.scatter_min_u32(idx, key, n_px)
                buf_plain = Z.scatter_min_u32_plain(idx, key, n_px)
                torch.cuda.synchronize()
                e_prep = max(max_abs_err(g, w) for gw in zip(got, want) for g, w in zip(*gw))
                e_scatter = max_abs_err(buf, buf_plain)
                exact = (all(torch.equal(g, w) for gw in zip(got, want) for g, w in zip(*gw))
                         and all(torch.equal(g, w) for gw in zip(got, posed) for g, w in zip(*gw))
                         and torch.equal(buf, buf_plain))
                valid = float((key != -1).float().mean())
                log(f"[10] fuse_prep dual {scene.w}x{scene.h} mirror={mirror} pose "
                    f"{'t_rl' if t_rl is scene.t_rl else 't_rl2'}: B3 max_abs_err={e_prep} "
                    f"scatter_min_u32 max_abs_err={e_scatter} bit-exact={exact} "
                    f"valid keys={valid:.4f} covered={float((buf != -1).float().mean()):.4f}")
                if not exact:
                    raise AssertionError(f"B3 or scatter_min_u32 differs from plain at "
                                         f"{scene.w}x{scene.h} mirror={mirror}")
                errs["fuse_prep"] = max(errs["fuse_prep"], e_prep)
                errs["scatter_min_u32"] = max(errs["scatter_min_u32"], e_scatter)


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
        "fuse_prep": 2 * n,
        "gauss3x3_image": (len(MODES) + 1) * n,
    }


# -- phase 6: timing ---------------------------------------------------------


def time_pipeline(scene: Scene, card: str, warmup: int = 5, iters: int = 30) -> dict:
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    intr, fs = framesets(scene, DEVICE)
    out = {}
    for zbuf in (False, True):
        cfg = FusionConfig.create(vertical_image=True, mirror_image=True, emit_zbuf=zbuf,
                                  device=DEVICE)
        pipe = FusionPipeline(intr, cfg, device=DEVICE)
        pipe.set_right_transform(scene.t_rl)
        left, right = fs[0]
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: pipe.process(left, right), iters, warmup)
        host_ms = (time.perf_counter() - t0) * 1e3 / (iters + warmup)
        key = f"dual_{scene.w}x{scene.h}_{'zbuf' if zbuf else 'image_only'}"
        out[key] = ms
        log(f"[6] process {key}: {ms:.4f} ms/frame (CUDA events, {iters} frames after "
            f"{warmup} warm-up; host wall incl. warm-up {host_ms:.4f} ms/frame) on {card}")
    return out


def turns(kernel, plain, iters: int = 20) -> tuple:
    """(kernel ms, plain ms, each turn) timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def time_kernels(card: str) -> dict:
    """Kernel, plain version and library call at the fused frame's shapes
    (dual 848×480): {name: (ms, plain_ms, library_ms or None, bound_ms,
    bound_by)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    n_px = 480 * 848
    n = 2 * n_px
    pix, z, rgb = resolve_entries(n, n_px, seed=7, device=DEVICE)
    # The library's resolve: one scatter_reduce_(amin) of prebuilt int64
    # keys (z bits high, rgb low) into a dump-slotted pixel buffer.
    idx = torch.where((pix >= 0) & (pix < n_px), pix, n_px).to(torch.int64)
    keys = (z.to(torch.int64) << 32) | (rgb.to(torch.int64) + (1 << 31))
    buf = torch.full((n_px + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=DEVICE)
    library = cuda_ms(lambda: buf.scatter_reduce_(0, idx, keys, "amin", include_self=True), 20)
    entries_in = 12 * n
    pairs = {
        "zresolve_winner_rgb": (lambda: Z.zresolve_winner_rgb(pix, z, rgb, n_px),
                                lambda: Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px),
                                library, bound(entries_in + 4 * n_px, n)),
        "zresolve_sorted_entries": (lambda: Z.zresolve_sorted_entries(pix, z, rgb, n_px),
                                    lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
                                    library, bound(entries_in + 8 * n_px, n)),
        "zresolve_sorted_entries_legacy": (
            lambda: Z.zresolve_sorted_entries(pix, z, rgb, n_px, legacy_feed=True),
            lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
            library, bound(entries_in + 8 * n_px, n)),
    }
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
        shape = f"{fh}x{fw} packed winner" if "image" in name else f"N={n} n_px={n_px}"
        log(f"[6] {name} at {shape}: kernel {k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}), "
            f"plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms (scatter_reduce_ amin)'}, "
            f"bound {b_ms:.5f} ms by {b_by} on {card}")
    return out


def time_color_tail(card: str) -> dict:
    """B4's image kernel against the tail it replaced, on the same inputs,
    in turns (old, new, new, old), at both fused frames' (vertical) shapes:
    form (a), the packed winner, against the decode, three plane launches
    (or none) and a stack; form (b), three u8 planes, against three plane
    launches and a stack; each also by its device time alone
    (:func:`device_time`). {"<form> <mode> <h>x<w>": (new ms, old ms, new
    device ms, old device ms)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4

    g = torch.Generator(device=DEVICE).manual_seed(19)
    out = {}
    for h, w in ((848, 480), (1280, 720)):
        mrgb, img = image_inputs(h, w, g)
        planes = [img[..., c].contiguous() for c in range(3)]
        for mode in IMAGE_MODES:
            forms = {"winner": (lambda m=mode: B4.winner_image(mrgb, h, w, m),
                                lambda m=mode: legacy_winner_tail(mrgb, h, w, m))}
            if mode is not None:
                forms["planes"] = (lambda m=mode: B4.planes_image(planes, m),
                                   lambda m=mode: legacy_planes_tail(planes, m))
            for form, (new, old) in forms.items():
                k, o, each = turns(new, old)
                dk, _ = device_time(new)
                do, _ = device_time(old)
                key = f"{form} {mode or 'copy'} {h}x{w}"
                out[key] = (k, o, dk, do)
                log(f"[6] color tail, {key}: image kernel {k:.5f} ms ({each[0]:.5f}, "
                    f"{each[1]:.5f}; device {dk:.5f}), the tail it replaced {o:.5f} ms "
                    f"({each[2]:.5f}, {each[3]:.5f}; device {do:.5f}) on {card}")
    return out


def profile_color_tail(scene: Scene, card: str) -> tuple:
    """One warm dual ``tiled`` frame (image only, Gauss tail) under the
    profiler, with the image kernel and with the tail it replaced: (device
    ops before, after). Fails unless the image kernel saves 10 or more."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    intr, fs = framesets(scene, DEVICE)
    cfg = FusionConfig.create(vertical_image=True, mirror_image=True, emit_zbuf=False,
                              device=DEVICE)
    pipe = FusionPipeline(intr, cfg, device=DEVICE)
    pipe.set_right_transform(scene.t_rl)
    left, right = fs[0]
    counts = {}
    for label in ("before", "after"):
        with legacy_color_tail() if label == "before" else contextlib.nullcontext():
            pipe.process(left, right)
            wall, busy, counts[label] = profiled(lambda: pipe.process(left, right), "[6]", top=4)
        log(f"[6] profiled warm frame (dual {scene.w}x{scene.h} tiled image only, {label} the "
            f"image kernel): wall {wall:.3f} ms, device busy {busy:.3f} ms, {counts[label]} "
            f"device ops on {card}")
    if counts["before"] - counts["after"] < 10:
        raise AssertionError(f"the image kernel saves {counts['before'] - counts['after']} "
                             f"device ops a frame, expected 10 or more")
    return counts["before"], counts["after"]


def time_modes(scene: Scene, card: str, warmup: int = 3, iters: int = 20) -> dict:
    """ms/frame of each mode of MODES (with the z-buffer, as every one of
    them but tiled always emits it)."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionPipeline

    out = {}
    for mode in MODES:
        intr, fs = framesets(scene, DEVICE, aligned=mode == "tiled+align")
        pipe = FusionPipeline(intr, mode_config(mode, device=DEVICE), device=DEVICE)
        pipe.set_right_transform(scene.t_rl)
        left, right = fs[0]
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: pipe.process(left, right), iters, warmup)
        host_ms = (time.perf_counter() - t0) * 1e3 / (iters + warmup)
        key = f"dual_{scene.w}x{scene.h}_{mode}"
        out[key] = ms
        log(f"[6] process {key}: {ms:.4f} ms/frame (CUDA events, {iters} frames after "
            f"{warmup} warm-up; host wall incl. warm-up {host_ms:.4f} ms/frame) on {card}")
    return out


def time_prep_kernels(scene: Scene, card: str) -> dict:
    """B3 on one camera and the scatter-min over both cameras' keys of the
    ``scene``'s first frame pair: {name: (ms, plain_ms, library_ms or None,
    bound_ms, bound_by)}."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    cams, n_px = prep_inputs(scene, scene.t_rl, True)
    preps = [B3.fuse_prep(*a) for a in cams]
    idx = torch.cat([i.reshape(-1) for i, _ in preps])
    key = torch.cat([k.reshape(-1) for _, k in preps])
    n_cam, n = scene.w * scene.h, idx.numel()
    # The library's scatter-min: one scatter_reduce_(amin) of prebuilt int64
    # key values into a dump-slotted buffer.
    slot = torch.where((idx >= 0) & (idx < n_px), idx, n_px).to(torch.int64)
    key64 = Z.u32_value(key)
    buf = torch.full((n_px + 1,), 0xFFFFFFFF, dtype=torch.int64, device=DEVICE)
    library = cuda_ms(lambda: buf.scatter_reduce_(0, slot, key64, "amin", include_self=True), 20)
    pose = pose_of(cams[0])
    pairs = {
        # One camera, launched as FusionPipeline launches it (pose parameters
        # built once): 4 B depth + 3 B color in, 4 B index + 4 B key out per
        # pixel; about 45 f32 and 25 integer operations per pixel.
        "fuse_prep": (lambda: B3.fuse_prep(*cams[0], pose=pose),
                      lambda: B3.fuse_prep_plain(*cams[0], pose=pose),
                      None, bound(15 * n_cam, 70 * n_cam)),
        # 8 B in per entry, 4 B out per pixel; a compare and an atomic per
        # entry.
        "scatter_min_u32": (lambda: Z.scatter_min_u32(idx, key, n_px),
                            lambda: Z.scatter_min_u32_plain(idx, key, n_px),
                            library, bound(8 * n + 4 * n_px, 2 * n)),
    }
    # What B3's wrapper spends around its launch: gathering the frame's
    # camera parameters onto the prebuilt pose ones, against the bare launch
    # on prebuilt parameters and outputs.
    params = B3.prep_params(*cams[0][2:8], *cams[0][9:11], DEVICE, pose)
    params_ms = cuda_ms(lambda: B3.prep_params(*cams[0][2:8], *cams[0][9:11], DEVICE, pose), 20)
    depth, color, fi = cams[0][0], cams[0][1], cams[0][7]
    out_idx, out_key = torch.empty_like(depth), torch.empty_like(depth)
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    bare_ms = cuda_ms(lambda: lib.fuse_prep_launch(
        depth.data_ptr(), color.data_ptr(), params.data_ptr(), scene.h, scene.w, fi.width,
        fi.height, 1, out_idx.data_ptr(), out_key.data_ptr(), stream), 50)
    log(f"[6] fuse_prep at one {scene.w}x{scene.h} camera: the camera parameter gather "
        f"(one torch.stack, one torch.cat) {params_ms:.5f} ms, the bare launch {bare_ms:.5f} ms on {card}")
    out = {}
    for name, (kernel, plain, lib_ms, (b_ms, b_by)) in pairs.items():
        k, p, each = turns(kernel, plain)
        out[name] = (k, p, lib_ms, b_ms, b_by)
        shape = (f"one {scene.w}x{scene.h} camera" if name == "fuse_prep"
                 else f"N={n} n_px={n_px}")
        log(f"[6] {name} at {shape}: kernel {k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}), "
            f"plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms (scatter_reduce_ amin)'}, "
            f"bound {b_ms:.5f} ms by {b_by} on {card}")
    return out


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


def legacy_segsum(slot, values, n_slots: int):
    """B5 as it was before its redesign: a stable ``torch.sort`` of the
    slots with int64 indices, then one thread per slot finding its run by
    binary search (``segsum_runs_launch``). Not counted."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

    n, c = values.shape
    ss, si = torch.sort(slot, stable=True)
    sums = torch.empty((n_slots, c), dtype=torch.float32, device=slot.device)
    rep = torch.empty((n_slots,), dtype=torch.int32, device=slot.device)
    _build.check(_build.load().segsum_runs_launch(
        ss.data_ptr(), si.data_ptr(), values.data_ptr(), n, c, n_slots, sums.data_ptr(),
        rep.data_ptr(), torch.cuda.current_stream().cuda_stream), "segsum_runs_launch")
    return sums, rep


def time_segsum(scenes, card: str) -> dict:
    """B5 kernel vs plain vs ``index_add_`` (the sums half alone), and vs
    the design it replaced (stable sort + binary-search runs, timed in
    turns on the same inputs), on the registration clouds at the coarse and
    the fine resolution and on the second call of a tick (the 2^15-entry
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
                sort_ms = cuda_ms(lambda: torch.sort(slot, stable=True), 20)
                old = legacy_segsum(slot, chans, n_slots)
                new = B5.segsum_sorted(slot, chans, n_slots)
                if not all(torch.equal(a, b) for a, b in zip(old, new)):
                    raise AssertionError(f"segsum {what}: the redesign differs from the old design")
                k, o, turn = turns(lambda: B5.segsum_sorted(slot, chans, n_slots),
                                   lambda: legacy_segsum(slot, chans, n_slots))
                _, p, each = turns(lambda: B5.segsum_sorted(slot, chans, n_slots),
                                   lambda: B5.segsum_sorted_plain(slot, chans, n_slots))
                b_ms, b_by = bound(4 * n + 4 * n * c + 4 * n_slots * c + 4 * n_slots, 2 * n * c)
                dk, parts = device_time(lambda: B5.segsum_sorted(slot, chans, n_slots))
                do, _ = device_time(lambda: legacy_segsum(slot, chans, n_slots))
                out[what] = (k, p, lib, b_ms, b_by, o, dk, do)
                log(f"[9] segsum_sorted {what} (N={n} C={c} n_slots={n_slots}): kernel "
                    f"{k:.5f} ms ({turn[0]:.5f}, {turn[1]:.5f}; {each[0]:.5f}, {each[1]:.5f}; "
                    f"device {dk:.5f}: " + ", ".join(f"{m} {v:.5f}" for m, v in parts.items())
                    + f"), the old design {o:.5f} ms ({turn[2]:.5f}, {turn[3]:.5f}; device "
                    f"{do:.5f}; of which the stable sort {sort_ms:.5f} ms), plain {p:.5f} ms, "
                    f"index_add_ (sums only) {lib:.5f} ms, bound {b_ms:.5f} ms by {b_by} on {card}")
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
    time under ``tag``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in rows[:top]:
        log(f"{tag}   {getattr(e, 'self_device_time_total', 0) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return wall, busy, len(kernels)


def profile_tick(pipe, scene: Scene, card: str) -> dict:
    """One warm tick under torch.profiler: device busy share, kernel
    launches, and the ops that take the device's time."""
    dl, dr = (f.depth for f in scene.frames[0])
    wall, busy, n_ops = profiled(lambda: pipe.tick(dl, dr), "[9]")
    iters = pipe.telemetry[-1].iterations
    log(f"[9] profiled warm tick (dual {scene.w}x{scene.h}): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {n_ops} device ops (kernels, copies, "
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


def rig_intrinsics(w: int, h: int, per_camera: bool = False, device="cpu"):
    """The bench camera (fx = 631·w/848), or RIG_CAMERAS per-camera
    variants of it under the inverse Brown-Conrady model, camera 1 with
    real coefficients (the heterogeneous rig of tests/test_torch_rig.py)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics

    fx = 631.0 * w / 848.0
    if not per_camera:
        return Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device=device)
    return [Intrinsics.create(w, h, fx=fx * (1 + 0.02 * i), fy=fx * (1 + 0.015 * i),
                              ppx=w / 2 + 1.5 * (i - 1), ppy=h / 2 - i,
                              model=Distortion.INVERSE_BROWN_CONRADY,
                              coeffs=RIG_BC_COEFFS if i == 1 else (0.0,) * 5, device=device)
            for i in range(RIG_CAMERAS)]


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
    if fields.get("render_mode") == "packed":
        out = {"scatter_min_u32": frames}
    elif multi and n >= 2:
        out = {"zresolve_sorted_streams": frames}
    elif fields.get("emit_zbuf", True):
        out = {"zresolve_sorted_entries": frames}
    else:
        out = {"zresolve_winner_rgb": frames}
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
        # The resolve and the color tail: one launch each for the batch and
        # for each stream of the per-stream reference.
        for name in ("scatter_min_u32" if mode == "packed" else "zresolve_sorted_entries",
                     "color_image"):
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
    expected = {"zresolve_winner_rgb": len(card_runs) * NODE_FRAMES,
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
    """ms/frame of every rig case and of the batched rig (CUDA events)."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import batched_rig_fuse

    out = {}
    for (n, w, h), cases in RIG_RUNS:
        rig = rigs[(n, w, h)]
        for case in cases:
            fn, _ = rig_case(rig, case, DEVICE)
            args = rig_args(rig, 0, DEVICE)
            key = f"rig_{n}x{w}x{h}_{case}"
            out[key] = cuda_ms(lambda: fn(*args), iters, warmup)
    rig = rigs[RIG_BATCHED[0]]
    batch = RIG_BATCHED[1]
    intr = rig_intrinsics(rig.w, rig.h)
    for mode in ("tiled", "packed"):
        cfg = FusionConfig.create(render_mode=mode, device=DEVICE, **RIG_CONFIG)
        fb = batched_rig_fuse(intr, fused_virtual_intrinsics(intr, False), cfg, batch,
                              rig.n // batch, device=DEVICE)
        args = rig_args(rig, 0, DEVICE, batch)
        out[f"batched_{batch}x{rig.n // batch}x{rig.w}x{rig.h}_{mode}"] = cuda_ms(
            lambda: fb(*args), iters, warmup)
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
        fn, _ = rig_case(rigs[key[:3]], key[3], DEVICE)
        args = rig_args(rigs[key[:3]], 0, DEVICE)
        ops = {}
        # The tiled frame also runs with the color tail the image kernel
        # replaced (decode and stack), for the launches before and after.
        for label in ("before", "after") if key[3].startswith("tiled") else ("after",):
            with legacy_color_tail() if label == "before" else contextlib.nullcontext():
                fn(*args)
                wall, busy, ops[label] = profiled(lambda: fn(*args), "[12]", top=6)
            log(f"[12] profiled warm frame ({key[0]}x{key[1]}x{key[2]} {key[3]}, {label} the "
                f"image kernel): wall {wall:.3f} ms, device busy {busy:.3f} ms "
                f"({100 * busy / wall:.1f}%), {ops[label]} device ops on {card}")
        if "before" in ops and ops["before"] - ops["after"] < 10:
            raise AssertionError(f"rig {key}: the image kernel saves "
                                 f"{ops['before'] - ops['after']} device ops, expected >= 10")
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


def phase_morph(scenes, errs: dict) -> tuple:
    """(a) B6 bit-exact to its plain version on the card; (b)
    ``filter_depth(use_morphology=True)`` on the card bit-identical to the
    CPU, with the launch counts of (b) alone. Returns (B6's launches in
    (b), the number of card calls)."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6

    g = torch.Generator(device=DEVICE).manual_seed(13)
    for scene in scenes:
        for kind, m in morph_masks(scene, g).items():
            for dilate in (False, True):
                got, want = B6.morph_plane(m, dilate), B6.morph_plane_plain(m, dilate)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["morph_plane"] = max(errs["morph_plane"], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"B6 differs from plain on {kind} {scene.w}x{scene.h} "
                                         f"dilate={dilate}: {err}")
        log(f"[13a] morph_plane {scene.w}x{scene.h}: erosion and dilation bit-exact on "
            f"random/depth>0/depth in 0.5-3 m/zeros/ones/lines")
    reset_launches()
    calls = 0
    filter_ms = {}
    for scene in scenes:
        for roi in (None, (40, 20, scene.w - 120, scene.h - 60)):
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
                    if not same or n != 4:
                        raise AssertionError(f"filter_depth(use_morphology=True) "
                                             f"{scene.w}x{scene.h} roi={roi}: card==CPU {same}, "
                                             f"{n} B6 launches")
            log(f"[13b] filter_depth(use_morphology=True) dual {scene.w}x{scene.h} roi={roi}: "
                f"card bit-identical to the CPU on {2 * len(scene.frames)} frames, 4 B6 launches "
                f"each; valid {float(vc.float().mean()):.4f}, closed-in pixels with depth 0 "
                f"{closed_holes} (the JAX order, reproduced)")
    launches = read_launches()
    log(f"[13b] launches {launches}, expected morph_plane {4 * calls} and no other")
    if launches["morph_plane"] != 4 * calls or sum(launches.values()) != 4 * calls:
        raise AssertionError(f"[13b] launch counts {launches}")
    return launches["morph_plane"], calls


def time_morph(scenes, card: str) -> tuple:
    """B6 against its plain version and the nearest library composition
    (max_pool2d over 3×5 and 5×3, then maximum: no one PyTorch call has
    the 21-point element), and filter_depth(use_morphology=True), at each
    size. Returns (B6's row at the last size, {size: filter_depth ms})."""
    import torch.nn.functional as NF

    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6

    row, filter_ms = None, {}
    for scene in scenes:
        f = scene.frames[0][0]
        depth = torch.from_numpy(f.depth.astype(np.int32)).to(DEVICE)
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
        # 1 B in and 1 B out per pixel; 20 min/max per pixel.
        b_ms, b_by = bound(2 * mask.numel(), 20 * mask.numel())
        scale, lo, hi = (torch.tensor(v, device=DEVICE) for v in (f.depth_scale, 0.5, 3.0))
        fd = cuda_ms(lambda: F.filter_depth(depth, scale, lo, hi, use_morphology=True), 20)
        plain_fd = cuda_ms(lambda: F.filter_depth(depth, scale, lo, hi), 20)
        filter_ms[f"{scene.w}x{scene.h}"] = fd
        log(f"[13] morph_plane at one {scene.w}x{scene.h} u8 mask: kernel {k:.5f} ms "
            f"({each[0]:.5f}, {each[1]:.5f}), plain {p:.5f} ms ({each[2]:.5f}, {each[3]:.5f}), "
            f"library {lib_ms:.5f} ms (3 calls: max_pool2d 3x5 and 5x3, maximum; on {lib_dtype}; "
            f"equal to B6's dilation: {same}), bound {b_ms:.5f} ms by {b_by}; "
            f"filter_depth(use_morphology=True) {fd:.5f} ms, without {plain_fd:.5f} ms on {card}")
        row = (k, p, lib_ms, b_ms, b_by)
    return row, filter_ms


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
        slow = name.startswith(("spatial", "bilateral"))
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


def run_deployment_recorded(manifest: dict, dev) -> tuple:
    """``run_deployment`` on ``dev``, recording every fused image the viewer
    receives: (summary, [(stamp, image)], wall s ending in synchronize)."""
    from pointcloud_depthfusion_tpu_torch.nodes import image_node, launch

    seen = []
    orig = image_node.ImageNode.__call__

    def record(self, image, ts):
        seen.append((ts, np.array(image)))
        orig(self, image, ts)

    image_node.ImageNode.__call__ = record
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = launch.run_deployment(manifest, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        image_node.ImageNode.__call__ = orig
    return summary, seen, wall


def deployment_expected(summary: dict) -> dict:
    """A card deployment's launches: B2 and one B4 image per fused frame
    (fusion_default.yaml: tiled with the z-buffer, Gauss tail); B5 4 per
    rebuilt target grid and 2 per cached tick."""
    frames, ticks, rebuilds = (summary[k] for k in ("frames", "registration_ticks",
                                                    "registration_grid_rebuilds"))
    return {"zresolve_sorted_entries": frames, "gauss3x3_image": frames,
            "segsum_sorted": 4 * rebuilds + 2 * (ticks - rebuilds)}


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
    import os

    fusion_yaml = os.path.join(tmp, "fusion_keep_all.yaml")
    with open(fusion_yaml, "w") as fh:
        fh.write("fusion_node:\n  qos: {lifespan_s: 0}\n")
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
        summary, seen, wall = run_deployment_recorded(
            deployment_manifest(w, h, DEPLOY_FRAMES, DEPLOY_EVERY, out_dir), DEVICE)
        add(summary)
        pngs = sorted(os.listdir(out_dir))
        coverage = min(float(img.any(-1).mean()) for _, img in seen)
        log(f"[13d] run_deployment dual {size} on the card: {json.dumps(summary)}; "
            f"{len(seen)} frames in {wall:.3f} s ({len(seen) / wall:.3f} frames/s live, the "
            f"numpy renderer in the loop), min coverage {coverage:.4f}, {len(pngs)} PNGs on {card}")
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
    """(e) FusionNodeApp.run over prerendered frames replayed through
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
            log(f"[13e] FusionNodeApp.run {size} {mode}: {done} frames in {wall:.3f} s "
                f"({fps:.3f} frames/s), upload_ms mean {np.mean(uploads):.4f} min "
                f"{np.min(uploads):.4f} max {np.max(uploads):.4f} on {card}")
            metrics[f"node_{size}_{mode.replace(' ', '_')}_upload_ms_mean"] = float(np.mean(uploads))
            if prof:
                with open(prof) as fh:
                    rows = [line.strip().split(",") for line in fh]
                head, vals = rows[0], np.asarray(rows[2:], np.float64)  # skip the first frame
                laps = {k: float(v) for k, v in zip(head, vals.mean(0))}
                log(f"[13e] process_profiled {size}, mean of frames 2-{len(rows) - 1} (ms): "
                    + " ".join(f"{k}={v:.4f}" for k, v in laps.items()) + f" on {card}")
                metrics[f"node_{size}_laps_ms"] = laps
    # Each fused frame: B2 and one B4 image (tiled with the z-buffer).
    return {"zresolve_sorted_entries": frames, "gauss3x3_image": frames}, metrics


def phase_filters_and_deployment(scenes, card: str, errs: dict) -> tuple:
    """Phase 13. Returns (launches of each kernel on its main paths here,
    B6's timing row, {metric: value})."""
    import tempfile

    morph_launches, calls = phase_morph(scenes, errs)
    filter_ms = phase_depth_filters(scenes[0], card)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        expected = {k: 0 for k in read_launches()}
        dep_expected, metrics = phase_deployment(tmp, card)
        node_expected, node_metrics = phase_node_timing(scenes, tmp, card)
        for part in (dep_expected, node_expected):
            for k, v in part.items():
                expected[k] += v
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"[13d-e] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    launches["morph_plane"] = morph_launches
    row, fd_ms = time_morph(scenes, card)
    metrics.update(node_metrics)
    log(f"[13] summary filters ms {json.dumps(filter_ms)} filter_depth+morphology ms "
        f"{json.dumps(fd_ms)} deployment {json.dumps(metrics)} on {card}")
    return launches, row, metrics


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
    phase_resolve(errs)
    phase_filters(errs)
    scene_848 = build_scene(848, 480)
    scene_720 = build_scene(1280, 720)
    phase_prep((scene_848, scene_720), errs)
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
    filt_launches, morph_timing, _ = phase_filters_and_deployment((scene_848, scene_720), card,
                                                                  errs)
    log(f"[13] done at {time.perf_counter() - t_start:.1f} s")

    # [6], [9] timing
    frame_ms = {**time_pipeline(scene_848, card), **time_pipeline(scene_720, card),
                **time_modes(scene_848, card), **time_modes(scene_720, card)}
    kernel_ms = {**time_kernels(card), **time_prep_kernels(scene_848, card)}
    time_prep_kernels(scene_720, card)
    tail_ms = time_color_tail(card)
    tail_ops = {f"dual {s.w}x{s.h}": profile_color_tail(s, card) for s in (scene_848, scene_720)}
    log(f"[6] summary color tail ms (image kernel, replaced tail) {json.dumps(tail_ms)}; device "
        f"ops per tiled frame (before, after) {json.dumps(tail_ops)} on {card}")
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
                + filt_launches[k] for k in fusion_launches}
    # No one PyTorch call computes both halves of B5 (the sums and the
    # representative); index_add_'s time for the sums alone is logged above.
    timing = {**kernel_ms, "segsum_sorted": (k, p, None, b_ms, b_by),
              "zresolve_sorted_streams": streams_timing, "morph_plane": morph_timing}
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
