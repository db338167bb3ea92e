#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_depthfusion_tpu_torch/csrc``
(nvcc, into ``build/torch_kernels/``) and holds each kernel against its plain
PyTorch version at the main paths' shapes. Then it drives the two services
the shipped deployment runs, each against the same pipeline on the CPU at
dual 848×480 and dual 1280×720, with every launch counter set to 0 just
before and read just after:

  [4-5] the dual-camera fused frame, ``FusionPipeline.process``;
  [8]   the registration service, ``RegistrationPipeline.tick``, with the
        settings of configs/registration_default.yaml.

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
    "gauss3x3_plane": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:69",
    "median3x3_plane": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:41",
    "segsum_sorted": "pointcloud_depthfusion_tpu/ops/pallas/segsum_pallas.py:42",
}
SOURCES = {
    "zresolve_winner_rgb": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "zresolve_sorted_entries": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "zresolve_sorted_entries_legacy": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "gauss3x3_plane": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "median3x3_plane": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "segsum_sorted": "pointcloud_depthfusion_tpu_torch/csrc/segsum.cu",
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): each input byte read once and
    each output byte written once at the memory rate, against the
    operations at the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches() -> None:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, segsum_cuda, zresolve_cuda

    for counts in (zresolve_cuda.launches, filters_cuda.launches, segsum_cuda.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, segsum_cuda, zresolve_cuda

    return {**zresolve_cuda.launches, **filters_cuda.launches, **segsum_cuda.launches}


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
                ("gauss3x3_plane", B4.gauss3x3_plane, B4.gauss3x3_plane_plain),
                ("median3x3_plane", B4.median3x3_plane, B4.median3x3_plane_plain),
            ):
                got, want = kernel(p), plain(p)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs[name] = max(errs[name], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs from plain on {kind} {h}x{w}: {err}")
        log(f"[3] filter3x3 {h}x{w}: gauss and median bit-exact on random/ties/zeros/full")


# -- phases 4-5: the main path ---------------------------------------------


@dataclasses.dataclass
class Scene:
    w: int
    h: int
    frames: list  # [(left HostFrameset, right HostFrameset)]
    t_rl: np.ndarray
    t_rl2: np.ndarray


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
    a = np.deg2rad(0.5)
    bump = np.eye(4)
    bump[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    bump[0, 3] = 0.01
    return Scene(w, h, frames, t_rl, (bump @ t_rl).astype(np.float32))


def framesets(scene: Scene, device: str):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset

    fx = 631.0 * scene.w / 848.0
    intr = Intrinsics.create(scene.w, scene.h, fx=fx, fy=fx, ppx=scene.w / 2,
                             ppy=scene.h / 2, device=device)

    return intr, [
        tuple(Frameset.create(f.depth, f.color, intr, depth_scale=f.depth_scale,
                              timestamp=f.timestamp, device=device) for f in pair)
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
        "gauss3x3_plane": 3 * 2 * n_frames,
        "median3x3_plane": 3 * 2 * n_median,
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
    plane = torch.randint(0, 256, (848, 480), device=DEVICE, dtype=torch.uint8,
                          generator=torch.Generator(device=DEVICE).manual_seed(9))
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
        # 3×3 filters of one u8 plane: 1 B in and 1 B out per pixel; about
        # 20 operations per pixel for the Gauss, 38 min/max for the median.
        "gauss3x3_plane": (lambda: B4.gauss3x3_plane(plane),
                           lambda: B4.gauss3x3_plane_plain(plane), None,
                           bound(2 * plane.numel(), 20 * plane.numel())),
        "median3x3_plane": (lambda: B4.median3x3_plane(plane),
                            lambda: B4.median3x3_plane_plain(plane), None,
                            bound(2 * plane.numel(), 38 * plane.numel())),
    }
    out = {}
    for name, (kernel, plain, lib_ms, (b_ms, b_by)) in pairs.items():
        k, p, each = turns(kernel, plain)
        out[name] = (k, p, lib_ms, b_ms, b_by)
        shape = "848x480 u8 plane" if "plane" in name else f"N={n} n_px={n_px}"
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
    log(f"[7] segsum {what}: N={slot.shape[0]} C={values.shape[1]} n_slots={n_slots} "
        f"occupied={occupied} rep exact={torch.equal(kr, pr)} max_abs_err(sums) vs plain on "
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
    """B5 kernel vs plain vs ``index_add_`` (the sums half alone) on the
    registration clouds at the coarse and the fine resolution, and on the
    second call of a tick (the 2^15-entry downsampled table)."""
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
                k, p, each = turns(lambda: B5.segsum_sorted(slot, chans, n_slots),
                                   lambda: B5.segsum_sorted_plain(slot, chans, n_slots))
                b_ms, b_by = bound(4 * n + 4 * n * c + 4 * n_slots * c + 4 * n_slots, 2 * n * c)
                out[what] = (k, p, lib, b_ms, b_by)
                log(f"[9] segsum_sorted {what} (N={n} C={c} n_slots={n_slots}): kernel "
                    f"{k:.5f} ms ({each[0]:.5f}, {each[1]:.5f}; of which the stable sort "
                    f"{sort_ms:.5f} ms), plain {p:.5f} ms, index_add_ (sums only) {lib:.5f} ms, "
                    f"bound {b_ms:.5f} ms by {b_by} on {card}")
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


def profile_tick(pipe, scene: Scene, card: str) -> dict:
    """One warm tick under torch.profiler: device busy share, kernel
    launches, and the ops that take the device's time."""
    from torch.profiler import ProfilerActivity, profile

    dl, dr = (f.depth for f in scene.frames[0])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.tick(dl, dr)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    iters = pipe.telemetry[-1].iterations
    rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, "self_device_time_total", 0))
    log(f"[9] profiled warm tick (dual {scene.w}x{scene.h}): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {len(kernels)} device ops (kernels, copies, "
        f"fills), {iters} iterations ({len(kernels) / max(iters, 1):.1f} per iteration) on {card}")
    for e in rows[:12]:
        log(f"[9]   {getattr(e, 'self_device_time_total', 0) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "kernels": len(kernels), "iterations": iters}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.utils.factory import registration_settings

    # [0] device
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
    log(f"[1] build: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[1] ptxas: {line.strip()}")

    errs = {name: 0 for name in REPLACES}
    # [2], [3] kernels against their plain versions
    phase_resolve(errs)
    phase_filters(errs)

    # [4], [5] the fused frame; the launch counts cover exactly these phases.
    scene_848 = build_scene(848, 480)
    scene_720 = build_scene(1280, 720)
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

    # [6], [9] timing
    frame_ms = {**time_pipeline(scene_848, card), **time_pipeline(scene_720, card)}
    kernel_ms = time_kernels(card)
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
    k, p, _, b_ms, b_by = seg[f"dual {reg_scenes[-1].w}x{reg_scenes[-1].h} cloud at 0.01 m"]

    launches = {**fusion_launches, "segsum_sorted": reg_launches["segsum_sorted"]}
    # No one PyTorch call computes both halves of B5 (the sums and the
    # representative); index_add_'s time for the sums alone is logged above.
    timing = {**kernel_ms, "segsum_sorted": (k, p, None, b_ms, b_by)}
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
