#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pointcloud_depthfusion_tpu_torch/csrc``
(nvcc, into ``build/torch_kernels/``), holds each kernel bit for bit against
its plain PyTorch version at the main path's shapes, drives the dual-camera
fused frame through ``FusionPipeline.process`` at dual 848×480 and dual
1280×720 against the same pipeline on the CPU, shows through the launch
counters that every frame went through the kernels, and times the frame and
each kernel with CUDA events. Any failure raises and exits non-zero; there
is no result without a CUDA device.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

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
    "gauss3x3_plane": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:69",
    "median3x3_plane": "pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py:41",
}
SOURCES = {
    "zresolve_winner_rgb": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "zresolve_sorted_entries": "pointcloud_depthfusion_tpu_torch/csrc/zresolve.cu",
    "gauss3x3_plane": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
    "median3x3_plane": "pointcloud_depthfusion_tpu_torch/csrc/filters3x3.cu",
}


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
        torch.cuda.synchronize()
        b2 = max(max_abs_err(kz, pz), max_abs_err(kr, pr), max_abs_err(kd, pd))
        b1 = max_abs_err(kw, pw)
        exact = (torch.equal(kz, pz) and torch.equal(kr, pr) and torch.equal(kd, pd)
                 and torch.equal(kd2, kd) and torch.equal(kw, pw))
        empty = float((kz == Z.INT32_MAX).float().mean())
        log(f"[2] resolve N={n} n_px={n_px}: B2 max_abs_err={b2} B1 max_abs_err={b1} "
            f"bit-exact={exact} empty_fraction={empty:.4f}")
        if not exact:
            raise AssertionError(f"resolve kernel differs from plain at n_px={n_px}")
        errs["zresolve_sorted_entries"] = max(errs["zresolve_sorted_entries"], b2)
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
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
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
        cfg = FusionConfig.create(vertical_image=True, mirror_image=True, use_median_filter=median)
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
        cfg = FusionConfig.create(vertical_image=True, mirror_image=True, emit_zbuf=zbuf)
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


def time_kernels(card: str) -> dict:
    """Kernel vs plain at the main path's shapes (dual 848×480)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    n_px = 480 * 848
    pix, z, rgb = resolve_entries(2 * n_px, n_px, seed=7, device=DEVICE)
    plane = torch.randint(0, 256, (848, 480), device=DEVICE, dtype=torch.uint8,
                          generator=torch.Generator(device=DEVICE).manual_seed(9))
    pairs = {
        "zresolve_winner_rgb": (lambda: Z.zresolve_winner_rgb(pix, z, rgb, n_px),
                                lambda: Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px),
                                f"N={2 * n_px} n_px={n_px}"),
        "zresolve_sorted_entries": (lambda: Z.zresolve_sorted_entries(pix, z, rgb, n_px),
                                    lambda: Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
                                    f"N={2 * n_px} n_px={n_px}"),
        "gauss3x3_plane": (lambda: B4.gauss3x3_plane(plane),
                           lambda: B4.gauss3x3_plane_plain(plane), "848x480 u8 plane"),
        "median3x3_plane": (lambda: B4.median3x3_plane(plane),
                            lambda: B4.median3x3_plane_plain(plane), "848x480 u8 plane"),
    }
    out = {}
    for name, (kernel, plain, shape) in pairs.items():
        # plain, kernel, kernel, plain: the mean of each pair of turns.
        p1 = cuda_ms(plain, 20)
        k1 = cuda_ms(kernel, 20)
        k2 = cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 20)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[6] {name} at {shape}: kernel {out[name][0]:.5f} ms ({k1:.5f}, {k2:.5f}), "
            f"plain {out[name][1]:.5f} ms ({p1:.5f}, {p2:.5f}) on {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build, filters_cuda, zresolve_cuda

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

    # [4], [5] main path; the launch counts cover exactly these two phases.
    scene_848 = build_scene(848, 480)
    scene_720 = build_scene(1280, 720)
    for counts in (zresolve_cuda.launches, filters_cuda.launches):
        for k in counts:
            counts[k] = 0
    expected = {k: 0 for k in REPLACES}
    for scene, n_frames, n_median, tag in ((scene_848, 10, 2, "4: dual 848x480"),
                                           (scene_720, 4, 2, "5: dual 1280x720")):
        for k, v in drive_main_path(scene, n_frames, n_median, tag).items():
            expected[k] += v
    torch.cuda.synchronize()
    launches = {**zresolve_cuda.launches, **filters_cuda.launches}
    log(f"[4-5] launches {launches}, expected {expected}")
    if launches != expected or min(launches.values()) < 1:
        raise AssertionError(f"launch counts {launches} != expected {expected}")

    # [6] timing
    frame_ms = {**time_pipeline(scene_848, card), **time_pipeline(scene_720, card)}
    kernel_ms = time_kernels(card)
    log(f"[6] summary ms/frame {json.dumps(frame_ms)} on {card}")

    log(card)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
        for name in REPLACES
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
