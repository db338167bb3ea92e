#!/usr/bin/env python3
"""Times the fused frame's prep and u32 scatter-min through the API that
the one-camera designs (before the all-cameras B3 and the one-launch
scatter-min) and the current ones share, on one NVIDIA GPU.

    python3 compare_designs.py            # the prep and the scatter-min
    python3 compare_designs.py --filters  # filter_depth(use_morphology=True)
                                          # and spatial_filter
    python3 compare_designs.py --host-runtime  # either, after loading and
                                               # using the native host runtime

Meant for a comparison on one card: unpack an older tree with
``git archive`` into a git-ignored directory, copy this file and
``chip_smoke.py`` into it, and run it there and here in one call (old,
new, new, old). It logs, at dual 848×480 and 1280×720 (the chip_smoke
scenes): B3 on one camera (``fuse_prep``), the ``pallas`` frame's prep and
resolve as the one-camera designs ran it, ``scatter_min_u32`` on given
keys, and the packed render of a frame's planes, each as wrapper ms (CUDA
events), device ms by the profiler and a bare launch; warm dual ``tiled``,
``pallas`` and ``packed`` frames and the profiled rig frames with their
device ops; and ms/frame of every mode. No ceiling applies. With
``--filters`` it times instead the two depth filters that B6's one-launch
design and the spatial filter's row-scan kernel replaced the eager chains
of (four B6 launches and eager ops; ~10 eager ops a step), through the
``ops.filters`` API both trees have. It exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as S


def bare_api_calls(lib, scene, one: list, idx, key, n_px: int) -> tuple:
    """Bare launches of B3 on one camera and of the scatter-min on given
    keys, through whichever C entries the built library has: the
    all-cameras designs', or the one-camera designs' (11 and 6 arguments:
    one camera's 25 parameters; a fill and a scatter into a given
    output)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    depth, color, scale, lo, hi, intr, pose, fi, mirror, z_near, z_far = one
    stream = torch.cuda.current_stream().cuda_stream
    out = [torch.empty_like(depth) for _ in range(4)]
    valid = torch.empty(depth.shape, dtype=torch.bool, device=S.DEVICE)
    bits = torch.empty(n_px, dtype=torch.int32, device=S.DEVICE)
    if len(lib.fuse_prep_launch.argtypes) == 11:
        params = B3.prep_params(scale, lo, hi, intr, pose, fi, z_near, z_far, S.DEVICE)
        prep = (params, scene.h, scene.w, fi.width, fi.height, int(mirror), out[0].data_ptr(),
                out[1].data_ptr(), stream)
        return (lambda: lib.fuse_prep_launch(depth.data_ptr(), color.data_ptr(),
                                             params.data_ptr(), *prep[1:]),
                lambda: lib.scatter_min_u32_launch(idx.data_ptr(), key.data_ptr(), idx.numel(),
                                                   bits.data_ptr(), n_px, stream))
    cams = B3.prep_cameras(intr, fi, lo, hi, mirror, z_near=z_near, z_far=z_far)
    prep = (depth.data_ptr(), 0, color.data_ptr(), 0, 0, pose.data_ptr(), 0, scale.data_ptr(), 0,
            cams.static.data_ptr(), cams.ints.data_ptr(), 1, scene.h, scene.w, fi.width,
            fi.height, int(mirror), 0, out[0].data_ptr(), out[1].data_ptr(), None, None, None, 0,
            valid.data_ptr(), stream)
    keys = Z._key_buffer(idx.device, stream, (n_px + 1) // 2)
    scatter = (idx.data_ptr(), key.data_ptr(), None, None, None, None, idx.numel(), 0,
               keys.data_ptr(), n_px, 0, bits.data_ptr(), None, None, None, None, 0, stream)
    return (lambda: lib.fuse_prep_launch(*prep), lambda: lib.scatter_min_u32_launch(*scatter))


def time_api_designs(scene, card: str) -> None:
    """The prep and the scatter-min through the JAX-API wrappers that both
    designs have, at one dual frame: B3 on one camera (``fuse_prep``), the
    pallas frame's prep and resolve as the one-camera designs ran it (two
    ``fuse_prep`` launches, two ``torch.cat``, ``scatter_min_u32``, the
    eager ``_decode_packed_planes``), ``scatter_min_u32`` on its keys, and
    the packed render of the frame's planes
    (``project_zbuffer_packed_planar``: the eager projection, then the key
    build, scatter-min and decode). Wrapper ms (CUDA events around 20
    calls), device ms by the profiler, and the bare launches."""
    from pointcloud_depthfusion_tpu_torch.core import geometry as G
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, fused_poses
    from pointcloud_depthfusion_tpu_torch.ops import filters as F
    from pointcloud_depthfusion_tpu_torch.ops import render as R
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
    from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
    from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

    intr, fs = S.framesets(scene, S.DEVICE)
    cfg = FusionConfig.create(vertical_image=True, mirror_image=True, device=S.DEVICE)
    fi = fused_virtual_intrinsics(intr, True)
    poses = fused_poses(cfg, torch.as_tensor(scene.t_rl, device=S.DEVICE))
    z_near, z_far = 0.5 * cfg.min_depth, cfg.max_depth + 1.0
    n_px = fi.width * fi.height
    cams = [(f.depth, f.color, f.depth_scale, cfg.min_depth, cfg.max_depth, f.color_intrinsics,
             pose, fi, True, z_near, z_far) for f, pose in zip(fs[0], poses)]

    def pallas():
        preps = [B3.fuse_prep(*a) for a in cams]
        buf = Z.scatter_min_u32(torch.cat([i.reshape(-1) for i, _ in preps]),
                                torch.cat([k.reshape(-1) for _, k in preps]), n_px)
        return R._decode_packed_planes(buf, z_near, z_far)

    preps = [B3.fuse_prep(*a) for a in cams]
    idx = torch.cat([i.reshape(-1) for i, _ in preps])
    key = torch.cat([k.reshape(-1) for _, k in preps])
    planes = []
    for f, pose in zip(fs[0], poses):
        d, valid = F.filter_depth(f.depth, f.depth_scale, cfg.min_depth, cfg.max_depth)
        *xyz, valid = G.deproject_planar(d.to(torch.float32) * f.depth_scale, f.color_intrinsics,
                                         valid)
        planes.append((*G.transform_planar(*xyz, pose), valid, R.pack_rgb(f.color)))
    x, y, z, val, rgb24 = (torch.stack(p) for p in zip(*planes))
    bare_prep1, bare_scatter1 = bare_api_calls(_build.load(), scene, list(cams[0]), idx, key,
                                               n_px)
    cases = {
        "fuse_prep one camera": (lambda: B3.fuse_prep(*cams[0]), bare_prep1),
        "pallas prep and resolve (2 fuse_prep, 2 cat, scatter_min_u32, decode)": (pallas, None),
        "scatter_min_u32 given keys": (lambda: Z.scatter_min_u32(idx, key, n_px), bare_scatter1),
        "packed render of the planes (project_zbuffer_packed_planar)": (
            lambda: R.project_zbuffer_packed_planar(x, y, z, None, None, None, val, fi, True,
                                                    z_near, z_far, True, rgb24), None),
    }
    for name, (fn, bare) in cases.items():
        ms = S.cuda_ms(fn, 20)
        dk, parts = S.device_time(fn)
        bare_ms = None if bare is None else S.cuda_ms(bare, 50)
        S.log(f"[6] JAX-API {name} at dual {scene.w}x{scene.h}: wrapper {ms:.5f} ms, device "
              f"{dk:.5f} ms ({len(parts)} kinds: "
              + ", ".join(f"{m} {v:.5f}" for m, v in parts.items()) + ")"
              + ("" if bare_ms is None else f", bare launch {bare_ms:.5f} ms") + f" on {card}")
    torch.cuda.synchronize()


def time_filter_designs(scenes, card: str) -> None:
    """``filter_depth(use_morphology=True)`` at each scene's size (wrapper
    ms by CUDA events around 20 calls, device ms by the profiler, and the
    kernel launches and copies of one traced call) and ``spatial_filter``
    at the first (wrapper ms, 5 calls: the eager loop takes ~1 s a call)."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    for scene in scenes:
        f = scene.frames[0][0]
        depth = torch.from_numpy(f.depth.astype("int32")).to(S.DEVICE)
        scale, lo, hi = (torch.tensor(v, device=S.DEVICE) for v in (f.depth_scale, 0.5, 3.0))
        roi = (40, 20, scene.w - 120, scene.h - 60)

        def fd():
            return F.filter_depth(depth, scale, lo, hi, roi, use_morphology=True)

        ms = S.cuda_ms(fd, 20)
        dk, parts = S.device_time(fd)
        trace = S.traced(fd, 1)
        S.log(f"[13] filter_depth(use_morphology=True) {scene.w}x{scene.h}: wrapper {ms:.5f} ms, "
              f"device {S.device_text(dk, parts)}, one call {trace.launches} kernel launches and "
              f"{trace.copy_calls} copies or fills on {card}")
    depth = torch.from_numpy(scenes[0].frames[0][0].depth.astype("int32")).to(S.DEVICE)
    for holes_fill in (0, 3):
        ms = S.cuda_ms(lambda: F.spatial_filter(depth, holes_fill=holes_fill), 5, 1)
        S.log(f"[13] spatial_filter {scenes[0].w}x{scenes[0].h} holes_fill {holes_fill}: wrapper "
              f"{ms:.5f} ms on {card}")


def use_host_runtime() -> None:
    """Build, load and use the native host runtime (20 renders of a
    1280×720 camera frame, each spatially filtered), as chip_smoke.py's
    phase 13e leaves the process before its timing phases: its OpenMP
    threads exist while the wrappers are timed."""
    from pointcloud_depthfusion_tpu_torch import runtime
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig

    scene, (pose, _) = SyntheticScene(), two_camera_rig()
    spheres = [[*q.center, q.radius, *q.base_color] for q in scene.spheres]
    for k in range(20):
        depth, _ = runtime.render_scene_native(
            1280, 720, 950.0, 950.0, 640.0, 360.0, pose, scene.plane_z, spheres,
            scene.checker_period, scene.max_depth, 0.001, 0.002, 0.01, k)
        runtime.spatial_filter_native(depth)
    S.log("native host runtime loaded and used (20 renders and spatial filters at 1280x720)")


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_designs: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

    card = S.card_line()
    S.log(card)
    _build.load()
    if "--host-runtime" in sys.argv[1:]:
        use_host_runtime()
    scenes = (S.build_scene(848, 480), S.build_scene(1280, 720))
    if "--filters" in sys.argv[1:]:
        time_filter_designs(scenes, card)
        return 0
    for scene in scenes:
        time_api_designs(scene, card)
        for mode in ("tiled", "pallas", "packed"):
            S.profile_frame(scene, card, mode, limit=False)
    for n, w, h, case in S.RIG_PROFILED:
        S.profile_rig_frame(S.build_rig(n, w, h, n_frames=1), case, card, limit=False)
    frame_ms = {}
    for scene in scenes:
        frame_ms.update({**S.time_pipeline(scene, card), **S.time_modes(scene, card)})
    S.log(f"[6] summary ms/frame {json.dumps(frame_ms)} on {card}")
    S.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
