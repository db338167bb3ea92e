"""End-to-end streaming demo: synthetic rig → registration → fusion → PNGs.

Port of pointcloud_depthfusion_tpu/nodes/demo.py. Run::

    python -m pointcloud_depthfusion_tpu_torch.nodes.demo [--frames N]
        [--width W --height H] [--out DIR] [--sway M] [--gif F] [--cpu]

The whole reference deployment (two camera nodes, registration node, fusion
node, image node; README.md:14-34) in one process: the DDS fabric is the
in-process feeder, the registration service ticks interleaved, and the
fused stream lands as PNG frames with FPS telemetry. It runs on the card
(and raises without one) unless ``--cpu`` asks for the CPU, and prints one
JSON summary line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch


def sway_motion(base: np.ndarray, amplitude: float, phase: float):
    """``motion`` for a synthetic source: the camera sways ``amplitude``
    meters along x (and 0.3 of it along y) about ``base``; None when the
    amplitude is 0."""
    if amplitude <= 0:
        return None

    def motion(frame_idx: int) -> np.ndarray:
        m = base.copy()
        t = frame_idx / 30.0
        m[0, 3] += amplitude * np.sin(0.8 * t + phase)
        m[1, 3] += 0.3 * amplitude * np.sin(1.3 * t + phase)
        return m

    return motion


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``argv``: the arguments (``None``: the command line)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--width", type=int, default=424)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--out", type=str,
                        default=os.path.join(tempfile.gettempdir(), "pdf_torch_demo"))
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    parser.add_argument("--registration-every", type=int, default=15,
                        help="run a registration tick every N frames")
    parser.add_argument("--vertical", action="store_true", default=True)
    parser.add_argument("--no-vertical", dest="vertical", action="store_false")
    parser.add_argument("--sway", type=float, default=0.0,
                        help="camera sway amplitude in meters (animates the rig)")
    parser.add_argument("--gif", type=str, default="",
                        help="write an animated GIF of the fused stream")
    parser.add_argument("--render-mode", default="",
                        choices=["", "tiled", "exact", "indexed", "packed", "pallas"],
                        help="override the configured render mode")
    parser.add_argument("--async-readback", action="store_true", default=None,
                        help="read the fused image back through a pinned host buffer, "
                        "with a wait that releases the GIL (the streaming default; flags "
                        "override the YAML)")
    parser.add_argument("--no-async-readback", dest="async_readback", action="store_false")
    parser.add_argument("--source-left", default="",
                        help="recorded .npz dataset for the left camera (camera_node --out); "
                        "replaces the synthetic source")
    parser.add_argument("--source-right", default="",
                        help="recorded .npz dataset for the right camera")
    args = parser.parse_args(argv)
    if bool(args.source_left) != bool(args.source_right):
        parser.error("--source-left and --source-right must be given together")

    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.device import resolve_device
    from pointcloud_depthfusion_tpu_torch.io.feeder import NativeSyntheticSource, SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu_torch.nodes.image_node import ImageNode
    from pointcloud_depthfusion_tpu_torch.nodes.registration_node import RegistrationNodeApp
    from pointcloud_depthfusion_tpu_torch.runtime import is_available as native_ok
    from pointcloud_depthfusion_tpu_torch.utils import factory

    device = resolve_device("cpu" if args.cpu else None)
    w, h = args.width, args.height
    # The benchmark's camera model (fx = 631 at 848 px, square pixels),
    # narrower than core.camera.d455_default_intrinsics (631 at 1280).
    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    source_cls = NativeSyntheticSource if native_ok() else SyntheticSource

    if args.source_left:
        # Recorded playback, looped so --frames past the recording's length
        # keeps streaming; the recordings bring their own calibration.
        from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource

        src_l = RecordedSource(args.source_left, loop=True)
        src_r = RecordedSource(args.source_right, loop=True)
        if (src_l.intrinsics.width, src_l.intrinsics.height) != (
                src_r.intrinsics.width, src_r.intrinsics.height):
            raise SystemExit("left/right recordings disagree on resolution")
        # A recording already carries its capture path's temporal EMA.
        cam_left = CameraNode("camera_left", src_l, temporal_filter=False)
        cam_right = CameraNode("camera_right", src_r, temporal_filter=False)
    else:
        cam_left = CameraNode("camera_left", source_cls(
            scene, intr, wl, depth_noise_std=0.002, seed=10,
            motion=sway_motion(wl, args.sway, 0.0)))
        cam_right = CameraNode("camera_right", source_cls(
            scene, intr, wr, depth_noise_std=0.002, seed=20,
            motion=sway_motion(wr, args.sway, 1.1)))
    cam_left.attach_config(factory.camera_config("camera_left"))
    cam_right.attach_config(factory.camera_config("camera_right"))

    fusion_cfg, fusion_tree = factory.fusion_config(device=device)
    fusion_cfg = dataclasses.replace(fusion_cfg, vertical_image=args.vertical)
    if args.render_mode:
        fusion_cfg = dataclasses.replace(fusion_cfg, render_mode=args.render_mode)
    # No CPU remap of `tiled` to `exact` (the JAX demo's, for its Pallas
    # interpreter): on the CPU the port's `tiled` runs the kernels' plain
    # versions, bit-identical to `exact`. The YAML's streaming defaults
    # (donate, async_readback, qos.lifespan_s) apply; flags override.
    node_kwargs = factory.fusion_node_kwargs_from_tree(fusion_tree)
    if args.async_readback is not None:
        node_kwargs["async_readback"] = args.async_readback
    fusion = FusionNodeApp(cam_left, cam_right, config=fusion_cfg, device=device, **node_kwargs)

    reg_settings, reg_tree = factory.registration_settings()
    reg_settings = dataclasses.replace(reg_settings, resolution=0.02, voxelsize=0.01,
                                       initial_resolution=0.12, resolution_step=0.05,
                                       max_iterations=48)
    registration = RegistrationNodeApp(cam_left, cam_right, settings=reg_settings, device=device,
                                       **factory.registration_node_kwargs_from_tree(reg_tree))
    registration.subscribe_transform(fusion.on_transform)

    # Viewer close → shutdown (image_node.cpp:54-68): a display raising
    # WindowClosed stops the camera loops and the feeder.
    def on_viewer_close():
        cam_left.stop()
        cam_right.stop()
        fusion.feeder.stop()

    sink = ImageNode(out_dir=args.out, every_n=max(1, args.frames // 8), on_close=on_viewer_close)
    fusion.subscribe_fused(sink)
    # The reference viewer's other subscriptions (image_node.cpp:38-109):
    # the raw depth, the frameset (color and scaled depth) and the small
    # preview, all from the left camera node.
    cam_left.subscribe_depth(sink.on_depth)
    cam_left.subscribe_frameset(sink.on_frameset)
    cam_left.subscribe_color_small(sink.on_image_small)
    gif_frames = []
    if args.gif:
        fusion.subscribe_fused(lambda img, ts: gif_frames.append(img.copy()))
    fusion.fps_counter.sink = print

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name} ({device})  output: {args.out}")
    t0 = time.perf_counter()
    frame_times = []
    with fusion.feeder as feeder:
        for i, pair in enumerate(feeder):
            # The feeder pulls through the CameraNodes, whose capture()
            # already publishes to the registration node's subscriptions.
            if args.registration_every and i % args.registration_every == 0:
                registration.tick()
            t1 = time.perf_counter()
            fusion.process_pair(pair)
            frame_times.append(time.perf_counter() - t1)
            if i + 1 >= args.frames:
                break
    # stop() writes what the YAML asks for (the profiling CSV, the saved
    # transform).
    registration.stop()
    wall = time.perf_counter() - t0

    if args.gif and gif_frames:
        from PIL import Image  # noqa: PLC0415

        imgs = [Image.fromarray(f) for f in gif_frames]
        imgs[0].save(args.gif, save_all=True, append_images=imgs[1:], duration=33, loop=0)
        print(f"wrote {args.gif} ({len(imgs)} frames)")

    ms = np.asarray(frame_times[2:]) * 1e3  # the first two frames warm up
    telemetry = registration.pipeline.telemetry
    print(json.dumps({
        "frames": fusion.frames_processed,
        "wall_s": round(wall, 3),
        "fused_ms_p50": round(float(np.percentile(ms, 50)), 3) if len(ms) else None,
        "fused_ms_p95": round(float(np.percentile(ms, 95)), 3) if len(ms) else None,
        "saved_pngs": sink.saved,
        "registration_fitness": float(telemetry[-1].fitness) if telemetry else None,
    }))


if __name__ == "__main__":
    main()
