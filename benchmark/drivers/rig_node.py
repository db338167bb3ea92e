"""Driver of the rig tier: ``RigFusionNodeApp.run`` over one ``CameraNode``
per camera, each on one of the benchmark's camera sources.

The path under test is the rig's as ``launch._run_rig`` ships it: the
camera nodes, the N-way ApproximateTime gate, the stacked pinned upload
with the colour packed on the device, the one-launch prep over every
camera, the image-only resolve and the colour kernel, the synchronous
readback and the subscriber. The calibration is the scene's true
camera->world poses, handed in as ``initial_cam_to_virtual``, as a loaded
calibration is.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark.drivers.fusion_node import host_frameset, intrinsics  # noqa: F401
from benchmark.metrics import _roofline
from benchmark.reference import rig as ref


def rig_kernels(config: dict) -> list:
    """The rig step's kernels and the bytes each launch must move: B3 over
    every camera, the resolve over every camera's pixels, the colour
    kernel over the virtual image."""
    i, r = config["intrinsics"], config["rig_node"]
    px, n = i["width"] * i["height"], config["rig"]["cameras"]
    return [("fuse_prep_kernel", _roofline.fuse_prep_bytes(n, px, 4 if r["pack_color"] else 3)),
            ("resolve", _roofline.resolve_bytes(n * px, px, r["emit_zbuf"])),
            ("color3x3", _roofline.color3x3_bytes(px))]


def fusion_config(config: dict, device):
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig  # noqa: PLC0415

    r = config["rig_node"]
    keys = ("min_depth", "max_depth", "vertical_image", "mirror_image", "use_median_filter",
            "filter_fused_color", "align_frames", "render_mode", "emit_zbuf")
    return FusionConfig.create(device=device, **{k: r[k] for k in keys})


def _check_feeder(feeder, r: dict) -> None:
    """The node builds its feeder at the feeder's defaults: the file must
    state those."""
    got = (round(feeder.sync.max_interval_s * 1e3, 6), feeder.sync.queue_size,
           feeder._q.maxsize)
    want = (r["sync_max_interval_ms"], r["sync_queue_size"], r["feeder_depth"])
    if got != want:
        raise ValueError(f"the rig node's feeder runs {got}; the configuration states {want}")


def build(config: dict, pool: dict, rec, device, make_source):
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp  # noqa: PLC0415

    cam, r = config["camera_node"], config["rig_node"]
    if r["calibration"] != "true_poses":
        raise ValueError(f"unknown calibration {r['calibration']!r}")
    intr = intrinsics(config)
    sources = [make_source(intr, c) for c in range(len(pool["poses"]))]
    cams = [CameraNode(f"cam{c}", src, fps=config["fps"], temporal_filter=cam["temporal_filter"],
                       temporal_alpha=cam["temporal_alpha"], temporal_delta=cam["temporal_delta"])
            for c, src in enumerate(sources)]
    app = RigFusionNodeApp(
        cams, [c.intrinsics for c in cams], np.stack(pool["poses"]).astype(np.float32),
        config=fusion_config(config, device), pack_color=r["pack_color"],
        lifespan_s=r["lifespan_s"] or None, registration_every=r["registration_every"],
        device=device)
    _check_feeder(app.feeder, r)
    app.subscribe_fused(lambda img, stamps: rec.on_image(img, stamps[0]))
    if rec.tracing:
        _spans(app, cams, sources, rec)

    def drops():
        return {"sync": app.feeder.sync.dropped, "lifespan": app.feeder.dropped_stale}

    return types.SimpleNamespace(sources=sources, kernels=rig_kernels(config), run=app.run,
                                 close=app.stop, drops=drops)


def _spans(app, cams, sources, rec) -> None:
    """The benchmark's spans around the calls into each layer (traced runs
    only): a set's captures on the feeder thread without the sources' waits
    for the due time, the set's wait in the feeder's queue and its upload
    time, the rig step's host time, and when the step returned."""
    from torch.profiler import record_function  # noqa: PLC0415

    last = len(cams) - 1
    capture = {}
    for c, (cam, src) in enumerate(zip(cams, sources)):
        def next_frame(orig=cam.next_frame, src=src, c=c):
            t = time.perf_counter()
            with record_function("camera_node.capture"):
                fs = orig()
            ms = (time.perf_counter() - t - src.last_wait_s) * 1e3
            if c == 0:
                capture.update(t=t + src.last_wait_s, ms=0.0)
            capture["ms"] += ms
            if fs is not None and c == last:
                rec.span("rig_feeder.capture_ms", capture["t"], capture["ms"])
            return fs
        cam.next_frame = next_frame

    current = {}

    def process_batch(batch, orig=app.process_batch):
        t = time.perf_counter()
        current["k"] = rec.clock.frame_of(batch.timestamps[0])
        rec.span("rig_feeder.wait_ms", t, (t - batch.enqueue_time) * 1e3)
        rec.span("rig_feeder.upload_ms", t, batch.upload_ms)
        with record_function("rig_node.process_batch"):
            return orig(batch)

    def fuse(*args, orig=app._fuse):
        t = time.perf_counter()
        with record_function("rig.step"):
            out = orig(*args)
        end = time.perf_counter()
        rec.span("rig.step_host_ms", t, (end - t) * 1e3)
        rec.process_end[current["k"]] = end
        return out

    app.process_batch = process_batch
    app._fuse = fuse


def reference_images(config: dict, pool: dict, rec, frames, device, dtype=torch.float32) -> dict:
    """{frame: the reference's fused image} for the sampled frames. Every
    camera's frame k carries the same stamp, and the node's sets pair them
    so; with no temporal filter a frame is its pool frame."""
    r = config["rig_node"]
    ref.check_supported(r)
    if config["camera_node"]["temporal_filter"]:
        raise ValueError("the rig reference takes the cameras' frames unfiltered")
    poses = ref.cam_to_virtual(pool["poses"], device)
    p = pool["depth"].shape[1]
    out = {k: ref.fuse_rig_image(pool["depth"][:, k % p], pool["color"][:, k % p],
                                 config["depth_scale"], config["intrinsics"], poses, r, dtype)
           for k in frames}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out
