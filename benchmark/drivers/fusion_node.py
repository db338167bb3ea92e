"""Driver of the two-camera fusion host: ``FusionNodeApp.run`` over two
``CameraNode``s, each on one of the benchmark's camera sources.

The path under test is the mirror's: camera node (the temporal filter),
ApproximateTime pairing, staging and upload on the feeder thread, the
fusion step, the readback and the subscriber. The registration transform
is handed in through ``on_transform``, as a loaded transform.txt is.
"""

from __future__ import annotations

import time
import types

import torch

from benchmark.metrics import _roofline
from benchmark.reference import fusion as ref
from benchmark.scene.render import right_to_left


def host_frameset():
    from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset  # noqa: PLC0415

    return HostFrameset


def intrinsics(config: dict):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics  # noqa: PLC0415

    i = config["intrinsics"]
    return Intrinsics.create(i["width"], i["height"], fx=i["fx"], fy=i["fy"], ppx=i["ppx"],
                             ppy=i["ppy"], device="cpu")


def frame_kernels(config: dict) -> list:
    """The frame's kernels and the bytes each launch must move."""
    i, f = config["intrinsics"], config["fusion_node"]
    px = i["width"] * i["height"]
    color_bytes = 4 if f["pack_color"] else 3
    return [("fuse_prep_kernel", _roofline.fuse_prep_bytes(2, px, color_bytes)),
            ("resolve", _roofline.resolve_bytes(2 * px, px, f["emit_zbuf"])),
            ("color3x3", _roofline.color3x3_bytes(px))]


def build(config: dict, pool: dict, rec, device, make_source):
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp  # noqa: PLC0415

    intr = intrinsics(config)
    cam, f = config["camera_node"], config["fusion_node"]
    sources = [make_source(intr, c) for c in range(2)]
    cams = [CameraNode(name, src, fps=config["fps"], temporal_filter=cam["temporal_filter"],
                       temporal_alpha=cam["temporal_alpha"], temporal_delta=cam["temporal_delta"])
            for name, src in zip(("camera_left", "camera_right"), sources)]
    fusion = FusionConfig.create(
        min_depth=f["min_depth"], max_depth=f["max_depth"], vertical_image=f["vertical_image"],
        mirror_image=f["mirror_image"], use_median_filter=f["use_median_filter"],
        align_frames=f["align_frames"], render_mode=f["render_mode"], emit_zbuf=f["emit_zbuf"],
        filter_fused_color=f["filter_fused_color"], device=device)
    app = FusionNodeApp(
        cams[0], cams[1], config=fusion, max_sync_interval_s=f["sync_max_interval_ms"] / 1e3,
        sync_queue_size=f["sync_queue_size"], feeder_depth=f["qos_history_depth"],
        device=device, async_readback=f["async_readback"], donate=f["donate"],
        lifespan_s=f["lifespan_s"] or None, pack_color=f["pack_color"])
    app.on_transform(right_to_left(pool["poses"]))
    app.subscribe_fused(rec.on_image)
    if rec.tracing:
        _spans(app, cams, sources, rec)

    def drops():
        return {"pairer": app.feeder.pairer.dropped, "lifespan": app.feeder.dropped_stale}

    def close():
        app.feeder.stop()

    return types.SimpleNamespace(sources=sources, kernels=frame_kernels(config),
                                 held=1 if f["async_readback"] else 0, run=app.run,
                                 close=close, drops=drops)


def _spans(app, cams, sources, rec) -> None:
    """The benchmark's spans around the calls into each layer (traced runs
    only): the camera node's capture without the source's wait for the due
    time, the pair's wait in the feeder's queue and its upload time, the
    fusion step's host time, and when the step ended."""
    from torch.profiler import record_function  # noqa: PLC0415

    for cam, src in zip(cams, sources):
        def next_frame(orig=cam.next_frame, src=src):
            t = time.perf_counter()
            with record_function("camera_node.capture"):
                fs = orig()
            if fs is not None:
                rec.span("camera_node.capture_ms", t,
                         (time.perf_counter() - t - src.last_wait_s) * 1e3)
            return fs
        cam.next_frame = next_frame

    current = {}

    def process_pair(pair, orig=app.process_pair):
        t = time.perf_counter()
        current["k"] = rec.clock.frame_of(pair.host_left.timestamp)
        rec.span("feeder.wait_ms", t, (t - pair.enqueue_time) * 1e3)
        rec.span("feeder.upload_ms", t, pair.upload_ms)
        with record_function("fusion_node.process_pair"):
            return orig(pair)

    def process(left, right, orig=app.pipeline.process):
        t = time.perf_counter()
        with record_function("fusion.process"):
            out = orig(left, right)
        end = time.perf_counter()
        rec.span("step.host_ms", t, (end - t) * 1e3)
        rec.process_end[current["k"]] = end
        return out

    app.process_pair = process_pair
    app.pipeline.process = process


def reference_images(config: dict, pool: dict, rec, frames, device, dtype=torch.float32) -> dict:
    """{frame: the reference's fused image} for the sampled frames."""
    f, cam = config["fusion_node"], config["camera_node"]
    intr = config["intrinsics"]
    wanted = set(frames)
    filtered = [ref.TemporalReplay(pool["depth"][c], cam["temporal_alpha"], cam["temporal_delta"],
                                   cam["temporal_filter"]).filtered(rec.sources[c].handed, wanted)
                for c in range(2)]
    poses = ref.fused_poses(right_to_left(pool["poses"]), f["vertical_image"], device)
    # The frames carry their camera's intrinsics; the virtual camera is made
    # from the ones the node's calibration handshake passed on.
    virt = ref.virtual_intrinsics(ref.handshake_intrinsics(intr), f["vertical_image"])
    if f["use_median_filter"] or f["render_mode"] not in ("tiled", "exact") or f["align_frames"]:
        raise ValueError("the reference computes the tiled, unaligned, Gauss-filtered image")
    p = pool["color"].shape[1]
    out = {}
    for k in frames:
        out[k] = ref.fuse_image([filtered[0][k], filtered[1][k]],
                                [pool["color"][0, k % p], pool["color"][1, k % p]],
                                [config["depth_scale"]] * 2, [intr] * 2, poses, virt, f, dtype)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out
