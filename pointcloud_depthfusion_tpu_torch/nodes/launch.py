"""One-command deployment: the ``ros2 launch`` equivalent.

Port of pointcloud_depthfusion_tpu/nodes/launch.py. One manifest describes
every node of a deployment (camera sources, the fusion tier, the
registration cadence, the viewer sink) and

    python -m pointcloud_depthfusion_tpu_torch.nodes.launch \\
        --deployment configs/deployment_dual.yaml [--frames N] [--cpu]

runs it on the card (``--cpu``: on the CPU) and prints one JSON summary.
Two cameras compose the reference's topology: two CameraNodes →
ApproximateTime-synced DeviceFeeder → FusionNodeApp, with
RegistrationNodeApp ticks every ``every_n_frames`` and an ImageNode PNG
sink. Three or more compose the rig tier (RigFusionNodeApp).

Manifest schema (see the JAX module; all sections optional but
``cameras``)::

    deployment:
      width: 424            # synthetic-source resolution
      height: 240
      frames: 60            # stop after N fused frames (0 = until EOS)
      cameras:
        - name: camera_left
          source: synthetic         # synthetic | tcp://host:port | /x.npz (a recording)
          seed: 10                  # synthetic only
          pose: left                # left | right, an index, or [tx, ty, tz, yaw_deg]
          config: cam_override.yaml # camera_default.yaml override tier
          serve: 127.0.0.1:0        # also publish this camera over TCP (port 0: any)
      fusion:
        config: fusion_override.yaml
      registration:
        every_n_frames: 15          # 0 disables the service
        config: reg_override.yaml
      viewer:
        out_dir: /tmp/pdf_launch    # PNG sink (ImageNode)
        every_n: 8

Synthetic cameras render with the native host runtime's C++ renderer
(``NativeSyntheticSource``) when it builds, else with the numpy
``SyntheticSource``, as the JAX launcher chooses. A path replays a
recording (``io.recorded.RecordedSource``, looped) with the camera node's
temporal filter off: the recording already carries it. Record one with
``python -m pointcloud_depthfusion_tpu_torch.nodes.camera_node --out x.npz``.

``tcp://host:port`` reads a remote camera host (the ``io.network`` or
``io.realsense_host`` server of either package) through
``io.network.NetworkSource``, with the camera node's temporal filter as
``camera_default.yaml`` sets it, as the JAX launcher does (so a served
camera's frames are filtered twice, ROADMAP queue C). ``serve:``
publishes a camera's filtered framesets over TCP as well, through a
subscription tee, so the local fusion tier and the remote client both see
every frame the camera captures; ``served_ports`` in the summary lists the
ports bound.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.device import resolve_device


def load_manifest(path: str) -> dict:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    manifest = doc.get("deployment", doc) if isinstance(doc, dict) else doc
    if not isinstance(manifest, dict) or "cameras" not in manifest:
        raise ValueError(f"{path}: manifest needs a 'deployment:' mapping with a 'cameras:' list")
    return manifest


class _TeeSource:
    """FramesetSource view of a CameraNode's published frameset stream.

    A camera with ``serve:`` has two consumers: the local fusion feeder and
    the TCP server. Pulling the CameraNode from both would give each every
    other frame and race the temporal filter's state across threads, so the
    server reads this tee, fed by the camera's publish fan-out: every frame
    the local consumer captures reaches both (the reference's one capture
    loop with many subscribers, camera_node.cpp:338-343). Its bounded
    keep-last queue drops the oldest frame for a slow remote client and
    never stalls the local capture."""

    def __init__(self, cam, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(depth)
        self._closed = threading.Event()
        self.intrinsics = cam.intrinsics
        cam.subscribe_frameset(self._on_frame)

    def _on_frame(self, fs) -> None:
        while True:
            try:
                self._q.put_nowait(fs)
                return
            except queue.Full:  # drop the oldest (keep-last QoS)
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def next_frame(self):
        while not self._closed.is_set():
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def close(self) -> None:
        self._closed.set()


def _camera_pose(spec, index: int, n: int) -> np.ndarray:
    """A manifest pose entry → 4×4 world_from_camera."""
    from pointcloud_depthfusion_tpu_torch.io.synthetic import rig_arc_poses, two_camera_rig

    pose = spec.get("pose", index)
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    if isinstance(pose, str):
        if pose == "left":
            return wl
        if pose == "right":
            return wr
        raise ValueError(f"camera pose {pose!r}: use left/right, an index, "
                         "or [tx, ty, tz, yaw_deg]")
    if isinstance(pose, (list, tuple)):
        tx, ty, tz, yaw_deg = (float(v) for v in pose)
        yaw = np.deg2rad(yaw_deg)
        m = np.eye(4)
        m[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        m[:3, 3] = [tx, ty, tz]
        return m
    # An index: 2 cameras → the stereo rig; more → a converging arc
    # (adjacent frusta overlap, which the pair sweeps need).
    if n == 2:
        return (wl, wr)[int(pose)]
    return rig_arc_poses(n, span=0.8, toe_in_deg_per_m=37.5)[int(pose)]


def _build_camera(spec: dict, index: int, n: int, width: int, height: int,
                  servers: Optional[list] = None):
    """One manifest camera entry → a CameraNode over a synthetic source, a
    remote camera host or a recording; with ``serve:``, its TCP server is
    started and appended to ``servers``."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.io.feeder import NativeSyntheticSource, SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.runtime import is_available as native_ok
    from pointcloud_depthfusion_tpu_torch.utils import factory

    name = spec.get("name", f"camera_{index}")
    kind = str(spec.get("source", "synthetic"))
    pose = None
    if kind.startswith("tcp://"):
        from pointcloud_depthfusion_tpu_torch.io.network import NetworkSource, parse_tcp_source

        source = NetworkSource(*parse_tcp_source(kind))
    elif kind != "synthetic":
        # A path: replay a recording. It already carries its capture
        # path's temporal EMA; filtering again would double it.
        source = RecordedSource(kind, loop=True)
    else:
        pose = _camera_pose(spec, index, n)
        fx = 631.0 * width / 848.0
        intr = Intrinsics.create(width, height, fx=fx, fy=fx, ppx=width / 2, ppy=height / 2,
                                 device="cpu")
        cls = NativeSyntheticSource if native_ok() else SyntheticSource
        source = cls(
            SyntheticScene(), intr, pose,
            depth_noise_std=float(spec.get("depth_noise_std", 0.002)),
            seed=int(spec.get("seed", 10 * (index + 1))),
        )
    cam = CameraNode(name, source)
    cam.attach_config(factory.camera_config(name, spec.get("config")))
    if isinstance(source, RecordedSource):
        # Set through the tree, after it is attached: camera_default.yaml
        # turns the filter on for camera_left and camera_right, which
        # overrides a constructor argument (the JAX launcher's, ROADMAP
        # queue C). A tcp:// camera keeps the filter as the tree sets it,
        # as in the JAX launcher.
        cam.config.set("sensor.depth.temporal_filter", False)
    # The rig tier seeds its calibration from the true synthetic poses;
    # a recording or a remote camera has none.
    cam.launch_pose = pose

    serve = spec.get("serve")
    if serve:
        if servers is None:
            raise ValueError(f"camera {name!r}: serve: needs a list to hand its server to")
        # The server reads a subscription tee, not the CameraNode, which
        # the local fusion feeder already pulls.
        from pointcloud_depthfusion_tpu_torch.io.network import FramesetStreamServer

        host, _, port = str(serve).partition(":")
        srv = FramesetStreamServer(_TeeSource(cam), host=host or "127.0.0.1",
                                   port=int(port or 0), name=name)
        srv.start()
        servers.append(srv)
    return cam


def run_deployment(manifest: dict, cpu: bool = False, frames: Optional[int] = None, *,
                   device=None) -> dict:
    """Stand up every node of ``manifest`` on ``device`` (``None``: the
    card), run, and return a summary. ``cpu=True`` (the JAX package's
    signature) means ``device="cpu"``; with another ``device`` it raises.
    ``cpu`` takes only a bool, so a device passed in its place raises."""
    from pointcloud_depthfusion_tpu_torch.nodes.image_node import ImageNode

    if not isinstance(cpu, (bool, np.bool_)):
        raise TypeError(f"cpu must be a bool, got {cpu!r}: pass a device as device=")
    if cpu:
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        device = "cpu"
    device = resolve_device(device)
    width = int(manifest.get("width", 424))
    height = int(manifest.get("height", 240))
    max_frames = frames if frames is not None else int(manifest.get("frames", 0))
    cam_specs = manifest["cameras"]
    if len(cam_specs) < 2:
        raise ValueError("a deployment needs at least 2 cameras")

    servers: list = []
    fused = []
    t0 = time.perf_counter()
    # The try covers construction too: a camera that raises while it is
    # built (an unreachable tcp:// peer, a bad recording path) must not leak
    # the servers the cameras before it started.
    try:
        cameras = [_build_camera(spec, i, len(cam_specs), width, height, servers)
                   for i, spec in enumerate(cam_specs)]
        fusion_section = manifest.get("fusion") or {}
        reg_section = manifest.get("registration") or {}
        reg_every = int(reg_section.get("every_n_frames", 15))
        viewer_section = manifest.get("viewer") or {}
        sink = None
        if viewer_section.get("out_dir"):
            sink = ImageNode(out_dir=str(viewer_section["out_dir"]),
                             every_n=int(viewer_section.get("every_n", 8)))
        if len(cameras) == 2:
            frames_done, reg = _run_dual(cameras, fusion_section, reg_section, reg_every,
                                         sink, fused, max_frames, device)
        else:
            frames_done, reg = _run_rig(cameras, fusion_section, reg_every, sink, fused,
                                        max_frames, device)
    finally:
        for srv in servers:
            # Close the tee first: its server's producer otherwise waits
            # for frames that stopped coming, and stop() would spend its
            # whole join timeout on each served camera.
            srv.source.close()
            srv.stop()
    wall = time.perf_counter() - t0
    telemetry = reg.pipeline.telemetry if reg is not None else []
    return {
        "cameras": len(cameras),
        "tier": "dual" if len(cameras) == 2 else "rig",
        "frames": frames_done,
        "wall_s": round(wall, 3),
        "fused_shape": list(fused[-1].shape) if fused else None,
        "fused_coverage": round(float((fused[-1].sum(-1) > 0).mean()), 3) if fused else None,
        "registration_fitness": float(telemetry[-1].fitness) if telemetry else None,
        "saved_pngs": sink.saved if sink else 0,
        "served_ports": [srv.port for srv in servers],
        # The port's own keys: the device, and the registration service's
        # ticks, target-grid rebuilds and last transform (dual tier).
        "device": str(device),
        "registration_ticks": len(telemetry),
        "registration_grid_rebuilds": sum(t.target_grid_rebuilt for t in telemetry),
        "registration_transform": (reg.pipeline.last_transform.tolist()
                                   if telemetry else None),
    }


def _run_dual(cameras, fusion_section, reg_section, reg_every, sink, fused, max_frames,
              device):
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu_torch.nodes.registration_node import RegistrationNodeApp
    from pointcloud_depthfusion_tpu_torch.utils import factory

    # No CPU remap of `tiled` to `exact` (the JAX launcher's, for its Pallas
    # interpreter): on the CPU the port's `tiled` runs the kernels' plain
    # versions, bit-identical to `exact`.
    fusion_cfg, fusion_tree = factory.fusion_config(fusion_section.get("config"), device)
    fusion = FusionNodeApp(cameras[0], cameras[1], config=fusion_cfg, device=device,
                           **factory.fusion_node_kwargs_from_tree(fusion_tree))
    fusion.subscribe_fused(lambda img, ts: fused.append(img))
    if sink is not None:
        fusion.subscribe_fused(sink)

    registration = None
    if reg_every:
        reg_settings, reg_tree = factory.registration_settings(reg_section.get("config"))
        registration = RegistrationNodeApp(
            cameras[0], cameras[1], settings=reg_settings, device=device,
            **factory.registration_node_kwargs_from_tree(reg_tree),
        )
        registration.subscribe_transform(fusion.on_transform)

    done = 0
    with fusion.feeder as feeder:
        for i, pair in enumerate(feeder):
            if registration is not None and i % reg_every == 0:
                registration.tick()
            fusion.process_pair(pair)
            done += 1
            if max_frames and done >= max_frames:
                break
    if registration is not None:
        registration.stop()
    return done, registration


def _run_rig(cameras, fusion_section, reg_every, sink, fused, max_frames, device):
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp
    from pointcloud_depthfusion_tpu_torch.utils import factory

    n = len(cameras)
    config = None
    if fusion_section.get("config"):
        config, _ = factory.fusion_config(fusion_section["config"], device)
    # Per-camera intrinsics, and the true synthetic poses as the initial
    # calibration (cam→world is cam→virtual for the world-frame camera);
    # with a recording among the cameras, the identity, which the per-pair
    # sweeps calibrate.
    intrs = [c.intrinsics for c in cameras]
    poses = [c.launch_pose for c in cameras]
    if all(p is not None for p in poses):
        initial = np.stack(poses).astype(np.float32)
    else:
        initial = np.eye(4, dtype=np.float32)[None].repeat(n, 0)
    app = RigFusionNodeApp(cameras, intrs, initial, config=config,
                           registration_every=reg_every,
                           registration_async=False,  # deterministic frame counts
                           device=device)
    app.subscribe_fused(lambda img, ts: fused.append(img))
    if sink is not None:
        app.subscribe_fused(lambda img, ts: sink(img, ts[0]))
    done = app.run(max_frames=max_frames or None)
    return done, None


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--deployment", required=True, help="YAML manifest (see above)")
    parser.add_argument("--frames", type=int, default=None,
                        help="override the manifest's frame bound")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args()
    summary = run_deployment(load_manifest(args.deployment), cpu=args.cpu, frames=args.frames)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
