"""N-camera rig fusion node: streaming ingestion + continuous calibration.

Port of pointcloud_depthfusion_tpu/nodes/rig_node.py. One
:class:`~pointcloud_depthfusion_tpu_torch.io.feeder.RigFeeder` ingests all
cameras (N-way ApproximateTime gate, one stacked upload, or one upload per
shard device over a camera mesh), one
:func:`~pointcloud_depthfusion_tpu_torch.parallel.mesh.rig_fuse` step (or
``rig_fuse_sharded`` over the mesh) renders, and a periodic adjacent-pair
registration sweep keeps the rig
calibrated while it streams (the N-camera analogue of the reference's
0.5 Hz registration service, registration_node.cpp:272-461).

Calibration model: ``cam_to_virtual[i]`` maps camera i points into the
virtual/output frame. The sweep solves the N-1 adjacent relative transforms
T_i (camera i+1 → camera i), gates each solve on fitness, composes the
accepted chain from camera 0 (P_0 = I, P_{i+1} = P_i·T_i), and re-anchors
``cam_to_virtual[i] = cam_to_virtual[0]·P_i``: camera 0 is the fixed frame.
The calibration lives on the host as numpy (the sweep thread writes it) and
is uploaded once per frame as one (N, 4, 4) f32 tensor.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics, fused_virtual_intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource, RigFeeder
from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse, rig_fuse_sharded
from pointcloud_depthfusion_tpu_torch.registration.pipeline import (
    RegistrationPipeline,
    RegistrationSettings,
)
from pointcloud_depthfusion_tpu_torch.utils.profiling import FpsCounter


class RigFusionNodeApp:
    """Streaming N-camera fusion with optional continuous calibration, on
    ``device`` (``None``: the card, or the mesh's first shard device).

    Args:
      sources: one FramesetSource per camera.
      intrinsics: shared Intrinsics or per-camera sequence (width/height
        must agree, like ``rig_fuse``).
      initial_cam_to_virtual: (N, 4, 4) camera→virtual transforms (the
        persisted or CAD calibration guess, cf. transform.txt,
        registration_node.cpp:742-833), refined by the registration sweep
        when ``registration_every`` > 0.
      mesh: optional camera mesh (parallel.mesh.make_camera_mesh): selects
        ``rig_fuse_sharded`` and the per-shard upload, and the z-buffer
        resolve by default (the sharded merge needs each shard's min z).
      registration_every: one adjacent-pair sweep every K fused frames (0
        disables). Each pair runs its own full RegistrationPipeline (cold
        annealing, warm starts, fitness gating, guess reset); a gated pair
        keeps its previous transform (registration_node.cpp:363-393).
      reg_settings: RegistrationSettings shared by the pair pipelines. The
        default disables the stereo angle gate: a converging rig's correct
        pair solves carry toe-in yaw that the |euler_y| < 2° prior rejects.
      registration_async: sweeps on a background thread (default; a due
        sweep is SKIPPED while one is in flight). False runs them inline.
    """

    def __init__(
        self,
        sources: Sequence[FramesetSource],
        intrinsics,
        initial_cam_to_virtual: np.ndarray,
        config: Optional[FusionConfig] = None,
        mesh=None,
        axis: str = "cam",
        pack_color: bool = True,
        lifespan_s: Optional[float] = None,
        registration_every: int = 0,
        reg_settings: Optional[RegistrationSettings] = None,
        registration_async: bool = True,
        device=None,
    ):
        self.device = mesh.devices[0] if mesh is not None and device is None else (
            resolve_device(device))
        n = len(sources)
        self.n_cameras = n
        # Image-only resolve on one device; the camera-sharded merge needs
        # each shard's min z (rig_node.py:90-97).
        self.config = (config or FusionConfig.create(
            vertical_image=False, mirror_image=False, filter_fused_color=False,
            emit_zbuf=mesh is not None, device=self.device,
        )).to(self.device)
        self.intrinsics = intrinsics
        self.registration_every = registration_every
        self.registration_async = registration_async
        self._sweep_thread: Optional[threading.Thread] = None
        self.cam_to_virtual = np.asarray(
            initial_cam_to_virtual, np.float32
        ).reshape(n, 4, 4).copy()
        self._pair_pipes: Optional[list] = None
        self.reg_settings = reg_settings
        # True once load_calibration succeeded: pair pipelines then
        # warm-start from the loaded transforms instead of cold-annealing.
        self._calibration_trusted = False
        if registration_every:
            self._ensure_pair_pipes()

        self.feeder = RigFeeder(sources, mesh=mesh, axis=axis, pack_color=pack_color,
                                lifespan_s=lifespan_s, device=self.device)
        if mesh is not None:
            self._fuse = rig_fuse_sharded(mesh, intrinsics, self.fused_intrinsics, self.config,
                                          axis=axis)
        else:
            self._fuse = rig_fuse(intrinsics, self.fused_intrinsics, self.config,
                                  device=self.device)
        self._fused_subs: List[Callable[[np.ndarray, List[float]], None]] = []
        self._transform_subs: List[Callable[[np.ndarray], None]] = []
        self.fps_counter = FpsCounter(name="rig_fusion/fps")
        self.frames_processed = 0
        self.registration_ticks = 0

    def _intr_at(self, i: int) -> Intrinsics:
        if isinstance(self.intrinsics, Intrinsics):
            return self.intrinsics
        return self.intrinsics[i]

    def _ensure_pair_pipes(self) -> list:
        """Build the adjacent-pair registration pipelines on first use
        (``registration_tick`` works with ``registration_every=0`` too)."""
        if self._pair_pipes is None:
            if self.reg_settings is None:
                # angle_gate=False: the Euler gate encodes the reference's
                # STEREO prior; a converging rig's adjacent pairs have toe-in
                # yaw by construction. The fitness gate stays on.
                self.reg_settings = RegistrationSettings(
                    resolution=0.02, voxelsize=0.01, initial_resolution=0.12,
                    resolution_step=0.05, max_iterations=48, angle_gate=False,
                )
            # One full 2-camera registration service per adjacent pair: pair
            # i refines T_i (camera i+1 → camera i).
            self._pair_pipes = [
                RegistrationPipeline(self._intr_at(i), self._intr_at(i + 1), self.reg_settings,
                                     device=self.device)
                for i in range(self.n_cameras - 1)
            ]
            if self._calibration_trusted:
                self._seed_pair_pipes()
        return self._pair_pipes

    def _seed_pair_pipes(self) -> None:
        """Warm-start each pair pipeline from the CURRENT cam_to_virtual, so
        the first sweep refines a loaded calibration instead of
        cold-annealing over it."""
        if not self._pair_pipes:
            return
        c2v = self.cam_to_virtual.astype(np.float64)
        for i, pipe in enumerate(self._pair_pipes):
            rel = np.linalg.inv(c2v[i]) @ c2v[i + 1]
            pipe.seed(rel.astype(np.float32))

    @property
    def fused_intrinsics(self) -> Intrinsics:
        return fused_virtual_intrinsics(self._intr_at(0).to(self.device),
                                        self.config.vertical_image)

    def subscribe_fused(self, cb: Callable[[np.ndarray, List[float]], None]) -> None:
        """``cb(image (Hf, Wf, 3) u8, per-camera host timestamps)``."""
        self._fused_subs.append(cb)

    def subscribe_transforms(self, cb: Callable[[np.ndarray], None]) -> None:
        """``cb(cam_to_virtual (N, 4, 4))`` after each sweep."""
        self._transform_subs.append(cb)

    # -- calibration sweep -------------------------------------------------

    def registration_tick(self, batch) -> np.ndarray:
        """One adjacent-pair sweep on ``batch``; returns cam_to_virtual.

        Pair i's RegistrationPipeline ticks on (depth_i, depth_{i+1}) with
        each frame's own depth scale, and the accepted chain re-anchors
        every camera to camera 0's fixed transform."""
        rel = []
        for i, pipe in enumerate(self._ensure_pair_pipes()):
            fl, fr = batch.host_frames[i], batch.host_frames[i + 1]
            rel.append(np.asarray(
                pipe.tick(fl.depth, fr.depth, depth_scale_left=fl.depth_scale,
                          depth_scale_right=fr.depth_scale),
                np.float32,
            ))
        # Compose into a NEW array and swap the reference at once: the sweep
        # may run on its thread while process_batch reads cam_to_virtual.
        new = self.cam_to_virtual.copy()
        p = np.eye(4, dtype=np.float32)
        for i in range(self.n_cameras - 1):
            p = p @ rel[i]
            new[i + 1] = new[0] @ p
        self.cam_to_virtual = new
        self.registration_ticks += 1
        for cb in self._transform_subs:
            cb(self.cam_to_virtual.copy())
        return self.cam_to_virtual

    # -- calibration persistence -------------------------------------------

    def save_calibration(self, path: str) -> None:
        """Persist cam_to_virtual as whitespace text ((4·N, 4) stacked 4×4s),
        the N-camera form of the reference's transform.txt."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savetxt(path, self.cam_to_virtual.reshape(-1, 4).astype(np.float64))

    def load_calibration(self, path: str) -> bool:
        """Load a persisted calibration; False (state untouched) on any
        failure, the identity-fallback discipline of loadTransform."""
        try:
            m = np.loadtxt(path).reshape(self.n_cameras, 4, 4)
        except (OSError, ValueError):
            return False
        if not np.all(np.isfinite(m)):
            return False
        self.cam_to_virtual = m.astype(np.float32)
        self._calibration_trusted = True
        self._seed_pair_pipes()
        return True

    # -- streaming loop ----------------------------------------------------

    def process_batch(self, batch) -> np.ndarray:
        c2v = torch.from_numpy(self.cam_to_virtual).to(self.device)
        img = self._fuse(batch.depth, batch.color, batch.depth_scale, c2v)
        out = img.cpu().numpy()
        for cb in self._fused_subs:
            cb(out, batch.timestamps)
        self.frames_processed += 1
        msg = self.fps_counter.tick()
        if msg:
            print(msg, flush=True)
        return out

    def _maybe_sweep(self, batch) -> None:
        """Kick (or run) one calibration sweep for ``batch``."""
        if not self.registration_async:
            self.registration_tick(batch)
            return
        if self._sweep_thread is not None and self._sweep_thread.is_alive():
            return  # latest-wins: a sweep is still running, skip this one
        # host_frames are numpy: safe to hand to the worker while the
        # streaming loop moves on.
        self._sweep_thread = threading.Thread(target=self.registration_tick, args=(batch,),
                                              daemon=True)
        self._sweep_thread.start()

    def _join_sweep(self, timeout: float = 60.0) -> None:
        t = self._sweep_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def run(self, max_frames: Optional[int] = None) -> int:
        """Stream until the sources end (or ``max_frames``); returns the
        number of fused frames. An in-flight sweep is joined before
        returning, so save_calibration at exit sees the final chain."""
        done = 0
        with self.feeder as feeder:
            for batch in feeder:
                if self.registration_every and done % self.registration_every == 0:
                    self._maybe_sweep(batch)
                self.process_batch(batch)
                done += 1
                if max_frames is not None and done >= max_frames:
                    break
        self._join_sweep()
        return done

    def stop(self) -> None:
        self.feeder.stop()
        self._join_sweep(timeout=5.0)


def main() -> None:
    """Standalone N-camera rig demo: synthetic rig → calibrate → fuse → PNGs.

    Run: ``python -m pointcloud_depthfusion_tpu_torch.nodes.rig_node
    [--cameras N] [--frames N] [--cpu] [--out DIR]``.
    """
    import argparse
    import json
    import tempfile

    from pointcloud_depthfusion_tpu_torch.io.artifacts import save_png
    from pointcloud_depthfusion_tpu_torch.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--cameras", type=int, default=4)
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--width", type=int, default=424)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "pdf_rig_demo"))
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    parser.add_argument("--registration-every", type=int, default=4)
    parser.add_argument("--calibration", default="",
                        help="calibration text file: loaded at start when present, saved "
                        "at exit (the reference's load_transform/save_transform workflow)")
    parser.add_argument("--render-mode", default="tiled", choices=["tiled", "exact", "packed"])
    args = parser.parse_args()

    device = resolve_device("cpu" if args.cpu else None)
    n = args.cameras
    w, h = args.width, args.height
    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
    scene = SyntheticScene()
    # Converging arc (37.5 deg/m toe-in): adjacent frusta overlap, which the
    # per-pair registration sweep needs.
    poses = rig_arc_poses(n, span=0.8, toe_in_deg_per_m=37.5)
    sources = [SyntheticSource(scene, intr, poses[i], seed=i + 1, depth_noise_std=0.002)
               for i in range(n)]
    config = FusionConfig.create(
        vertical_image=False, mirror_image=False, filter_fused_color=False,
        emit_zbuf=False, render_mode=args.render_mode, device=device,
    )
    app = RigFusionNodeApp(sources, intr, np.stack(poses), config=config,
                           registration_every=args.registration_every, device=device)
    os.makedirs(args.out, exist_ok=True)
    idx = [0]

    def save(img, stamps):
        save_png(os.path.join(args.out, f"rig_fused_{idx[0]:04d}.png"), img)
        idx[0] += 1

    app.subscribe_fused(save)
    if args.calibration and app.load_calibration(args.calibration):
        print(f"loaded calibration from {args.calibration}")
    t0 = time.perf_counter()
    done = app.run(max_frames=args.frames)
    if args.calibration:
        app.save_calibration(args.calibration)
    print(json.dumps({
        "frames": done,
        "cameras": n,
        "device": str(device),
        "wall_s": round(time.perf_counter() - t0, 2),
        "registration_ticks": app.registration_ticks,
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
