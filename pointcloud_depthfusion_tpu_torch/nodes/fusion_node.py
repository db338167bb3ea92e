"""Fusion node: cameras → feeder → pipeline → sinks.

Port of pointcloud_depthfusion_tpu/nodes/fusion_node.py (the reference
FusionNode and its DDS plumbing): fetches calibration through the camera
nodes' parameter service, builds the FusionPipeline on ``device``
(``None``: the card), consumes synchronized device pairs from a
DeviceFeeder, takes registration-transform updates, and publishes fused
frames to subscribers with FPS and stage telemetry.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, camera_info_to_intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import (
    FusionConfig,
    FusionPipeline,
    FusionResult,
)
from pointcloud_depthfusion_tpu_torch.io.feeder import (
    ApproximateTimePairer,
    DeviceFeeder,
    DevicePair,
)
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu_torch.ops.align import auto_footprint
from pointcloud_depthfusion_tpu_torch.utils.profiling import FpsCounter, StageLog


class _Readback:
    """The fused image's device→host copy through a pinned host buffer.

    :meth:`copy` copies the image into the buffer with ``non_blocking=True``
    on the current stream, records an event, waits for it (the wait
    releases the GIL, so the feeder's threads keep capturing) and returns a
    copy of the buffer. A ``non_blocking`` copy into pageable memory would
    be synchronous. On the CPU the image is already on the host: it is
    handed through."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def copy(self, image: torch.Tensor) -> np.ndarray:
        if not image.is_cuda:
            return image.numpy()
        if self._buf is None or self._buf.shape != image.shape:
            self._buf = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
        self._buf.copy_(image, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return self._buf.numpy().copy()


class FusionNodeApp:
    def __init__(
        self,
        camera_left: CameraNode,
        camera_right: CameraNode,
        config: Optional[FusionConfig] = None,
        legacy_int_truncation: bool = True,
        max_sync_interval_s: float = 0.017,
        sync_queue_size: int = 10,
        feeder_depth: int = 2,
        profiling_path: Optional[str] = None,
        profiling_log_size: int = 400,
        device=None,
        save_data_dir: Optional[str] = None,
        async_readback: bool = False,
        donate: bool = False,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
    ):
        """``async_readback=True``: the fused image comes back through a
        pinned host buffer, with a non-blocking copy and an event wait that
        releases the GIL, instead of a blocking copy into pageable memory.
        In both modes frame N is published when its copy lands, before
        :meth:`process_pair` returns, as the upstream node publishes right
        after its device→host copy (the JAX node publishes one frame late
        and drains the last one at the end of the stream). Ignored while
        stage profiling is on.

        ``donate`` is accepted and has no effect, as in FusionPipeline.

        ``lifespan_s``: drop synchronized pairs older than this at dequeue
        (the reference's 1 s QoS lifespan, fusion_node.cpp:183-187); None
        keeps every pair.

        Both async_readback and donate default False; the streaming tier
        turns them on through configs/fusion_default.yaml
        (utils/factory.py)."""
        self.device = resolve_device(device)
        self.camera_left = camera_left
        self.camera_right = camera_right
        self.config = (config or FusionConfig.create(device=self.device)).to(self.device)

        # Startup handshake (fusion_node.cpp:92-148): fetch calibration.
        params_left = camera_left.get_camera_parameters()
        params_right = camera_right.get_camera_parameters()
        self.intr_left = camera_info_to_intrinsics(
            params_left.color_info, legacy_int_truncation=legacy_int_truncation,
            device=self.device)
        self.intr_right = camera_info_to_intrinsics(
            params_right.color_info, legacy_int_truncation=legacy_int_truncation,
            device=self.device)

        # Pin the align splat cap from the handshake's calibration.
        if self.config.align_frames and self.config.align_footprint == "auto":
            bound = max(
                auto_footprint(
                    camera_info_to_intrinsics(p.depth_info,
                                              legacy_int_truncation=legacy_int_truncation,
                                              device="cpu"),
                    c_intr.to("cpu"),
                    Extrinsics.create(np.asarray(p.extrinsic_rotation).reshape(3, 3).T,
                                      p.extrinsic_translation, device="cpu"),
                    min_depth=float(self.config.min_depth),
                )
                for p, c_intr in ((params_left, self.intr_left), (params_right, self.intr_right))
            )
            self.config = dataclasses.replace(self.config, align_footprint=bound)

        # The pallas prep kernel reads the u8 channels and never the packed
        # plane: packing would upload a dead plane every frame.
        if pack_color and self.config.render_mode == "pallas":
            pack_color = False
        self.pipeline = FusionPipeline(self.intr_left, self.config, donate=donate,
                                       device=self.device)
        # Feed through the camera nodes (FramesetSources), not their raw
        # sources: capture() applies the temporal filter the reference runs
        # in getFrames (realsense.cpp:398-404).
        self.feeder = DeviceFeeder(
            camera_left,
            camera_right,
            pairer=ApproximateTimePairer(max_interval_s=max_sync_interval_s,
                                         queue_size=sync_queue_size),
            depth=feeder_depth,
            device=self.device,
            lifespan_s=lifespan_s,
            pack_color=pack_color,
        )
        self._fused_subs: List[Callable[[np.ndarray, float], None]] = []
        self._sync_debug_subs: List[Callable[[str], None]] = []
        self.fps_counter = FpsCounter(name="fusion/fps")
        self.stage_log = (StageLog(profiling_path, log_size=profiling_log_size)
                          if profiling_path else None)
        self._transform_lock = threading.Lock()
        self.frames_processed = 0
        self.save_data_dir = save_data_dir
        self.async_readback = async_readback
        self._readback = _Readback()
        self._last_sync_time: Optional[float] = None

    # -- dynamic reconfiguration ------------------------------------------

    def attach_config(self, cfg) -> None:
        """Wire a ConfigTree for runtime debug and profiling toggles.

        The reference dispatches ``debug.*`` and ``profiling.*`` updates
        while the node runs (parametersCallback, config.cpp:118-137): here
        ``cfg.set("debug.save_data", True)`` starts the PNG dumps between
        frames, ``profiling.enable_profiling`` switches the stage-timing
        mode (``process_profiled`` and the StageLog CSV at
        ``profiling.log_path``) on or off, and ``profiling.publish_fps``
        the FpsCounter's publication.
        """
        self.node_config = cfg
        default_dir = self.save_data_dir or "fusion_debug"
        if bool(cfg.declare("debug.save_data", self.save_data_dir is not None)):
            self.save_data_dir = str(cfg.declare("debug.save_data_dir", default_dir))
        else:
            cfg.declare("debug.save_data_dir", default_dir)
        self.fps_counter.publish = bool(
            cfg.declare("profiling.publish_fps", self.fps_counter.publish))
        prof_path = str(cfg.declare(
            "profiling.log_path",
            self.stage_log.path if self.stage_log else "fusion_profiling.csv"))
        if bool(cfg.declare("profiling.enable_profiling", self.stage_log is not None)) \
                and self.stage_log is None:
            self.stage_log = StageLog(prof_path)

        def on_change(key: str, value) -> None:
            truthy = CameraNode._coerce_option(True, value)
            if key == "debug.save_data":
                self.save_data_dir = (str(self.node_config.get("debug.save_data_dir", default_dir))
                                      if truthy else None)
            elif key == "debug.save_data_dir":
                if self.save_data_dir is not None:
                    self.save_data_dir = str(value)
            elif key == "profiling.enable_profiling":
                if truthy and self.stage_log is None:
                    self.stage_log = StageLog(
                        str(self.node_config.get("profiling.log_path", prof_path)))
                elif not truthy and self.stage_log is not None:
                    self.stage_log.flush()
                    self.stage_log = None
            elif key == "profiling.publish_fps":
                self.fps_counter.publish = truthy

        cfg.on_change(on_change)

    # -- topic-equivalents -------------------------------------------------

    def subscribe_fused(self, cb: Callable[[np.ndarray, float], None]) -> None:
        """Subscribe to the fused image (rgb8 ndarray + the left stamp)."""
        self._fused_subs.append(cb)

    def on_transform(self, transform: np.ndarray) -> None:
        """/registration/transform update (transformCallback)."""
        with self._transform_lock:
            self.pipeline.set_right_transform(np.asarray(transform, np.float32))

    def subscribe_sync_debug(self, cb: Callable[[str], None]) -> None:
        """Sync cadence, stamp skew and drops as strings
        (fusion_node.cpp:674-698)."""
        self._sync_debug_subs.append(cb)

    def _publish_sync_debug(self, pair: DevicePair) -> None:
        if not self._sync_debug_subs:
            return
        now = time.perf_counter()
        sync_ms = (now - self._last_sync_time) * 1e3 if self._last_sync_time else 0.0
        self._last_sync_time = now
        diff_ms = (pair.host_left.timestamp - pair.host_right.timestamp) * 1e3
        fps = 1000.0 / sync_ms if sync_ms > 0 else 0.0
        msg = (f"sync callback: {sync_ms:.2f} ms, {fps:.2f} fps, diff: {diff_ms:.2f}, "
               f"dropped: {self.feeder.pairer.dropped}")
        for cb in self._sync_debug_subs:
            cb(msg)

    def _save_data(self, pair: DevicePair, image: np.ndarray) -> None:
        """save_data dumps: both inputs and the fused output as PNGs
        (depth_frame.cpp:201-228)."""
        from pointcloud_depthfusion_tpu_torch.io.artifacts import save_png  # noqa: PLC0415

        i = self.frames_processed
        d = self.save_data_dir
        save_png(os.path.join(d, f"{i:06d}_left_depth.png"), pair.host_left.depth)
        save_png(os.path.join(d, f"{i:06d}_left_color.png"), pair.host_left.color)
        save_png(os.path.join(d, f"{i:06d}_right_depth.png"), pair.host_right.depth)
        save_png(os.path.join(d, f"{i:06d}_right_color.png"), pair.host_right.color)
        save_png(os.path.join(d, f"{i:06d}_fused.png"), image)

    # -- steady state ------------------------------------------------------

    def process_pair(self, pair: DevicePair) -> FusionResult:
        t_loop = time.perf_counter()
        self._publish_sync_debug(pair)
        profiling = self.stage_log is not None
        laps = {}
        if profiling:
            laps["callback"] = (time.perf_counter() - t_loop) * 1e3
            with self._transform_lock:
                result, stage_laps, image = self.pipeline.process_profiled(pair.left, pair.right)
            laps.update(stage_laps)
        else:
            with self._transform_lock:
                result = self.pipeline.process(pair.left, pair.right)
            image = (self._readback.copy(result.image) if self.async_readback
                     else result.image.cpu().numpy())
        stamp = float(pair.host_left.timestamp)
        t_pub = time.perf_counter()
        for cb in self._fused_subs:
            cb(image, stamp)
        if profiling:
            laps["publish"] = (time.perf_counter() - t_pub) * 1e3
            laps["diff"] = abs(pair.host_left.timestamp - pair.host_right.timestamp) * 1e3
            laps["copy_to_gpu"] = pair.upload_ms
            # Frame age at publication; meaningful only for wall-clock stamps.
            age_s = time.time() - stamp
            if 0.0 <= age_s < 3600.0:
                laps["latency"] = age_s * 1e3
        if self.save_data_dir:
            self._save_data(pair, image)
        self.fps_counter.tick()
        if self.stage_log:
            laps["loop"] = (time.perf_counter() - t_loop) * 1e3
            self.stage_log.add(laps)
        self.frames_processed += 1
        return result

    def flush_pending(self) -> None:
        """The JAX node's end-of-stream drain of its one-frame-late image.
        Here every frame is published before :meth:`process_pair` returns,
        so nothing is in flight and there is nothing to drain."""

    def run(self, max_frames: Optional[int] = None) -> int:
        """Consume the feeder until end of stream (or ``max_frames``)."""
        with self.feeder as feeder:
            for pair in feeder:
                self.process_pair(pair)
                if max_frames is not None and self.frames_processed >= max_frames:
                    break
        if self.stage_log:
            self.stage_log.flush()
        return self.frames_processed
