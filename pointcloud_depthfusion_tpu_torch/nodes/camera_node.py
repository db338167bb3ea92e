"""Camera node: frameset acquisition and calibration service.

Port of pointcloud_depthfusion_tpu/nodes/camera_node.py (the reference
camera_node, camera_node/src/camera_node.cpp): wraps a FramesetSource,
serves camera parameters (the GetCameraParameters service,
camera_node.cpp:377-386), runs the rs2 post-processing bank on the host,
publishes framesets and depth images to subscribers, and reports FPS. It
runs pull-based inside a DeviceFeeder or push-based via :meth:`spin` on a
thread. Host-side only: numpy frames, CPU intrinsics.

:func:`main` is the standalone camera: it streams a synthetic camera (the
native renderer when the host runtime builds) or replays a recording, and
fronts a remote camera host (``--source tcp://host:port``), and writes what
it captured as a ``.npz`` recording or a ``.pdfe`` stream::

    python -m pointcloud_depthfusion_tpu_torch.nodes.camera_node \
        --frames 10 --out /tmp/rec.npz
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import CameraInfo, Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource
from pointcloud_depthfusion_tpu_torch.ops import host_filters as HF
from pointcloud_depthfusion_tpu_torch.utils.profiling import FpsCounter


@dataclasses.dataclass
class CameraParameters:
    """GetCameraParameters response (GetCameraParameters.srv:1-10)."""

    depth_info: CameraInfo
    color_info: CameraInfo
    extrinsic_rotation: np.ndarray  # (9,) column-major
    extrinsic_translation: np.ndarray  # (3,)


class CameraNode(FramesetSource):
    """One camera's acquisition pipeline.

    Also a :class:`FramesetSource` (``next_frame`` → :meth:`capture`), so a
    DeviceFeeder pulls through the node and gets its post-processing: the
    reference always runs the temporal filter inside getFrames
    (realsense.cpp:398-404).
    """

    # The reflected depth-sensor options: each becomes a
    # ``sensor.depth.<name>`` parameter (the reference's declareRosParameters
    # sweep over the RealSense option list, realsense.cpp:608-664).
    DEPTH_OPTIONS = (
        "temporal_filter", "temporal_alpha", "temporal_delta",
        "decimation_filter", "decimation_magnitude",
        "spatial_filter", "spatial_alpha", "spatial_delta",
        "spatial_magnitude",
        "disparity_domain", "stereo_baseline_m",
        "threshold_filter", "threshold_min_m", "threshold_max_m",
        "hole_filling", "hole_fill_mode",
    )
    # Color-stream options, reflected as ``sensor.color.*`` (the small
    # preview's geometry, camera_node config.hpp:101-102: 608×608).
    COLOR_OPTIONS = ("small_image_width", "small_image_height")
    # Enumerated string options, validated when set (parametersCallback
    # semantics), not frames later inside capture().
    _ENUM_OPTIONS = {"hole_fill_mode": ("farthest", "nearest", "left")}

    def __init__(
        self,
        name: str,
        source: FramesetSource,
        depth_to_color: Optional[Extrinsics] = None,
        fps: float = 30.0,
        temporal_filter: bool = True,
        temporal_alpha: float = 0.4,
        temporal_delta: float = 20.0,
        decimation_filter: bool = False,
        decimation_magnitude: int = 2,
        spatial_filter: bool = False,
        spatial_alpha: float = 0.55,
        spatial_delta: float = 20.0,
        spatial_magnitude: int = 2,
        disparity_domain: bool = False,
        stereo_baseline_m: float = 0.095,
        threshold_filter: bool = False,
        threshold_min_m: float = 0.0,
        threshold_max_m: float = 2.0,
        hole_filling: bool = False,
        hole_fill_mode: str = "farthest",
        small_image_width: int = 608,
        small_image_height: int = 608,
    ):
        """Defaults mirror the reference's active set (only the temporal
        filter runs in getFrames, realsense.cpp:398-404); the others take
        its construction-time parameters (realsense.cpp:239-250). Enabled
        filters run in librealsense's recommended order: decimation →
        threshold → depth-to-disparity → spatial → temporal →
        disparity-to-depth → hole filling."""
        self.name = name
        self.source = source
        self.fps = fps
        self.depth_to_color = depth_to_color or Extrinsics.identity("cpu")
        self.temporal_filter = temporal_filter
        self.temporal_alpha = temporal_alpha
        self.temporal_delta = temporal_delta
        self.decimation_filter = decimation_filter
        self.decimation_magnitude = decimation_magnitude
        self.spatial_filter = spatial_filter
        self.spatial_alpha = spatial_alpha
        self.spatial_delta = spatial_delta
        self.spatial_magnitude = spatial_magnitude
        self.disparity_domain = disparity_domain
        self.stereo_baseline_m = stereo_baseline_m
        self.threshold_filter = threshold_filter
        self.threshold_min_m = threshold_min_m
        self.threshold_max_m = threshold_max_m
        self.hole_filling = hole_filling
        self.hole_fill_mode = hole_fill_mode
        self.small_image_width = small_image_width
        self.small_image_height = small_image_height
        # Runtime debug/profiling namespace (the reference dispatches
        # debug.enable_debug / profiling.publish_fps while streaming,
        # config.cpp:118-137).
        self.verbose = False
        self.debug_save_data = False
        self.debug_save_dir = f"{name}_debug"
        self._debug_frame_idx = 0
        self._fx_cache: Optional[float] = None
        self._prev_depth: Optional[np.ndarray] = None
        #: Temporal steps run, by path: the native one-pass step or numpy.
        self.temporal_steps = {"native": 0, "numpy": 0}
        if temporal_filter:
            # Build or load the native runtime now, in set-up, not on the
            # first frame.
            HF.temporal_runs_native(np.uint16)
        self._frameset_subs: List[Callable[[HostFrameset], None]] = []
        self._depth_subs: List[Callable[[np.ndarray, float], None]] = []
        self._small_subs: List[Callable[[np.ndarray, float], None]] = []
        self.fps_counter = FpsCounter(name=f"{name}/fps")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- dynamic reconfiguration ------------------------------------------

    def sensor_options(self) -> dict:
        """The reflected option tree {group: {name: current value}}; a
        source's own ``sensor_options()`` are merged in."""
        groups: dict = {
            "depth": {name: getattr(self, name) for name in self.DEPTH_OPTIONS},
            "color": {name: getattr(self, name) for name in self.COLOR_OPTIONS},
        }
        src_opts = getattr(self.source, "sensor_options", None)
        if callable(src_opts):
            for group, opts in src_opts().items():
                groups.setdefault(group, {}).update(opts)
        return groups

    @staticmethod
    def _coerce_option(current, value):
        """The new value in the current value's type (the reference's rs2
        option-type switch, config.cpp:53-169). Booleans accept
        true/false/1/0 spellings; integers go through float first."""
        if isinstance(current, bool):
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if isinstance(current, int):
            return int(float(value))
        if isinstance(current, float):
            return float(value)
        return type(current)(value)

    def _set_option(self, group: str, name: str, value) -> bool:
        """Dispatch one runtime option update (parametersCallback,
        config.cpp:53-169); False when no one owns the option."""
        own = (group == "depth" and name in self.DEPTH_OPTIONS) or (
            group == "color" and name in self.COLOR_OPTIONS
        )
        if own:
            coerced = self._coerce_option(getattr(self, name), value)
            allowed = self._ENUM_OPTIONS.get(name)
            if allowed is not None and coerced not in allowed:
                raise ValueError(f"sensor.{group}.{name} must be one of {allowed}, not {value!r}")
            setattr(self, name, coerced)
            return True
        src_opts = getattr(self.source, "sensor_options", None)
        if callable(src_opts) and name in src_opts().get(group, {}):
            current = getattr(self.source, name)
            setattr(self.source, name, self._coerce_option(current, value))
            return True
        return False

    def attach_config(self, cfg) -> None:
        """Wire a ConfigTree: declare every reflected option as
        ``sensor.<group>.<name>``, apply values already in the tree, and
        dispatch runtime updates (``cfg.set(...)``) back into the node and
        its source. ``fps`` retunes the loop rate."""
        self.config = cfg
        self.fps = float(cfg.declare("fps", self.fps))
        self.verbose = bool(cfg.declare("verbose", self.verbose))
        self.debug_save_data = bool(cfg.declare("debug.enable_debug", self.debug_save_data))
        self.debug_save_dir = str(cfg.declare("debug.save_data_dir", self.debug_save_dir))
        self.fps_counter.publish = bool(
            cfg.declare("profiling.publish_fps", self.fps_counter.publish)
        )
        for group, opts in self.sensor_options().items():
            for name, default in opts.items():
                value = cfg.declare(f"sensor.{group}.{name}", default)
                if value is not default:
                    self._set_option(group, name, value)

        def on_change(key: str, value) -> None:
            if key == "fps":
                self.fps = float(value)
                return
            if key == "verbose":
                self.verbose = self._coerce_option(True, value)
                return
            parts = key.split(".")
            if len(parts) == 3 and parts[0] == "sensor":
                self._set_option(parts[1], parts[2], value)
            elif parts[0] == "debug":
                if parts[-1] == "enable_debug":
                    self.debug_save_data = self._coerce_option(True, value)
                elif parts[-1] == "save_data_dir":
                    self.debug_save_dir = str(value)
            elif parts[0] == "profiling" and parts[-1] == "publish_fps":
                self.fps_counter.publish = self._coerce_option(True, value)

        cfg.on_change(on_change)

    # -- service -----------------------------------------------------------

    def get_camera_parameters(self) -> CameraParameters:
        """Calibration: the color profile, and the depth profile, which a
        decimation filter shrinks like librealsense's decimated stream."""
        from pointcloud_depthfusion_tpu_torch.ops.filters import decimate_intrinsics  # noqa: PLC0415

        intr = self.source.intrinsics
        info = CameraInfo.from_intrinsics(intr)
        depth_info = info  # aligned: depth shares the color profile
        if self.decimation_filter:
            depth_info = CameraInfo.from_intrinsics(
                decimate_intrinsics(intr, self.decimation_magnitude)
            )
        rot = self.depth_to_color.rotation.cpu().numpy()
        return CameraParameters(
            depth_info=depth_info,
            color_info=info,
            extrinsic_rotation=rot.flatten(order="F"),
            extrinsic_translation=self.depth_to_color.translation.cpu().numpy(),
        )

    # -- topics ------------------------------------------------------------

    def subscribe_frameset(self, cb: Callable[[HostFrameset], None]) -> None:
        self._frameset_subs.append(cb)

    def subscribe_depth(self, cb: Callable[[np.ndarray, float], None]) -> None:
        self._depth_subs.append(cb)

    def subscribe_color_small(self, cb: Callable[[np.ndarray, float], None]) -> None:
        """The color/image_small preview topic: a bilinear resize of the
        color frame to small_image_{width,height} (camera_node.cpp:349-352),
        computed only while subscribed."""
        self._small_subs.append(cb)

    # -- acquisition --------------------------------------------------------

    @property
    def intrinsics(self) -> Intrinsics:
        """The color stream's profile, which the feeder uploads framesets
        with (a decimated depth stream cannot feed the fusion path)."""
        return self.source.intrinsics

    def next_frame(self) -> Optional[HostFrameset]:
        """FramesetSource face: one filtered frame."""
        return self.capture()

    def capture(self) -> Optional[HostFrameset]:
        """Grab one frame, run the post-processing bank, publish."""
        fs = self.source.next_frame()
        if fs is None:
            return None
        fs = self._apply_filter_bank(fs)
        if self.debug_save_data:
            self._dump_debug(fs)
        if self.verbose:
            print(f"{self.name}: frame {self._debug_frame_idx} stamp {fs.timestamp:.4f}")
        self._debug_frame_idx += 1
        for cb in self._frameset_subs:
            cb(fs)
        for cb in self._depth_subs:
            cb(fs.depth, fs.timestamp)
        if self._small_subs:
            from PIL import Image  # noqa: PLC0415

            small = np.asarray(Image.fromarray(fs.color).resize(
                (self.small_image_width, self.small_image_height), Image.BILINEAR))
            for cb in self._small_subs:
                cb(small, fs.timestamp)
        self.fps_counter.tick()
        return fs

    def _dump_debug(self, fs: HostFrameset) -> None:
        """debug.enable_debug: each captured frameset as PNGs (the
        reference's debug dumps, depth_frame.cpp:157-181)."""
        from pointcloud_depthfusion_tpu_torch.io.artifacts import save_png  # noqa: PLC0415

        os.makedirs(self.debug_save_dir, exist_ok=True)
        i = self._debug_frame_idx
        save_png(os.path.join(self.debug_save_dir, f"{i:06d}_depth.png"), fs.depth)
        save_png(os.path.join(self.debug_save_dir, f"{i:06d}_color.png"), fs.color)

    def _apply_filter_bank(self, fs: HostFrameset) -> HostFrameset:
        """decimation → threshold → [→disparity] → spatial → temporal
        [→depth] → hole fill, the order the reference documents
        (realsense.cpp:377-389). On the capture thread, in the native
        host runtime where it loads and numpy otherwise
        (``ops.host_filters``): a device round trip per frame costs more
        than these filters."""
        depth = fs.depth
        # fx only feeds the decimation/disparity branches (both off by
        # default): read it once, lazily.
        fx = self._fx_host() if (self.decimation_filter or self.disparity_domain) else 0.0
        if self.decimation_filter:
            depth = HF.decimation_filter_np(depth, self.decimation_magnitude)
            fx /= self.decimation_magnitude
        if self.threshold_filter:
            depth = HF.threshold_filter_np(depth, fs.depth_scale, self.threshold_min_m,
                                           self.threshold_max_m)
        data = (HF.depth_to_disparity_np(depth, fs.depth_scale, fx, self.stereo_baseline_m)
                if self.disparity_domain else depth)
        if self.spatial_filter:
            data = HF.spatial_filter_np(data, self.spatial_alpha, self.spatial_delta,
                                        self.spatial_magnitude)
        if self.temporal_filter:
            data = self._apply_temporal(data)
        depth = (HF.disparity_to_depth_np(data, fs.depth_scale, fx, self.stereo_baseline_m)
                 if self.disparity_domain else data)
        if self.hole_filling:
            depth = HF.hole_fill_np(depth, self.hole_fill_mode)
        if depth is fs.depth:
            return fs
        return HostFrameset(depth=depth, color=fs.color, timestamp=fs.timestamp,
                            depth_scale=fs.depth_scale)

    def _fx_host(self) -> float:
        """The source's fx as a host float, read once."""
        if self._fx_cache is None:
            self._fx_cache = float(self.source.intrinsics.fx)
        return self._fx_cache

    def _apply_temporal(self, data: np.ndarray) -> np.ndarray:
        """Temporal EMA step in the current domain (u16 depth or f32
        disparity), as ops.filters.temporal_filter computes it; integer
        depth rounds half to even (np.rint). The history resets when the
        stream's shape or domain changes."""
        prev = self._prev_depth
        if prev is None or prev.shape != data.shape or prev.dtype != data.dtype:
            self._prev_depth = data
            return data
        path = "native" if HF.temporal_runs_native(data.dtype) else "numpy"
        out = HF.temporal_filter_np(data, prev, self.temporal_alpha, self.temporal_delta)
        self.temporal_steps[path] += 1
        self._prev_depth = out
        return out

    # -- push-mode loop ------------------------------------------------------

    def spin(self, realtime: bool = True, max_frames: Optional[int] = None) -> None:
        count = 0
        while not self._stop.is_set():
            # Re-read each iteration: attach_config's ``fps`` retunes a
            # running node.
            period = 1.0 / self.fps if self.fps > 0 else 0.0
            t0 = time.perf_counter()
            if self.capture() is None:
                return
            count += 1
            if max_frames is not None and count >= max_frames:
                return
            if realtime:
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)

    def start(self, **spin_kw) -> "CameraNode":
        self._thread = threading.Thread(target=self.spin, kwargs=spin_kw, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Standalone camera node: stream a synthetic camera and record it.

    The CLI face of the reference camera_node main (--name selects the
    camera, camera_node/src/main.cpp:60-100): the source is synthetic, a
    remote camera host or a recording, and the output a dataset file (.npz
    via io.recorded or .pdfe via io.encoded) instead of DDS topics.
    ``argv``: the arguments (``None``: the command line).
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--name", default="camera_left",
                        choices=["camera_left", "camera_right"])
    parser.add_argument("--model", default="D455")
    parser.add_argument("--width", type=int, default=0, help="override preset width")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--out", default="", help="output dataset (.npz or .pdfe); empty = none")
    parser.add_argument("--fps", type=float, default=0.0)
    parser.add_argument("--source", default="",
                        help="tcp://host:port (a camera host's io.network server) or a "
                        "recorded .npz dataset (see --out) to replay, instead of the local "
                        "synthetic camera")
    args = parser.parse_args(argv)

    from pointcloud_depthfusion_tpu_torch.core.camera import model_preset
    from pointcloud_depthfusion_tpu_torch.io.encoded import write_encoded_stream
    from pointcloud_depthfusion_tpu_torch.io.feeder import NativeSyntheticSource, SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource, record_dataset
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
    from pointcloud_depthfusion_tpu_torch.runtime import is_available

    preset = model_preset(args.model)
    w, h = preset["color_size"]
    if args.width:
        w = args.width
    if args.height:
        h = args.height
    fps = args.fps or preset["fps"]
    if args.source.startswith("tcp://"):
        from pointcloud_depthfusion_tpu_torch.io.network import NetworkSource, parse_tcp_source

        source = NetworkSource(*parse_tcp_source(args.source))
        intr = source.intrinsics
        w, h = intr.width, intr.height
        fps = args.fps or source.fps or 30.0
    elif args.source:
        # Replay a recording (the rosbag-replay analogue), looped so
        # --frames beyond its length keeps streaming.
        source = RecordedSource(args.source, loop=True)
        intr = source.intrinsics
        w, h = intr.width, intr.height
        fps = args.fps or source.fps
    else:
        fx = 631.0 * w / 1280.0
        intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
        wl, wr = two_camera_rig()
        pose = wl if args.name == "camera_left" else wr
        src_cls = NativeSyntheticSource if is_available() else SyntheticSource
        source = src_cls(SyntheticScene(), intr, pose, fps=fps,
                         depth_noise_std=0.002, hole_fraction=0.01)
    # The temporal EMA runs once per stream, as in the reference's
    # getFrames: a recording made through a CameraNode and a network bridge
    # (io.realsense_host) already carry it.
    node = CameraNode(args.name, source, fps=fps, temporal_filter=not args.source)

    frames: List[HostFrameset] = []
    node.subscribe_frameset(frames.append)
    node.spin(realtime=False, max_frames=args.frames)
    print(f"{args.name}: captured {len(frames)} frames @ {w}x{h}")

    if args.out.endswith(".npz"):
        record_dataset(args.out, frames, intr)
        print(f"wrote {args.out}")
    elif args.out.endswith(".pdfe"):
        write_encoded_stream(args.out, frames)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
