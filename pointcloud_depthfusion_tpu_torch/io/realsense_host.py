"""Live RealSense capture → TCP frameset stream (the camera-host bridge).

A copy of pointcloud_depthfusion_tpu/io/realsense_host.py. A GPU fusion
host need not carry the camera's USB stack, so live capture runs on the
machine the sensor is plugged into (the reference's Jetson role,
realsense.cpp:57-444) and streams framesets to the fusion host through
``io.network``. This module drives a RealSense through pyrealsense2
(discovery by serial, the reference's stream presets, align-to-color, the
temporal filter, the hardware→system clock rebase) and serves the result
with :class:`~pointcloud_depthfusion_tpu_torch.io.network.FramesetStreamServer`.

Run on the camera host (it needs ``pyrealsense2``, which this package
does not depend on: the import happens when a source is built)::

    python -m pointcloud_depthfusion_tpu_torch.io.realsense_host \\
        --name camera_left --port 7447 [--serial <S>] [--model D455]

On the fusion host, read it with ``camera_node --source
tcp://camerahost:7447``, a manifest camera's ``source: tcp://…`` or a
``NetworkSource``. Everything here is host work: the calibration tensors
lie on the CPU, and the bridge never initialises CUDA.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import (
    Distortion,
    Extrinsics,
    Intrinsics,
    model_preset,
)
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource

# rs2 distortion enum → Distortion (rs.distortion values are stable).
_RS_DISTORTION = {
    0: Distortion.NONE,
    1: Distortion.MODIFIED_BROWN_CONRADY,
    2: Distortion.INVERSE_BROWN_CONRADY,
    3: Distortion.FTHETA,
    4: Distortion.BROWN_CONRADY,
    5: Distortion.KANNALA_BRANDT4,
}


def _require_rs2():
    try:
        import pyrealsense2 as rs  # noqa: PLC0415
    except ImportError as exc:
        raise RuntimeError(
            "pyrealsense2 is not installed: this bridge runs on the camera host (with the "
            "RealSense SDK), not on the fusion host; install librealsense2 and pyrealsense2 "
            "there"
        ) from exc
    return rs


class RealsenseSource(FramesetSource):
    """FramesetSource over a live RealSense device (pyrealsense2).

    The reference's capture behaviour (realsense.cpp):
      * discovery by serial, else the first device (:57-110);
      * the model's stream preset: D455/D435/D415 1280×720 Z16 and RGB8 at
        30, L515 1024×768 depth (:226-236), via core.camera.model_preset;
      * align-to-color every frame (:239, :373-376);
      * only the temporal filter in the hot loop (:398-404);
      * the hardware clock rebased to the system clock at start
        (:318-334, :424-431);
      * four warm-up grabs (camera_node.cpp:166-169).
    """

    def __init__(
        self,
        serial: str = "",
        model: str = "D455",
        fps: Optional[float] = None,
        width: int = 0,
        height: int = 0,
        warmup_frames: int = 4,
        timeout_ms: int = 5000,
    ):
        rs = _require_rs2()
        preset = model_preset(model)
        cw, ch = preset["color_size"]
        dw, dh = preset["depth_size"]
        if width:
            cw = dw = width
        if height:
            ch = dh = height
        self.fps = float(fps or preset["fps"])
        self.timeout_ms = timeout_ms

        ctx = rs.context()
        devices = ctx.query_devices()
        if len(devices) == 0:
            raise RuntimeError("no RealSense device connected")
        if serial and serial not in {d.get_info(rs.camera_info.serial_number) for d in devices}:
            raise RuntimeError(f"RealSense serial {serial} not found")

        self._cfg = rs.config()
        if serial:
            self._cfg.enable_device(serial)
        self._cfg.enable_stream(rs.stream.depth, dw, dh, rs.format.z16, int(self.fps))
        self._cfg.enable_stream(rs.stream.color, cw, ch, rs.format.rgb8, int(self.fps))
        self._pipe = rs.pipeline(ctx)
        profile = self._pipe.start(self._cfg)

        self._align = rs.align(rs.stream.color)
        self._temporal = rs.temporal_filter()
        self.depth_scale = float(profile.get_device().first_depth_sensor().get_depth_scale())

        # Aligned depth shares the color stream's profile (:670-680).
        ci = profile.get_stream(rs.stream.color).as_video_stream_profile().get_intrinsics()
        self._intr = Intrinsics.create(
            ci.width, ci.height, fx=ci.fx, fy=ci.fy, ppx=ci.ppx, ppy=ci.ppy,
            model=_RS_DISTORTION.get(int(ci.model), Distortion.NONE),
            coeffs=list(ci.coeffs), device="cpu",
        )
        # Aligned output: depth is already in the color frame, so the
        # extrinsics are the identity, as on the reference's aligned path.
        self.depth_to_color = Extrinsics.identity("cpu")

        # Hardware clock → system clock (:318-334).
        frames = self._pipe.wait_for_frames(self.timeout_ms)
        self._clock_offset = time.time() - frames.get_timestamp() / 1e3
        for _ in range(max(0, warmup_frames - 1)):
            self._pipe.wait_for_frames(self.timeout_ms)

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def next_frame(self) -> Optional[HostFrameset]:
        # Partial framesets (a stream missing after align, common for a
        # moment under USB pressure) are skipped a bounded number of times,
        # never answered with None: None makes the server send its clean
        # end, and the fusion host would stop while the sensor is healthy.
        for _ in range(64):
            try:
                frames = self._pipe.wait_for_frames(self.timeout_ms)
            except RuntimeError as exc:
                # A live sensor has no natural end of stream: every failed
                # wait (timeout, USB stall, disconnect) is an error.
                raise TimeoutError(
                    f"RealSense capture failed after {self.timeout_ms} ms ({exc}) — sensor "
                    "stalled or disconnected") from exc
            frames = self._align.process(frames)
            depth = frames.get_depth_frame()
            color = frames.get_color_frame()
            if depth and color:
                break
        else:
            raise TimeoutError("RealSense delivered 64 consecutive partial framesets (missing "
                               "depth or color after align) — sensor failing")
        depth = self._temporal.process(depth)
        stamp = frames.get_timestamp() / 1e3 + self._clock_offset
        return HostFrameset(
            depth=np.asanyarray(depth.get_data()).copy(),
            color=np.asanyarray(color.get_data()).copy(),
            timestamp=stamp,
            depth_scale=self.depth_scale,
        )

    def stop(self) -> None:
        self._pipe.stop()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Serve a live RealSense over TCP; ``argv``: the arguments (``None``:
    the command line)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--name", default="camera_left")
    parser.add_argument("--serial", default="")
    parser.add_argument("--model", default="D455")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7447)
    parser.add_argument("--fps", type=float, default=0.0)
    parser.add_argument("--width", type=int, default=0,
                        help="override the model preset's stream width")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--warmup-frames", type=int, default=4)
    parser.add_argument("--timeout-ms", type=int, default=5000)
    parser.add_argument(
        "--codec", default="png", choices=["png", "raw"],
        help="frame codec: 'png' (compressed, thin links) or 'raw' (no encode cost on this "
        "camera host, wired LAN; a 720p@30 stream's PNG encode can exceed the 33 ms budget on "
        "Jetson-class hosts and halve the delivered rate through the drop-oldest QoS)",
    )
    args = parser.parse_args(argv)

    from pointcloud_depthfusion_tpu_torch.io.network import FramesetStreamServer

    source = RealsenseSource(
        serial=args.serial, model=args.model, fps=args.fps or None,
        width=args.width, height=args.height,
        warmup_frames=args.warmup_frames, timeout_ms=args.timeout_ms,
    )
    server = FramesetStreamServer(
        source, host=args.host, port=args.port, name=args.name,
        fps=source.fps, depth_to_color=source.depth_to_color, codec=args.codec,
    )
    server.start()
    print(f"{args.name}: RealSense → tcp://{server.host}:{server.port} ({args.codec})",
          flush=True)
    try:
        while True:
            time.sleep(5)
            print(f"sent {server.frames_sent} dropped {server.frames_dropped}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        # Any exit releases the sensor pipeline and closes the client.
        server.stop()
        source.stop()


if __name__ == "__main__":
    main()
