"""Recorded frameset datasets: capture to disk and playback.

A copy of pointcloud_depthfusion_tpu/io/recorded.py, with the same ``.npz``
keys and dtypes, so a recording written by either package replays through
the other: depth uint16 (N, H, W), color uint8 (N, H, W, 3), timestamps and
per-frame depth scales float64 (N,), intrinsics as six float64 (width,
height, fx, fy, ppx, ppy), the distortion coefficients and model.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource


def record_dataset(path: str, frames: List[HostFrameset], intr: Intrinsics) -> None:
    if not frames:
        raise ValueError(f"no frames captured: refusing to write an empty recording to {path!r}")
    # np.savez appends '.npz' to a name that lacks it; through an open file
    # the recording lands at exactly ``path``, where RecordedSource looks.
    with open(path, "wb") as fh:
        np.savez_compressed(
            fh,
            depth=np.stack([f.depth for f in frames]),
            color=np.stack([f.color for f in frames]),
            timestamps=np.asarray([f.timestamp for f in frames], np.float64),
            # One scale per frame: the feeders honour each frame's own.
            depth_scale=np.asarray([f.depth_scale for f in frames], np.float64),
            intrinsics=np.asarray(
                [intr.width, intr.height, float(intr.fx), float(intr.fy),
                 float(intr.ppx), float(intr.ppy)],
                np.float64,
            ),
            coeffs=intr.coeffs.cpu().numpy().astype(np.float64),
            model=np.asarray([int(intr.model)], np.int64),
        )


class RecordedSource(FramesetSource):
    """Plays back a recorded ``.npz`` dataset, optionally looping; its
    intrinsics live on the CPU, as every camera node's do."""

    def __init__(self, path: str, loop: bool = False):
        # Everything is read here, so the file is closed on return.
        with np.load(path) as data:
            self.depth = data["depth"]
            self.color = data["color"]
            self.timestamps = data["timestamps"]
            # Older recordings stored one scalar scale: broadcast it.
            scales = np.asarray(data["depth_scale"], np.float64).reshape(-1)
            if scales.shape[0] == len(self.timestamps):
                self.depth_scales = scales
            else:
                self.depth_scales = np.full(len(self.timestamps), float(scales[0]), np.float64)
            w, h, fx, fy, ppx, ppy = data["intrinsics"]
            self._intr = Intrinsics.create(
                int(w), int(h), fx=fx, fy=fy, ppx=ppx, ppy=ppy,
                model=int(data["model"][0]), coeffs=tuple(data["coeffs"]), device="cpu",
            )
        self.depth_scale = float(self.depth_scales[0])
        self.loop = loop
        self.idx = 0
        self._loop_offset = 0.0
        if len(self.timestamps) > 1:
            self._period = float(np.median(np.diff(self.timestamps)))
        else:
            self._period = 1.0 / 30.0

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    @property
    def fps(self) -> float:
        """Median capture rate of the recording (Hz)."""
        return 1.0 / self._period if self._period > 0 else 30.0

    def __len__(self) -> int:
        return len(self.timestamps)

    def next_frame(self) -> Optional[HostFrameset]:
        if self.idx >= len(self.timestamps):
            if not self.loop:
                return None
            self._loop_offset += self.timestamps[-1] - self.timestamps[0] + self._period
            self.idx = 0
        i = self.idx
        self.idx += 1
        return HostFrameset(
            depth=self.depth[i],
            color=self.color[i],
            timestamp=float(self.timestamps[i]) + self._loop_offset,
            depth_scale=float(self.depth_scales[i]),
        )
