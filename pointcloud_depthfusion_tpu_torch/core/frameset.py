"""Frameset: one synchronized depth+color frame pair with calibration.

Port of pointcloud_depthfusion_tpu/core/frameset.py. A Frameset holds
tensors on one device. Depth is stored as int32 (values 0..65535): torch's
uint16 supports few operations, and every consumer compares or converts
depth, so it is widened once at upload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Frameset:
    """A depth + color (uint8 RGB) frame pair with calibration.

    ``timestamp`` is f32 seconds since ``timestamp_epoch`` (see
    :func:`split_stamp`). ``color_packed`` optionally carries the color as
    an (H, W) int32 ``(r<<16)|(g<<8)|b`` plane, the exact rgb24 operand of
    the render.
    """

    depth: torch.Tensor  # (H, W) int32
    color: torch.Tensor  # (H, W, 3) uint8
    depth_intrinsics: Intrinsics
    color_intrinsics: Intrinsics
    depth_to_color: Extrinsics
    depth_scale: torch.Tensor  # 0-d f32, meters per LSB
    timestamp: torch.Tensor  # 0-d f32
    timestamp_epoch: torch.Tensor  # 0-d f32
    color_packed: Optional[torch.Tensor] = None

    @staticmethod
    def create(
        depth,
        color,
        color_intrinsics: Intrinsics,
        depth_intrinsics: Optional[Intrinsics] = None,
        depth_to_color: Optional[Extrinsics] = None,
        depth_scale: float = 0.001,
        timestamp: float = 0.0,
        pack_color: bool = False,
        device=None,
    ) -> "Frameset":
        """Build a Frameset on ``device`` (``None``: the card) from numpy
        arrays or tensors.

        ``pack_color=True`` packs numpy color on the host and tensor color
        on its device."""
        device = resolve_device(device)
        packed = None
        if pack_color and not isinstance(color, torch.Tensor):
            packed = torch.from_numpy(pack_rgb24_host(np.asarray(color))).to(device)
        if isinstance(depth, torch.Tensor):
            depth = depth.to(device=device, dtype=torch.int32)
        else:
            depth = torch.from_numpy(
                np.asarray(depth).astype(np.uint16).astype(np.int32)
            ).to(device)
        if isinstance(color, torch.Tensor):
            color = color.to(device=device, dtype=torch.uint8)
        else:
            color = torch.from_numpy(np.asarray(color).astype(np.uint8)).to(device)
        epoch, offset = split_stamp(float(timestamp))
        if depth_intrinsics is None:
            depth_intrinsics = color_intrinsics
        if depth_to_color is None:
            depth_to_color = Extrinsics.identity(device)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        fs = Frameset(
            depth=depth,
            color=color,
            depth_intrinsics=depth_intrinsics.to(device),
            color_intrinsics=color_intrinsics.to(device),
            depth_to_color=depth_to_color.to(device),
            depth_scale=f32(depth_scale),
            timestamp=f32(offset),
            timestamp_epoch=f32(epoch),
            color_packed=packed,
        )
        if pack_color and packed is None:
            fs = fs.with_packed_color()
        return fs

    def with_packed_color(self) -> "Frameset":
        """Return a copy carrying ``color_packed``, packed on the device."""
        if self.color_packed is not None:
            return self
        c = self.color.to(torch.int32)
        packed = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        return dataclasses.replace(self, color_packed=packed)

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    def depth_metric(self) -> torch.Tensor:
        """Depth in meters, float32."""
        return self.depth.to(torch.float32) * self.depth_scale

    def to_host(self) -> "HostFrameset":
        """The frameset on the host: u16 depth, u8 color, the absolute f64
        stamp and the depth scale."""
        return HostFrameset(
            depth=self.depth.cpu().numpy().astype(np.uint16),
            color=self.color.cpu().numpy(),
            timestamp=absolute_stamp(float(self.timestamp), float(self.timestamp_epoch)),
            depth_scale=float(self.depth_scale),
        )


@dataclasses.dataclass
class HostFrameset:
    """Host-side (numpy) frameset; ``timestamp`` is float64 absolute time."""

    depth: np.ndarray  # (H, W) uint16
    color: np.ndarray  # (H, W, 3) uint8
    timestamp: float
    depth_scale: float = 0.001


def pack_rgb24_host(color_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 → (H, W) int32 ``(r<<16)|(g<<8)|b`` on the host.
    Wider input wraps to uint8 first, as Frameset's stored color does."""
    c = np.asarray(color_u8).astype(np.uint8).astype(np.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


# Device stamps are f32; raw epoch seconds would quantize to >60 ms. Each
# Frameset carries an epoch floored to a 4096 s grid (exact in f32) plus an
# f32 offset below 4096 s (quantum <= 0.25 ms).
STAMP_EPOCH_GRID_S = 4096.0


def split_stamp(timestamp: float) -> Tuple[float, float]:
    """Absolute seconds → (exact-f32 epoch, sub-ms-precise f32 offset)."""
    epoch = float(np.floor(timestamp / STAMP_EPOCH_GRID_S) * STAMP_EPOCH_GRID_S)
    return epoch, timestamp - epoch


def absolute_stamp(offset: float, epoch: float) -> float:
    """Inverse of :func:`split_stamp` (float64 on host)."""
    return float(epoch) + float(offset)
