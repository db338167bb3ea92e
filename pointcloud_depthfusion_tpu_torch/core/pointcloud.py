"""PointCloud: the user-facing colored-cloud container. Port of
pointcloud_depthfusion_tpu/core/pointcloud.py.

API-parity layer for the reference's Pointcloud class
(pointcloud_processing/src/pointcloud.cpp: deproject :100-111, append
:117-129, transform :63-93, project :136-157, copyToHost :163-169). Inside
the fused pipeline clouds stay as raw coordinate planes; this class
packages the same operations for interactive and library use, on the
device of its frameset's tensors.

Dense fixed-shape semantics: a PointCloud always carries its validity
mask; ``append`` concatenates. ``project`` runs the render's kernels: the
exact z-buffer on kernel B2 (``exact``/``tiled``), the packed mode on the
u32 scatter-min.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
from pointcloud_depthfusion_tpu_torch.io.artifacts import save_ply
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import render as R


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Colored point cloud with validity mask (flat, fixed shape)."""

    points: torch.Tensor  # (N, 3) float32
    colors: torch.Tensor  # (N, 3) uint8
    valid: torch.Tensor  # (N,) bool

    @staticmethod
    def deproject(
        frameset: Frameset,
        min_depth: float = 0.0,
        max_depth: float = math.inf,
        roi=None,
    ) -> "PointCloud":
        """Deproject a frameset into a cloud (Pointcloud::deproject).

        Applies the depth window like Frameset::filterDepth +
        Pointcloud::deproject chained, and deprojects with
        ``depth_intrinsics`` (the color intrinsics once depth is aligned,
        realsense.cpp:670-680). Colors pair with depth pixels by position,
        so a depth whose size differs from the color's raises (run
        ops.align.align_depth_to_color first).
        """
        depth = frameset.depth
        if tuple(depth.shape) != tuple(frameset.color.shape[:2]):
            raise ValueError(
                f"depth {tuple(depth.shape)} vs color {tuple(frameset.color.shape[:2])}: "
                "PointCloud.deproject pairs colors per pixel, so depth must "
                "be aligned to color (ops.align.align_depth_to_color) first"
            )
        if np.isfinite(max_depth) or min_depth > 0 or roi is not None:
            depth, valid = F.filter_depth(depth, frameset.depth_scale, min_depth, max_depth, roi)
        else:
            valid = None
        depth_m = depth.to(torch.float32) * frameset.depth_scale
        pts, valid = G.deproject(depth_m, frameset.depth_intrinsics, valid)
        return PointCloud(
            points=pts.reshape(-1, 3),
            colors=frameset.color.reshape(-1, 3),
            valid=valid.reshape(-1),
        )

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (the reference's mask_count), 0-d int32."""
        return self.valid.sum(dtype=torch.int32)

    def transform(self, transform) -> "PointCloud":
        """Rigid transform (Pointcloud::transform)."""
        t = torch.as_tensor(transform, dtype=torch.float32).to(self.points.device)
        return dataclasses.replace(self, points=G.transform_points(self.points, t))

    def append(self, other: "PointCloud") -> "PointCloud":
        """Concatenate clouds (Pointcloud::append)."""
        return PointCloud(
            points=torch.cat([self.points, other.points]),
            colors=torch.cat([self.colors, other.colors]),
            valid=torch.cat([self.valid, other.valid]),
        )

    def project(
        self,
        intrinsics: Intrinsics,
        mirror: bool = False,
        mode: str = "exact",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render through a camera with z-buffering (Pointcloud::project).

        Returns (image uint8 (H, W, 3), zbuf float32, FLT_MAX where empty).
        ``mode``: "exact" ("tiled" aliases here: the same winner contract)
        or "packed" (lossy RGB666). Unknown modes raise.
        """
        intrinsics = intrinsics.to(self.points.device)
        if mode == "packed":
            return R.project_zbuffer_packed(self.points, self.colors, self.valid, intrinsics,
                                            mirror)
        if mode not in ("exact", "tiled"):
            raise ValueError(
                f"PointCloud.project supports 'exact'/'tiled' or 'packed', not {mode!r}"
            )
        return R.project_zbuffer(self.points, self.colors, self.valid, intrinsics, mirror)

    def to_host(self, compact: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Copy to numpy (Pointcloud::copyToHost); ``compact=True`` drops
        invalid points (host-side, where ragged shapes are fine)."""
        pts = self.points.cpu().numpy()
        cols = self.colors.cpu().numpy()
        if compact:
            mask = self.valid.cpu().numpy()
            return pts[mask], cols[mask]
        return pts, cols

    def save_ply(self, path: str) -> None:
        pts, cols = self.to_host(compact=True)
        save_ply(path, pts, cols)
