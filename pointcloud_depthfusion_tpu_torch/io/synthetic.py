"""Analytic synthetic RGB-D scene: the test/bench stand-in for live capture.

A numpy copy of pointcloud_depthfusion_tpu/io/synthetic.py (whose imports
pull in jax). It ray-casts a ground plane plus spheres with a
world-anchored color pattern from any camera pose, so two views of one
world point have the same color. Depth is the camera-frame z, quantized by
``depth_scale`` into uint16, as a RealSense stores it. The frames are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset


@dataclasses.dataclass
class Sphere:
    center: np.ndarray  # (3,) world
    radius: float
    base_color: np.ndarray  # (3,) 0..255


@dataclasses.dataclass
class SyntheticScene:
    """Ground plane at world z = plane_z (viewed along +z) plus spheres."""

    plane_z: float = 2.5
    spheres: Sequence[Sphere] = dataclasses.field(
        default_factory=lambda: [
            Sphere(np.array([0.0, 0.0, 1.8]), 0.35, np.array([230.0, 60.0, 40.0])),
            Sphere(np.array([-0.45, 0.25, 2.1]), 0.25, np.array([40.0, 200.0, 80.0])),
            Sphere(np.array([0.5, -0.3, 1.5]), 0.2, np.array([60.0, 90.0, 235.0])),
        ]
    )
    checker_period: float = 0.25
    max_depth: float = 20.0

    def render(
        self,
        intrinsics: Intrinsics,
        world_from_cam: np.ndarray,
        depth_scale: float = 0.001,
        timestamp: float = 0.0,
        depth_noise_std: float = 0.0,
        hole_fraction: float = 0.0,
        seed: int = 0,
    ) -> HostFrameset:
        """Ray-cast the scene from one camera (``world_from_cam``: 4×4
        camera→world pose)."""
        h, w = intrinsics.height, intrinsics.width
        fx, fy = float(intrinsics.fx), float(intrinsics.fy)
        ppx, ppy = float(intrinsics.ppx), float(intrinsics.ppy)
        r = np.asarray(world_from_cam, np.float64)[:3, :3]
        t = np.asarray(world_from_cam, np.float64)[:3, 3]

        u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        # Camera-frame ray with unit z so the parameter s IS the depth.
        dirs = np.stack([(u - ppx) / fx, (v - ppy) / fy, np.ones_like(u)], -1)

        s_best = np.full((h, w), np.inf)
        obj_id = np.full((h, w), -1, np.int32)

        # Plane: world z = plane_z → (R d)_z s + t_z = plane_z.
        rd = dirs @ r.T
        denom = rd[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            s_plane = (self.plane_z - t[2]) / denom
        hit = (denom > 1e-9) & (s_plane > 0.05)
        s_best = np.where(hit & (s_plane < s_best), s_plane, s_best)
        obj_id = np.where(hit & (s_plane <= s_best), 0, obj_id)

        for i, sp in enumerate(self.spheres):
            m = t - sp.center
            a = np.sum(rd * rd, -1)
            b = 2.0 * (rd @ m)
            c = float(m @ m) - sp.radius**2
            disc = b * b - 4 * a * c
            with np.errstate(invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                s_sph = (-b - sq) / (2 * a)
            hit = (disc > 0) & (s_sph > 0.05)
            closer = hit & (s_sph < s_best)
            s_best = np.where(closer, s_sph, s_best)
            obj_id = np.where(closer, i + 1, obj_id)

        depth = np.where(np.isfinite(s_best) & (s_best < self.max_depth), s_best, 0.0)

        # World-anchored coloring (consistent across viewpoints).
        p_world = t[None, None, :] + rd * s_best[..., None]
        checker = (
            (np.floor(p_world[..., 0] / self.checker_period)
             + np.floor(p_world[..., 1] / self.checker_period)) % 2
        )
        color = np.where(
            checker[..., None] > 0.5,
            np.array([200.0, 200.0, 200.0]),
            np.array([90.0, 110.0, 130.0]),
        )
        for i, sp in enumerate(self.spheres):
            shade = 0.7 + 0.3 * np.clip(
                (p_world[..., 1] - sp.center[1]) / max(sp.radius, 1e-6), -1, 1
            )
            sphere_color = sp.base_color[None, None, :] * shade[..., None]
            color = np.where((obj_id == i + 1)[..., None], sphere_color, color)
        color = np.where((obj_id >= 0)[..., None], color, 0.0)

        rng = np.random.default_rng(seed)
        if depth_noise_std > 0:
            depth = np.where(
                depth > 0, depth + rng.normal(0, depth_noise_std, depth.shape), 0.0
            )
        if hole_fraction > 0:
            holes = rng.random(depth.shape) < hole_fraction
            depth = np.where(holes, 0.0, depth)

        depth_u16 = np.clip(np.round(depth / depth_scale), 0, 65535).astype(np.uint16)
        color_u8 = np.clip(np.round(color), 0, 255).astype(np.uint8)
        return HostFrameset(
            depth=depth_u16, color=color_u8, timestamp=timestamp, depth_scale=depth_scale
        )


def _yaw_pose(x_off: float, yaw_deg: float) -> np.ndarray:
    a = np.deg2rad(yaw_deg)
    m = np.eye(4)
    m[:3, :3] = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    )
    m[:3, 3] = [x_off, 0.0, 0.0]
    return m


def two_camera_rig(
    baseline: float = 0.6,
    toe_in_deg: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Camera→world poses of a left/right rig, left at -baseline/2 and right
    at +baseline/2 on x, both toed in by ``toe_in_deg``."""
    return _yaw_pose(-baseline / 2, +toe_in_deg), _yaw_pose(+baseline / 2, -toe_in_deg)


def rig_arc_poses(
    n: int,
    span: float = 0.8,
    toe_in_deg_per_m: float = 0.0,
) -> list:
    """Camera→world poses of an n-camera rig spread along x over ``span``
    meters, each yawed by ``toe_in_deg_per_m * (-x)`` degrees."""
    poses = []
    for i in range(n):
        x = span * (i / max(n - 1, 1) - 0.5)
        poses.append(_yaw_pose(x, -toe_in_deg_per_m * x))
    return poses


def right_to_left_transform(
    world_from_left: np.ndarray, world_from_right: np.ndarray
) -> np.ndarray:
    """Ground-truth right→left camera transform (what registration estimates)."""
    return np.linalg.inv(world_from_left) @ world_from_right
