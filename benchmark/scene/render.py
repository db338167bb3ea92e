"""The benchmark's inputs: a ray-cast RGB-D scene rendered on the device.

A PyTorch rewrite of the scene of ``io/synthetic.py``: a ground plane at
world z = ``plane_z`` (viewed along +z) and spheres, coloured by a
world-anchored checker and a per-sphere shade, so two views of one world
point get one colour. Depth is the camera-frame z, quantised to uint16 at
the configured metres per LSB, as a RealSense D455 stores it.

The spheres move along closed seeded paths, one period per frame pool, so a
pool replayed in a loop has no jump. Every seed draws the same sphere sizes
and the same path amplitudes: only the phases and directions differ, so the
work per frame does not depend on the seed.

Rendering runs in float64 on the given device, a block of frames per call,
with the noise and holes drawn from one ``torch.Generator`` on that device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def yaw_pose(x_off: float, yaw_deg: float) -> np.ndarray:
    """4x4 camera->world pose: a yaw about y, then a shift along x."""
    a = math.radians(yaw_deg)
    m = np.eye(4)
    m[:3, :3] = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                 [-math.sin(a), 0.0, math.cos(a)]]
    m[:3, 3] = [x_off, 0.0, 0.0]
    return m


def camera_poses(geometry: dict) -> List[np.ndarray]:
    """Camera->world poses of a rig description: ``{"kind": "pair",
    "baseline_m", "toe_in_deg"}`` (left at -baseline/2, right at
    +baseline/2, both toed in)."""
    if geometry["kind"] == "pair":
        b, toe = geometry["baseline_m"], geometry["toe_in_deg"]
        return [yaw_pose(-b / 2, +toe), yaw_pose(+b / 2, -toe)]
    raise ValueError(f"unknown rig kind {geometry['kind']!r}")


def sphere_paths(scene: dict, pool: int, seed: int) -> np.ndarray:
    """(pool, S, 3) sphere centres: each sphere on a closed path around its
    rest position, ``amplitude_m`` per axis, a whole number of cycles per
    pool, phases and signs drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    rest = np.asarray([s["center"] for s in scene["spheres"]], np.float64)
    amp = np.asarray(scene["amplitude_m"], np.float64)
    n = len(rest)
    phase = rng.uniform(0.0, 2.0 * math.pi, size=(n, 3))
    sign = rng.choice([-1.0, 1.0], size=(n, 3))
    cycles = np.asarray(scene["cycles"], np.float64)[:n, None]
    t = np.arange(pool, dtype=np.float64)[:, None, None] / pool
    return rest[None] + amp * sign * np.sin(2.0 * math.pi * cycles * t + phase)


def render_depth_color(intr: dict, world_from_cam: np.ndarray, centers: torch.Tensor,
                       scene: dict, device) -> tuple:
    """Ray-cast F frames of one camera: (depth m (F, H, W) f64, 0 where no
    hit, colour (F, H, W, 3) f64). ``centers``: (F, S, 3) sphere centres."""
    f64 = dict(dtype=torch.float64, device=device)
    h, w = intr["height"], intr["width"]
    r = torch.as_tensor(np.asarray(world_from_cam)[:3, :3], **f64)
    t = torch.as_tensor(np.asarray(world_from_cam)[:3, 3], **f64)
    v, u = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    dirs = torch.stack([(u - intr["ppx"]) / intr["fx"], (v - intr["ppy"]) / intr["fy"],
                        torch.ones_like(u)], -1)
    rd = dirs @ r.T  # (H, W, 3): unit-z rays in world axes, so s is the depth
    frames = centers.shape[0]
    inf = torch.full((frames, h, w), math.inf, **f64)
    denom = rd[..., 2]
    s_plane = (scene["plane_z"] - t[2]) / torch.where(denom.abs() > 0, denom, 1e-300)
    hit = (denom > 1e-9) & (s_plane > 0.05)
    s_best = torch.where(hit, s_plane, inf)
    obj = torch.where(hit, 0, -1).to(torch.int32).expand(frames, h, w).clone()
    a = (rd * rd).sum(-1)
    for i, sp in enumerate(scene["spheres"]):
        m = t[None] - centers[:, i]  # (F, 3)
        b = 2.0 * torch.einsum("hwc,fc->fhw", rd, m)
        c = (m * m).sum(-1)[:, None, None] - sp["radius"] ** 2
        disc = b * b - 4.0 * a * c
        s_sph = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a)
        closer = (disc > 0) & (s_sph > 0.05) & (s_sph < s_best)
        s_best = torch.where(closer, s_sph, s_best)
        obj = torch.where(closer, i + 1, obj)
    depth = torch.where(torch.isfinite(s_best) & (s_best < scene["max_depth"]), s_best, 0.0)
    p = t + rd[None] * s_best[..., None]
    period = scene["checker_period"]
    checker = torch.remainder(torch.floor(p[..., 0] / period) + torch.floor(p[..., 1] / period), 2)
    light = torch.as_tensor([200.0, 200.0, 200.0], **f64)
    dark = torch.as_tensor([90.0, 110.0, 130.0], **f64)
    color = torch.where(checker[..., None] > 0.5, light, dark)
    for i, sp in enumerate(scene["spheres"]):
        shade = 0.7 + 0.3 * torch.clamp(
            (p[..., 1] - centers[:, i, 1][:, None, None]) / max(sp["radius"], 1e-6), -1.0, 1.0)
        base = torch.as_tensor(sp["color"], **f64)
        color = torch.where((obj == i + 1)[..., None], base * shade[..., None], color)
    color = torch.where((obj >= 0)[..., None], color, 0.0)
    return depth, color


def quantize(depth_m: torch.Tensor, color: torch.Tensor, depth_scale: float, noise_std: float,
             hole_fraction: float, gen: torch.Generator) -> tuple:
    """Sensor model: Gaussian depth noise on hits, dropped pixels, then
    uint16 depth (held as int32) and uint8 colour."""
    if noise_std > 0:
        noise = torch.randn(depth_m.shape, generator=gen, dtype=depth_m.dtype,
                            device=depth_m.device)
        depth_m = torch.where(depth_m > 0, depth_m + noise_std * noise, 0.0)
    if hole_fraction > 0:
        holes = torch.rand(depth_m.shape, generator=gen, dtype=torch.float32,
                           device=depth_m.device) < hole_fraction
        depth_m = torch.where(holes, 0.0, depth_m)
    depth = torch.clamp(torch.round(depth_m / depth_scale), 0, 65535).to(torch.int32)
    return depth, torch.clamp(torch.round(color), 0, 255).to(torch.uint8)


def render_pool(config: dict, pool: int, seed: int, device, block: int = 8) -> Dict[str, object]:
    """Every camera's ``pool`` frames, on ``device``: ``{"depth": (C, P, H,
    W) int32, "color": (C, P, H, W, 3) uint8, "poses": [4x4 camera->world],
    "centers": (P, S, 3)}``. The same seed gives the same frames."""
    scene, intr = config["scene"], config["intrinsics"]
    poses = camera_poses(config["rig"])
    centers = torch.as_tensor(sphere_paths(scene, pool, seed), dtype=torch.float64,
                              device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    depth = torch.empty((len(poses), pool, intr["height"], intr["width"]), dtype=torch.int32,
                        device=device)
    color = torch.empty((*depth.shape, 3), dtype=torch.uint8, device=device)
    for c, pose in enumerate(poses):
        for lo in range(0, pool, block):
            hi = min(pool, lo + block)
            dm, col = render_depth_color(intr, pose, centers[lo:hi], scene, device)
            depth[c, lo:hi], color[c, lo:hi] = quantize(
                dm, col, config["depth_scale"], scene["depth_noise_std"],
                scene["hole_fraction"], gen)
    return {"depth": depth, "color": color, "poses": poses, "centers": centers}


def right_to_left(poses: Sequence[np.ndarray]) -> np.ndarray:
    """The true right->left transform of a pair rig (what registration
    estimates and what a loaded transform.txt holds), float32."""
    return (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
