"""The plain reference of the served fused images.

Plain PyTorch, written from the upstream fusion node's arithmetic
(fusion_node.cpp:700-811, kernels.cu) and independent of the code under
test: it imports nothing of the program. It works out again everything the
program derives from the benchmark's inputs:

- each camera's temporal-filter state, replayed over the frames the camera
  was handed, in order (``TemporalReplay``);
- the virtual camera's pose from the handed-in right->left transform
  (``fused_poses``: the slerp midpoint, the vertical pre-rotation);
- the fused image: depth window, deprojection, rigid transform, projection
  with C-cast rounding and the mirror, the nearest-point resolve (ties to
  the smaller rgb24), the colour decode and the half-up 3x3 Gauss on the
  interior (``fuse_image``).

``dtype`` selects the precision of the per-point geometry: float32 is what
the configurations state; the control runs the same code in bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set

import torch

INT32_MAX = 0x7FFFFFFF
_CAST_LIMIT = float(1 << 30)

# Pose products in full float32: TF32 would move projected pixels.
torch.backends.cuda.matmul.allow_tf32 = False


# -- camera node: the temporal filter -----------------------------------------


def temporal_step(prev: Optional[torch.Tensor], depth: torch.Tensor, alpha: float,
                  delta: float) -> torch.Tensor:
    """One step of the D455 temporal filter on uint16 depth held as int32:
    an exponential average where both frames have depth within ``delta``
    LSB, the previous value where the new frame has a hole, rounded half to
    even. The first frame passes through. Returns the new state, which is
    also the filtered frame."""
    if prev is None:
        return depth
    cur = depth.to(torch.float32)
    old = prev.to(torch.float32)
    blend = (cur > 0) & (old > 0) & ((cur - old).abs() <= delta)
    out = torch.where(blend, alpha * cur + (1.0 - alpha) * old, cur)
    out = torch.where((cur == 0) & (old > 0), old, out)
    return torch.clamp(torch.round(out), 0, 65535).to(torch.int32)


class TemporalReplay:
    """Replays one camera's temporal filter over the pool indices the camera
    handed out, in order, and keeps the filtered frames asked for."""

    def __init__(self, pool_depth: torch.Tensor, alpha: float, delta: float, enabled: bool):
        self.pool_depth = pool_depth  # (P, H, W) int32
        self.alpha, self.delta, self.enabled = alpha, delta, enabled

    def filtered(self, sequence: Sequence[int], wanted: Set[int]) -> Dict[int, torch.Tensor]:
        """``sequence``: the frame numbers handed out, in order (frame k
        shows pool frame k mod P); ``wanted``: the frame numbers to keep.
        Returns {frame number: filtered depth}."""
        pool = self.pool_depth.shape[0]
        out, state = {}, None
        last = max(wanted, default=None)
        for frame in sequence:
            raw = self.pool_depth[frame % pool]
            state = temporal_step(state, raw, self.alpha, self.delta) if self.enabled else raw
            if frame in wanted:
                out[frame] = state
            if frame == last:
                break
        return out


# -- poses ----------------------------------------------------------------------


def _quat_from_matrix(r: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) by Eigen's branch rule: the w branch when the trace is
    positive, else the dominant diagonal's."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12)) * 2.0

    s = root(tr + 1.0)
    qw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])
    pick = torch.where(tr > 0, 0, 1 + torch.argmax(torch.stack([m00, m11, m22])))
    q = torch.stack([qw, qx, qy, qz])[pick]
    return q / torch.linalg.vector_norm(q)


def _matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def _slerp(q0: torch.Tensor, q1: torch.Tensor, t: float) -> torch.Tensor:
    """Eigen's slerp: the short path, a lerp when nearly parallel."""
    d = torch.dot(q0, q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp_max(torch.abs(d), 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    lerp = sin_theta < 1e-6
    safe = torch.where(lerp, 1.0, sin_theta)
    w0 = torch.where(lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(lerp, t, torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q)


def _rigid(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=rot.dtype, device=rot.device)
    m[:3, :3] = rot
    m[:3, 3] = trans
    return m


def _midpoint(right: torch.Tensor) -> torch.Tensor:
    """interpolateTransform(identity, right) (fusion_node.cpp:589-604):
    slerp(0.5) of the rotations, the mean of the translations, inverted
    when the right rotation's quaternion has w < 0."""
    left = torch.eye(4, dtype=right.dtype, device=right.device)
    q_r = _quat_from_matrix(right[:3, :3])
    q = _slerp(_quat_from_matrix(left[:3, :3]), q_r, 0.5)
    m = _rigid(_matrix_from_quat(q), 0.5 * left[:3, 3] + 0.5 * right[:3, 3])
    r = m[:3, :3]
    inv = _rigid(r.T, -torch.matmul(r.T, m[:3, 3]))
    return torch.where(q_r[0] < 0, inv, m)


def _rotz(angle: float, device) -> torch.Tensor:
    a = torch.as_tensor(angle, dtype=torch.float32, device=device)
    c, s = torch.cos(a), torch.sin(a)
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def fused_poses(right_to_left, vertical: bool, device) -> tuple:
    """(left->virtual, right->virtual) 4x4 float32: the midpoint of the
    left camera and the handed-in right->left transform, turned +90 deg
    about z for a vertical image (fusion_node.cpp:766-778)."""
    right = torch.as_tensor(right_to_left, dtype=torch.float32).to(device)
    t = _midpoint(right)
    if vertical:
        t = torch.matmul(_rotz(90.0 * (math.pi / 180.0), device), t)
    return t, torch.matmul(t, right)


# -- the image ---------------------------------------------------------------


def handshake_intrinsics(intr: dict) -> dict:
    """The camera as the fusion node's calibration handshake passes it on:
    fx, fy, ppx and ppy truncated to integers (fusion_node.cpp:574-577)."""
    return dict(intr, **{k: float(int(intr[k])) for k in ("fx", "fy", "ppx", "ppy")})


def virtual_intrinsics(intr: dict, vertical: bool) -> dict:
    """The virtual camera: the left camera, transposed for a vertical image,
    principal point at the centre by C integer division."""
    if vertical:
        intr = dict(width=intr["height"], height=intr["width"], fx=intr["fy"], fy=intr["fx"],
                    ppx=intr["ppy"], ppy=intr["ppx"])
    return dict(intr, ppx=float(intr["width"] // 2), ppy=float(intr["height"] // 2))


def _window(meters: float, scale: torch.Tensor) -> torch.Tensor:
    """(int)(meters_f32 / scale_f32): the depth window on the u16 grid."""
    q = torch.as_tensor(meters, dtype=torch.float32, device=scale.device) / scale
    return torch.clamp(q, 0.0, 65535.0).to(torch.int32)


def project_camera(depth: torch.Tensor, rgb24: torch.Tensor, scale: float, intr: dict,
                   pose: torch.Tensor, virt: dict, mirror: bool, min_depth: float,
                   max_depth: float, dtype=torch.float32) -> tuple:
    """One camera's points in the virtual image: (flat pixel, z, ok, rgb24),
    each (H*W,). ``dtype``: the precision of the geometry."""
    dev = depth.device
    f32 = dict(dtype=torch.float32, device=dev)
    s = torch.as_tensor(scale, **f32)
    keep = (depth >= _window(min_depth, s)) & (depth <= _window(max_depth, s))
    d = torch.where(keep, depth, 0)
    valid = d > 0
    h, w = depth.shape
    u = torch.arange(w, **f32).expand(h, w)
    v = torch.arange(h, **f32)[:, None].expand(h, w)

    def c(x):
        return torch.as_tensor(x, **f32).to(dtype)

    dm = (torch.where(valid, d, 0).to(torch.float32) * s).to(dtype)
    x0 = dm * ((u.to(dtype) - c(intr["ppx"])) / c(intr["fx"]))
    y0 = dm * ((v.to(dtype) - c(intr["ppy"])) / c(intr["fy"]))
    t = pose.to(dtype)
    x = t[0, 0] * x0 + t[0, 1] * y0 + t[0, 2] * dm + t[0, 3]
    y = t[1, 0] * x0 + t[1, 1] * y0 + t[1, 2] * dm + t[1, 3]
    z = t[2, 0] * x0 + t[2, 1] * y0 + t[2, 2] * dm + t[2, 3]
    pos = z > 0
    inv = torch.reciprocal(torch.where(pos, z, c(1.0)))
    ix = c(virt["ppx"]) + c(virt["fx"]) * x * inv
    iy = c(virt["ppy"]) + c(virt["fy"]) * y * inv
    px = torch.clamp(ix.to(torch.float32) + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    py = torch.clamp(iy.to(torch.float32) + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    vw, vh = virt["width"], virt["height"]
    ok = valid & pos & (px >= 0) & (py >= 0) & (px <= vw - 1) & (py <= vh - 1)
    if mirror:
        px = (vw - 1) - px
    flat = torch.where(ok, py * vw + px, vw * vh)
    return flat.reshape(-1), z.to(torch.float32).reshape(-1), ok.reshape(-1), rgb24.reshape(-1)


def pack_rgb24(color: torch.Tensor) -> torch.Tensor:
    c = color.to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def resolve(points: List[tuple], n_px: int) -> torch.Tensor:
    """The nearest point of each virtual pixel, ties to the smaller rgb24:
    its rgb24 per pixel, INT32_MAX where no point landed."""
    flat = torch.cat([p[0] for p in points]).to(torch.int64)
    z = torch.cat([p[1] for p in points])
    ok = torch.cat([p[2] for p in points])
    rgb = torch.cat([p[3] for p in points]).to(torch.int64)
    key = (z.view(torch.int32).to(torch.int64) << 32) | (rgb + (1 << 31))
    key = torch.where(ok, key, torch.iinfo(torch.int64).max)
    slot = torch.where(ok, flat, n_px)
    best = torch.full((n_px + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=flat.device)
    best = best.scatter_reduce(0, slot, key, "amin", include_self=True)[:n_px]
    return ((best & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _gauss3x3(plane: torch.Tensor) -> torch.Tensor:
    """(sum of w*x + 8) >> 4 with weights 1 2 1 / 2 4 2 / 1 2 1 on the
    interior; the border keeps its value."""
    x = plane.to(torch.int32)
    h, w = x.shape
    out = plane.clone()
    if h < 3 or w < 3:
        return out
    wts = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
    acc = sum(wts[dy][dx] * x[dy:h - 2 + dy, dx:w - 2 + dx] for dy in range(3) for dx in range(3))
    out[1:h - 1, 1:w - 1] = ((acc + 8) >> 4).to(torch.uint8)
    return out


def color_image(winner: torch.Tensor, h: int, w: int, gauss: bool) -> torch.Tensor:
    """(H, W, 3) uint8 from the per-pixel winner, black where uncovered."""
    win = torch.where(winner != INT32_MAX, winner, 0).reshape(h, w)
    planes = [((win >> sh) & 0xFF).to(torch.uint8) for sh in (16, 8, 0)]
    if gauss:
        planes = [_gauss3x3(p) for p in planes]
    return torch.stack(planes, -1)


def fuse_image(depths: Sequence[torch.Tensor], colors: Sequence[torch.Tensor],
               scales: Sequence[float], intrs: Sequence[dict], poses: Sequence[torch.Tensor],
               virt: dict, fusion: dict, dtype=torch.float32) -> torch.Tensor:
    """The fused (H, W, 3) uint8 image of N cameras. ``fusion``: the
    configuration's mirror, depth window and colour filter."""
    points = [project_camera(d, pack_rgb24(c) if c.dim() == 3 else c, s, i, p, virt,
                             fusion["mirror_image"], fusion["min_depth"], fusion["max_depth"],
                             dtype)
              for d, c, s, i, p in zip(depths, colors, scales, intrs, poses)]
    winner = resolve(points, virt["width"] * virt["height"])
    return color_image(winner, virt["height"], virt["width"], fusion["filter_fused_color"])
