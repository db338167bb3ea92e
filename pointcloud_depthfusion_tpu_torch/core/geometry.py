"""Dense camera geometry: deprojection, rigid transforms, SO(3) utilities.

Port of the fusion and registration subset of
pointcloud_depthfusion_tpu/core/geometry.py. Every function keeps the JAX
version's f32 operation order, so the per-pixel planes are bit-identical to
it on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics

# Pose composes must stay in full f32: TF32 keeps ~10 mantissa bits, enough
# to shift projected pixels (the TPU's version of this trap was bf16
# matmuls, pointcloud_depthfusion_tpu/core/geometry.py:186-199).
torch.backends.cuda.matmul.allow_tf32 = False


def pixel_grid(
    height: int, width: int, dtype=torch.float32, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (u, v) pixel-coordinate grids of shape (height, width)."""
    u = torch.arange(width, dtype=dtype, device=device).expand(height, width)
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return u, v


def _undistort_inverse_brown_conrady(x, y, coeffs):
    """Inverse-Brown-Conrady undistortion of normalized coords
    (kernels.cu:56-63)."""
    r2 = x * x + y * y
    f = 1.0 + coeffs[0] * r2 + coeffs[1] * r2 * r2 + coeffs[4] * r2 * r2 * r2
    ux = x * f + 2.0 * coeffs[2] * x * y + coeffs[3] * (r2 + 2.0 * x * x)
    uy = y * f + 2.0 * coeffs[3] * x * y + coeffs[2] * (r2 + 2.0 * y * y)
    return ux, uy


def deproject_pixels(u, v, depth: torch.Tensor, intrinsics: Intrinsics) -> torch.Tensor:
    """Pixel coordinates + metric depth → (*shape, 3) points."""
    x = (u - intrinsics.ppx) / intrinsics.fx
    y = (v - intrinsics.ppy) / intrinsics.fy
    if intrinsics.model == Distortion.INVERSE_BROWN_CONRADY:
        x, y = _undistort_inverse_brown_conrady(x, y, intrinsics.coeffs)
    return torch.stack([depth * x, depth * y, depth], dim=-1)


def deproject(
    depth_m: torch.Tensor,
    intrinsics: Intrinsics,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense frame deprojection: (H, W, 3) f32 camera-frame points and the
    (H, W) validity mask (``mask`` and depth > 0). Invalid points keep
    z = 0 and are masked explicitly downstream."""
    h, w = depth_m.shape
    u, v = pixel_grid(h, w, depth_m.dtype, depth_m.device)
    valid = depth_m > 0 if mask is None else mask & (depth_m > 0)
    return deproject_pixels(u, v, depth_m, intrinsics), valid


def deproject_planar(
    depth_m: torch.Tensor,
    intrinsics: Intrinsics,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure-of-arrays deprojection: returns (x, y, z, valid) planes."""
    h, w = depth_m.shape
    u, v = pixel_grid(h, w, depth_m.dtype, depth_m.device)
    valid = depth_m > 0 if mask is None else mask & (depth_m > 0)
    nx = (u - intrinsics.ppx) / intrinsics.fx
    ny = (v - intrinsics.ppy) / intrinsics.fy
    if intrinsics.model == Distortion.INVERSE_BROWN_CONRADY:
        nx, ny = _undistort_inverse_brown_conrady(nx, ny, intrinsics.coeffs)
    return depth_m * nx, depth_m * ny, depth_m, valid


def transform_planar(x, y, z, transform: torch.Tensor):
    """Rigid transform on coordinate planes, summed left to right
    (kernel_transform equivalent)."""
    t = transform.to(x.dtype)
    xo = t[0, 0] * x + t[0, 1] * y + t[0, 2] * z + t[0, 3]
    yo = t[1, 0] * x + t[1, 1] * y + t[1, 2] * z + t[1, 3]
    zo = t[2, 0] * x + t[2, 1] * y + t[2, 2] * z + t[2, 3]
    return xo, yo, zo


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product in full f32 (TF32 is off for this package)."""
    return torch.matmul(a, b)


def transform_points(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a 4×4 homogeneous transform to (..., 3) points."""
    r = transform[:3, :3].to(points.dtype)
    t = transform[:3, 3].to(points.dtype)
    return mm(points, r.T) + t


def quaternion_from_matrix(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3,3) -> quaternion (w, x, y, z).

    Eigen's ``Quaternion(Matrix3)`` branch rule: the w-branch whenever
    trace > 0, otherwise the dominant-diagonal branch. The sign matters to
    :func:`interpolate_transform`'s ``q_r.w < 0`` quirk. All four candidates
    are computed and one is selected on the device, with no host sync.
    """
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12)) * 2.0

    s = root(tr + 1.0)
    cand_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    s = root(1.0 + m00 - m11 - m22)
    cand_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    s = root(1.0 + m11 - m00 - m22)
    cand_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    s = root(1.0 + m22 - m00 - m11)
    cand_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    diag = torch.stack([m00, m11, m22])
    idx = torch.where(tr > 0, 0, 1 + torch.argmax(diag))
    q = torch.stack([cand_w, cand_x, cand_y, cand_z])[idx]
    return q / torch.linalg.vector_norm(q)


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix (3,3)."""
    q = q / torch.linalg.vector_norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation, Eigen ``Quaterniond::slerp`` semantics:
    short path, lerp for nearly-parallel quaternions."""
    d = torch.dot(q0, q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp_max(torch.abs(d), 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe_sin = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q)


def make_transform(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=rotation.dtype, device=rotation.device)
    m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


def interpolate_transform(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Midpoint of two 4×4 transforms (FusionNode::interpolateTransform,
    fusion_node.cpp:589-604): slerp(0.5) of the rotations, lerp(0.5) of the
    translations, and the whole result inverted when the right rotation's
    quaternion has w < 0 (fusion_node.cpp:603)."""
    q_l = quaternion_from_matrix(left[:3, :3])
    q_r = quaternion_from_matrix(right[:3, :3])
    q = quaternion_slerp(q_l, q_r, 0.5)
    t = 0.5 * left[:3, 3] + 0.5 * right[:3, 3]
    m = make_transform(matrix_from_quaternion(q), t)
    return torch.where(q_r[0] < 0, invert_rigid(m), m)


def invert_rigid(transform: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4×4 transform without a general solve."""
    r = transform[:3, :3]
    t = transform[:3, 3]
    return make_transform(r.T, -mm(r.T, t))


def extract_euler_angles(rotation: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → (x, y, z) Euler angles, atan2/asin XYZ extraction
    (Registration::extractEulerAngles, registration.cpp)."""
    ea_x = torch.atan2(rotation[2, 1], rotation[2, 2])
    ea_y = -torch.asin(torch.clamp(rotation[2, 0], -1.0, 1.0))
    ea_z = torch.atan2(rotation[1, 0], rotation[0, 0])
    return torch.stack([ea_x, ea_y, ea_z])


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(x, y, z) Euler angles -> R = Rx(ax) @ Ry(ay) @ Rz(az)
    (fusion_node.cpp:174-177)."""
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, cx, -sx]),
        torch.stack([zero, sx, cx]),
    ])
    ry = torch.stack([
        torch.stack([cy, zero, sy]),
        torch.stack([zero, one, zero]),
        torch.stack([-sy, zero, cy]),
    ])
    rz = torch.stack([
        torch.stack([cz, -sz, zero]),
        torch.stack([sz, cz, zero]),
        torch.stack([zero, zero, one]),
    ])
    return mm(mm(rx, ry), rz)


def rotz(angle_rad, device=None) -> torch.Tensor:
    """4×4 rotation about Z (the +90° vertical-image pre-rotation,
    fusion_node.cpp:775-778)."""
    a = torch.as_tensor(angle_rad, dtype=torch.float32, device=device)
    c, s = torch.cos(a), torch.sin(a)
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[0, 0] = c
    m[0, 1] = -s
    m[1, 0] = s
    m[1, 1] = c
    return m


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: twist (6,) [rho, phi] → 4×4 transform (the
    Gauss-Newton update of the VGICP solver). No host sync: the small-angle
    branch is selected on the device."""
    rho, phi = xi[:3], xi[3:]
    theta = torch.linalg.vector_norm(phi)
    small = theta < 1e-8
    safe = torch.where(small, 1.0, theta)
    zero = torch.zeros_like(theta)
    k = torch.stack([
        torch.stack([zero, -phi[2], phi[1]]),
        torch.stack([phi[2], zero, -phi[0]]),
        torch.stack([-phi[1], phi[0], zero]),
    ])
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    sin, cos = torch.sin(safe), torch.cos(safe)
    a = torch.where(small, 1.0, sin / safe)
    b = torch.where(small, 0.5, (1.0 - cos) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0, (safe - sin) / (safe ** 3))
    kk = mm(k, k)
    r = eye + a * k + b * kk
    v = eye + b * k + c * kk
    return make_transform(r, mm(v, rho))


def deg2rad(deg):
    """Degrees to radians: a Python float stays a Python (f64) float, a
    tensor keeps its dtype."""
    return deg * (math.pi / 180.0)


def rad2deg(rad):
    """Radians to degrees, with the same dtype rule as :func:`deg2rad`."""
    return rad * (180.0 / math.pi)
