"""Depth→color alignment: port of pointcloud_depthfusion_tpu/ops/align.py.

Each depth pixel's ±0.5-pixel corners are deprojected, moved through the
depth→color extrinsics and projected into the color camera, giving an
integer box [p0, p1]; the raw depth is min-splatted into every color pixel
of the box (kernels.cu:138-158, :276-301). Pixels no box reached, and
pixels whose minimum is the saturated 0xFFFF (it collides with the
reference's buffer sentinel, kernels.cu:284), become 0.

The box edge is capped at ``max_footprint`` (K), so each depth pixel
emits K² entries, and the per-pixel minimum runs as kernel B2
(``zresolve_sorted_entries`` with ``rgb=None``). The JAX package's three
methods ("binned", "sorted", "scatter") are bit-identical
(align.py:152-160); every ``method`` runs this one formulation.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INT32_MAX, INVALID_PIX
from pointcloud_depthfusion_tpu_torch.ops.render import _CAST_LIMIT

_SENTINEL = 0xFFFF


def _map_corner(u, v, depth_m, shift: float, depth_intrinsics: Intrinsics,
                color_intrinsics: Intrinsics, extrinsics: Extrinsics
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A depth pixel corner in integer color-image coordinates: deproject
    at (u+shift, v+shift), transform, project, ``(int)(x + 0.5)``."""
    pts = G.deproject_pixels(u + shift, v + shift, depth_m, depth_intrinsics)
    pts = G.transform_extrinsic(pts, extrinsics.rotation, extrinsics.translation)
    px, py = G.project_points(pts, color_intrinsics)
    return tuple(torch.clamp(p + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
                 for p in (px, py))


def auto_footprint(
    depth_intrinsics: Intrinsics,
    color_intrinsics: Intrinsics,
    extrinsics: Optional[Extrinsics] = None,
    min_depth: float = 0.2,
) -> int:
    """Bound on the per-pixel splat box edge (pixels), from the intrinsics'
    focal ratio, inflated by the worst perspective magnification of the
    extrinsics' translation at ``min_depth`` and by 7% for rotations up to
    20°, plus one pixel of rounding (JAX align.py:65-134). Outside that
    envelope it warns and returns the conservative cap ``max(bound, 8)``.

    It reads the calibration on the host: on the card that is a sync, so a
    pipeline resolves it once per calibration, not per frame. Calibration
    with no values to read (meta tensors, the analogue of the JAX package's
    traced intrinsics) warns and takes the conservative cap 4."""
    calib = [depth_intrinsics.fx, color_intrinsics.fx]
    if extrinsics is not None:
        calib += [extrinsics.rotation, extrinsics.translation]
    if any(t.device.type == "meta" for t in calib):
        warnings.warn(
            "auto_footprint: calibration has no values to read (meta tensors) — "
            "falling back to the conservative splat cap 4; pin "
            "FusionConfig.align_footprint to get the tight bound",
            stacklevel=2,
        )
        return 4
    rx = float(color_intrinsics.fx) / max(float(depth_intrinsics.fx), 1e-6)
    ry = float(color_intrinsics.fy) / max(float(depth_intrinsics.fy), 1e-6)
    t_norm = 0.0
    rot_deg = 0.0
    if extrinsics is not None:
        t_norm = float(np.linalg.norm(extrinsics.translation.cpu().numpy()))
        tr = float(np.trace(extrinsics.rotation.cpu().numpy()))
        rot_deg = math.degrees(math.acos(min(1.0, max(-1.0, (tr - 1.0) / 2.0))))
    z_floor = max(min_depth, 1e-3)
    perspective = z_floor / max(z_floor - t_norm, z_floor * 0.25)
    ratio = max(rx, ry) * perspective * 1.07
    bound = max(2, int(math.ceil(ratio)) + 1)
    if t_norm > 0.5 * z_floor or rot_deg > 20.0:
        warnings.warn(
            f"auto_footprint: depth→color extrinsics outside the bound's "
            f"envelope (|t|={t_norm:.3f} m vs min_depth={z_floor:.3f} m, "
            f"rotation {rot_deg:.1f}°) — using conservative splat cap "
            f"{max(bound, 8)}; pin FusionConfig.align_footprint manually "
            "to trade coverage for entry count",
            stacklevel=2,
        )
        return max(bound, 8)
    return bound


def align_depth_to_color(
    depth: torch.Tensor,
    depth_scale,
    depth_intrinsics: Intrinsics,
    color_intrinsics: Intrinsics,
    depth_to_color: Extrinsics,
    max_footprint=4,
    method: Optional[str] = None,
) -> torch.Tensor:
    """Align raw depth ((Hd, Wd), u16 values in any integer dtype) to the
    color camera's pixel grid: (Hc, Wc) int32 raw depth.

    ``max_footprint``: the box-edge cap K, or "auto" (:func:`auto_footprint`).
    ``method`` is accepted for parity with the JAX package; every method
    gives the same bits and runs the same kernel."""
    del method
    if max_footprint == "auto":
        max_footprint = auto_footprint(depth_intrinsics, color_intrinsics, depth_to_color)
    k = int(max_footprint)
    dev = depth.device
    dh, dw = depth.shape
    ch, cw = color_intrinsics.height, color_intrinsics.width

    u, v = G.pixel_grid(dh, dw, device=dev)
    raw = depth.to(torch.int32)
    z = raw.to(torch.float32) * depth_scale
    x0, y0 = _map_corner(u, v, z, -0.5, depth_intrinsics, color_intrinsics, depth_to_color)
    x1, y1 = _map_corner(u, v, z, +0.5, depth_intrinsics, color_intrinsics, depth_to_color)
    # The whole box must lie inside the color image (kernels.cu:290).
    ok = (raw > 0) & (x0 >= 0) & (y0 >= 0) & (x1 < cw) & (y1 < ch)

    # K² entries per depth pixel, offset (dy, dx) on the leading axis.
    off = torch.arange(k, dtype=torch.int32, device=dev)
    dy = off.repeat_interleave(k)[:, None]
    dx = off.repeat(k)[:, None]
    x0f, y0f = x0.reshape(1, -1), y0.reshape(1, -1)
    active = ok.reshape(1, -1) & (dy <= (y1 - y0).reshape(1, -1)) & (dx <= (x1 - x0).reshape(1, -1))
    tx = torch.clamp(x0f + dx, 0, cw - 1)
    ty = torch.clamp(y0f + dy, 0, ch - 1)
    pix = torch.where(active, ty * cw + tx, INVALID_PIX).reshape(-1)
    vals = torch.where(active, raw.reshape(1, -1), INT32_MAX).reshape(-1)
    minz, _ = zresolve_cuda.zresolve_sorted_entries(pix, vals, None, cw * ch)
    out = torch.where((minz == INT32_MAX) | (minz == _SENTINEL), 0, minz)
    return out.reshape(ch, cw)
