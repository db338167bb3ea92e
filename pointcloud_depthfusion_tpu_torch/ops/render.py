"""Z-buffered point-cloud projection: the main-path subset of
pointcloud_depthfusion_tpu/ops/render.py.

The tiled render's contract, bit for bit: per target pixel, the point with
the smallest f32 depth wins, ties go to the smaller packed RGB; the image
carries the winner's exact RGB888 and the z-buffer its exact f32 depth
(FLT_MAX where empty). The resolve runs as kernel B1 (image only) or B2
(image and z-buffer), ops/cuda/zresolve_cuda.py. The exact, indexed,
packed and pallas render modes are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import INT32_MAX, INVALID_PIX

FLT_MAX = torch.finfo(torch.float32).max
# f32 → i32 casts outside the i32 range are undefined in C and torch; XLA
# saturates. Clamping to ±2^30 first keeps every in-bounds result exact and
# every out-of-bounds one out of bounds.
_CAST_LIMIT = float(1 << 30)


def compute_pixel_indices_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project coordinate planes to flat pixel indices.

    Reciprocal then multiply (render.py:98-100), and C-cast
    ``(int)(x + 0.5)`` truncation toward zero (kernels.cu:249-250); the
    mirror applies after the bounds test. Returns (flat, z, in_bounds) with
    ``w*h`` as the dump index of masked-out points.
    """
    w, h = intrinsics.width, intrinsics.height
    pos_z = z > 0
    inv_z = torch.reciprocal(torch.where(pos_z, z, 1.0))
    image_x = intrinsics.ppx + intrinsics.fx * x * inv_z
    image_y = intrinsics.ppy + intrinsics.fy * y * inv_z
    px = torch.clamp(image_x + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    py = torch.clamp(image_y + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    in_bounds = valid & pos_z & (px >= 0) & (py >= 0) & (px <= w - 1) & (py <= h - 1)
    if mirror:
        px = (w - 1) - px
    flat = torch.where(in_bounds, py * w + px, w * h)
    return flat, z, in_bounds


def decode_winner_planes(covered: torch.Tensor, mrgb: torch.Tensor):
    """(covered mask, packed r<<16|g<<8|b winner) → (r, g, b) u8 planes,
    black where uncovered."""
    win = torch.where(covered, mrgb, 0)
    rp = ((win >> 16) & 0xFF).to(torch.uint8)
    gp = ((win >> 8) & 0xFF).to(torch.uint8)
    bp = (win & 0xFF).to(torch.uint8)
    return rp, gp, bp


def pack_rgb(color_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> (...,) int32 key r<<16 | g<<8 | b."""
    c = color_u8.to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """(...,) int32 -> (..., 3) uint8."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)


def project_zbuffer_tiled_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    r: Optional[torch.Tensor],
    g: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    return_planes: bool = False,
    need_zbuf: bool = True,
    rgb24: Optional[torch.Tensor] = None,
):
    """Bit-exact z-buffered render of coordinate planes.

    ``need_zbuf=False`` runs the image-only resolve (B1) and returns None
    for the z-buffer; the image is identical. ``rgb24``: optional packed
    color ``(r<<16)|(g<<8)|b`` with z's shape; when given, r/g/b are
    ignored. Returns (image (H, W, 3) u8 or its three planes, zbuf).
    """
    w, h = intrinsics.width, intrinsics.height
    n_px = w * h

    idx, zc, ok = compute_pixel_indices_planar(x, y, z, valid, intrinsics, mirror)
    okf = ok.reshape(-1)
    pix = torch.where(okf, idx.reshape(-1), INVALID_PIX)
    zbits = torch.where(okf, zc.to(torch.float32).reshape(-1).view(torch.int32), INT32_MAX)
    if rgb24 is None:
        rgb24 = (r.to(torch.int32) << 16) | (g.to(torch.int32) << 8) | b.to(torch.int32)
    rgb = torch.where(okf, rgb24.to(torch.int32).reshape(-1), INT32_MAX)

    if need_zbuf:
        minz, mrgb = zresolve_cuda.zresolve_sorted_entries(pix, zbits, rgb, n_px)
        covered = minz != INT32_MAX
        zbuf = torch.where(covered, minz.view(torch.float32), FLT_MAX).reshape(h, w)
    else:
        mrgb = zresolve_cuda.zresolve_winner_rgb(pix, zbits, rgb, n_px)
        covered = mrgb != INT32_MAX
        zbuf = None
    rp, gp, bp = (p.reshape(h, w) for p in decode_winner_planes(covered, mrgb))
    if return_planes:
        return (rp, gp, bp), zbuf
    return torch.stack([rp, gp, bp], dim=-1), zbuf
