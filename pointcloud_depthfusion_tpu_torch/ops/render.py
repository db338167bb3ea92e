"""Z-buffered point-cloud projection: port of
pointcloud_depthfusion_tpu/ops/render.py, every render mode.

- ``tiled`` and ``exact``: per target pixel, the point with the smallest
  f32 depth wins, ties go to the smaller packed RGB; the image carries the
  winner's exact RGB888 and the z-buffer its exact f32 depth (FLT_MAX where
  empty). Both run the resolve as kernel B1 (image only) or B2 (image and
  z-buffer), ops/cuda/zresolve_cuda.py.
- ``packed``: one scatter-min of ``zq14 << 18 | RGB666`` keys, decoded by
  :func:`_decode_packed_planes` alone.
- ``indexed``: one scatter-min of ``zq << idx_bits | point_index`` keys,
  then one row gather of the winner's exact RGB888 and f32 depth.

The packed and indexed keys are uint32 in the JAX package. torch has no
uint32 arithmetic, so a key travels as the bit pattern of an int32 tensor
(0xFFFFFFFF is -1) and every shift, compare and min on it runs in int64
(``zresolve_cuda.u32_value`` / ``u32_bits``). The scatter-min is
``zresolve_cuda.scatter_min_u32``.

Op order follows the JAX package: reciprocal then multiply in the planar
paths, division in the (N, 3) ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, zresolve_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda.filters_cuda import decode_winner_planes
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import (
    INT32_MAX,
    INVALID_PIX,
    U32_EMPTY,
    u32_bits,
    u32_value,
)

FLT_MAX = torch.finfo(torch.float32).max
# f32 → i32 casts outside the i32 range are undefined in C and torch; XLA
# saturates. Clamping to ±2^30 first keeps every in-bounds result exact and
# every out-of-bounds one out of bounds.
_CAST_LIMIT = float(1 << 30)
#: Depth levels of the packed key's 14-bit zq.
_Z_LEVELS_14 = float((1 << 14) - 1)
_FLT_MAX_BITS = 0x7F7FFFFF


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _pixels(image_x, image_y, valid, pos_z, intrinsics: Intrinsics, mirror: bool):
    """C-cast ``(int)(x + 0.5)`` truncation toward zero (kernels.cu:249-250),
    the bounds test, then the mirror: (flat index, in_bounds), ``w*h`` as the
    dump index of masked-out points."""
    w, h = intrinsics.width, intrinsics.height
    px = torch.clamp(image_x + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    py = torch.clamp(image_y + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    in_bounds = valid & pos_z & (px >= 0) & (py >= 0) & (px <= w - 1) & (py <= h - 1)
    if mirror:
        px = (w - 1) - px
    return torch.where(in_bounds, py * w + px, w * h), in_bounds


def compute_pixel_indices(
    points: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 3) points → (flat index, z, in_bounds), dividing by ``safe_z``
    as the JAX (N, 3) path does (render.py:59-61)."""
    z = points[..., 2]
    pos_z = z > 0
    safe_z = torch.where(pos_z, z, 1.0)
    image_x = intrinsics.ppx + intrinsics.fx * points[..., 0] / safe_z
    image_y = intrinsics.ppy + intrinsics.fy * points[..., 1] / safe_z
    flat, in_bounds = _pixels(image_x, image_y, valid, pos_z, intrinsics, mirror)
    return flat, z, in_bounds


def compute_pixel_indices_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project coordinate planes to flat pixel indices: reciprocal then
    multiply (render.py:98-100). Returns (flat, z, in_bounds)."""
    pos_z = z > 0
    inv_z = torch.reciprocal(torch.where(pos_z, z, 1.0))
    image_x = intrinsics.ppx + intrinsics.fx * x * inv_z
    image_y = intrinsics.ppy + intrinsics.fy * y * inv_z
    flat, in_bounds = _pixels(image_x, image_y, valid, pos_z, intrinsics, mirror)
    return flat, z, in_bounds


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


# -- tiled and exact: the exact winner through B1/B2 -------------------------


def _resolve_exact(idx, zc, ok, rgb24, n_px: int, need_zbuf: bool):
    """Exact winners of flat entries: (packed winner rgb, min z bits or
    None), INT32_MAX where no entry landed. Dropped entries carry
    INVALID_PIX and MAX fields."""
    okf = ok.reshape(-1)
    pix = torch.where(okf, idx.reshape(-1), INVALID_PIX)
    zbits = torch.where(okf, zc.to(torch.float32).reshape(-1).view(torch.int32), INT32_MAX)
    rgb = torch.where(okf, rgb24.to(torch.int32).reshape(-1), INT32_MAX)
    if need_zbuf:
        minz, mrgb = zresolve_cuda.zresolve_sorted_entries(pix, zbits, rgb, n_px)
        return mrgb, minz
    return zresolve_cuda.zresolve_winner_rgb(pix, zbits, rgb, n_px), None


def _zbuf(minz, h: int, w: int) -> torch.Tensor:
    return torch.where(minz != INT32_MAX, minz.view(torch.float32), FLT_MAX).reshape(h, w)


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
    ignored. Returns (image (H, W, 3) u8 or its three planes, zbuf); the
    image is decoded by one launch of kernel B4 (``winner_image``).
    """
    w, h = intrinsics.width, intrinsics.height
    mrgb, zbuf = tiled_winner_planar(x, y, z, r, g, b, valid, intrinsics, mirror,
                                     need_zbuf, rgb24)
    if return_planes:
        covered = mrgb != INT32_MAX
        return tuple(p.reshape(h, w) for p in decode_winner_planes(covered, mrgb)), zbuf
    return filters_cuda.winner_image(mrgb, h, w), zbuf


def tiled_winner_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    r: Optional[torch.Tensor],
    g: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    need_zbuf: bool = True,
    rgb24: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The resolve of :func:`project_zbuffer_tiled_planar` before its
    decode: (packed winner rgb (H·W,) int32, INT32_MAX exactly where
    uncovered; zbuf (H, W) or None). A valid entry's rgb24 lies below
    INT32_MAX, so the winner alone marks coverage, with or without the
    z-buffer."""
    w, h = intrinsics.width, intrinsics.height
    idx, zc, ok = compute_pixel_indices_planar(x, y, z, valid, intrinsics, mirror)
    if rgb24 is None:
        rgb24 = (r.to(torch.int32) << 16) | (g.to(torch.int32) << 8) | b.to(torch.int32)
    mrgb, minz = _resolve_exact(idx, zc, ok, rgb24, w * h, need_zbuf)
    return mrgb, None if minz is None else _zbuf(minz, h, w)


def project_zbuffer_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    r: Optional[torch.Tensor],
    g: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    rgb24: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact render (render_mode="exact"): the tiled contract, always
    with the z-buffer, returned as an (H, W, 3) image. The JAX package
    sorts and scatters; the port runs B2."""
    return project_zbuffer_tiled_planar(x, y, z, r, g, b, valid, intrinsics, mirror,
                                        need_zbuf=True, rgb24=rgb24)


def project_zbuffer(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    background: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact render of (..., 3) points with (..., 3) uint8 colors: (image
    (H, W, 3) uint8, zbuf (H, W) f32, FLT_MAX where empty). ``background``:
    optional (H, W, 3) uint8 fill for uncovered pixels (black otherwise)."""
    w, h = intrinsics.width, intrinsics.height
    flat = points.reshape(-1, 3).to(torch.float32)
    idx, zc, ok = compute_pixel_indices(flat, valid.reshape(-1), intrinsics, mirror)
    mrgb, minz = _resolve_exact(idx, zc, ok, pack_rgb(colors.reshape(-1, 3)), w * h, True)
    covered = mrgb != INT32_MAX
    img = unpack_rgb(torch.where(covered, mrgb, 0)).reshape(h, w, 3)
    if background is not None:
        img = torch.where(covered.reshape(h, w, 1), img, background)
    return img, _zbuf(minz, h, w)


# -- packed: one u32 scatter-min of zq14 << 18 | RGB666 -----------------------


def _decode_packed_planes(buf: torch.Tensor, z_near, z_far):
    """Decode a flat packed (zq14|RGB666) min-buffer (int32 bits) into
    (r, g, b) u8 planes and the f32 zbuf (FLT_MAX where uncovered, color
    black). The one decode of the packed layout: every packed path goes
    through it."""
    covered = buf != U32_EMPTY
    key = torch.where(covered, u32_value(buf), 0)
    planes = []
    for shift in (12, 6, 0):
        c6 = (key >> shift) & 0x3F
        planes.append(((c6 << 2) | (c6 >> 4)).to(torch.uint8))
    z_near, z_far = _f32(z_near, buf.device), _f32(z_far, buf.device)
    # A 0-d device divisor: a host scalar would make CUDA multiply by its
    # reciprocal.
    z_levels = torch.full((), _Z_LEVELS_14, dtype=torch.float32, device=buf.device)
    zq = (key >> 18).to(torch.float32) / z_levels * (z_far - z_near) + z_near
    return (*planes, torch.where(covered, zq, FLT_MAX))


def unpack_packed_buffer(buf: torch.Tensor, intrinsics: Intrinsics, z_near, z_far):
    """Decode an (H·W,) packed min-buffer into (image (H, W, 3), zbuf)."""
    h, w = intrinsics.height, intrinsics.width
    rp, gp, bp, zbuf = _decode_packed_planes(buf, z_near, z_far)
    return torch.stack([rp, gp, bp], dim=-1).reshape(h, w, 3), zbuf.reshape(h, w)


def _rgb666(r, g, b, rgb24) -> torch.Tensor:
    """RGB666 key bits (int64) from u8 planes, or from the rgb24 plane
    (the same bits)."""
    if rgb24 is None:
        return (((r.to(torch.int64) >> 2) << 12) | ((g.to(torch.int64) >> 2) << 6)
                | (b.to(torch.int64) >> 2))
    p24 = rgb24.to(torch.int64)
    return (((p24 >> 18) & 0x3F) << 12) | (((p24 >> 10) & 0x3F) << 6) | ((p24 >> 2) & 0x3F)


def _packed_render(idx, zc, ok, rgb666, n_px: int, z_near, z_far):
    """Key, scatter-min and decode: (r, g, b, zbuf) flat planes. zq is
    clipped to z_levels - 1, so a far near-white point's key never equals
    the 0xFFFFFFFF sentinel (render.py:194-199)."""
    z_near, z_far = _f32(z_near, zc.device), _f32(z_far, zc.device)
    zq = torch.clamp((zc - z_near) / (z_far - z_near) * _Z_LEVELS_14,
                     0.0, _Z_LEVELS_14 - 1.0).to(torch.int64)
    key = torch.where(ok, (zq << 18) | rgb666, 0xFFFFFFFF)
    buf = zresolve_cuda.scatter_min_u32(idx.reshape(-1), u32_bits(key).reshape(-1), n_px)
    return _decode_packed_planes(buf, z_near, z_far)


def project_zbuffer_packed_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    r: Optional[torch.Tensor],
    g: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    z_near=0.25,
    z_far=4.5,
    return_planes: bool = False,
    rgb24: Optional[torch.Tensor] = None,
):
    """Single-scatter packed render of coordinate planes: 14-bit depth and
    RGB666 color. Returns (image (H, W, 3) u8 or its three planes, zbuf
    dequantized, FLT_MAX where empty)."""
    w, h = intrinsics.width, intrinsics.height
    idx, zc, ok = compute_pixel_indices_planar(x, y, z, valid, intrinsics, mirror)
    ro, go, bo, zbuf = _packed_render(idx, zc, ok, _rgb666(r, g, b, rgb24), w * h,
                                      z_near, z_far)
    ro, go, bo = (p.reshape(h, w) for p in (ro, go, bo))
    if return_planes:
        return (ro, go, bo), zbuf.reshape(h, w)
    return torch.stack([ro, go, bo], dim=-1), zbuf.reshape(h, w)


def project_zbuffer_packed(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    z_near=0.25,
    z_far=4.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed render of (..., 3) points (division in the projection)."""
    w, h = intrinsics.width, intrinsics.height
    col = colors.reshape(-1, 3)
    idx, zc, ok = compute_pixel_indices(points.reshape(-1, 3), valid.reshape(-1),
                                        intrinsics, mirror)
    rp, gp, bp, zbuf = _packed_render(idx, zc, ok, _rgb666(col[:, 0], col[:, 1], col[:, 2], None),
                                      w * h, z_near, z_far)
    return torch.stack([rp, gp, bp], dim=-1).reshape(h, w, 3), zbuf.reshape(h, w)


# -- indexed: one u32 scatter-min of zq << idx_bits | point index -------------


def _index_bits_for(n_pts: int) -> int:
    """Bits to address point indices 0..n_pts-1 with the all-ones key
    unreachable (an index space of n_pts + 1)."""
    return max(1, n_pts.bit_length())


def indexed_winner_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    z_near=0.25,
    z_far=4.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner selection of the indexed render: (covered (n_px,) bool,
    winner point index (n_px,) int32, 0 where uncovered). Ties within a
    depth bin go to the lowest point index."""
    w, h = intrinsics.width, intrinsics.height
    n_pts = x.numel()
    idx_bits = _index_bits_for(n_pts)
    zq_bits = 32 - idx_bits
    if zq_bits < 8:
        raise ValueError(
            f"{n_pts} points leave only {zq_bits} depth bits; "
            "split the scatter per camera group"
        )
    # The f32 value of 2^zq_bits - 1, which rounds up to 2^zq_bits for
    # zq_bits >= 25; the integer re-clamp below keeps the shift from wrapping.
    z_levels = float(np.float32((1 << zq_bits) - 1))
    idx, zc, ok = compute_pixel_indices_planar(x, y, z, valid, intrinsics, mirror)
    z_near, z_far = _f32(z_near, z.device), _f32(z_far, z.device)
    zq = torch.clamp((zc - z_near) / (z_far - z_near) * z_levels, 0.0, z_levels).to(torch.int64)
    zq = torch.clamp_max(zq, (1 << zq_bits) - 1)
    point_id = torch.arange(n_pts, dtype=torch.int64, device=z.device).reshape(zq.shape)
    key = torch.where(ok, (zq << idx_bits) | point_id, 0xFFFFFFFF)
    buf = zresolve_cuda.scatter_min_u32(idx.reshape(-1), u32_bits(key).reshape(-1), w * h)
    covered = buf != U32_EMPTY
    widx = torch.where(covered, u32_value(buf) & ((1 << idx_bits) - 1), 0).to(torch.int32)
    return covered, widx


def indexed_winner_gather(
    covered: torch.Tensor,
    widx: torch.Tensor,
    z: torch.Tensor,
    r: Optional[torch.Tensor],
    g: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    rgb24: Optional[torch.Tensor] = None,
):
    """The winners' exact RGB888 and f32 depth by one row gather from an
    (n_pts, 2) table of (packed RGB, z bits). Returns flat (r, g, b u8,
    zbuf f32) over the pixels."""
    if rgb24 is None:
        rgb24 = (r.to(torch.int32) << 16) | (g.to(torch.int32) << 8) | b.to(torch.int32)
    table = torch.stack([rgb24.to(torch.int32).reshape(-1),
                         z.to(torch.float32).reshape(-1).view(torch.int32)], dim=-1)
    rows = table[widx.to(torch.int64)]
    win_rgb = torch.where(covered, rows[:, 0], 0)
    win_z = torch.where(covered, rows[:, 1], _FLT_MAX_BITS)
    rp, gp, bp = decode_winner_planes(covered, win_rgb)
    return rp, gp, bp, win_z.view(torch.float32)


def project_zbuffer_indexed_planar(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    r: torch.Tensor,
    g: torch.Tensor,
    b: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    z_near=0.25,
    z_far=4.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-scatter render with the exact winner color and depth, the
    winner chosen within one depth quantization step."""
    w, h = intrinsics.width, intrinsics.height
    covered, widx = indexed_winner_planar(x, y, z, valid, intrinsics, mirror, z_near, z_far)
    rp, gp, bp, zbuf = indexed_winner_gather(covered, widx, z, r, g, b)
    return torch.stack([rp, gp, bp], dim=-1).reshape(h, w, 3), zbuf.reshape(h, w)


def project_zbuffer_indexed(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    mirror: bool = False,
    z_near=0.25,
    z_far=4.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3)-input wrapper of :func:`project_zbuffer_indexed_planar`."""
    flat = points.reshape(-1, 3).to(torch.float32)
    col = colors.reshape(-1, 3)
    return project_zbuffer_indexed_planar(
        flat[:, 0], flat[:, 1], flat[:, 2], col[:, 0], col[:, 1], col[:, 2],
        valid.reshape(-1), intrinsics, mirror, z_near, z_far,
    )
