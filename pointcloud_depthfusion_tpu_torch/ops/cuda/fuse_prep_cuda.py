"""The fused per-pixel prep of ``render_mode="pallas"``: kernel B3
(csrc/fuse_prep.cu) and its plain PyTorch version.

Replaces ``fuse_prep_pallas`` of
pointcloud_depthfusion_tpu/ops/pallas/fuse_prep_pallas.py. Per pixel of one
camera: depth window → metres → pinhole deproject → rigid transform into the
virtual camera → project → C-cast rounding → bounds → mirror. It returns the
flat target index ((H, W) int32, ``w·h`` where invalid) and the packed
z-buffer key ``zq14 << 18 | RGB666`` as uint32 bits in an (H, W) int32
tensor (0xFFFFFFFF, i.e. -1, where invalid), ready for
``zresolve_cuda.scatter_min_u32``.

Pinhole only, like the Pallas kernel (fuse_prep_pallas.py:67-68): inverse
Brown-Conrady intrinsics are not undistorted here, although the packed mode
undistorts them. The port keeps this quirk of the reference.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import u32_bits
from pointcloud_depthfusion_tpu_torch.ops.filters import _u16_threshold

#: Wrapper launches of the kernel.
launches = {"fuse_prep": 0}

Z_LEVELS = float((1 << 14) - 1)
_CAST_LIMIT = float(1 << 30)


def largest_tile_rows(h: int, cap: int = 64) -> int:
    """Largest multiple-of-8 divisor of h, capped; h itself when there is
    none (the JAX package's Mosaic tiling rule, kept for API parity)."""
    for cand in range(min(cap, h), 7, -1):
        if cand % 8 == 0 and h % cand == 0:
            return cand
    return h


def _vec(values, device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device) for v in values])


def camera_params(intrinsics: Intrinsics, depth_scale, device) -> torch.Tensor:
    """The first 5 of the kernel's 25 f32 parameters, those of the source
    camera: fx, fy, ppx, ppy, depth_scale."""
    src = intrinsics
    return _vec((src.fx, src.fy, src.ppx, src.ppy, depth_scale), device)


def pose_params(transform: torch.Tensor, fused_intrinsics: Intrinsics, min_depth, max_depth,
                z_near, z_far, device) -> torch.Tensor:
    """The last 20 of the kernel's parameters, fixed while the camera's pose
    and the config are: the row-major 3×4 transform; target fx, fy, ppx,
    ppy; min_depth, max_depth, z_near, z_far. A caller that fuses many
    frames under one pose builds them once (FusionPipeline does)."""
    dst = fused_intrinsics
    return torch.cat([
        transform.to(device=device, dtype=torch.float32)[:3, :].reshape(-1),
        _vec((dst.fx, dst.fy, dst.ppx, dst.ppy, min_depth, max_depth, z_near, z_far), device),
    ])


def prep_params(depth_scale, min_depth, max_depth, intrinsics: Intrinsics,
                transform: torch.Tensor, fused_intrinsics: Intrinsics, z_near, z_far,
                device, pose: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's (25,) f32 parameters on ``device``: :func:`camera_params`
    then :func:`pose_params` (``pose`` when the caller has built them)."""
    if pose is None:
        pose = pose_params(transform, fused_intrinsics, min_depth, max_depth, z_near, z_far,
                           device)
    return torch.cat([camera_params(intrinsics, depth_scale, device), pose])


def fuse_prep_plain(depth, color, depth_scale, min_depth, max_depth, intrinsics: Intrinsics,
                    transform, fused_intrinsics: Intrinsics, mirror: bool, z_near, z_far,
                    pose: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fuse_prep`: the kernel's operations one at a
    time, in the JAX op order."""
    p = prep_params(depth_scale, min_depth, max_depth, intrinsics, transform,
                    fused_intrinsics, z_near, z_far, depth.device, pose)
    h, w = depth.shape
    ow, oh = fused_intrinsics.width, fused_intrinsics.height
    d = depth.to(torch.float32)
    lo = _u16_threshold(p[21], p[4], depth.device).to(torch.float32)
    hi = _u16_threshold(p[22], p[4], depth.device).to(torch.float32)
    valid = (d >= lo) & (d <= hi) & (depth > 0)
    z0 = d * p[4]
    u = torch.arange(w, dtype=torch.float32, device=depth.device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    x0 = (u - p[2]) / p[0] * z0
    y0 = (v - p[3]) / p[1] * z0
    x = p[5] * x0 + p[6] * y0 + p[7] * z0 + p[8]
    y = p[9] * x0 + p[10] * y0 + p[11] * z0 + p[12]
    z = p[13] * x0 + p[14] * y0 + p[15] * z0 + p[16]
    pos_z = z > 0
    inv_z = torch.reciprocal(torch.where(pos_z, z, 1.0))
    image_x = p[19] + p[17] * x * inv_z
    image_y = p[20] + p[18] * y * inv_z
    px = torch.clamp(image_x + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    py = torch.clamp(image_y + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    ok = valid & pos_z & (px >= 0) & (py >= 0) & (px <= ow - 1) & (py <= oh - 1)
    if mirror:
        px = (ow - 1) - px
    flat = torch.where(ok, py * ow + px, ow * oh)
    zq = torch.clamp((z - p[23]) / (p[24] - p[23]) * Z_LEVELS, 0.0, Z_LEVELS - 1.0
                     ).to(torch.int64)
    c = color.to(torch.int64)
    rgb666 = ((c[..., 0] >> 2) << 12) | ((c[..., 1] >> 2) << 6) | (c[..., 2] >> 2)
    key = torch.where(ok, (zq << 18) | rgb666, 0xFFFFFFFF)
    return flat, u32_bits(key)


def fuse_prep(depth: torch.Tensor, color: torch.Tensor, depth_scale, min_depth, max_depth,
              intrinsics: Intrinsics, transform: torch.Tensor, fused_intrinsics: Intrinsics,
              mirror: bool, z_near, z_far, tile_rows: Optional[int] = None,
              pose: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat index, packed key bits) for every pixel of one camera.

    ``depth``: (H, W) int32 raw depth; ``color``: (H, W, 3) uint8;
    ``transform``: 4×4 camera → virtual camera. ``pose``: the
    :func:`pose_params` of ``transform`` and the window, when the caller
    keeps them across frames; ``None`` builds them here. ``tile_rows`` is
    accepted for parity with the JAX package and must divide H; the kernel
    does not tile rows."""
    h, w = depth.shape
    if tile_rows is None:
        tile_rows = largest_tile_rows(h)
    if h % tile_rows != 0:
        raise ValueError(f"tile_rows={tile_rows} must divide the image height {h}")
    if depth.dtype != torch.int32 or color.dtype != torch.uint8 or color.shape != (h, w, 3):
        raise ValueError(f"expected (H, W) int32 depth and (H, W, 3) uint8 color, got "
                         f"{tuple(depth.shape)} {depth.dtype}, {tuple(color.shape)} {color.dtype}")
    if color.device != depth.device:
        raise ValueError(f"color on {color.device}, depth on {depth.device}")
    args = (depth_scale, min_depth, max_depth, intrinsics, transform, fused_intrinsics)
    if depth.device.type == "cpu":
        return fuse_prep_plain(depth, color, *args, mirror, z_near, z_far, pose)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if not (depth.is_contiguous() and color.is_contiguous()):
        raise ValueError("expected contiguous depth and color")
    params = prep_params(*args, z_near, z_far, depth.device, pose)
    idx = torch.empty((h, w), dtype=torch.int32, device=depth.device)
    key = torch.empty_like(idx)
    lib = _build.load()
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    _build.check(
        lib.fuse_prep_launch(depth.data_ptr(), color.data_ptr(), params.data_ptr(), h, w,
                             fused_intrinsics.width, fused_intrinsics.height, int(mirror),
                             idx.data_ptr(), key.data_ptr(), stream),
        "fuse_prep_launch",
    )
    launches["fuse_prep"] += 1
    return idx, key
