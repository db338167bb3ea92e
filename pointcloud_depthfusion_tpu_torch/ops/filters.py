"""Dense image filters: the main-path subset of
pointcloud_depthfusion_tpu/ops/filters.py.

Depth filtering (min/max window, validity mask, ROI) and the fused image's
3×3 color filters. The 3×3 filters run as kernel B4
(ops/cuda/filters_cuda.py). Morphology and the remaining filters are not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _u16_threshold(meters, depth_scale, device) -> torch.Tensor:
    """``(u16)(meters_f32 / scale_f32)``: f32 division, then truncation
    (0.5 / 0.001 in f32 is 499.99997, so 499)."""
    q = _f32(meters, device) / _f32(depth_scale, device)
    return torch.clamp(q, 0.0, 65535.0).to(torch.int32)


def filter_depth_minmax(depth: torch.Tensor, depth_scale, min_depth, max_depth) -> torch.Tensor:
    """Zero out raw depth outside [min_depth, max_depth] meters, with the
    thresholds truncated to the u16 grid like NPP (kernels.cu:357-359).
    ``depth`` holds u16 values in any integer dtype."""
    depth = depth.to(torch.int32)
    lo = _u16_threshold(min_depth, depth_scale, depth.device)
    hi = _u16_threshold(max_depth, depth_scale, depth.device)
    keep = (depth >= lo) & (depth <= hi)
    return torch.where(keep, depth, 0)


def _clamped_roi(height: int, width: int, roi) -> Tuple[int, int, int, int]:
    """[x, y, w, h] clamping: negative fields select the full image; a box
    past the image keeps its origin and clips at the edge (the reference
    instead resets the size and overruns rows, kernels.cu:381-382)."""
    x0, y0, rw, rh = (int(v) for v in roi)
    x0 = max(x0, 0)
    y0 = max(y0, 0)
    rw = width if (rw < 0 or x0 + rw > width) else rw
    rh = height if (rh < 0 or y0 + rh > height) else rh
    return x0, y0, rw, rh


def roi_mask(height: int, width: int, roi: Optional[Sequence[int]], device=None) -> torch.Tensor:
    """Rectangular ROI mask [x, y, w, h] as an (H, W) bool tensor."""
    m = torch.zeros((height, width), dtype=torch.bool, device=device)
    if roi is None:
        return m.fill_(True)
    x0, y0, rw, rh = _clamped_roi(height, width, roi)
    m[y0:y0 + rh, x0:x0 + rw] = True
    return m


def depth_validity_mask(depth: torch.Tensor, roi: Optional[Sequence[int]] = None) -> torch.Tensor:
    """depth > 0 within the ROI (kernels.cu:371-395)."""
    h, w = depth.shape
    valid = depth > 0
    if roi is not None:
        valid = valid & roi_mask(h, w, roi, depth.device)
    return valid


def filter_depth(
    depth: torch.Tensor,
    depth_scale,
    min_depth,
    max_depth,
    roi: Optional[Sequence[int]] = None,
    use_morphology: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """minmax → mask(ROI) (DepthFrame::filter, depth_frame.cpp:153-182).

    Returns (filtered depth as int32, valid mask)."""
    if use_morphology:
        raise NotImplementedError(
            "filter_depth(use_morphology=True): morphology is not ported yet (ROADMAP A10)"
        )
    d = filter_depth_minmax(depth, depth_scale, min_depth, max_depth)
    valid = depth_validity_mask(d, roi)
    return torch.where(valid, d, 0), valid


def _per_plane(img: torch.Tensor, fn) -> torch.Tensor:
    if img.dim() == 2:
        return fn(img.contiguous())
    return torch.stack([fn(img[..., c].contiguous()) for c in range(img.shape[-1])], dim=-1)


def _check_3x3(img: torch.Tensor, k: int, interior_roi: bool, what: str) -> None:
    if k != 3 or not interior_roi or img.dtype != torch.uint8:
        raise NotImplementedError(
            f"{what}: only the 3×3 interior-ROI uint8 case is ported (ROADMAP A10)"
        )


def median_filter(img: torch.Tensor, radius: int = 1, interior_roi: bool = True) -> torch.Tensor:
    """Per-channel 3×3 median of an (H, W) or (H, W, C) uint8 image; the
    border keeps its input value (NPP's interior ROI)."""
    _check_3x3(img, 2 * radius + 1, interior_roi, "median_filter")
    return _per_plane(img, filters_cuda.median3x3_plane)


def gauss_filter(img: torch.Tensor, size: int = 3, interior_roi: bool = True) -> torch.Tensor:
    """Per-channel 3×3 binomial Gauss of an (H, W) or (H, W, C) uint8
    image, rounding half up like NPP's fixed point; the border keeps its
    input value."""
    _check_3x3(img, size, interior_roi, "gauss_filter")
    return _per_plane(img, filters_cuda.gauss3x3_plane)


def filter_color(color: torch.Tensor, use_median: bool) -> torch.Tensor:
    """Fused-image color filter on (H, W, 3) uint8: 3×3 median or Gauss,
    per ``use_median_filter`` (kernels.cu:594-653)."""
    return median_filter(color, 1) if use_median else gauss_filter(color, 3)


def filter_color_planar(r, g, b, use_median: bool) -> torch.Tensor:
    """:func:`filter_color` on (H, W) channel planes, stacked to
    (H, W, 3) once."""
    f = filters_cuda.median3x3_plane if use_median else filters_cuda.gauss3x3_plane
    return torch.stack([f(r), f(g), f(b)], dim=-1)
