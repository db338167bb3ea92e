"""Dense image filters: port of pointcloud_depthfusion_tpu/ops/filters.py.

The reference's NPP filter suite and the rs2 post-processing filters, on
tensors of one device:

  * minmax threshold, >0 mask with ROI, mask count;
  * morphology with the 21-point element (5×5 less its corners), on
    kernel B6 (ops/cuda/morph_cuda.py): one launch for up to four passes,
    and ``filter_depth(use_morphology=True)`` whole in one launch;
  * median and binomial Gauss filters; the 3×3 uint8 case of an (H, W)
    or (H, W, C) image runs as kernel B4 (ops/cuda/filters_cuda.py), one
    launch per four channels;
  * the spatial edge-preserving filter on its row-scan kernel
    (ops/cuda/spatial_cuda.py);
  * bilateral, temporal, hole fill, decimation and the disparity
    transforms (plain PyTorch, as the JAX package computes them outside
    any Pallas kernel).

Depth holds u16 values in any integer dtype; depth outputs are int32 (the
port's depth convention, core/frameset.py) unless a function says
otherwise. Scalars enter as 0-d f32 tensors on the data's device: a CPU
scalar divisor makes CUDA multiply by its reciprocal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, morph_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda.filters_cuda import median9
from pointcloud_depthfusion_tpu_torch.ops.cuda.morph_cuda import u16_threshold as _u16_threshold
from pointcloud_depthfusion_tpu_torch.ops.cuda.spatial_cuda import spatial_filter  # noqa: F401
from pointcloud_depthfusion_tpu_torch.ops.host_filters import spatial_holes_radius  # noqa: F401


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _max_value(t: torch.Tensor) -> float:
    """The saturation value of the stored values: 255 for uint8, else u16."""
    return 255.0 if t.dtype == torch.uint8 else 65535.0


def _replicate_pad(x: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Edge-replicate ``ry`` rows and ``rx`` columns on each side of the
    leading two axes (``jnp.pad(mode="edge")``), by clamped indices."""
    h, w = x.shape[:2]
    if ry:
        x = x[torch.arange(-ry, h + ry, device=x.device).clamp_(0, h - 1)]
    if rx:
        x = x[:, torch.arange(-rx, w + rx, device=x.device).clamp_(0, w - 1)]
    return x


# ---------------------------------------------------------------------------
# Depth range filtering and masks
# ---------------------------------------------------------------------------


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


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of valid pixels, a 0-d int32 tensor (nppiSum,
    kernels.cu:501-540)."""
    return mask.to(torch.int32).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Morphology (kernel B6)
# ---------------------------------------------------------------------------


def _morph(mask: torch.Tensor, passes) -> torch.Tensor:
    """B6's passes (``True`` dilates) over a bool mask: one launch."""
    return morph_cuda.mask_passes(mask.contiguous(), passes)


def erode(mask: torch.Tensor) -> torch.Tensor:
    """Binary erosion of an (H, W) bool mask with the 21-point element."""
    return _morph(mask, (False,))


def dilate(mask: torch.Tensor) -> torch.Tensor:
    """Binary dilation of an (H, W) bool mask with the 21-point element."""
    return _morph(mask, (True,))


def morph_open(mask: torch.Tensor) -> torch.Tensor:
    """Erosion then dilation (nppiMorphOpenBorder, kernels.cu:397-447)."""
    return _morph(mask, (False, True))


def morph_close(mask: torch.Tensor) -> torch.Tensor:
    """Dilation then erosion (nppiMorphCloseBorder, kernels.cu:449-499)."""
    return _morph(mask, (True, False))


def filter_depth(
    depth: torch.Tensor,
    depth_scale,
    min_depth,
    max_depth,
    roi: Optional[Sequence[int]] = None,
    use_morphology: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """minmax → mask(ROI) [→ open/close] (DepthFrame::filter,
    depth_frame.cpp:153-182; morphology is off at the reference call site,
    :175-178).

    As in the JAX package, the mask is opened and closed after the depth is
    thresholded, and the depth is then zeroed outside it: pixels that the
    closing turns on keep depth 0 with ``valid`` True. With morphology the
    whole call is one B6 launch on the card (``depth`` in one of
    ``morph_cuda.DEPTH_KINDS``' dtypes); without it, eager ops.

    Returns (filtered depth as int32, valid mask)."""
    if use_morphology:
        h, w = depth.shape
        box = None
        if roi is not None:
            x0, y0, rw, rh = _clamped_roi(h, w, roi)
            box = (x0, y0, x0 + rw, y0 + rh)
        return morph_cuda.filter_depth_open_close(depth, depth_scale, min_depth, max_depth, box)
    d = filter_depth_minmax(depth, depth_scale, min_depth, max_depth)
    valid = depth_validity_mask(d, roi)
    return torch.where(valid, d, 0), valid


# ---------------------------------------------------------------------------
# Rank / convolution filters
# ---------------------------------------------------------------------------


def _b4_takes(img: torch.Tensor) -> bool:
    """Whether kernel B4 takes ``img``: uint8, (H, W) or (H, W, C ≥ 1)."""
    return img.dtype == torch.uint8 and (img.dim() == 2 or (img.dim() == 3 and img.shape[-1] > 0))


def _b4_image(img: torch.Tensor, mode: str) -> torch.Tensor:
    """Kernel B4 over every channel of ``img``: one launch per group of up
    to four channels."""
    step = filters_cuda.MAX_CHANNELS
    if img.dim() == 2 or img.shape[-1] <= step:
        return filters_cuda.interleaved_image(img.contiguous(), mode)
    return torch.cat([filters_cuda.interleaved_image(img[..., c:c + step].contiguous(), mode)
                      for c in range(0, img.shape[-1], step)], dim=-1)


def _interior_only(filtered: torch.Tensor, original: torch.Tensor, border: int) -> torch.Tensor:
    """Filter output on the interior, input values on the ``border``-pixel
    rim (NPP's offset-ROI convention, kernels.cu:600-609)."""
    h, w = original.shape[:2]
    out = original.clone()
    if h > 2 * border and w > 2 * border:
        out[border:h - border, border:w - border] = filtered[border:h - border,
                                                             border:w - border]
    return out


def _shifted(img: torch.Tensor, radius: int):
    """The (2r+1)² shifted neighborhoods of a replicate-padded 2-D or 3-D
    image, in row-major window order."""
    h, w = img.shape[:2]
    k = 2 * radius + 1
    padded = _replicate_pad(img, radius, radius)
    return [padded[dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)]


def median_filter(img: torch.Tensor, radius: int = 1, interior_roi: bool = True) -> torch.Tensor:
    """Per-channel square median of an (H, W) or (H, W, C) image.

    ``interior_roi=True`` keeps the border's input values (the NPP call
    pattern). The 3×3 interior uint8 case runs as kernel B4; radius 1
    otherwise uses the same 19-exchange network, larger radii a sort."""
    if radius == 1 and interior_roi and _b4_takes(img):
        return _b4_image(img, "median")
    taps = _shifted(img, radius)
    if radius == 1:
        med = median9(taps)
    else:
        med = torch.sort(torch.stack(taps), dim=0).values[len(taps) // 2]
    return _interior_only(med, img, radius) if interior_roi else med


def _gauss_kernel_1d(size: int) -> np.ndarray:
    """NPP's fixed Gauss kernels are binomial: 3 → [1,2,1]/4, 5 → [1,4,6,4,1]/16."""
    k = np.array([1.0])
    for _ in range(size - 1):
        k = np.convolve(k, [1.0, 1.0])
    return k / k.sum()


def gauss_filter(img: torch.Tensor, size: int = 3, interior_roi: bool = True) -> torch.Tensor:
    """Separable binomial Gauss of an (H, W) or (H, W, C) uint8 or u16
    image, same dtype out, rounding half up like NPP's fixed point.

    The 3×3 interior uint8 case runs as kernel B4. The rest is f32
    shifted sums in the JAX order, rows then columns, each pass over a
    replicate-padded input: every product and sum is exact in f32 up to the
    5×5 u16 case (256·65535 < 2²⁴), so ``floor(x + 0.5)`` is NPP's
    rounding. No convolution call: cuDNN would run it in TF32."""
    if size == 3 and interior_roi and _b4_takes(img):
        return _b4_image(img, "gauss")
    radius = size // 2
    k1 = _gauss_kernel_1d(size)
    x = img.to(torch.float32)
    h, w = x.shape[:2]
    xp = _replicate_pad(x, radius, 0)
    rows = sum(_f32(k1[i], x.device) * xp[i:i + h] for i in range(size))
    rp = _replicate_pad(rows, 0, radius)
    out = sum(_f32(k1[i], x.device) * rp[:, i:i + w] for i in range(size))
    out = torch.clamp(torch.floor(out + 0.5), 0.0, _max_value(img)).to(img.dtype)
    return _interior_only(out, img, radius) if interior_roi else out


def filter_color(color: torch.Tensor, use_median: bool) -> torch.Tensor:
    """Fused-image color filter on (H, W, 3) uint8: 3×3 median or Gauss,
    per ``use_median_filter`` (kernels.cu:594-653)."""
    return median_filter(color, 1) if use_median else gauss_filter(color, 3)


def filter_color_planar(r, g, b, use_median: bool) -> torch.Tensor:
    """:func:`filter_color` on (H, W) channel planes, written as the
    (H, W, 3) image by one B4 launch."""
    return filters_cuda.planes_image((r, g, b), "median" if use_median else "gauss")


def bilateral_filter_depth(
    depth: torch.Tensor,
    radius: int = 10,
    val_square_sigma: float = 9_000_000.0,
    pos_square_sigma: float = 10_000.0,
) -> torch.Tensor:
    """Bilateral Gauss on u16 depth (kernels.cu:749-779 parameters);
    returns int32.

    Accumulates in f32 with the spatial weight rounded to f32, as the JAX
    package computes without x64 (with x64 its numpy f64 spatial weight
    makes the sums f64). (2r+1)² shifted windows: off the hot path."""
    h, w = depth.shape
    dev = depth.device
    x = depth.to(torch.float32)
    k = 2 * radius + 1
    padded = _replicate_pad(x, radius, radius)
    two_val = _f32(2.0 * val_square_sigma, dev)
    num = torch.zeros((h, w), dtype=torch.float32, device=dev)
    den = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dy in range(k):
        for dx in range(k):
            win = padded[dy:dy + h, dx:dx + w]
            gd = (dy - radius) ** 2 + (dx - radius) ** 2
            wg = _f32(np.exp(-gd / (2.0 * pos_square_sigma)), dev)
            vd = (win - x) ** 2
            wgt = wg * torch.exp(-vd / two_val)
            num = num + wgt * win
            den = den + wgt
    out = num / torch.maximum(den, _f32(1e-12, dev))
    return torch.clamp(torch.round(out), 0.0, 65535.0).to(torch.int32)


# ---------------------------------------------------------------------------
# Temporal filter (rs2::temporal_filter)
# ---------------------------------------------------------------------------


def temporal_filter(
    depth: torch.Tensor,
    prev: torch.Tensor,
    alpha: float = 0.4,
    delta: float = 20.0,
    persistence: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the temporal EMA filter (smooth_alpha 0.4,
    realsense.cpp:249; delta 20): where the current and previous frames are
    both valid and within ``delta``, ``alpha·cur + (1-alpha)·prev``; where
    the current frame is a hole and ``persistence`` is on, the previous
    value. Rounds half to even. Returns (filtered, new history), int32."""
    dev = depth.device
    cur = depth.to(torch.float32)
    prv = prev.to(torch.float32)
    have_both = (cur > 0) & (prv > 0)
    close = torch.abs(cur - prv) <= _f32(delta, dev)
    blended = _f32(alpha, dev) * cur + _f32(1.0 - alpha, dev) * prv
    out = torch.where(have_both & close, blended, cur)
    if persistence:
        out = torch.where((cur == 0) & (prv > 0), prv, out)
    out = torch.clamp(torch.round(out), 0.0, 65535.0).to(torch.int32)
    return out, out


# ---------------------------------------------------------------------------
# Hole filling (rs2::hole_filling_filter)
# ---------------------------------------------------------------------------


def hole_fill(depth: torch.Tensor, mode: str = "farthest") -> torch.Tensor:
    """Fill zero-depth holes (rs2 hole-filling modes; HOLES_FILL=1,
    realsense.cpp:250); returns int32.

      * ``left``     — the last valid value to the left in the row (0 where
        none), as a running max of valid column indices and a gather;
      * ``farthest`` — the largest value of the 3×3 neighborhood;
      * ``nearest``  — the smallest valid value of the 3×3 neighborhood.
    """
    d = depth.to(torch.int32)
    hole = d == 0
    if mode == "left":
        cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
        src = torch.where(d > 0, cols, 0).cummax(dim=1).values
        return torch.where(hole, torch.gather(d, 1, src), d)
    taps = torch.stack(_shifted(d, 1))
    if mode == "farthest":
        nb = taps.max(dim=0).values
    elif mode == "nearest":
        big = torch.where(taps > 0, taps, 1 << 30)
        nb = big.min(dim=0).values
        nb = torch.where(nb == (1 << 30), 0, nb)
    else:
        raise ValueError(f"unknown hole_fill mode {mode!r}")
    return torch.where(hole, nb, d)


# ---------------------------------------------------------------------------
# Decimation filter (rs2::decimation_filter)
# ---------------------------------------------------------------------------


def decimation_filter(depth: torch.Tensor, magnitude: int = 2) -> torch.Tensor:
    """Per-block upper median (``sorted[count // 2]``) of the nonzero
    depths of each magnitude×magnitude block, 0 where the block is all
    holes (FILTER_MAGNITUDE 2, realsense.cpp:244). Output (H/m, W/m) int32;
    ``magnitude <= 1`` returns the input."""
    h, w = depth.shape
    m = int(magnitude)
    if m <= 1:
        return depth
    if h % m or w % m:
        raise ValueError(f"image {h}x{w} not divisible by magnitude {m}")
    vals = (depth.to(torch.int32).reshape(h // m, m, w // m, m)
            .permute(0, 2, 1, 3).reshape(h // m, w // m, m * m))
    s = torch.sort(vals, dim=-1).values  # zeros first, then nonzero ascending
    count = (vals > 0).sum(dim=-1)
    k = m * m
    idx = torch.clamp(k - count + count // 2, 0, k - 1)
    med = torch.gather(s, -1, idx[..., None])[..., 0]
    return torch.where(count > 0, med, 0)


def decimate_intrinsics(intr: Intrinsics, magnitude: int = 2) -> Intrinsics:
    """Intrinsics of a decimated stream: every linear quantity divided by
    the magnitude (librealsense's decimated stream profile)."""
    m = int(magnitude)
    if m <= 1:
        return intr
    return Intrinsics.create(
        intr.width // m,
        intr.height // m,
        fx=float(intr.fx) / m,
        fy=float(intr.fy) / m,
        ppx=float(intr.ppx) / m,
        ppy=float(intr.ppy) / m,
        model=intr.model,
        coeffs=intr.coeffs.cpu().numpy(),
        device=intr.device,
    )


# ---------------------------------------------------------------------------
# Spatial edge-preserving filter (rs2::spatial_filter)
# ---------------------------------------------------------------------------


# ``spatial_filter`` (imported above) runs the recurrence as kernel code:
# ops/cuda/spatial_cuda.py, whose plain version is the eager loop.


# ---------------------------------------------------------------------------
# Disparity transforms (rs2::disparity_transform)
# ---------------------------------------------------------------------------


def depth_to_disparity(depth: torch.Tensor, depth_scale, fx, baseline_m: float = 0.095
                       ) -> torch.Tensor:
    """u16 depth → f32 disparity in pixels, ``fx · baseline / depth_m``;
    0 depth maps to 0 (realsense.cpp:240-241; D455 baseline ~95 mm)."""
    dev = depth.device
    depth_m = depth.to(torch.float32) * _f32(depth_scale, dev)
    factor = _f32(fx, dev) * _f32(baseline_m, dev)
    out = factor / torch.maximum(depth_m, _f32(1e-9, dev))
    return torch.where(depth > 0, out, _f32(0.0, dev))


def disparity_to_depth(disparity: torch.Tensor, depth_scale, fx, baseline_m: float = 0.095
                       ) -> torch.Tensor:
    """f32 disparity → u16 depth as int32 (inverse of
    :func:`depth_to_disparity`, rounded half to even)."""
    dev = disparity.device
    factor = _f32(fx, dev) * _f32(baseline_m, dev)
    depth_m = torch.where(disparity > 0, factor / torch.maximum(disparity, _f32(1e-9, dev)),
                          _f32(0.0, dev))
    raw = depth_m / _f32(depth_scale, dev)
    return torch.clamp(torch.round(raw), 0.0, 65535.0).to(torch.int32)
