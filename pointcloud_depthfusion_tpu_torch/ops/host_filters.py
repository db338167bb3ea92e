"""Host-side rs2 post-processing filters for the camera node's capture
thread: a copy of pointcloud_depthfusion_tpu/ops/host_filters.py.

A device round trip per frame costs more than these filters, so the
camera node runs them on the host, value for value as ``ops.filters``
computes them. The spatial and decimation filters dispatch to the native
host runtime (``runtime``, the port's copy of the C++ filter bank) when it
loads, as the JAX package's do, and so does the temporal step, which the
port adds to that library (``csrc/host/temporal.cpp``); their numpy
versions (``_spatial_filter_numpy``, ``_decimation_filter_numpy``,
``_temporal_filter_numpy``) are the plain versions, value-identical to the
native ones. The card machine's times
for the spatial and decimation filters are in PERF.md §5 (``chip_smoke.py``
phase 13e). The holes_fill
rule is this module's own copy (the JAX package reads it from its
``ops.filters``, which imports jax).
"""

from __future__ import annotations

import numpy as np

from pointcloud_depthfusion_tpu_torch import runtime


def _native():
    """The native runtime when it loads, else None (the numpy versions
    serve)."""
    return runtime if runtime.has_native_filters() else None


def spatial_holes_radius(holes_fill: int, width: int) -> int:
    """rs2 spatial-filter holes_fill option → persistence radius in pixels:
    0 disabled, 1..4 → 2/4/8/16, 5 → unlimited (the row width); outside
    0..5 raises."""
    holes_fill = int(holes_fill)
    if not 0 <= holes_fill <= 5:
        raise ValueError(f"holes_fill must be 0..5, got {holes_fill}")
    if holes_fill == 0:
        return 0
    if holes_fill == 5:
        return int(width)
    return 1 << holes_fill


def decimation_filter_np(depth_u16: np.ndarray, magnitude: int = 2) -> np.ndarray:
    """Block upper-median of nonzero depths (see filters.decimation_filter)."""
    h, w = depth_u16.shape
    m = int(magnitude)
    if m <= 1:
        return depth_u16
    if h % m or w % m:
        raise ValueError(f"image {h}x{w} not divisible by magnitude {m}")
    rt = _native()
    if rt is not None:
        return rt.decimation_filter_native(depth_u16, m)
    return _decimation_filter_numpy(depth_u16, m)


def _decimation_filter_numpy(depth_u16: np.ndarray, m: int) -> np.ndarray:
    h, w = depth_u16.shape
    blocks = depth_u16.reshape(h // m, m, w // m, m)
    vals = np.moveaxis(blocks, (1, 3), (2, 3)).reshape(h // m, w // m, m * m)
    vals = vals.astype(np.int32)
    s = np.sort(vals, axis=-1)
    count = np.sum(vals > 0, axis=-1)
    k = m * m
    idx = np.clip(k - count + count // 2, 0, k - 1)
    med = np.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
    return np.where(count > 0, med, 0).astype(np.uint16)


def _spatial_sweep_np(x: np.ndarray, alpha: float, delta: float,
                      integer_domain: bool, holes_radius: int = 0) -> np.ndarray:
    out = x.copy()
    carry = out[:, 0].copy()
    run = np.zeros(out.shape[0], np.int32)
    for u in range(1, out.shape[1]):
        col = out[:, u]
        if holes_radius:
            is_hole = col == 0
            run = np.where(is_hole, run + 1, 0)
            fill = is_hole & (carry > 0) & (run <= holes_radius)
            col = np.where(fill, carry, col)
        gate = (col > 0) & (carry > 0) & (np.abs(col - carry) <= delta)
        blended = col * alpha + carry * (1.0 - alpha)
        if integer_domain:
            blended = np.floor(blended + 0.5)
        col = np.where(gate, blended, col)
        out[:, u] = col
        carry = col
    return out


def spatial_filter_np(
    depth: np.ndarray,
    alpha: float = 0.55,
    delta: float = 20.0,
    magnitude: int = 2,
    holes_fill: int = 0,
) -> np.ndarray:
    """Four-direction recursive EMA (see filters.spatial_filter).

    Native only for the dtypes the C++ buffers hold exactly (u16 and u8
    depth, f32 disparity): the numpy recursion filters wider integers at
    full value and clips at the end, which a u16 buffer cannot reproduce,
    so those stay on numpy and the result's values and dtype do not depend
    on whether the native runtime loads."""
    spatial_holes_radius(holes_fill, depth.shape[1])
    rt = _native()
    if rt is not None and depth.dtype in (np.uint16, np.uint8, np.float32):
        out = rt.spatial_filter_native(
            depth.astype(np.uint16) if depth.dtype == np.uint8 else depth,
            alpha, delta, magnitude, holes_fill,
        )
        return out.astype(depth.dtype, copy=False)
    return _spatial_filter_numpy(depth, alpha, delta, magnitude, holes_fill)


def _spatial_filter_numpy(depth: np.ndarray, alpha: float = 0.55, delta: float = 20.0,
                          magnitude: int = 2, holes_fill: int = 0) -> np.ndarray:
    holes_radius = spatial_holes_radius(holes_fill, depth.shape[1])
    integer_domain = np.issubdtype(depth.dtype, np.integer)
    x = depth.astype(np.float32)
    for _ in range(int(magnitude)):
        # Hole persistence rides the left→right sweep only.
        x = _spatial_sweep_np(x, alpha, delta, integer_domain, holes_radius=holes_radius)
        x = _spatial_sweep_np(x[:, ::-1], alpha, delta, integer_domain)[:, ::-1]
        xt = x.T.copy()
        xt = _spatial_sweep_np(xt, alpha, delta, integer_domain)
        xt = _spatial_sweep_np(xt[:, ::-1], alpha, delta, integer_domain)[:, ::-1]
        x = xt.T.copy()
    if integer_domain:
        return np.clip(x, 0, 65535).astype(depth.dtype)
    return x


def temporal_runs_native(dtype) -> bool:
    """Whether :func:`temporal_filter_np` takes the native step for frames of
    ``dtype``: u16 depth and f32 disparity, when the runtime loads."""
    return dtype in (np.uint16, np.float32) and _native() is not None


def temporal_filter_np(data: np.ndarray, prev: np.ndarray, alpha: float = 0.4,
                       delta: float = 20.0) -> np.ndarray:
    """One temporal EMA step (see filters.temporal_filter) of ``data``
    against the history ``prev`` (same shape and dtype): the blend where
    both have depth within ``delta``, the history over a hole; integer
    depth rounds half to even. A fresh array, which becomes the history."""
    if temporal_runs_native(data.dtype):
        return runtime.temporal_filter_native(data, prev, alpha, delta)
    return _temporal_filter_numpy(data, prev, alpha, delta)


def _temporal_filter_numpy(data: np.ndarray, prev: np.ndarray, alpha: float,
                           delta: float) -> np.ndarray:
    cur = data.astype(np.float32)
    prev_f = prev.astype(np.float32)
    have_both = (cur > 0) & (prev_f > 0)
    close = np.abs(cur - prev_f) <= delta
    out = np.where(
        have_both & close,
        alpha * cur + (1.0 - alpha) * prev_f,
        cur,
    )
    out = np.where((cur == 0) & (prev_f > 0), prev_f, out)
    if np.issubdtype(data.dtype, np.integer):
        out = np.clip(np.rint(out), 0, 65535)
    return out.astype(data.dtype)


def depth_to_disparity_np(depth_u16: np.ndarray, depth_scale: float, fx: float,
                          baseline_m: float = 0.095) -> np.ndarray:
    depth_m = depth_u16.astype(np.float32) * np.float32(depth_scale)
    factor = np.float32(fx) * np.float32(baseline_m)
    return np.where(
        depth_u16 > 0, factor / np.maximum(depth_m, 1e-9), np.float32(0.0)
    ).astype(np.float32)


def disparity_to_depth_np(disparity: np.ndarray, depth_scale: float, fx: float,
                          baseline_m: float = 0.095) -> np.ndarray:
    factor = np.float32(fx) * np.float32(baseline_m)
    depth_m = np.where(disparity > 0, factor / np.maximum(disparity, 1e-9), np.float32(0.0))
    raw = depth_m / np.float32(depth_scale)
    return np.clip(np.rint(raw), 0, 65535).astype(np.uint16)


def hole_fill_np(depth_u16: np.ndarray, mode: str = "farthest") -> np.ndarray:
    """rs2::hole_filling_filter (HOLES_FILL=1 = farthest-from-around,
    realsense.cpp:250); see filters.hole_fill."""
    d = depth_u16.astype(np.int32)
    hole = d == 0
    if mode == "left":
        h, w = d.shape
        src = np.maximum.accumulate(np.where(d > 0, np.arange(w)[None, :], 0), axis=1)
        filled = d[np.arange(h)[:, None], src]
        return np.where(hole, filled, d).astype(np.uint16)
    pad = np.pad(d, 1, mode="edge")
    stack = np.stack(
        [pad[1 + dy:1 + dy + d.shape[0], 1 + dx:1 + dx + d.shape[1]]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    )
    if mode == "farthest":
        nb = stack.max(axis=0)
    elif mode == "nearest":
        big = np.where(stack > 0, stack, np.int32(1 << 30))
        nb = big.min(axis=0)
        nb = np.where(nb == (1 << 30), 0, nb)
    else:
        raise ValueError(f"unknown hole_fill mode {mode!r}")
    return np.where(hole, nb, d).astype(np.uint16)


def threshold_filter_np(depth_u16: np.ndarray, depth_scale: float,
                        min_dist_m: float = 0.0, max_dist_m: float = 2.0) -> np.ndarray:
    """rs2::threshold_filter (MIN/MAX_DISTANCE 0..2 m, realsense.cpp:242-243):
    zero out depths outside the window."""
    d_m = depth_u16.astype(np.float32) * np.float32(depth_scale)
    keep = (d_m >= min_dist_m) & (d_m <= max_dist_m) & (depth_u16 > 0)
    return np.where(keep, depth_u16, 0).astype(np.uint16)
