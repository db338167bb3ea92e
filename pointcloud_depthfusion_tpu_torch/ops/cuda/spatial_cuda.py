"""The rs2 spatial edge-preserving filter: its recurrence as a row-scan
kernel (csrc/spatial.cu) and its plain PyTorch version.

Not a Pallas kernel: replaces the ``lax.scan`` of ``spatial_filter`` in
pointcloud_depthfusion_tpu/ops/filters.py. Per iteration, recursive EMA
sweeps left→right, right→left, top→bottom and bottom→top, each step gated
on the already filtered neighbour. The kernel runs one line a thread: two
launches an iteration (rows, then columns), reading the caller's dtype in
the first and writing it in the last.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
from pointcloud_depthfusion_tpu_torch.ops.host_filters import spatial_holes_radius

#: Wrapper launches of the kernels (2 an iteration).
launches = {"spatial_filter": 0}

#: The dtypes the kernel takes, by its Kind code (float32: the disparity
#: domain; the rest: integer depth, rounded half up and clamped to u16).
KINDS = {torch.float32: 0, torch.uint16: 1, torch.int32: 2, torch.int64: 3}


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _sweep_rows(xt: torch.Tensor, alpha, one_m_alpha, delta, integer_domain: bool,
                holes_radius: int = 0) -> torch.Tensor:
    """One recursive EMA sweep of (W, H) ``xt`` along its first axis, in
    place: row u blends with the already-filtered row u-1 where both are
    valid and within ``delta``. ``holes_radius > 0`` first fills a hole
    with the carried value while the run of holes is within the radius.
    The JAX package's ``lax.scan``, one step per row."""
    prev = xt[0]
    run = torch.zeros_like(prev, dtype=torch.int32)
    half = _f32(0.5, xt.device)
    for u in range(1, xt.shape[0]):
        col = xt[u]
        if holes_radius:
            is_hole = col == 0
            run = torch.where(is_hole, run + 1, 0)
            fill = is_hole & (prev > 0) & (run <= holes_radius)
            col = torch.where(fill, prev, col)
        gate = (col > 0) & (prev > 0) & (torch.abs(col - prev) <= delta)
        blended = col * alpha + prev * one_m_alpha
        if integer_domain:
            # librealsense stores (T)(filtered + 0.5f): round half up.
            blended = torch.floor(blended + half)
        prev = torch.where(gate, blended, col)
        xt[u] = prev
    return xt


def spatial_filter_plain(depth: torch.Tensor, alpha: float = 0.55, delta: float = 20.0,
                         magnitude: int = 2, holes_fill: int = 0) -> torch.Tensor:
    """Plain version of :func:`spatial_filter`: one step of ~10 eager ops
    a column and a row, about 8,000 steps at 1280×720."""
    holes_radius = spatial_holes_radius(holes_fill, depth.shape[1])
    integer_domain = not torch.is_floating_point(depth)
    dev = depth.device
    a, b, dl = _f32(alpha, dev), _f32(1.0 - alpha, dev), _f32(delta, dev)
    # (W, H): the horizontal sweeps walk contiguous rows of the transpose,
    # in place on a copy (for an f32 line, .t().contiguous() is a view).
    xt = depth.to(torch.float32, copy=True).t().contiguous()
    for _ in range(int(magnitude)):
        _sweep_rows(xt, a, b, dl, integer_domain, holes_radius)  # left→right
        xt = _sweep_rows(xt.flip(0), a, b, dl, integer_domain).flip(0)
        x = xt.t().contiguous()
        _sweep_rows(x, a, b, dl, integer_domain)  # top→bottom
        x = _sweep_rows(x.flip(0), a, b, dl, integer_domain).flip(0)
        xt = x.t().contiguous()
    x = xt.t().contiguous()
    if integer_domain:
        return torch.clamp(x, 0.0, 65535.0).to(depth.dtype)
    return x


def spatial_filter(depth: torch.Tensor, alpha: float = 0.55, delta: float = 20.0,
                   magnitude: int = 2, holes_fill: int = 0) -> torch.Tensor:
    """rs2 spatial edge-preserving filter of an (H, W) plane: per
    iteration, recursive EMA sweeps left→right, right→left, top→bottom and
    bottom→top, each gated on the already-filtered neighbor; ``magnitude``
    iterations (smooth_alpha 0.55, realsense.cpp:248; delta 20 and
    magnitude 2 are librealsense's defaults). Integer depth rounds half up
    and returns its own dtype; f32 disparity stays f32. ``holes_fill``
    1..5 fills holes during the left→right sweep
    (``host_filters.spatial_holes_radius``: outside 0..5 raises; the C++
    mirror clamps instead, ADVICE.md:7).

    On the card: ``2 · magnitude`` launches of the row-scan kernel (one for
    ``magnitude`` 0, the conversion) and no other device op; ``depth`` is
    contiguous, in one of :data:`KINDS`' dtypes."""
    if depth.dim() != 2:
        raise ValueError(f"expected an (H, W) plane, got {tuple(depth.shape)}")
    holes_radius = spatial_holes_radius(holes_fill, depth.shape[1])
    if depth.device.type == "cpu":
        return spatial_filter_plain(depth, alpha, delta, magnitude, holes_fill)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if depth.dtype not in KINDS:
        raise ValueError(f"expected one of {sorted(map(str, KINDS))}, got {depth.dtype}")
    if not depth.is_contiguous():
        raise ValueError("expected a contiguous plane")
    h, w = depth.shape
    out = torch.empty_like(depth)
    if depth.numel() == 0:
        return out
    floating = depth.dtype == torch.float32
    work = out if floating else torch.empty((h, w), dtype=torch.float32, device=depth.device)
    magnitude = int(magnitude)
    lib = _build.load()
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    kind = KINDS[depth.dtype]
    _build.check(
        lib.spatial_launch(depth.data_ptr(), kind, work.data_ptr(), out.data_ptr(), kind, h, w,
                           magnitude, ctypes.c_float(alpha), ctypes.c_float(1.0 - alpha),
                           ctypes.c_float(delta), int(not floating), holes_radius, stream),
        "spatial_launch",
    )
    launches["spatial_filter"] += 2 * magnitude if magnitude > 0 else 1
    return out
