"""3×3 color filters on u8 planes: kernel B4 (csrc/filters3x3.cu) and its
plain PyTorch versions.

Replaces ``gauss3x3_plane`` and ``median3x3_plane`` of
pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py: a 3×3 binomial
Gauss with half-up rounding, or a 3×3 median, on the interior; the border
(and any plane smaller than 3×3) passes through. Integer arithmetic only.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

#: Wrapper launches of the kernel, by wrapper name.
launches = {"gauss3x3_plane": 0, "median3x3_plane": 0}


# -- plain versions ---------------------------------------------------------


def _taps(x: torch.Tensor):
    """The nine (h-2, w-2) shifted interior views of an int32 plane."""
    h, w = x.shape
    return [x[dy:h - 2 + dy, dx:w - 2 + dx] for dy in range(3) for dx in range(3)]


def median9(p):
    """Median of nine tensors by the 19-exchange min/max network."""
    def s(a, b):
        return torch.minimum(a, b), torch.maximum(a, b)

    p = list(p)
    p[1], p[2] = s(p[1], p[2]); p[4], p[5] = s(p[4], p[5]); p[7], p[8] = s(p[7], p[8])  # noqa: E702
    p[0], p[1] = s(p[0], p[1]); p[3], p[4] = s(p[3], p[4]); p[6], p[7] = s(p[6], p[7])  # noqa: E702
    p[1], p[2] = s(p[1], p[2]); p[4], p[5] = s(p[4], p[5]); p[7], p[8] = s(p[7], p[8])  # noqa: E702
    p[0], p[3] = s(p[0], p[3]); p[5], p[8] = s(p[5], p[8]); p[4], p[7] = s(p[4], p[7])  # noqa: E702
    p[3], p[6] = s(p[3], p[6]); p[1], p[4] = s(p[1], p[4]); p[2], p[5] = s(p[2], p[5])  # noqa: E702
    p[4], p[7] = s(p[4], p[7]); p[4], p[2] = s(p[4], p[2]); p[6], p[4] = s(p[6], p[4])  # noqa: E702
    p[4], p[2] = s(p[4], p[2])
    return p[4]


def _interior(plane: torch.Tensor, fn) -> torch.Tensor:
    out = plane.clone()
    h, w = plane.shape
    if h >= 3 and w >= 3:
        out[1:h - 1, 1:w - 1] = fn(_taps(plane.to(torch.int32))).to(torch.uint8)
    return out


def gauss3x3_plane_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gauss3x3_plane`: ``(Σ w·x + 8) >> 4``."""
    def gauss(p):
        s = (p[0] + 2 * p[1] + p[2] + 2 * p[3] + 4 * p[4] + 2 * p[5]
             + p[6] + 2 * p[7] + p[8])
        return (s + 8) >> 4

    return _interior(plane, gauss)


def median3x3_plane_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`median3x3_plane`."""
    return _interior(plane, median9)


# -- kernel wrappers --------------------------------------------------------


def _filter(plane: torch.Tensor, median: bool, name: str) -> torch.Tensor:
    if plane.dtype != torch.uint8 or plane.dim() != 2:
        raise ValueError(f"expected an (H, W) uint8 plane, got {tuple(plane.shape)} {plane.dtype}")
    if plane.device.type == "cpu":
        return (median3x3_plane_plain if median else gauss3x3_plane_plain)(plane)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if not plane.is_contiguous():
        raise ValueError("expected a contiguous plane")
    out = torch.empty_like(plane)
    if plane.numel() == 0:
        return out
    h, w = plane.shape
    lib = _build.load()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    _build.check(
        lib.filter3x3_launch(plane.data_ptr(), out.data_ptr(), h, w, int(median), stream),
        "filter3x3_launch",
    )
    launches[name] += 1
    return out


def gauss3x3_plane(plane: torch.Tensor) -> torch.Tensor:
    """3×3 binomial Gauss of one (H, W) uint8 plane, half-up rounding."""
    return _filter(plane, False, "gauss3x3_plane")


def median3x3_plane(plane: torch.Tensor) -> torch.Tensor:
    """3×3 median of one (H, W) uint8 plane."""
    return _filter(plane, True, "median3x3_plane")
