"""The kernels' rooflines: the least time the card could take for a launch.

Every kernel of the frame path moves data and computes little, so its bound
is the bytes it must move at the card's memory bandwidth: each input byte
read once and each output byte written once, from the shapes (the PERF.md
kernel table's arithmetic). The peak is NVIDIA's data sheet figure for one
H100 SXM at its 700 W limit.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12


def fuse_prep_bytes(cameras: int, pixels: int, color_bytes: int) -> int:
    """B3, the masked feed: in, int32 depth and the colour (3 B of uint8 or
    a 4 B rgb24 plane) per pixel; out, idx int32, z f32, ok bool, rgb24
    int32 and the valid plane (bool) per pixel."""
    return cameras * pixels * ((4 + color_bytes) + (4 + 4 + 1 + 4 + 1))


def resolve_bytes(entries: int, pixels: int, zbuf: bool) -> int:
    """The resolve on the masked feed: in, idx, z, ok and rgb24 per entry
    (13 B); out, the winner's rgb24 and, with the z-buffer, its z per
    virtual pixel."""
    return entries * 13 + pixels * (8 if zbuf else 4)


def color3x3_bytes(pixels: int) -> int:
    """B4's image kernel: the packed winner in (4 B), RGB out (3 B)."""
    return pixels * 7


def roofline_pct(trace: dict, kernels) -> Optional[float]:
    """Sum of the frame kernels' bounds over the sum of their device times,
    in percent, over every launch of them in the trace. ``kernels``:
    [(kernel name, bytes a launch)]."""
    bound = spent = 0.0
    for name, nbytes in kernels:
        count, seconds = trace["kernels"].get(name, (0, 0.0))
        bound += count * nbytes / HBM_BYTES_PER_S
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
