"""21-point erosion and dilation of a u8 plane: kernel B6 (csrc/morph.cu)
and its plain PyTorch version.

Replaces ``morph_plane`` of
pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py: one min (erosion)
or max (dilation) pass over the 5×5 structuring element without its four
corners, with a replicate border (``jnp.pad(mode="edge")``). Integer
min/max only, so a 0/1 mask stays 0/1.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

#: Wrapper launches of the kernel.
launches = {"morph_plane": 0}

#: The element's (dy, dx) offsets: the 5×5 box less its corners (21 taps).
CROSS5_OFFSETS = tuple(
    (dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if abs(dy) != 2 or abs(dx) != 2
)


def morph_plane_plain(mask_u8: torch.Tensor, dilate: bool) -> torch.Tensor:
    """Plain version of :func:`morph_plane`: the 21 shifted views of the
    replicate-padded plane, reduced with min or max."""
    h, w = mask_u8.shape
    if h == 0 or w == 0:
        return mask_u8.clone()
    dev = mask_u8.device
    rows = torch.arange(-2, h + 2, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-2, w + 2, device=dev).clamp_(0, w - 1)
    padded = mask_u8[rows][:, cols]
    op = torch.maximum if dilate else torch.minimum
    out = padded[2:2 + h, 2:2 + w]
    for dy, dx in CROSS5_OFFSETS:
        out = op(out, padded[2 + dy:2 + dy + h, 2 + dx:2 + dx + w])
    return out.contiguous()


def morph_plane(mask_u8: torch.Tensor, dilate: bool) -> torch.Tensor:
    """One erosion (``dilate=False``) or dilation pass of an (H, W) uint8
    plane with the 21-point element and a replicate border."""
    if mask_u8.dtype != torch.uint8 or mask_u8.dim() != 2:
        raise ValueError(
            f"expected an (H, W) uint8 plane, got {tuple(mask_u8.shape)} {mask_u8.dtype}"
        )
    if mask_u8.device.type == "cpu":
        return morph_plane_plain(mask_u8, dilate)
    if mask_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {mask_u8.device}")
    if not mask_u8.is_contiguous():
        raise ValueError("expected a contiguous plane")
    out = torch.empty_like(mask_u8)
    if mask_u8.numel() == 0:
        return out
    h, w = mask_u8.shape
    lib = _build.load()
    stream = torch.cuda.current_stream(mask_u8.device).cuda_stream
    _build.check(
        lib.morph_launch(mask_u8.data_ptr(), out.data_ptr(), h, w, int(dilate), stream),
        "morph_launch",
    )
    launches["morph_plane"] += 1
    return out
