"""21-point erosion and dilation of a u8 plane, and the whole of
``filter_depth(use_morphology=True)``: kernel B6 (csrc/morph.cu) and its
plain PyTorch versions.

Replaces ``morph_plane`` of
pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py: one min (erosion)
or max (dilation) pass over the 5×5 structuring element without its four
corners, with a replicate border (``jnp.pad(mode="edge")``). Integer
min/max only, so a 0/1 mask stays 0/1 and any other u8 values stay u8
values. One launch runs up to four passes, each with the replicate border
of its own input, bit-exact to one launch a pass: :func:`morph_passes` on
any u8 plane (four pixels a word), :func:`mask_passes` on a bool mask (32
pixels a word); and :func:`filter_depth_open_close` runs the depth
filter's window, mask, ROI, open, close and zeroing in one launch, on the
mask format.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

#: Wrapper launches of the kernel (any number of passes, either input).
launches = {"morph_plane": 0}

#: The element's (dy, dx) offsets: the 5×5 box less its corners (21 taps).
CROSS5_OFFSETS = tuple(
    (dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if abs(dy) != 2 or abs(dx) != 2
)
#: Passes of one launch at most (the kernel's 8-pixel halo).
MAX_PASSES = 4
#: Open (erode, dilate) then close (dilate, erode): ``filter_depth``'s passes.
OPEN_CLOSE = (False, True, True, False)
#: The depth dtypes the kernel takes, by its DepthKind code.
DEPTH_KINDS = {torch.uint8: 0, torch.int16: 1, torch.uint16: 2, torch.int32: 3, torch.int64: 4}

Box = Tuple[int, int, int, int]


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


def morph_passes_plain(mask_u8: torch.Tensor, passes: Sequence[bool]) -> torch.Tensor:
    """Plain version of :func:`morph_passes`: one :func:`morph_plane_plain`
    a pass (``True`` dilates)."""
    out = mask_u8
    for dilate in passes:
        out = morph_plane_plain(out, dilate)
    return out


def _check_plane(t: torch.Tensor, dtypes, what: str) -> None:
    if t.dim() != 2 or t.dtype not in dtypes:
        raise ValueError(f"expected an (H, W) {what}, got {tuple(t.shape)} {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError("expected a contiguous plane")


def _check_passes(passes: Sequence[bool]) -> int:
    """The kernel's dilate bits of ``passes`` (bit p: pass p dilates)."""
    if not 1 <= len(passes) <= MAX_PASSES:
        raise ValueError(f"1 to {MAX_PASSES} passes a launch, got {len(passes)}")
    return sum(1 << p for p, dilate in enumerate(passes) if dilate)


def morph_passes(mask_u8: torch.Tensor, passes: Sequence[bool]) -> torch.Tensor:
    """One to four erosion (``False``) or dilation (``True``) passes of an
    (H, W) uint8 plane with the 21-point element, each with a replicate
    border: one launch on the card."""
    _check_plane(mask_u8, (torch.uint8,), "uint8 plane")
    bits = _check_passes(passes)
    if mask_u8.device.type == "cpu":
        return morph_passes_plain(mask_u8, passes)
    out = torch.empty_like(mask_u8)
    if mask_u8.numel() == 0:
        return out
    h, w = mask_u8.shape
    lib = _build.load()
    stream = torch.cuda.current_stream(mask_u8.device).cuda_stream
    _build.check(
        lib.morph_launch(mask_u8.data_ptr(), out.data_ptr(), h, w, len(passes), bits, stream),
        "morph_launch",
    )
    launches["morph_plane"] += 1
    return out


def morph_plane(mask_u8: torch.Tensor, dilate: bool) -> torch.Tensor:
    """One erosion (``dilate=False``) or dilation pass of an (H, W) uint8
    plane with the 21-point element and a replicate border."""
    return morph_passes(mask_u8, (dilate,))


def mask_passes(mask: torch.Tensor, passes: Sequence[bool]) -> torch.Tensor:
    """:func:`morph_passes` of an (H, W) bool mask, in the kernel's mask
    format: one launch on the card."""
    _check_plane(mask, (torch.bool,), "bool mask")
    bits = _check_passes(passes)
    if mask.device.type == "cpu":
        return morph_passes_plain(mask.view(torch.uint8), passes).view(torch.bool)
    out = torch.empty_like(mask)
    if mask.numel() == 0:
        return out
    h, w = mask.shape
    lib = _build.load()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    _build.check(
        lib.mask_morph_launch(mask.data_ptr(), out.data_ptr(), h, w, len(passes), bits, stream),
        "mask_morph_launch",
    )
    launches["morph_plane"] += 1
    return out


# -- filter_depth(use_morphology=True) -------------------------------------


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def u16_threshold(meters, depth_scale, device) -> torch.Tensor:
    """``(u16)(meters_f32 / scale_f32)``: f32 division, then truncation
    (0.5 / 0.001 in f32 is 499.99997, so 499)."""
    q = _f32(meters, device) / _f32(depth_scale, device)
    return torch.clamp(q, 0.0, 65535.0).to(torch.int32)


def filter_depth_open_close_plain(depth: torch.Tensor, depth_scale, min_depth, max_depth,
                                  box: Optional[Box]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`filter_depth_open_close`: the eager chain
    ``filter_depth`` ran around four B6 passes. The u16 window (f32
    division, truncation), depth > 0 within the ROI ``box`` ((x0, y0, x1,
    y1), ends exclusive; None: the whole image), open then close, and the
    depth zeroed outside the final mask."""
    dev = depth.device
    d = depth.to(torch.int32)
    lo = u16_threshold(min_depth, depth_scale, dev)
    hi = u16_threshold(max_depth, depth_scale, dev)
    d = torch.where((d >= lo) & (d <= hi), d, 0)
    valid = d > 0
    if box is not None:
        x0, y0, x1, y1 = box
        roi = torch.zeros_like(valid)
        roi[y0:y1, x0:x1] = True
        valid = valid & roi
    valid = morph_passes_plain(valid.view(torch.uint8), OPEN_CLOSE).view(torch.bool)
    return torch.where(valid, d, 0), valid


def _scalar(v, device) -> Tuple[Optional[int], float, Optional[torch.Tensor]]:
    """A scalar for the kernel: (pointer, value, tensor to keep alive). A
    tensor on the card is read there through its pointer (as f32, converted
    by one op if it is not), so the call needs no host sync; a number or a
    CPU tensor passes its f32 value."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"expected a scalar, got shape {tuple(v.shape)}")
        if v.device.type == "cpu":
            return None, float(v.to(torch.float32)), None
        if v.device != device:
            raise ValueError(f"a scalar on {v.device}, depth on {device}")
        t = v.to(torch.float32).contiguous()
        return t.data_ptr(), 0.0, t
    return None, float(np.float32(v)), None


def filter_depth_open_close(depth: torch.Tensor, depth_scale, min_depth, max_depth,
                            box: Optional[Box]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``filter_depth(use_morphology=True)`` in one launch on the card:
    (depth as int32, valid mask as bool). ``depth`` is an (H, W) plane of
    u16 values in one of :data:`DEPTH_KINDS`' dtypes; ``box`` the clamped
    ROI (x0, y0, x1, y1), ends exclusive, or None."""
    _check_plane(depth, DEPTH_KINDS, "integer depth plane")
    if depth.device.type == "cpu":
        return filter_depth_open_close_plain(depth, depth_scale, min_depth, max_depth, box)
    h, w = depth.shape
    d_out = torch.empty((h, w), dtype=torch.int32, device=depth.device)
    m_out = torch.empty((h, w), dtype=torch.bool, device=depth.device)
    if depth.numel() == 0:
        return d_out, m_out
    x0, y0, x1, y1 = box if box is not None else (0, 0, w, h)
    scalars = [_scalar(v, depth.device) for v in (depth_scale, min_depth, max_depth)]
    args = [a for ptr, val, _ in scalars for a in (ptr, ctypes.c_float(val))]
    lib = _build.load()
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    _build.check(
        lib.filter_depth_morph_launch(depth.data_ptr(), DEPTH_KINDS[depth.dtype], d_out.data_ptr(),
                                      m_out.data_ptr(), h, w, len(OPEN_CLOSE),
                                      _check_passes(OPEN_CLOSE), *args, x0, y0, x1, y1, stream),
        "filter_depth_morph_launch",
    )
    launches["morph_plane"] += 1
    return d_out, m_out
