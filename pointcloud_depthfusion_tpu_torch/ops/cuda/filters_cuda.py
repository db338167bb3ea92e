"""3×3 color filters on u8 images: kernel B4 (csrc/filters3x3.cu) and its
plain PyTorch versions.

Replaces ``gauss3x3_plane`` and ``median3x3_plane`` of
pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py: a 3×3 binomial
Gauss with half-up rounding, or a 3×3 median, on the interior; the border
(and any image smaller than 3×3) passes through. Integer arithmetic only.

One kernel for every channel of an image (or of a batch of images), which
writes the interleaved ``(..., H, W, C)`` u8 image. It filters with
``mode="gauss"`` or ``"median"``, or only decodes and interleaves with
``mode=None``. Its input forms:

- :func:`winner_image`: the packed winner of the z-buffer resolve, an
  int32 ``r<<16 | g<<8 | b`` per pixel with INT32_MAX where uncovered
  (black). The kernel decodes it as it loads, so the fused frame's color
  tail is this one launch;
- :func:`planes_image`: three u8 channel planes;
- :func:`interleaved_image`: an (H, W) or (H, W, C) u8 image, C of 1 to 4;
- :func:`gauss3x3_plane` / :func:`median3x3_plane`: one (H, W) plane, the
  JAX package's per-plane API.

Its launches are counted by mode: ``gauss3x3_image``, ``median3x3_image``
and ``color_image`` (``mode=None``).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

INT32_MAX = 0x7FFFFFFF
MAX_CHANNELS = 4  # of one launch: a pixel's channels are the bytes of a word
_MODES = {None: 0, "gauss": 1, "median": 2}

#: Wrapper launches of the kernel, by mode.
launches = {"gauss3x3_image": 0, "median3x3_image": 0, "color_image": 0}
_IMAGE_COUNTER = {None: "color_image", "gauss": "gauss3x3_image", "median": "median3x3_image"}


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


def decode_winner_planes(covered: torch.Tensor, mrgb: torch.Tensor):
    """(covered mask, packed r<<16|g<<8|b winner) → (r, g, b) u8 planes,
    black where uncovered."""
    win = torch.where(covered, mrgb, 0)
    rp = ((win >> 16) & 0xFF).to(torch.uint8)
    gp = ((win >> 8) & 0xFF).to(torch.uint8)
    bp = (win & 0xFF).to(torch.uint8)
    return rp, gp, bp


def planes_image_plain(planes: Sequence[torch.Tensor], mode: Optional[str] = None
                       ) -> torch.Tensor:
    """Plain version of :func:`planes_image`: each (H, W) image of each
    plane through the per-plane plain filter, then one stack."""
    _check_mode(mode)
    if mode is None or planes[0].numel() == 0:
        return torch.stack(list(planes), dim=-1)
    fn = median3x3_plane_plain if mode == "median" else gauss3x3_plane_plain
    h, w = planes[0].shape[-2:]
    out = [torch.stack([fn(img) for img in p.reshape(-1, h, w)]).reshape(p.shape)
           for p in planes]
    return torch.stack(out, dim=-1)


def winner_image_plain(mrgb: torch.Tensor, h: int, w: int, mode: Optional[str] = None
                       ) -> torch.Tensor:
    """Plain version of :func:`winner_image`: :func:`decode_winner_planes`,
    then :func:`planes_image_plain`."""
    planes = decode_winner_planes(mrgb != INT32_MAX, mrgb)
    return planes_image_plain([p.reshape(*mrgb.shape[:-1], h, w) for p in planes], mode)


def interleaved_image_plain(img: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`interleaved_image`."""
    if img.dim() == 2:
        return planes_image_plain([img], mode)[..., 0]
    return planes_image_plain([img[..., c] for c in range(img.shape[-1])], mode)


# -- kernel wrappers --------------------------------------------------------


def _plane(plane: torch.Tensor, mode: str) -> torch.Tensor:
    if plane.dtype != torch.uint8 or plane.dim() != 2:
        raise ValueError(f"expected an (H, W) uint8 plane, got {tuple(plane.shape)} {plane.dtype}")
    return interleaved_image(plane, mode)


def gauss3x3_plane(plane: torch.Tensor) -> torch.Tensor:
    """3×3 binomial Gauss of one (H, W) uint8 plane, half-up rounding."""
    return _plane(plane, "gauss")


def median3x3_plane(plane: torch.Tensor) -> torch.Tensor:
    """3×3 median of one (H, W) uint8 plane."""
    return _plane(plane, "median")


def _check_mode(mode) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: expected one of {list(_MODES)}")


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _launch_image(out: torch.Tensor, mode, h: int, w: int, channels: int, winner=None,
                  channel_ptrs=(), pstride: int = 1) -> torch.Tensor:
    """One launch of the image kernel over every (h, w) image of ``out``."""
    batch = out.numel() // max(h * w * channels, 1)
    if out.numel() == 0:
        return out
    if batch > 65535:
        raise ValueError(f"{batch} images in one launch: at most 65535")
    ptrs = list(channel_ptrs) + [None] * (MAX_CHANNELS - len(channel_ptrs))
    lib = _build.load()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check(
        lib.color3x3_launch(None if winner is None else winner.data_ptr(), *ptrs, pstride,
                            channels, out.data_ptr(), batch, h, w, _MODES[mode], stream),
        "color3x3_launch",
    )
    launches[_IMAGE_COUNTER[mode]] += 1
    return out


def winner_image(mrgb: torch.Tensor, h: int, w: int, mode: Optional[str] = None
                 ) -> torch.Tensor:
    """The (..., H, W, 3) u8 image of a packed winner ``mrgb`` (..., H·W)
    int32, ``r<<16 | g<<8 | b`` with INT32_MAX where uncovered (black):
    decoded and, with ``mode`` "gauss" or "median", filtered; each (H, W)
    image apart. One launch on a CUDA tensor."""
    if mrgb.dtype != torch.int32 or mrgb.dim() < 1 or mrgb.shape[-1] != h * w:
        raise ValueError(f"expected (..., {h * w}) int32 winners, got "
                         f"{tuple(mrgb.shape)} {mrgb.dtype}")
    _check_mode(mode)
    if mrgb.device.type == "cpu":
        return winner_image_plain(mrgb, h, w, mode)
    _check_cuda(mrgb)
    out = torch.empty((*mrgb.shape[:-1], h, w, 3), dtype=torch.uint8, device=mrgb.device)
    return _launch_image(out, mode, h, w, 3, winner=mrgb)


def planes_image(planes: Sequence[torch.Tensor], mode: Optional[str] = None) -> torch.Tensor:
    """Three u8 channel planes of one shape (..., H, W) → the interleaved
    (..., H, W, 3) image, each (H, W) image filtered apart per ``mode``.
    One launch on CUDA tensors."""
    planes = list(planes)
    if len(planes) != 3:
        raise ValueError(f"{len(planes)} planes: expected 3")
    first = planes[0]
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() < 2 or p.shape != first.shape:
            raise ValueError(f"expected (..., H, W) uint8 planes of one shape, got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.device != first.device:
            raise ValueError(f"planes on {p.device} and {first.device}")
    _check_mode(mode)
    if first.device.type == "cpu":
        return planes_image_plain(planes, mode)
    for p in planes:
        _check_cuda(p)
    h, w = first.shape[-2:]
    out = torch.empty((*first.shape, len(planes)), dtype=torch.uint8, device=first.device)
    return _launch_image(out, mode, h, w, len(planes),
                         channel_ptrs=[p.data_ptr() for p in planes])


def interleaved_image(img: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """An (H, W) or (H, W, C) u8 image with C of 1 to 4, every channel
    filtered per ``mode``; same shape out. One launch on a CUDA tensor."""
    if img.dtype != torch.uint8 or img.dim() not in (2, 3) or (
            img.dim() == 3 and not 1 <= img.shape[-1] <= MAX_CHANNELS):
        raise ValueError(f"expected an (H, W) or (H, W, C <= {MAX_CHANNELS}) uint8 image, got "
                         f"{tuple(img.shape)} {img.dtype}")
    _check_mode(mode)
    if img.device.type == "cpu":
        return interleaved_image_plain(img, mode)
    _check_cuda(img)
    c = img.shape[-1] if img.dim() == 3 else 1
    out = torch.empty_like(img)
    base = img.data_ptr()
    return _launch_image(out, mode, img.shape[0], img.shape[1], c,
                         channel_ptrs=[base + k for k in range(c)], pstride=c)
