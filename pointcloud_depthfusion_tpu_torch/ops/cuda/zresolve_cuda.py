"""Z-buffer resolve: kernels B1 and B2 (csrc/zresolve.cu) and their plain
PyTorch versions.

Replaces ``zresolve_winner_rgb`` and ``zresolve_sorted_entries`` of
pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py. Contract: per
pixel, the entry with the smallest z bits (signed i32) wins, ties go to the
smaller rgb (signed i32); INT32_MAX where no entry landed. Entries whose
pixel lies outside ``[0, n_px)`` are dropped.

``zresolve_sorted_entries(legacy_feed=True)`` (the JAX package's (4, N)
feed into its first resolve kernel, zresolve_pallas.py:417-453) computes
the same contract, so it runs the same kernel; its launches are counted
apart.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

INT32_MAX = 0x7FFFFFFF
#: Pixel id that routes an entry past every pixel (the JAX package's
#: ``invalid_pixel_id``).
INVALID_PIX = 0x40000000

#: Wrapper launches of the kernel, by wrapper name.
launches = {"zresolve_winner_rgb": 0, "zresolve_sorted_entries": 0,
            "zresolve_sorted_entries_legacy": 0}


# -- plain versions ---------------------------------------------------------


def _keys(zbits: torch.Tensor, rgb: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's u64 key with its top bit flipped, as a signed int64:
    ``zbits << 32 | (u32)(rgb ^ 0x80000000)``. Same order as the u64 key,
    and representable in torch's int64."""
    hi = zbits.to(torch.int64) << 32
    if rgb is None:
        return hi
    return hi | (rgb.to(torch.int64) + (1 << 31))


def _resolve_plain(pix, zbits, rgb, n_px: int) -> torch.Tensor:
    """(n_px,) int64 minimum key per pixel; INT64_MAX where empty. Dropped
    entries go to a dump slot at index n_px."""
    keys = _keys(zbits, rgb)
    inside = (pix >= 0) & (pix < n_px)
    idx = torch.where(inside, pix, n_px).to(torch.int64)
    buf = torch.full((n_px + 1,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=pix.device)
    buf = buf.scatter_reduce(0, idx, keys, "amin", include_self=True)
    return buf[:n_px]


def _hi(keys: torch.Tensor) -> torch.Tensor:
    return (keys >> 32).to(torch.int32)


def _lo(keys: torch.Tensor) -> torch.Tensor:
    return ((keys & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def zresolve_sorted_entries_plain(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: Optional[torch.Tensor], n_px: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`zresolve_sorted_entries` (either feed)."""
    keys = _resolve_plain(pix, zbits, rgb, n_px)
    minz = _hi(keys)
    return (minz, minz) if rgb is None else (minz, _lo(keys))


def zresolve_winner_rgb_plain(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: torch.Tensor, n_px: int
) -> torch.Tensor:
    """Plain version of :func:`zresolve_winner_rgb`."""
    return _lo(_resolve_plain(pix, zbits, rgb, n_px))


# -- kernel wrappers --------------------------------------------------------


def _check_entries(pix, zbits, rgb) -> None:
    n = pix.shape[0]
    for name, t in (("pix", pix), ("zbits", zbits), ("rgb", rgb)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name}: expected ({n},) int32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != pix.device:
            raise ValueError(f"{name}: on {t.device}, pix on {pix.device}")


def _launch(pix, zbits, rgb, n_px: int, minz, mrgb) -> None:
    lib = _build.load()
    keys = torch.empty(n_px, dtype=torch.int64, device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    _build.check(
        lib.zresolve_launch(
            pix.data_ptr(), zbits.data_ptr(),
            None if rgb is None else rgb.data_ptr(),
            pix.shape[0], keys.data_ptr(), n_px,
            None if minz is None else minz.data_ptr(),
            None if mrgb is None else mrgb.data_ptr(),
            stream,
        ),
        "zresolve_launch",
    )


def zresolve_sorted_entries(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: Optional[torch.Tensor], n_px: int,
    legacy_feed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (min z bits, rgb of the winner), both (n_px,) int32 and
    INT32_MAX where empty. ``rgb=None`` resolves depth alone and returns
    the min z bits twice. ``legacy_feed`` gives the same result through
    the same kernel and counts under ``zresolve_sorted_entries_legacy``."""
    _check_entries(pix, zbits, rgb)
    if pix.device.type == "cpu":
        return zresolve_sorted_entries_plain(pix, zbits, rgb, n_px)
    if pix.device.type != "cuda":
        raise ValueError(f"unsupported device {pix.device}")
    minz = torch.empty(n_px, dtype=torch.int32, device=pix.device)
    mrgb = None if rgb is None else torch.empty_like(minz)
    _launch(pix, zbits, rgb, n_px, minz, mrgb)
    launches["zresolve_sorted_entries_legacy" if legacy_feed else "zresolve_sorted_entries"] += 1
    return (minz, minz) if rgb is None else (minz, mrgb)


def zresolve_winner_rgb(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: torch.Tensor, n_px: int
) -> torch.Tensor:
    """Per-pixel rgb of the winner only, (n_px,) int32, INT32_MAX where
    empty."""
    if rgb is None:
        raise ValueError("zresolve_winner_rgb needs rgb")
    _check_entries(pix, zbits, rgb)
    if pix.device.type == "cpu":
        return zresolve_winner_rgb_plain(pix, zbits, rgb, n_px)
    if pix.device.type != "cuda":
        raise ValueError(f"unsupported device {pix.device}")
    mrgb = torch.empty(n_px, dtype=torch.int32, device=pix.device)
    _launch(pix, zbits, rgb, n_px, None, mrgb)
    launches["zresolve_winner_rgb"] += 1
    return mrgb
