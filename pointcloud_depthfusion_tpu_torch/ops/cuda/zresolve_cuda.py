"""Z-buffer resolve: kernels B1 and B2 (csrc/zresolve.cu) and their plain
PyTorch versions.

Replaces ``zresolve_winner_rgb`` and ``zresolve_sorted_entries`` of
pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py. Contract: per
pixel, the entry with the smallest z bits (signed i32) wins, ties go to the
smaller rgb (signed i32); INT32_MAX where no entry landed. Entries whose
pixel lies outside ``[0, n_px)`` are dropped.

Each call of a kernel wrapper is one launch of one kernel: the scatter of
the entries' keys and the decode of the winners, separated by a grid-wide
barrier, over a key buffer that the module keeps per (device, stream) and
that every call leaves all-ones as it found it (``_key_buffer``). A launch
that reports an error drops its buffer, so the next call starts from a
freshly filled one.

:func:`zresolve_masked` is the render's own feed: the pixel index, f32 z,
the bool mask and rgb24 as the prep produces them, masked in the kernel; its
result is bit for bit the JAX API's resolve of :func:`masked_entries` (the
``torch.where`` composition it replaces). It counts under the name of the
resolve it runs.

``zresolve_sorted_entries(legacy_feed=True)`` (the JAX package's (4, N)
feed into its first resolve kernel, zresolve_pallas.py:417-453) computes
the same contract, so it runs the same kernel; its launches are counted
apart.

``zresolve_sorted_streams`` (kernel B7) replaces the JAX package's
multi-stream resolve (``_streams_kernel``, zresolve_pallas.py:500-581):
the same contract over (S, N) entries, S streams that the TPU sorts one by
one because its sort scales super-linearly. The atomic resolve does not
depend on the order of its entries, so B7 is one launch of the B2 kernel
over all S·N entries, counted apart.

``scatter_min_u32`` is the per-slot unsigned 32-bit minimum of the packed,
indexed and pallas render modes (an XLA scatter in the JAX package, not a
Pallas kernel; torch has no uint32 scatter-min). Its keys are uint32 bit
patterns carried in int32 tensors (0xFFFFFFFF is -1): :func:`u32_value`
and :func:`u32_bits` convert, and all arithmetic on them runs in int64.
It too is one cooperative launch a call, over the same key buffer read as
u32 words. It takes given keys, or builds the packed ``zq14 << 18 |
RGB666`` key itself from the masked feed (:func:`scatter_min_packed`), and
writes the raw minimum bits or their packed decode (three u8 planes and
the z-buffer, :func:`decode_packed_plain`'s arithmetic). Every variant
counts under ``scatter_min_u32``.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

INT32_MAX = 0x7FFFFFFF
FLT_MAX = torch.finfo(torch.float32).max
#: Depth levels of the packed key's 14-bit zq.
Z_LEVELS_14 = float((1 << 14) - 1)
#: Pixel id that routes an entry past every pixel (the JAX package's
#: ``invalid_pixel_id``).
INVALID_PIX = 0x40000000
#: The all-ones uint32 key (empty slot, invalid entry) as its int32 bits.
U32_EMPTY = -1

#: Wrapper launches of the kernel, by wrapper name.
launches = {"zresolve_winner_rgb": 0, "zresolve_sorted_entries": 0,
            "zresolve_sorted_entries_legacy": 0, "zresolve_sorted_streams": 0,
            "scatter_min_u32": 0}


def u32_value(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern → its uint32 value, as int64."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def u32_bits(value: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 (in [0, 2³²)) → its int32 bit pattern."""
    return (value - ((value >> 31) << 32)).to(torch.int32)


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


def zresolve_sorted_streams_plain(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: Optional[torch.Tensor], n_px: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`zresolve_sorted_streams`: the single-stream
    resolve over the flattened entries."""
    return zresolve_sorted_entries_plain(
        pix.reshape(-1), zbits.reshape(-1), None if rgb is None else rgb.reshape(-1), n_px)


def zresolve_winner_rgb_plain(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: torch.Tensor, n_px: int
) -> torch.Tensor:
    """Plain version of :func:`zresolve_winner_rgb`."""
    return _lo(_resolve_plain(pix, zbits, rgb, n_px))


def masked_entries(
    idx: torch.Tensor, z: torch.Tensor, ok: torch.Tensor, rgb24: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX API's (pix, zbits, rgb) of a masked feed: INVALID_PIX and
    INT32_MAX where ``ok`` is off, z's f32 bits and rgb24 where it is on."""
    return (torch.where(ok, idx, INVALID_PIX), torch.where(ok, z.view(torch.int32), INT32_MAX),
            torch.where(ok, rgb24, INT32_MAX))


def zresolve_masked_plain(
    idx: torch.Tensor, z: torch.Tensor, ok: torch.Tensor, rgb24: torch.Tensor, n_px: int,
    need_zbuf: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`zresolve_masked`: :func:`masked_entries`,
    then the plain resolve."""
    minz, mrgb = zresolve_sorted_streams_plain(*masked_entries(idx, z, ok, rgb24), n_px)
    return mrgb, minz if need_zbuf else None


def scatter_min_u32_plain(idx: torch.Tensor, key: torch.Tensor, n_slots: int,
                          zparams: Optional[torch.Tensor] = None, planes: bool = False,
                          need_zbuf: bool = False):
    """Plain version of :func:`scatter_min_u32`: ``scatter_reduce_(amin)``
    of the int64 key values into a dump-slotted buffer, then
    :func:`decode_packed_plain` when ``planes``."""
    inside = (idx >= 0) & (idx < n_slots)
    slot = torch.where(inside, idx, n_slots).to(torch.int64)
    buf = torch.full((n_slots + 1,), 0xFFFFFFFF, dtype=torch.int64, device=idx.device)
    buf.scatter_reduce_(0, slot, u32_value(key), "amin", include_self=True)
    bits = u32_bits(buf[:n_slots])
    return decode_packed_plain(bits, zparams, need_zbuf) if planes else bits


def packed_zparams(z_near, z_far, device, span=None) -> torch.Tensor:
    """The packed key's (near, span, far) as a (3,) f32 tensor on
    ``device``. ``span`` defaults to f32(far) - f32(near), the dual frame's
    (ops/render.py); the rig passes its own, f32(far - near) rounded once
    from the host's double."""
    near = torch.as_tensor(z_near, dtype=torch.float32, device=device)
    far = torch.as_tensor(z_far, dtype=torch.float32, device=device)
    span = far - near if span is None else torch.as_tensor(span, dtype=torch.float32,
                                                            device=device)
    return torch.stack([near, span, far])


def packed_keys_plain(z: torch.Tensor, ok: torch.Tensor, rgb24: torch.Tensor,
                      zparams: torch.Tensor) -> torch.Tensor:
    """The packed key bits ``zq14 << 18 | RGB666`` of a masked feed, all-ones
    where ``ok`` is off. zq is clipped to 16382, so a far near-white
    point's key never equals the all-ones sentinel (render.py:194-199)."""
    zq = torch.clamp((z - zparams[0]) / zparams[1] * Z_LEVELS_14, 0.0, Z_LEVELS_14 - 1.0
                     ).to(torch.int64)
    p24 = rgb24.to(torch.int64)
    rgb666 = (((p24 >> 18) & 0x3F) << 12) | (((p24 >> 10) & 0x3F) << 6) | ((p24 >> 2) & 0x3F)
    return u32_bits(torch.where(ok, (zq << 18) | rgb666, 0xFFFFFFFF))


def decode_packed_plain(buf: torch.Tensor, zparams: Optional[torch.Tensor],
                        need_zbuf: bool) -> tuple:
    """Decode a flat packed (zq14 | RGB666) min-buffer (int32 bits) into
    (r, g, b) u8 planes and, when ``need_zbuf``, the f32 zbuf (FLT_MAX where
    uncovered, color black; else None): ``zq / 16383 · (far - near) +
    near`` with a true division (a 0-d device divisor: a host scalar would
    make CUDA multiply by its reciprocal)."""
    covered = buf != U32_EMPTY
    key = torch.where(covered, u32_value(buf), 0)
    planes = []
    for shift in (12, 6, 0):
        c6 = (key >> shift) & 0x3F
        planes.append(((c6 << 2) | (c6 >> 4)).to(torch.uint8))
    if not need_zbuf:
        return (*planes, None)
    near, far = zparams[0], zparams[2]
    z_levels = torch.full((), Z_LEVELS_14, dtype=torch.float32, device=buf.device)
    zq = (key >> 18).to(torch.float32) / z_levels * (far - near) + near
    return (*planes, torch.where(covered, zq, FLT_MAX))


def scatter_min_packed_plain(idx, z, ok, rgb24, n_slots: int, zparams: torch.Tensor,
                             planes: bool = True, need_zbuf: bool = False):
    """Plain version of :func:`scatter_min_packed`: the eager key build, the
    scatter-min and, when ``planes``, the decode."""
    return scatter_min_u32_plain(idx, packed_keys_plain(z, ok, rgb24, zparams), n_slots,
                                 zparams, planes, need_zbuf)


# -- kernel wrappers --------------------------------------------------------

_I32 = (torch.int32, torch.int32, torch.int32)
#: The key buffers, by (device index, stream): int64 tensors of all-ones
#: bits between calls (see the module docstring), grown to the largest
#: n_px seen on their stream.
_key_buffers: dict = {}
_key_lock = threading.Lock()


def _check_entries(ts, names=("pix", "zbits", "rgb"), dtypes=_I32, ndim: int = 1) -> None:
    """Each given tensor (None skipped): of its dtype, contiguous, on the
    first one's device, with the first one's shape of rank ``ndim`` ((N,)
    entries, or (S, N) streams)."""
    first = ts[0]
    shape, device = first.shape, first.device
    if first.dim() == ndim:
        for t, dt in zip(ts, dtypes):
            if t is not None and (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                                  or t.device != device):
                break
        else:
            return
    layout = "(N,)" if ndim == 1 else "(S, N)"
    for name, t, dt in zip(names, ts, dtypes):
        if t is None:
            continue
        if t.dtype != dt or t.dim() != ndim or t.shape != shape:
            raise ValueError(f"{name}: expected {layout} {str(dt)[6:]} of {tuple(shape)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, {names[0]} on {device}")


def _on_card(device: torch.device) -> bool:
    """False for the CPU (the plain version runs), True for a card; raises
    for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


def _key_buffer(device: torch.device, stream: int, n_px: int) -> torch.Tensor:
    """The key buffer of (``device``, ``stream``), of at least ``n_px``
    keys: filled with all-ones (on that stream) when it is allocated."""
    slot = (device.index, stream)
    with _key_lock:
        keys = _key_buffers.get(slot)
        if keys is None or keys.numel() < n_px:
            keys = torch.full((max(n_px, 1),), -1, dtype=torch.int64, device=device)
            _key_buffers[slot] = keys
        return keys


def _run(device: torch.device, n_keys: int, call, what: str) -> None:
    """``call(keys pointer, stream)``, one launch on the current stream of
    ``device`` over its key buffer of at least ``n_keys`` int64 words."""
    stream = torch.cuda.current_stream(device).cuda_stream
    keys = _key_buffer(device, stream, n_keys)
    status = call(keys.data_ptr(), stream)
    if status:
        # A launch that did not run to its end may leave keys set: the next
        # call on this stream allocates and fills a new buffer.
        with _key_lock:
            if _key_buffers.get((device.index, stream)) is keys:
                del _key_buffers[(device.index, stream)]
        _build.check(status, what)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(pix, zbits, ok, rgb, n_px: int, minz, mrgb) -> None:
    """One launch of the resolve on the current stream of ``pix``'s card."""
    _run(pix.device, n_px, lambda keys, stream: _build.load().zresolve_launch(
        pix.data_ptr(), zbits.data_ptr(), _ptr(ok), _ptr(rgb), pix.numel(), ok is not None,
        rgb is not None, keys, n_px, _ptr(minz), _ptr(mrgb), stream), "zresolve_launch")


def _sorted(pix, zbits, rgb, n_px: int, counter: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 on checked entries of any layout: the plain version on the CPU,
    else one launch counted under ``counter``."""
    if not _on_card(pix.device):
        return zresolve_sorted_streams_plain(pix, zbits, rgb, n_px)
    minz = torch.empty(n_px, dtype=torch.int32, device=pix.device)
    mrgb = None if rgb is None else torch.empty_like(minz)
    _launch(pix, zbits, None, rgb, n_px, minz, mrgb)
    launches[counter] += 1
    return (minz, minz) if rgb is None else (minz, mrgb)


def zresolve_sorted_entries(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: Optional[torch.Tensor], n_px: int,
    legacy_feed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (min z bits, rgb of the winner), both (n_px,) int32 and
    INT32_MAX where empty. ``rgb=None`` resolves depth alone (32-bit keys)
    and returns the min z bits twice. ``legacy_feed`` gives the same result
    through the same kernel and counts under
    ``zresolve_sorted_entries_legacy``."""
    _check_entries((pix, zbits, rgb))
    return _sorted(pix, zbits, rgb, n_px, "zresolve_sorted_entries_legacy" if legacy_feed
                   else "zresolve_sorted_entries")


def zresolve_sorted_streams(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: Optional[torch.Tensor], n_px: int,
    tile_px: int = 256, chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`zresolve_sorted_entries` over (S, N) int32 entries, S streams
    of N: per pixel (min z bits, rgb of the winner) over all S·N entries.
    ``tile_px`` and ``chunk`` (the TPU kernel's tiling) are accepted and
    unused."""
    del tile_px, chunk
    _check_entries((pix, zbits, rgb), ndim=2)
    return _sorted(pix, zbits, rgb, n_px, "zresolve_sorted_streams")


def zresolve_winner_rgb(
    pix: torch.Tensor, zbits: torch.Tensor, rgb: torch.Tensor, n_px: int
) -> torch.Tensor:
    """Per-pixel rgb of the winner only, (n_px,) int32, INT32_MAX where
    empty."""
    if rgb is None:
        raise ValueError("zresolve_winner_rgb needs rgb")
    _check_entries((pix, zbits, rgb))
    if not _on_card(pix.device):
        return zresolve_winner_rgb_plain(pix, zbits, rgb, n_px)
    mrgb = torch.empty(n_px, dtype=torch.int32, device=pix.device)
    _launch(pix, zbits, None, rgb, n_px, None, mrgb)
    launches["zresolve_winner_rgb"] += 1
    return mrgb


_MASKED = ("idx", "z", "ok", "rgb24")
_MASKED_DTYPES = (torch.int32, torch.float32, torch.bool, torch.int32)


def zresolve_masked(
    idx: torch.Tensor, z: torch.Tensor, ok: torch.Tensor, rgb24: torch.Tensor, n_px: int,
    need_zbuf: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The resolve of the render's own entries, masked in the kernel: per
    pixel of ``[0, n_px)``, the winner among the entries whose ``ok`` is set
    and whose ``idx`` lies inside. ``idx`` int32, ``z`` float32 (compared
    by its bits, as signed int32), ``ok`` bool and ``rgb24`` int32, all of
    one shape: (N,) entries, or (S, N) streams (kernel B7). Returns (rgb of
    the winner, min z bits or None unless ``need_zbuf``), (n_px,) int32 and
    INT32_MAX where empty: bit for bit the JAX API's resolve of
    :func:`masked_entries`. Counts under ``zresolve_sorted_streams`` for
    streams, else ``zresolve_sorted_entries`` with the z-buffer and
    ``zresolve_winner_rgb`` without it. Takes each dtype as it is and
    refuses any other."""
    if rgb24 is None:
        raise ValueError("zresolve_masked needs rgb24")
    _check_entries((idx, z, ok, rgb24), _MASKED, _MASKED_DTYPES,
                   ndim=2 if idx.dim() == 2 else 1)
    if not _on_card(idx.device):
        return zresolve_masked_plain(idx, z, ok, rgb24, n_px, need_zbuf)
    mrgb = torch.empty(n_px, dtype=torch.int32, device=idx.device)
    minz = torch.empty_like(mrgb) if need_zbuf else None
    _launch(idx, z, ok, rgb24, n_px, minz, mrgb)
    launches["zresolve_sorted_streams" if idx.dim() == 2 else
             "zresolve_sorted_entries" if need_zbuf else "zresolve_winner_rgb"] += 1
    return mrgb, minz


def _check_zparams(zparams, device) -> None:
    if (zparams is None or zparams.dtype != torch.float32 or zparams.shape != (3,)
            or not zparams.is_contiguous() or zparams.device != device):
        raise ValueError(f"zparams: expected a contiguous (3,) float32 tensor on {device} "
                         "(packed_zparams)")


def _scatter_min(idx, key, feed, n_slots: int, zparams, planes: bool, need_zbuf: bool):
    """One launch of the scatter-min: given keys (``key``) or the masked
    ``feed`` (z, ok, rgb24); the raw bits, or (r, g, b, zbuf or None)."""
    device = idx.device
    bits = planes_out = zbuf = None
    if planes:
        planes_out = torch.empty((3, n_slots), dtype=torch.uint8, device=device)
        zbuf = torch.empty(n_slots, dtype=torch.float32, device=device) if need_zbuf else None
    else:
        bits = torch.empty(n_slots, dtype=torch.int32, device=device)
    z, ok, rgb24 = feed if feed is not None else (None, None, None)
    rgb_ptrs = (None,) * 3 if planes_out is None else tuple(p.data_ptr() for p in planes_out)
    _run(device, (n_slots + 1) // 2, lambda keys, stream: _build.load().scatter_min_u32_launch(
        idx.data_ptr(), _ptr(key), _ptr(z), _ptr(ok), _ptr(rgb24), _ptr(zparams), idx.numel(),
        feed is not None, keys, n_slots, planes, _ptr(bits), *rgb_ptrs, _ptr(zbuf), need_zbuf,
        stream), "scatter_min_u32_launch")
    launches["scatter_min_u32"] += 1
    return bits if not planes else (*planes_out, zbuf)


def scatter_min_u32(idx: torch.Tensor, key: torch.Tensor, n_slots: int,
                    zparams: Optional[torch.Tensor] = None, planes: bool = False,
                    need_zbuf: bool = False):
    """Per-slot unsigned minimum of uint32 keys: (n_slots,) int32 bits,
    0xFFFFFFFF (-1) where no entry landed. ``idx`` and ``key`` are (N,)
    int32; an entry whose slot lies outside ``[0, n_slots)`` (the dump slot
    ``n_slots`` among them) is dropped. With ``planes`` the keys are packed
    (zq14 | RGB666) and the result is their decode (r, g, b (n_slots,) u8,
    zbuf (n_slots,) f32 or None unless ``need_zbuf``) by ``zparams``
    (:func:`packed_zparams`)."""
    _check_entries((idx, key), ("idx", "key"))
    if planes and need_zbuf:
        _check_zparams(zparams, idx.device)
    if not _on_card(idx.device):
        return scatter_min_u32_plain(idx, key, n_slots, zparams, planes, need_zbuf)
    return _scatter_min(idx, key, None, n_slots, zparams, planes, need_zbuf)


def scatter_min_packed(idx: torch.Tensor, z: torch.Tensor, ok: torch.Tensor,
                       rgb24: torch.Tensor, n_slots: int, zparams: torch.Tensor,
                       planes: bool = True, need_zbuf: bool = False):
    """:func:`scatter_min_u32` of the packed keys of a masked feed (the
    render's (N,) idx int32, z float32, ok bool, rgb24 int32), built in the
    kernel with ``zparams``' near and span: bit for bit
    :func:`packed_keys_plain`. Returns the raw bits, or with ``planes``
    their decode (r, g, b, zbuf or None)."""
    _check_entries((idx, z, ok, rgb24), _MASKED, _MASKED_DTYPES)
    _check_zparams(zparams, idx.device)
    if not _on_card(idx.device):
        return scatter_min_packed_plain(idx, z, ok, rgb24, n_slots, zparams, planes, need_zbuf)
    return _scatter_min(idx, None, (z, ok, rgb24), n_slots, zparams, planes, need_zbuf)
