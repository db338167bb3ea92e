"""The fused per-pixel prep of every render mode: kernel B3
(csrc/fuse_prep.cu) and its plain PyTorch versions.

Replaces ``fuse_prep_pallas`` of
pointcloud_depthfusion_tpu/ops/pallas/fuse_prep_pallas.py, and the eager
chain the other modes ran in its place. One launch takes all N cameras of a
frame: per pixel, depth window (and ROI) → metres → deproject → rigid
transform into the virtual camera → project → C-cast rounding → bounds →
mirror. It writes one of two outputs:

- (a) :func:`fuse_prep_keys`: the flat target index (``w·h`` where
  dropped) and the packed z-buffer key ``zq14 << 18 | RGB666`` as uint32
  bits in int32 (0xFFFFFFFF, i.e. -1, where dropped), ready for
  ``zresolve_cuda.scatter_min_u32``: the ``pallas`` mode. Pinhole only,
  like the Pallas kernel (fuse_prep_pallas.py:67-68): inverse
  Brown-Conrady intrinsics are not undistorted here, although the packed
  mode undistorts them. The port keeps this quirk of the reference.
  :func:`fuse_prep` is the JAX package's one-camera API on it.
- (b) :func:`fuse_prep_feed`: the masked exact feed (idx int32, z f32, ok
  bool, rgb24 int32) that ``zresolve_cuda.zresolve_masked`` and
  ``zresolve_cuda.scatter_min_packed`` take, with the inverse Brown-Conrady
  undistortion, the ROI and a pixel offset per camera: ``tiled``,
  ``exact``, ``packed`` and ``indexed``, and the rig. Its plain version
  (:func:`fuse_prep_feed_plain`) is the eager chain those paths ran
  before: ``filter_depth`` → ``deproject_planar`` → ``transform_planar`` →
  ``compute_pixel_indices_planar``.

Both write each camera's valid plane (window ∧ depth > 0 ∧ ROI), which
``FusionResult.valid_left``/``valid_right`` carry.

The kernel reads each camera's pose and depth scale straight from the
caller's tensors, on every call, and the rest of its parameters from the
(N, 17) f32 and (N, 6) int32 tables that :func:`prep_cameras` builds once
(source intrinsics, distortion, the virtual camera, the window, the packed
key's depth range; ROI, pixel offset, undistortion). :class:`Memo` keeps a
call site's cameras while the calibration and config they were built from
stay the same objects, so a steady stream of frames uploads nothing but its
frames, and a pose or depth scale is never stale.

Dispatch, by the frames' device: a CPU tensor runs the plain version; a
CUDA tensor launches the kernel, or raises. Cameras, poses and depth scales
on another device than the frames raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import Z_LEVELS_14, u32_bits

#: Wrapper launches of the kernel (either output).
launches = {"fuse_prep": 0}

_CAST_LIMIT = float(1 << 30)


def largest_tile_rows(h: int, cap: int = 64) -> int:
    """Largest multiple-of-8 divisor of h, capped; h itself when there is
    none (the JAX package's Mosaic tiling rule, kept for API parity)."""
    for cand in range(min(cap, h), 7, -1):
        if cand % 8 == 0 and h % cand == 0:
            return cand
    return h


# -- the cameras and their tables ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrepCameras:
    """The N cameras of one launch, all but their frames, poses and depth
    scales: built once by :func:`prep_cameras`, with B3's static tables."""

    intrinsics: Tuple[Intrinsics, ...]  # one per camera
    fused: Intrinsics  # the virtual camera
    min_depth: torch.Tensor  # 0-d f32 window, metres
    max_depth: torch.Tensor
    z_near: torch.Tensor  # 0-d f32, the packed key's range (output a)
    z_far: torch.Tensor
    rois: Tuple  # per camera [x, y, w, h] or None
    pix_offsets: Tuple[int, ...]
    mirror: bool
    static: torch.Tensor  # (N, 17) f32 table (csrc/fuse_prep.cu, kFx on)
    ints: torch.Tensor  # (N, 6) int32 table

    @property
    def n(self) -> int:
        return len(self.intrinsics)

    @property
    def device(self) -> torch.device:
        return self.static.device


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def prep_cameras(intrinsics, fused_intrinsics: Intrinsics, min_depth, max_depth,
                 mirror: bool = False, *, rois=None, pix_offsets: Optional[Sequence[int]] = None,
                 z_near=0.25, z_far=4.5, device=None) -> PrepCameras:
    """B3's cameras and tables for N cameras on ``device`` (the virtual
    camera's by default). ``intrinsics``: a sequence of N, or one
    camera's; ``rois``: N [x, y, w, h] or None; ``pix_offsets``: N ints
    added to every index of output (b)."""
    intrinsics = (intrinsics,) if isinstance(intrinsics, Intrinsics) else tuple(intrinsics)
    n = len(intrinsics)
    device = fused_intrinsics.device if device is None else torch.device(device)
    rois = (None,) * n if rois is None else tuple(rois)
    pix_offsets = (0,) * n if pix_offsets is None else tuple(int(o) for o in pix_offsets)
    if len(rois) != n or len(pix_offsets) != n:
        raise ValueError(f"{len(rois)} rois and {len(pix_offsets)} pixel offsets for {n} cameras")
    ref = intrinsics[0]
    if any((i.width, i.height) != (ref.width, ref.height) for i in intrinsics):
        raise ValueError("the cameras of one launch must share width and height")
    win = [_f32(v, device) for v in (min_depth, max_depth, z_near, z_far)]
    dst = fused_intrinsics
    tail = torch.stack([_f32(v, device) for v in (dst.fx, dst.fy, dst.ppx, dst.ppy)] + win)
    static = torch.stack([
        torch.cat([torch.stack([_f32(v, device) for v in (i.fx, i.fy, i.ppx, i.ppy)]),
                   _f32(i.coeffs, device).reshape(5), tail])
        for i in intrinsics])
    ints = []
    for i, roi, off in zip(intrinsics, rois, pix_offsets):
        x0, y0, rw, rh = (0, 0, i.width, i.height) if roi is None else F._clamped_roi(
            i.height, i.width, roi)
        ints.append([x0, y0, min(x0 + rw, i.width), min(y0 + rh, i.height), off,
                     int(i.model == Distortion.INVERSE_BROWN_CONRADY)])
    return PrepCameras(intrinsics, dst, *win, rois, pix_offsets, bool(mirror), static,
                       torch.tensor(ints, dtype=torch.int32).to(device))


def _same(a, b) -> bool:
    if a is b:
        return True
    plain = (int, float, bool, str, type(None))
    return isinstance(a, plain) and isinstance(b, plain) and a == b


class Memo:
    """One value, kept while the objects it was built from are the same
    (tensors and other objects by identity, numbers and strings by value):
    a call site's :class:`PrepCameras`, rebuilt only when a camera's
    calibration or the config is a new object. Calibration rewritten in
    place keeps its identity: callers pass new intrinsics (as the feeders
    do). Poses and depth scales are no part of it."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, key: tuple, build):
        old = self._key
        if old is None or len(old) != len(key) or not all(_same(a, b) for a, b in zip(key, old)):
            self._value, self._key = build(), key
        return self._value


def intrinsics_key(intr: Intrinsics) -> tuple:
    """What the cameras depend on of ``intr``, for :class:`Memo` keys."""
    return (intr.fx, intr.fy, intr.ppx, intr.ppy, intr.coeffs, int(intr.model), intr.width,
            intr.height)


# -- plain versions ---------------------------------------------------------


def fuse_prep_plain(depth, color, depth_scale, min_depth, max_depth, intrinsics: Intrinsics,
                    transform, fused_intrinsics: Intrinsics, mirror: bool, z_near, z_far
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fuse_prep` (output (a) of one camera): the
    kernel's operations one at a time, in the JAX op order."""
    device = depth.device
    src, dst = intrinsics, fused_intrinsics
    scale = _f32(depth_scale, device)
    h, w = depth.shape
    ow, oh = dst.width, dst.height
    d = depth.to(torch.float32)
    lo = F._u16_threshold(min_depth, scale, device).to(torch.float32)
    hi = F._u16_threshold(max_depth, scale, device).to(torch.float32)
    valid = (d >= lo) & (d <= hi) & (depth > 0)
    z0 = d * scale
    u, v = G.pixel_grid(h, w, torch.float32, device)
    x0 = (u - _f32(src.ppx, device)) / _f32(src.fx, device) * z0
    y0 = (v - _f32(src.ppy, device)) / _f32(src.fy, device) * z0
    x, y, z = G.transform_planar(x0, y0, z0, transform.to(device=device, dtype=torch.float32))
    pos_z = z > 0
    inv_z = torch.reciprocal(torch.where(pos_z, z, 1.0))
    image_x = _f32(dst.ppx, device) + _f32(dst.fx, device) * x * inv_z
    image_y = _f32(dst.ppy, device) + _f32(dst.fy, device) * y * inv_z
    px = torch.clamp(image_x + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    py = torch.clamp(image_y + 0.5, -_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)
    ok = valid & pos_z & (px >= 0) & (py >= 0) & (px <= ow - 1) & (py <= oh - 1)
    if mirror:
        px = (ow - 1) - px
    flat = torch.where(ok, py * ow + px, ow * oh)
    z_near, z_far = _f32(z_near, device), _f32(z_far, device)
    zq = torch.clamp((z - z_near) / (z_far - z_near) * Z_LEVELS_14, 0.0, Z_LEVELS_14 - 1.0
                     ).to(torch.int64)
    c = color.to(torch.int64)
    rgb666 = ((c[..., 0] >> 2) << 12) | ((c[..., 1] >> 2) << 6) | (c[..., 2] >> 2)
    key = torch.where(ok, (zq << 18) | rgb666, 0xFFFFFFFF)
    return flat, u32_bits(key)


def fuse_prep_keys_plain(depth, color, depth_scale, cam_to_virtual, cams: PrepCameras
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fuse_prep_keys`: :func:`fuse_prep_plain` per
    camera, and its ``filter_depth`` valid plane."""
    idxs, keys, valids = [], [], []
    for c in range(cams.n):
        d, s = depth[c], depth_scale[c]
        idx, key = fuse_prep_plain(d, color[c], s, cams.min_depth, cams.max_depth,
                                   cams.intrinsics[c], cam_to_virtual[c], cams.fused,
                                   cams.mirror, cams.z_near, cams.z_far)
        idxs.append(idx.reshape(-1))
        keys.append(key.reshape(-1))
        valids.append(F.filter_depth(d, s, cams.min_depth, cams.max_depth, cams.rois[c])[1])
    return torch.cat(idxs), torch.cat(keys), torch.stack(valids)


def fuse_prep_feed_plain(depth, color, depth_scale, cam_to_virtual, cams: PrepCameras,
                         per_stream: bool = False):
    """Plain version of :func:`fuse_prep_feed`: per camera the eager chain
    ``filter_depth`` (window, ROI) → ``deproject_planar`` →
    ``transform_planar`` → ``compute_pixel_indices_planar``, plus the
    camera's pixel offset."""
    idxs, zs, oks, rgbs, valids = [], [], [], [], []
    for c in range(cams.n):
        d0, s = depth[c], depth_scale[c]
        d, valid = F.filter_depth(d0, s, cams.min_depth, cams.max_depth, cams.rois[c])
        x, y, z, valid = G.deproject_planar(d.to(torch.float32) * s, cams.intrinsics[c], valid)
        x, y, z = G.transform_planar(x, y, z, cam_to_virtual[c])
        idx, zc, ok = R.compute_pixel_indices_planar(x, y, z, valid, cams.fused, cams.mirror)
        col = color[c]
        idxs.append(idx + cams.pix_offsets[c] if cams.pix_offsets[c] else idx)
        zs.append(zc)
        oks.append(ok)
        rgbs.append(col if col.dim() == 2 else R.pack_rgb(col))
        valids.append(valid)
    shape = (cams.n, -1) if per_stream else (-1,)
    return (*(torch.stack(t).reshape(shape) for t in (idxs, zs, oks, rgbs)),
            torch.stack(valids))


# -- kernel wrappers --------------------------------------------------------


def _spaced(seq, per_camera: int):
    """(pointer, camera stride in bytes, stacked copy or None) of N separate
    tensors: addressed by the distance between them when it is the same
    for each pair (always so for two), else stacked."""
    ptrs = [t.data_ptr() for t in seq]
    steps = {b - a for a, b in zip(ptrs, ptrs[1:])}
    if len(steps) <= 1:
        return ptrs[0], steps.pop() if steps else 0, None
    stacked = torch.stack(seq)
    return stacked.data_ptr(), per_camera, stacked


def _cameras(frames, n: int, shape: tuple, dtype, name: str, device):
    """(pointer, camera stride in bytes, stacked copy or None) of N cameras'
    frames: an (N, *shape) tensor, or an N-sequence of ``shape`` tensors."""
    stacked_in = isinstance(frames, torch.Tensor)
    seq = [frames] if stacked_in else list(frames)
    want = (n, *shape) if stacked_in else shape
    if not stacked_in and len(seq) != n:
        raise ValueError(f"{name}: {len(seq)} frames for {n} cameras")
    for t in seq:
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"{name}: expected {want} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, the cameras on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    per_camera = math.prod(shape) * seq[0].element_size()
    if stacked_in:
        return frames.data_ptr(), per_camera, None
    return _spaced(seq, per_camera)


def _rows(values, n: int, size: int, name: str, device):
    """(pointer, camera stride in bytes, tensors to keep) of N cameras'
    f32 poses (``size`` 16, row-major 4×4) or depth scales (``size`` 1): an
    (N, ...) tensor of N·size elements, or an N-sequence of tensors of
    ``size`` elements. Read by the kernel on every launch, never cached."""
    stacked_in = isinstance(values, torch.Tensor)
    seq = [values] if stacked_in else list(values)
    if not stacked_in and len(seq) != n:
        raise ValueError(f"{name}: {len(seq)} values for {n} cameras")
    for t in seq:
        if not isinstance(t, torch.Tensor) or t.device != device:
            where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"{name} on {where}, the cameras on {device}")
    seq = [t.to(torch.float32).contiguous() for t in seq]  # no copy when they are
    each = n * size if stacked_in else size
    if any(t.numel() != each for t in seq):
        raise ValueError(f"{name}: expected {each} elements, got "
                         f"{[t.numel() for t in seq]}")
    if stacked_in:
        return seq[0].data_ptr(), size * 4, seq
    ptr, stride, stacked = _spaced(seq, size * 4)
    return ptr, stride, (seq, stacked)


def _packed_color(color) -> bool:
    """True for int32 rgb24 planes, False for (H, W, 3) uint8 images."""
    first = color if isinstance(color, torch.Tensor) else color[0]
    return first.dtype == torch.int32


def _launch(depth, color, depth_scale, cam_to_virtual, cams: PrepCameras, feed: bool):
    """One launch over every camera: the outputs as flat tensors."""
    device = cams.device
    first = depth if isinstance(depth, torch.Tensor) else depth[0]
    h, w = first.shape[-2:]
    n = cams.n
    d_ptr, d_stride, d_keep = _cameras(depth, n, (h, w), torch.int32, "depth", device)
    packed = _packed_color(color)
    c_shape, c_dtype = ((h, w), torch.int32) if packed else ((h, w, 3), torch.uint8)
    c_ptr, c_stride, c_keep = _cameras(color, n, c_shape, c_dtype, "color", device)
    p_ptr, p_stride, p_keep = _rows(cam_to_virtual, n, 16, "cam_to_virtual", device)
    s_ptr, s_stride, s_keep = _rows(depth_scale, n, 1, "depth_scale", device)
    n_all = n * h * w
    idx = torch.empty(n_all, dtype=torch.int32, device=device)
    valid = torch.empty((n, h, w), dtype=torch.bool, device=device)
    key = z = ok = rgb24 = None
    # A stacked int32 color is the rgb24 feed as it stands; the kernel
    # writes it otherwise.
    reuse_rgb = packed and isinstance(color, torch.Tensor)
    if feed:
        z = torch.empty(n_all, dtype=torch.float32, device=device)
        ok = torch.empty(n_all, dtype=torch.bool, device=device)
        rgb24 = color.reshape(-1) if reuse_rgb else torch.empty_like(idx)
    else:
        key = torch.empty_like(idx)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(_build.load().fuse_prep_launch(
        d_ptr, d_stride, c_ptr, c_stride, int(packed), p_ptr, p_stride, s_ptr, s_stride,
        cams.static.data_ptr(), cams.ints.data_ptr(), n, h, w, cams.fused.width,
        cams.fused.height, int(cams.mirror), int(feed), idx.data_ptr(), ptr(key), ptr(z),
        ptr(ok), ptr(rgb24), int(feed and not reuse_rgb), valid.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "fuse_prep_launch")
    del d_keep, c_keep, p_keep, s_keep  # freed after the launch, in stream order
    launches["fuse_prep"] += 1
    return idx, key, z, ok, rgb24, valid


def _on_card(depth, cams: PrepCameras) -> bool:
    """True to launch the kernel: by the frames' device, which the cameras
    must share."""
    dev = (depth if isinstance(depth, torch.Tensor) else depth[0]).device
    if dev != cams.device:
        raise ValueError(f"frames on {dev}, the cameras on {cams.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def fuse_prep_feed(depth, color, depth_scale, cam_to_virtual, cams: PrepCameras,
                   per_stream: bool = False):
    """Output (b) for all N cameras of a frame in one launch: (idx int32,
    z f32, ok bool, rgb24 int32), each (N·H·W,) camera-major or, with
    ``per_stream``, (N, H·W) (kernel B7's feed); and the (N, H, W) bool
    valid planes. ``idx`` is ``w·h`` (the dump slot) where a point is
    dropped, plus the camera's pixel offset.

    ``depth``: (N, H, W) int32 or N (H, W) tensors; ``color``: (N, H, W, 3)
    uint8 or (N, H, W) int32 rgb24, or N such tensors; ``depth_scale``:
    (N,) or N 0-d tensors; ``cam_to_virtual``: (N, 4, 4) or N (4, 4)
    tensors, camera → virtual camera."""
    if not _on_card(depth, cams):
        return fuse_prep_feed_plain(depth, color, depth_scale, cam_to_virtual, cams, per_stream)
    idx, _, z, ok, rgb24, valid = _launch(depth, color, depth_scale, cam_to_virtual, cams, True)
    shape = (cams.n, -1) if per_stream else (-1,)
    return idx.reshape(shape), z.reshape(shape), ok.reshape(shape), rgb24.reshape(shape), valid


def fuse_prep_keys(depth, color, depth_scale, cam_to_virtual, cams: PrepCameras):
    """Output (a) for all N cameras in one launch: (flat index (N·H·W,)
    int32, packed key bits (N·H·W,) int32, valid (N, H, W) bool). Color is
    (H, W, 3) uint8; pinhole and without a ROI, as the Pallas kernel."""
    if any(r is not None for r in cams.rois):
        raise ValueError("the packed-key prep takes no ROI")
    if not _on_card(depth, cams):
        return fuse_prep_keys_plain(depth, color, depth_scale, cam_to_virtual, cams)
    if _packed_color(color):
        raise ValueError("the packed-key prep takes (H, W, 3) uint8 color")
    idx, key, _, _, _, valid = _launch(depth, color, depth_scale, cam_to_virtual, cams, False)
    return idx, key, valid


def fuse_prep(depth: torch.Tensor, color: torch.Tensor, depth_scale, min_depth, max_depth,
              intrinsics: Intrinsics, transform: torch.Tensor, fused_intrinsics: Intrinsics,
              mirror: bool, z_near, z_far, tile_rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat index, packed key bits) for every pixel of one camera: the
    JAX package's API, one launch of output (a).

    ``depth``: (H, W) int32 raw depth; ``color``: (H, W, 3) uint8;
    ``transform``: 4×4 camera → virtual camera. ``tile_rows`` is accepted
    for parity with the JAX package and must divide H; the kernel does not
    tile rows."""
    h, w = depth.shape
    if tile_rows is None:
        tile_rows = largest_tile_rows(h)
    if h % tile_rows != 0:
        raise ValueError(f"tile_rows={tile_rows} must divide the image height {h}")
    if depth.dtype != torch.int32 or color.dtype != torch.uint8 or color.shape != (h, w, 3):
        raise ValueError(f"expected (H, W) int32 depth and (H, W, 3) uint8 color, got "
                         f"{tuple(depth.shape)} {depth.dtype}, {tuple(color.shape)} {color.dtype}")
    if color.device != depth.device:
        raise ValueError(f"color on {color.device}, depth on {depth.device}")
    if depth.device.type == "cpu":
        return fuse_prep_plain(depth, color, depth_scale, min_depth, max_depth, intrinsics,
                               transform, fused_intrinsics, mirror, z_near, z_far)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if not (depth.is_contiguous() and color.is_contiguous()):
        raise ValueError("expected contiguous depth and color")
    cams = prep_cameras(intrinsics, fused_intrinsics, min_depth, max_depth, mirror,
                        z_near=z_near, z_far=z_far, device=depth.device)
    idx, key, _ = fuse_prep_keys(depth[None], color[None], (_f32(depth_scale, depth.device),),
                                 (transform.to(depth.device),), cams)
    return idx.reshape(h, w), key.reshape(h, w)
