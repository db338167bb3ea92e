"""N-camera rig fusion: port of pointcloud_depthfusion_tpu/parallel/mesh.py.

Every camera of the rig contributes (pixel, z bits, rgb24) entries to one
fused virtual image; the per-pixel winner is the smallest f32 depth, ties
going to the smaller packed RGB, as in the dual fused frame. The prep of
every camera is one launch of kernel B3 (ops/cuda/fuse_prep_cuda.py), whose
masked feed (``feed_all``) the resolve takes:

- ``tiled`` (or ``exact``), image only: kernel B1;
- ``tiled`` with the z-buffer: kernel B2;
- ``tiled`` with ``multi_stream=True``: kernel B7, the (S, N) feed;
- ``packed``: the uint32 scatter-min, which builds the (zq14 | RGB666) keys
  from the feed and decodes their minimum in the same launch;
- the color tail (decode, interleave, and with ``config.filter_fused_color``
  the 3×3 filter): one launch of kernel B4's image kernel per call.

:func:`rig_fuse` and :func:`batched_rig_fuse` build the step on one device
(``device=None``: the card) and return ``fn(depth, color, depth_scale,
cam_to_virtual)``.

:func:`rig_fuse_sharded` shards the CAMERAS over a :class:`CameraMesh`
(:func:`make_camera_mesh`): each shard runs B3 and the resolve (B2, or the
scatter-min's raw keys in ``packed``) on its own cameras, and the shards'
buffers merge by one elementwise MIN: first over this process's shards, in
shard order, then ``torch.distributed.all_reduce(MIN)`` over the mesh's
process group when it spans processes (parallel/multihost.py). The JAX
package's two ``pmin`` collectives of the ``tiled`` merge (min z bits, then
the min rgb among the shards holding that z) are one MIN over the int64 key
``minz << 32 | mrgb``: both halves are non-negative int32, INT32_MAX where
empty. The ``packed`` keys merge as their uint32 values held in int64. The
merged winners go through B4's image kernel once, replicated on the first
shard's device.

A mesh may put several shards on one device: on one H100,
``make_camera_mesh(4)`` holds four shards on ``cuda:0``, as the JAX
package's test mesh holds eight virtual devices on one CPU. Those shards
run one after another on that device's stream; the resolve keeps its key
buffer per (device, stream), so two shards never fill it at once.

The per-pixel chain keeps the JAX package's f32 operation order term by
term, and every divisor is a tensor on the device: a Python float divisor
makes CUDA multiply by its reciprocal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, color_mode
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import (
    INT32_MAX,
    INVALID_PIX,
    u32_bits,
)


class _RigCalibration:
    """Shared or per-camera source calibration of the rig bodies, on one
    device.

    ``intrinsics`` is ONE shared :class:`Intrinsics` or a sequence of N
    (the reference's per-camera handshake, fusion_node.cpp:92-148); width,
    height and the distortion model must agree across cameras. ``rois``:
    optional per-camera [x, y, w, h] (or None) validity ROIs
    (kernels.cu:379-384), held as one (C, H, W) bool mask stack for the
    per-camera API and as rectangles in kernel B3's table.
    """

    def __init__(self, intrinsics, rois=None, device=None):
        if isinstance(intrinsics, Intrinsics):
            self.ref = intrinsics.to(device)
            self.seq = None
        else:
            seq = tuple(it.to(device) for it in intrinsics)
            if not seq:
                raise ValueError("need at least one camera's intrinsics")
            self.ref = seq[0]
            for it in seq[1:]:
                if (it.width, it.height, it.model) != (
                    self.ref.width, self.ref.height, self.ref.model
                ):
                    raise ValueError(
                        "per-camera intrinsics must share width/height/"
                        "distortion model (they are static shape/program "
                        "parameters); traced leaves (fx/fy/ppx/ppy/coeffs) "
                        "may differ freely"
                    )
            self.seq = seq
        self.rois = None
        self.masks = None
        if rois is not None:
            self.rois = tuple(
                None if r is None else tuple(int(v) for v in r) for r in rois
            )
            if self.seq is not None and len(self.rois) != len(self.seq):
                raise ValueError(
                    f"{len(self.rois)} rois for {len(self.seq)} per-camera "
                    "intrinsics — the per-camera axes must agree"
                )
            h, w = self.ref.height, self.ref.width
            self.masks = torch.stack([F.roi_mask(h, w, r, device) for r in self.rois])

    @property
    def per_camera(self) -> bool:
        return self.seq is not None or self.rois is not None

    @property
    def n_cameras(self) -> Optional[int]:
        """Number of per-camera calibration entries (None when shared)."""
        if self.seq is not None:
            return len(self.seq)
        if self.rois is not None:
            return len(self.rois)
        return None

    def _cameras(self, n_local: int, cam_offset: Optional[int]) -> list:
        """Global calibration index of each of ``n_local`` local cameras:
        ``cam_offset + i`` on a shard, else the calibrated cameras tiled to
        a multiple (the batched path)."""
        c = self.n_cameras
        if cam_offset is not None:
            return [cam_offset + i for i in range(n_local)]
        if c is not None and n_local % c:
            raise ValueError(
                f"{n_local} local cameras is not a multiple of the "
                f"{c} calibrated cameras"
            )
        return [i % c if c else 0 for i in range(n_local)]

    def prep_cameras(self, n_local: int, fused_intrinsics: Intrinsics, config: FusionConfig,
                     pix_offsets=None, cam_offset: Optional[int] = None) -> B3.PrepCameras:
        """Kernel B3's cameras for ``n_local`` local cameras (see
        :meth:`_cameras`)."""
        idx = self._cameras(n_local, cam_offset)
        intr = tuple(self.at(i) for i in idx)
        rois = None if self.rois is None else tuple(self.rois[i] for i in idx)
        return B3.prep_cameras(intr, fused_intrinsics, config.min_depth, config.max_depth,
                               config.mirror_image, rois=rois, pix_offsets=pix_offsets,
                               device=self.ref.device)

    def windows(self, n_local: int, cam_offset: Optional[int] = None):
        """(ppx, ppy, fx, fy, coeffs) broadcastable against (N, H, W): the
        shared camera's leaves, or (N, 1, 1) per-camera ones (coeffs
        (5, N, 1, 1))."""
        if self.seq is None:
            i = self.ref
            return i.ppx, i.ppy, i.fx, i.fy, i.coeffs
        cams = [self.seq[i] for i in self._cameras(n_local, cam_offset)]

        def e(name):
            return torch.stack([getattr(c, name) for c in cams], -1)[..., :, None, None]

        return e("ppx"), e("ppy"), e("fx"), e("fy"), e("coeffs")

    def valid_roi(self, valid: torch.Tensor, cam_offset: Optional[int] = None) -> torch.Tensor:
        """AND the per-camera ROI masks into an (N, H, W) validity mask."""
        if self.masks is None:
            return valid
        return valid & self.masks[self._cameras(valid.shape[0], cam_offset)]

    def at(self, i: int, cam_offset: Optional[int] = None) -> Intrinsics:
        """Camera i's Intrinsics (i local; ``cam_offset`` shifts it into the
        global camera axis on sharded paths)."""
        if self.seq is None:
            return self.ref
        return self.seq[i + (cam_offset or 0)]

    def roi_at(self, i: int, cam_offset: Optional[int] = None) -> Optional[torch.Tensor]:
        return None if self.masks is None else self.masks[i + (cam_offset or 0)]


def _rgb24_of(color: torch.Tensor, ref_ndim: int) -> torch.Tensor:
    """rgb24 int32 from either an (…, 3) u8 HWC image or a pre-packed (…)
    int32 plane (Frameset.color_packed semantics): the rank tells which."""
    if color.dim() == ref_ndim:
        return color.to(torch.int32)
    return R.pack_rgb(color)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _feed_fn(calib: _RigCalibration, fused_intrinsics: Intrinsics, config: FusionConfig):
    """``feed_all(depth, color, depth_scale, cam_to_virtual, pix_offsets=None,
    per_stream=False)``: all N cameras' masked feed (idx int32, z f32, ok
    bool, rgb24 int32) from one B3 launch.

    ``pix_offsets``: optional N per-camera pixel offsets, ints or an (N,)
    int32 tensor (the batched rig routes each stream into its own slice
    this way). ``per_stream=True`` keeps the (N, H·W) camera axis (the B7
    feed). B3's cameras are built once per camera count and offsets; the
    kernel reads ``cam_to_virtual`` and ``depth_scale`` on every call."""
    prep = {}

    def feed_all(depth, color, depth_scale, cam_to_virtual, pix_offsets=None,
                 per_stream=False, cam_offset=None):
        if isinstance(pix_offsets, torch.Tensor):
            pix_offsets = pix_offsets.tolist()
        offsets = None if pix_offsets is None else tuple(int(o) for o in pix_offsets)
        # A shared calibration serves every shard with the same cameras.
        cam_offset = cam_offset if calib.per_camera else None
        key = (depth.shape[0], offsets, cam_offset)
        if key not in prep:
            prep[key] = calib.prep_cameras(depth.shape[0], fused_intrinsics, config, offsets,
                                           cam_offset)
        *feed, _ = B3.fuse_prep_feed(depth, color, depth_scale, cam_to_virtual, prep[key],
                                     per_stream)
        return tuple(feed)

    return feed_all


def _packed_rig_body(calib: _RigCalibration, fused_intrinsics: Intrinsics,
                     config: FusionConfig, z_near: float, z_far: float):
    """The packed (zq14 | RGB666) rig body: (project_one, local_planes,
    local_buffer). ``project_one`` is one camera's (pixel, key) pair, the
    JAX API; ``local_planes`` folds every camera into one uint32
    scatter-min (B3's feed, the keys built and decoded in the scatter-min's
    launch); ``local_buffer`` is the same launch's raw minimum key bits, the
    sharded rig's merge operand."""
    device = calib.ref.device
    n_px = fused_intrinsics.width * fused_intrinsics.height
    z_levels = float((1 << 14) - 1)
    # The JAX body divides by the Python float (z_far - z_near): its f64
    # difference rounded once to f32, a 0-d tensor here.
    near, span = _f32(z_near, device), _f32(z_far - z_near, device)
    zparams = Z.packed_zparams(z_near, z_far, device, span=z_far - z_near)
    feed_all = _feed_fn(calib, fused_intrinsics, config)

    def project_one(depth1, color1, scale1, t1, intr1=None, roi1=None):
        d, valid = F.filter_depth(depth1, scale1, config.min_depth, config.max_depth)
        if roi1 is not None:
            valid = valid & roi1
        x, y, z, valid = G.deproject_planar(
            d.to(torch.float32) * scale1, intr1 if intr1 is not None else calib.ref, valid
        )
        x, y, z = G.transform_planar(x, y, z, t1)
        idx, zc, ok = R.compute_pixel_indices_planar(
            x, y, z, valid, fused_intrinsics, config.mirror_image
        )
        # Clipped to z_levels - 1, so a far near-white point's key never
        # equals the all-ones sentinel (ops/render._packed_zq_hi).
        zq = torch.clamp((zc - near) / span * z_levels, 0.0, z_levels - 1.0).to(torch.int64)
        p24 = _rgb24_of(color1, depth1.dim()).to(torch.int64)
        rgb666 = (((p24 >> 18) & 0x3F) << 12) | (((p24 >> 10) & 0x3F) << 6) | ((p24 >> 2) & 0x3F)
        key = torch.where(ok, (zq << 18) | rgb666, 0xFFFFFFFF)
        return idx, u32_bits(key)

    def local_planes(depth, color, depth_scale, cam_to_virtual, pix_offsets=None,
                     n_slots: int = n_px):
        """The (r, g, b) u8 planes, (n_slots,) each, of every camera's
        packed minimum (black where uncovered)."""
        feed = feed_all(depth, color, depth_scale, cam_to_virtual, pix_offsets)
        return Z.scatter_min_packed(*feed, n_slots, zparams, planes=True)[:3]

    def local_buffer(depth, color, depth_scale, cam_to_virtual, cam_offset=None):
        """(n_px,) int32 bits of every local camera's packed minimum key
        (all-ones where uncovered)."""
        feed = feed_all(depth, color, depth_scale, cam_to_virtual, cam_offset=cam_offset)
        return Z.scatter_min_packed(*feed, n_px, zparams, planes=False)

    return project_one, local_planes, local_buffer


def _decode_rgb666_planes(merged: torch.Tensor) -> tuple:
    """A flat packed (zq14 | RGB666) buffer (int32 bits) as three flat u8
    channel planes, black where the all-ones sentinel says uncovered: the
    one packed-layout decode (``zresolve_cuda.decode_packed_plain``); the z
    field is discarded."""
    return Z.decode_packed_plain(merged, None, False)[:3]


def _decode_rgb666(merged: torch.Tensor) -> torch.Tensor:
    """:func:`_decode_rgb666_planes` as (n, 3) u8 colors."""
    return torch.stack(_decode_rgb666_planes(merged), -1)


def _finish_planes(planes, config: FusionConfig) -> torch.Tensor:
    """The fused-image tail of the packed rig paths: the reference's fused
    color filter (fusion_node.cpp:789 → kernels.cu:594-653) when
    ``config.filter_fused_color``; (..., H, W) planes in, (..., H, W, 3)
    u8 out, each (H, W) image apart; one B4 launch."""
    return B4.planes_image(planes, color_mode(config))


def _finish_winner(mrgb, config: FusionConfig, h_f: int, w_f: int) -> torch.Tensor:
    """The tail of the tiled rig paths: packed winners (..., H·W) in,
    decoded and filtered (..., H, W, 3) u8 out; one B4 launch."""
    return B4.winner_image(mrgb, h_f, w_f, color_mode(config))


def _rig_render_mode(config: FusionConfig) -> str:
    """'exact' aliases to 'tiled' (the same winner contract); modes other
    than tiled/exact/packed raise."""
    mode = config.render_mode
    if mode == "exact":
        return "tiled"
    if mode not in ("tiled", "packed"):
        raise ValueError(
            f"rig fusion supports render_mode 'tiled'/'exact' (bit-exact) "
            f"or 'packed' (lossy RGB666), not {mode!r}"
        )
    return mode


def _tiled_rig_body(calib: _RigCalibration, fused_intrinsics: Intrinsics,
                    config: FusionConfig):
    """The bit-exact rig body: every camera contributes (pixel, z bits,
    rgb24) entries and one resolve kernel picks the winners. Returns
    (entries_one, entries_all, local_minbufs, unpack, local_winner_rgb,
    feed_all)."""
    n_px = fused_intrinsics.width * fused_intrinsics.height

    def entries_one(depth1, color1, scale1, t1, pix_offset=0, intr1=None, roi1=None):
        """One camera's flat (pix, zbits, rgb) entries."""
        d, valid = F.filter_depth(depth1, scale1, config.min_depth, config.max_depth)
        if roi1 is not None:
            valid = valid & roi1
        x, y, z, valid = G.deproject_planar(
            d.to(torch.float32) * scale1, intr1 if intr1 is not None else calib.ref, valid
        )
        x, y, z = G.transform_planar(x, y, z, t1)
        idx, zc, ok = R.compute_pixel_indices_planar(
            x, y, z, valid, fused_intrinsics, config.mirror_image
        )
        okf = ok.reshape(-1)
        pix = torch.where(okf, idx.reshape(-1) + pix_offset, INVALID_PIX).to(torch.int32)
        zbits = torch.where(okf, zc.to(torch.float32).reshape(-1).view(torch.int32), INT32_MAX)
        rgb = torch.where(okf, _rgb24_of(color1, depth1.dim()).reshape(-1), INT32_MAX)
        return pix, zbits, rgb

    feed_all = _feed_fn(calib, fused_intrinsics, config)

    def entries_all(depth, color, depth_scale, cam_to_virtual, pix_offsets=None,
                    per_stream=False):
        """The JAX API's (pix, zbits, rgb) entries of :func:`feed_all`'s
        masked feed (INVALID_PIX and INT32_MAX where a point is dropped)."""
        return Z.masked_entries(*feed_all(depth, color, depth_scale, cam_to_virtual,
                                          pix_offsets, per_stream))

    def local_minbufs(depth, color, depth_scale, cam_to_virtual, multi_stream=False,
                      cam_offset=None):
        """(min z bits, rgb of the winner) per fused pixel: B7 on the
        per-camera streams with ``multi_stream`` and two or more cameras,
        else B2 on the flat feed; the kernel masks the entries."""
        per_stream = multi_stream and depth.shape[0] >= 2
        mrgb, minz = Z.zresolve_masked(
            *feed_all(depth, color, depth_scale, cam_to_virtual, per_stream=per_stream,
                      cam_offset=cam_offset),
            n_px, True)
        return minz, mrgb

    def local_winner_rgb(depth, color, depth_scale, cam_to_virtual):
        """Image-only resolve (B1): the winner's rgb per fused pixel."""
        return Z.zresolve_masked(*feed_all(depth, color, depth_scale, cam_to_virtual),
                                 n_px, False)[0]

    def unpack(mrgb):
        # The winner's rgb alone marks coverage: a covered rgb24 is below
        # INT32_MAX, the resolve's empty value, with or without the z-buffer.
        return _finish_winner(mrgb, config, fused_intrinsics.height, fused_intrinsics.width)

    return entries_one, entries_all, local_minbufs, unpack, local_winner_rgb, feed_all


def _on_device(intrinsics, fused_intrinsics, config, rois, device):
    device = resolve_device(device)
    return (_RigCalibration(intrinsics, rois, device), fused_intrinsics.to(device),
            config.to(device), device)


def rig_fuse(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    z_near: float = 0.25,
    z_far: float = 4.5,
    multi_stream: bool = False,
    rois=None,
    device=None,
):
    """Single-device N-camera rig fusion on ``device`` (``None``: the card).

    Returns ``fn(depth (N, H, W) int32, color (N, H, W, 3) u8 or pre-packed
    (N, H, W) int32 rgb24, depth_scale (N,) f32, cam_to_virtual (N, 4, 4)
    f32) -> (Hf, Wf, 3) u8``, all tensors on ``device``; ``fn.device`` names
    it. Depth is expected aligned to color (rs2::align at capture,
    realsense.cpp:373-376).

    ``intrinsics``: one shared Intrinsics or a per-camera sequence (width,
    height and distortion model must agree); ``rois``: optional per-camera
    [x, y, w, h] validity ROIs. ``render_mode`` "tiled"/"exact" resolves
    exactly (B1 image only when ``config.emit_zbuf`` is False, else B2, or
    B7 with ``multi_stream``); "packed" runs the lossy (zq14 | RGB666)
    scatter-min; other modes raise.
    """
    calib, fused, config, device = _on_device(intrinsics, fused_intrinsics, config, rois,
                                              device)
    n_cal = calib.n_cameras

    def check_count(depth):
        # The calibration must match the camera axis exactly here: the tile
        # fallback of _RigCalibration._take serves the batched path only.
        if n_cal is not None and depth.shape[0] != n_cal:
            raise ValueError(
                f"rig got {depth.shape[0]} cameras but {n_cal} per-camera "
                "calibration entries — they must match exactly (use "
                "batched_rig_fuse for B rigs sharing one calibration)"
            )

    if _rig_render_mode(config) == "tiled":
        _, _, local_minbufs, unpack_t, local_winner, _ = _tiled_rig_body(calib, fused, config)

        if not config.emit_zbuf and not multi_stream:
            def fn(depth, color, depth_scale, cam_to_virtual):
                check_count(depth)
                return unpack_t(local_winner(depth, color, depth_scale, cam_to_virtual))
        else:
            def fn(depth, color, depth_scale, cam_to_virtual):
                check_count(depth)
                _, mrgb = local_minbufs(depth, color, depth_scale, cam_to_virtual,
                                        multi_stream=multi_stream)
                return unpack_t(mrgb)
    else:
        local_planes = _packed_rig_body(calib, fused, config, z_near, z_far)[1]

        def fn(depth, color, depth_scale, cam_to_virtual):
            check_count(depth)
            planes = local_planes(depth, color, depth_scale, cam_to_virtual)
            return _finish_planes([p.reshape(fused.height, fused.width) for p in planes], config)

    fn.device = device
    return fn


def batched_rig_fuse(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    batch: int,
    cameras: int,
    z_near: float = 0.25,
    z_far: float = 4.5,
    rois=None,
    device=None,
):
    """Fuse B independent rigs (streams) of C cameras in one call.

    ``intrinsics``/``rois``: shared, or per-camera sequences of length
    ``cameras`` (every stream fuses the same physical rig). Each stream's
    entries land in their own slice of one flat (B·Hf·Wf,) buffer by a
    pixel offset of ``b·Hf·Wf``: one resolve for the whole batch.

    Returns ``fn(depth (B, C, H, W), color (B, C, H, W, 3) u8 or (B, C, H, W)
    int32, depth_scale (B, C), cam_to_virtual (B, C, 4, 4)) -> (B, Hf, Wf, 3)
    u8``; ``fn.device`` names the device.
    """
    calib, fused, config, device = _on_device(intrinsics, fused_intrinsics, config, rois,
                                              device)
    if calib.n_cameras is not None and calib.n_cameras != cameras:
        raise ValueError(
            f"batched rig got {calib.n_cameras} per-camera calibration "
            f"entries for cameras={cameras} — every stream fuses the same "
            "physical rig, so the calibration must cover exactly one rig"
        )
    n_px = fused.width * fused.height
    h_f, w_f = fused.height, fused.width
    if batch * n_px >= INVALID_PIX:
        raise ValueError(
            f"{batch} streams of {n_px} pixels reach the invalid pixel id "
            f"{INVALID_PIX:#x}; use fewer streams per call"
        )
    total_px = batch * n_px

    # Each stream into its own slice of the batch's pixels.
    stream_offsets = tuple(b * n_px for b in range(batch) for _ in range(cameras))

    def flat(depth, color, depth_scale, cam_to_virtual):
        h, w = depth.shape[-2:]
        n = batch * cameras
        color_flat = (color.reshape(n, h, w) if color.dim() == depth.dim()
                      else color.reshape(n, h, w, 3))
        return (depth.reshape(n, h, w), color_flat, depth_scale.reshape(-1),
                cam_to_virtual.reshape(n, 4, 4))

    if _rig_render_mode(config) == "tiled":
        feed_all = _feed_fn(calib, fused, config)

        def fn(depth, color, depth_scale, cam_to_virtual):
            feed = feed_all(*flat(depth, color, depth_scale, cam_to_virtual),
                            pix_offsets=stream_offsets)
            mrgb, _ = Z.zresolve_masked(*feed, total_px, True)
            return _finish_winner(mrgb.reshape(batch, n_px), config, h_f, w_f)
    else:
        local_planes = _packed_rig_body(calib, fused, config, z_near, z_far)[1]

        def fn(depth, color, depth_scale, cam_to_virtual):
            planes = local_planes(*flat(depth, color, depth_scale, cam_to_virtual),
                                  pix_offsets=stream_offsets, n_slots=total_px)
            return _finish_planes([p.reshape(batch, h_f, w_f) for p in planes], config)

    fn.device = device
    return fn


# ---------------------------------------------------------------------------
# The camera-sharded rig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CameraMesh:
    """A 1-D mesh over the camera axis.

    ``devices``: this process's shards in axis order (one device may hold
    several); ``axis``: the axis name (``shape[axis]`` is the shard count,
    as in a JAX mesh); ``group``: the ``torch.distributed`` process group
    joining the processes of a mesh that spans them (parallel/multihost.py),
    or None for one process. Process k holds the shards
    ``[k·len(devices), (k+1)·len(devices))`` of the axis.
    """

    devices: Tuple[torch.device, ...]
    axis: str = "cam"
    group: Optional[object] = None

    @property
    def n_processes(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist  # noqa: PLC0415

        return dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist  # noqa: PLC0415

        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards on the whole axis, every process's."""
        return len(self.devices) * self.n_processes

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def first_shard(self) -> int:
        """Axis index of this process's first shard."""
        return self.process_index * len(self.devices)


def make_camera_mesh(n_cameras: Optional[int] = None, axis: str = "cam",
                     device=None) -> CameraMesh:
    """A 1-D mesh of ``n_cameras`` shards (default: one per device).

    ``device=None`` takes the CUDA devices and raises without a card;
    ``device`` may name one device or give a sequence of them (``"cpu"``
    for a CPU mesh). With more shards than devices, consecutive shards
    share a device: on one H100, ``make_camera_mesh(4)`` puts four shards
    on ``cuda:0``."""
    if device is None:
        resolve_device(None)
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(device, (list, tuple)):
        pool = [torch.device(d) for d in device]
    else:
        pool = [torch.device(device)]
    if any(d.type == "cuda" for d in pool) and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass device='cpu' for a CPU mesh")
    n = n_cameras or len(pool)
    return CameraMesh(tuple(pool[i * len(pool) // n] for i in range(n)), axis)


@dataclasses.dataclass(frozen=True)
class ShardedCameras:
    """A camera-axis tensor split over a mesh: ``shards[i]`` holds this
    process's shard i's cameras on that shard's device; ``n_cameras``
    counts the cameras of the whole axis, every process's."""

    shards: Tuple[torch.Tensor, ...]
    n_cameras: int

    @property
    def shape(self) -> tuple:
        return (self.n_cameras, *self.shards[0].shape[1:])


def shard_cameras(mesh: CameraMesh, tensor, axis: Optional[str] = None) -> ShardedCameras:
    """Split this process's cameras (the leading axis of ``tensor``, a
    tensor or array) over its shards, each slice copied to its shard's
    device. A :class:`ShardedCameras` passes through."""
    if isinstance(tensor, ShardedCameras):
        if len(tensor.shards) != len(mesh.devices):
            raise ValueError(f"{len(tensor.shards)} shards for a mesh of "
                             f"{len(mesh.devices)} local shards")
        return tensor
    t = torch.as_tensor(tensor)
    n_local = len(mesh.devices)
    if t.shape[0] % n_local:
        raise ValueError(
            f"{t.shape[0]} cameras not divisible by the {n_local}-device "
            f"'{axis or mesh.axis}' mesh axis"
        )
    c = t.shape[0] // n_local
    return ShardedCameras(
        tuple(t[i * c:(i + 1) * c].to(d) for i, d in enumerate(mesh.devices)),
        t.shape[0] * mesh.n_processes,
    )


def _merge_min(mesh: CameraMesh, keys) -> torch.Tensor:
    """Elementwise MIN of the shards' int64 keys, in shard order, on the
    first shard's device; then over the mesh's processes (all_reduce)."""
    out = keys[0]
    for k in keys[1:]:
        out = torch.minimum(out, k.to(out.device))
    if mesh.group is not None:
        import torch.distributed as dist  # noqa: PLC0415

        out = out.contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.group)
    return out


def rig_fuse_sharded(
    mesh: CameraMesh,
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    axis: str = "cam",
    z_near: float = 0.25,
    z_far: float = 4.5,
    rois=None,
):
    """The camera-sharded rig fusion step over ``mesh``.

    Returns ``fn(depth (N, H, W) int32, color (N, H, W, 3) u8 or (N, H, W)
    int32 rgb24, depth_scale (N,), cam_to_virtual (N, 4, 4)) -> fused image
    (Hf, Wf, 3) u8`` on the first shard's device, the same in every process
    (the JAX result is replicated). Each argument is a
    :class:`ShardedCameras` (the ``RigFeeder(mesh=)`` upload) or this
    process's cameras as one tensor, split over its shards here; shard s
    holds cameras ``[s·C, (s+1)·C)`` of the axis.

    ``tiled``/``exact``: each shard resolves its cameras with the z-buffer
    (B2) and the shards merge by one MIN of ``minz << 32 | mrgb`` (see the
    module docstring); ``emit_zbuf=False`` raises, as in the JAX package.
    ``packed``: each shard's raw scatter-min keys, one MIN, then the
    RGB666 decode. ``intrinsics``/``rois`` may be per-camera sequences
    covering the whole axis; each shard reads its own cameras' entries.
    """
    n_shards = mesh.shape[axis]
    mode = _rig_render_mode(config)
    if mode == "tiled" and not config.emit_zbuf:
        # The cross-shard merge needs each shard's min z: a shard's winner
        # must be able to lose to a closer camera on another shard.
        raise ValueError(
            "rig_fuse_sharded(tiled) cannot honor emit_zbuf=False: the "
            "cross-device merge pmins per-device min-z buffers. Use "
            "emit_zbuf=True for sharded rigs (single-device rig_fuse "
            "honors the image-only resolve)."
        )
    bodies = {}
    for dev in dict.fromkeys(mesh.devices):
        calib, fused, cfg, _ = _on_device(intrinsics, fused_intrinsics, config, rois, dev)
        if mode == "tiled":
            local_minbufs = _tiled_rig_body(calib, fused, cfg)[2]

            def local(d, c, s, t, cam_offset, _fn=local_minbufs):
                minz, mrgb = _fn(d, c, s, t, cam_offset=cam_offset)
                return (minz.to(torch.int64) << 32) | mrgb.to(torch.int64)
        else:
            local_buffer = _packed_rig_body(calib, fused, cfg, z_near, z_far)[2]

            def local(d, c, s, t, cam_offset, _fn=local_buffer):
                return Z.u32_value(_fn(d, c, s, t, cam_offset=cam_offset))
        bodies[dev] = local
        if dev == mesh.devices[0]:
            calib0, fused0, config0 = calib, fused, cfg
    n_cal = calib0.n_cameras
    h_f, w_f = fused0.height, fused0.width

    def fn(depth, color, depth_scale, cam_to_virtual):
        n = depth.shape[0] if isinstance(depth, ShardedCameras) else (
            depth.shape[0] * mesh.n_processes)
        if n_cal is not None and n != n_cal:
            raise ValueError(
                f"sharded rig got {n} cameras but {n_cal} per-camera calibration "
                "entries — they must match exactly (axis_index offsets index the "
                "global calibration axis)"
            )
        args = [shard_cameras(mesh, a, axis).shards
                for a in (depth, color, depth_scale, cam_to_virtual)]
        per_shard = n // n_shards
        keys = [bodies[dev](*(a[s] for a in args), (mesh.first_shard + s) * per_shard)
                for s, dev in enumerate(mesh.devices)]
        merged = _merge_min(mesh, keys)
        if mode == "tiled":
            mrgb = (merged & 0xFFFFFFFF).to(torch.int32)
            return _finish_winner(mrgb, config0, h_f, w_f)
        planes = _decode_rgb666_planes(Z.u32_bits(merged))
        return _finish_planes([p.reshape(h_f, w_f) for p in planes], config0)

    fn.device = mesh.devices[0]
    return fn
