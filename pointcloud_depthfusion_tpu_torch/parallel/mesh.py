"""N-camera rig fusion on one device: port of the single-device subset of
pointcloud_depthfusion_tpu/parallel/mesh.py.

Every camera of the rig contributes (pixel, z bits, rgb24) entries to one
fused virtual image; the per-pixel winner is the smallest f32 depth, ties
going to the smaller packed RGB, as in the dual fused frame. The resolve
runs on the z-buffer kernels of ops/cuda/zresolve_cuda.py:

- ``tiled`` (or ``exact``), image only: kernel B1;
- ``tiled`` with the z-buffer: kernel B2;
- ``tiled`` with ``multi_stream=True``: kernel B7, the (S, N) feed;
- ``packed``: the uint32 scatter-min of (zq14 | RGB666) keys;
- the color tail (decode, interleave, and with ``config.filter_fused_color``
  the 3×3 filter): one launch of kernel B4's image kernel per call.

:func:`rig_fuse` and :func:`batched_rig_fuse` build the step on one device
(``device=None``: the card) and return ``fn(depth, color, depth_scale,
cam_to_virtual)``. The camera-sharded variant (``rig_fuse_sharded``) and its
mesh are not ported yet (ROADMAP A15).

The per-pixel chain keeps the JAX package's f32 operation order term by
term, and every divisor is a tensor on the device: a Python float divisor
makes CUDA multiply by its reciprocal.
"""

from __future__ import annotations

from typing import Optional

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, color_mode
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z
from pointcloud_depthfusion_tpu_torch.ops.cuda.zresolve_cuda import (
    INT32_MAX,
    INVALID_PIX,
    U32_EMPTY,
    u32_bits,
)


class _RigCalibration:
    """Shared or per-camera source calibration of the rig bodies, on one
    device.

    ``intrinsics`` is ONE shared :class:`Intrinsics` or a sequence of N
    (the reference's per-camera handshake, fusion_node.cpp:92-148). The
    per-camera values become (C,) tensors that broadcast against the
    (N, H, W) prep as (N, 1, 1) windows; width, height and the distortion
    model must agree across cameras. ``rois``: optional per-camera
    [x, y, w, h] (or None) validity ROIs (kernels.cu:379-384), held as one
    (C, H, W) bool mask stack.
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
            self.ppx = torch.stack([it.ppx for it in seq])  # (C,)
            self.ppy = torch.stack([it.ppy for it in seq])
            self.fx = torch.stack([it.fx for it in seq])
            self.fy = torch.stack([it.fy for it in seq])
            # (5, C): coeffs[k] is the k-th polynomial term, as in the
            # shared case.
            self.coeffs = torch.stack([it.coeffs for it in seq], dim=1)
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
    def n_cameras(self) -> Optional[int]:
        """Number of per-camera calibration entries (None when shared)."""
        if self.seq is not None:
            return len(self.seq)
        if self.rois is not None:
            return len(self.rois)
        return None

    @staticmethod
    def _take(arr: torch.Tensor, n_local: int) -> torch.Tensor:
        """(..., C) → (..., n_local): tiled to a multiple (batched path)."""
        c = arr.shape[-1]
        if c == n_local:
            return arr
        if n_local % c:
            raise ValueError(
                f"{n_local} local cameras is not a multiple of the "
                f"{c} calibrated cameras"
            )
        return arr.repeat(*(1,) * (arr.dim() - 1), n_local // c)

    def windows(self, n_local: int):
        """Broadcastable (ppx, ppy, fx, fy, coeffs) against (N, H, W)."""
        if self.seq is None:
            i = self.ref
            return i.ppx, i.ppy, i.fx, i.fy, i.coeffs

        def e(a):
            return self._take(a, n_local)[..., :, None, None]

        return e(self.ppx), e(self.ppy), e(self.fx), e(self.fy), e(self.coeffs)

    def valid_roi(self, valid: torch.Tensor) -> torch.Tensor:
        """AND the per-camera ROI masks into an (N, H, W) validity mask."""
        if self.masks is None:
            return valid
        masks = self._take(self.masks.permute(1, 2, 0), valid.shape[0])
        return valid & masks.permute(2, 0, 1)

    def at(self, i: int) -> Intrinsics:
        """Camera i's Intrinsics."""
        return self.ref if self.seq is None else self.seq[i]

    def roi_at(self, i: int) -> Optional[torch.Tensor]:
        return None if self.masks is None else self.masks[i]


def _rgb24_of(color: torch.Tensor, ref_ndim: int) -> torch.Tensor:
    """rgb24 int32 from either an (…, 3) u8 HWC image or a pre-packed (…)
    int32 plane (Frameset.color_packed semantics): the rank tells which."""
    if color.dim() == ref_ndim:
        return color.to(torch.int32)
    return R.pack_rgb(color)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _packed_rig_body(calib: _RigCalibration, fused_intrinsics: Intrinsics,
                     config: FusionConfig, z_near: float, z_far: float):
    """The packed (zq14 | RGB666) rig body: (project_one, local_buffer,
    unpack). Every camera folds into one uint32 scatter-min; keys are int32
    bit patterns, built in int64."""
    device = calib.ref.device
    n_px = fused_intrinsics.width * fused_intrinsics.height
    z_levels = float((1 << 14) - 1)
    # The JAX body divides by the Python float (z_far - z_near): its f64
    # difference rounded once to f32, a 0-d tensor here.
    near, span = _f32(z_near, device), _f32(z_far - z_near, device)

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

    def local_buffer(depth, color, depth_scale, cam_to_virtual):
        idxs, keys = [], []
        for i in range(depth.shape[0]):
            a, k = project_one(depth[i], color[i], depth_scale[i], cam_to_virtual[i],
                               intr1=calib.at(i), roi1=calib.roi_at(i))
            idxs.append(a.reshape(-1))
            keys.append(k.reshape(-1))
        return Z.scatter_min_u32(torch.cat(idxs), torch.cat(keys), n_px)

    def unpack(merged):
        h_f, w_f = fused_intrinsics.height, fused_intrinsics.width
        return _finish_planes([p.reshape(h_f, w_f) for p in _decode_rgb666_planes(merged)],
                              config)

    return project_one, local_buffer, unpack


def _decode_rgb666_planes(merged: torch.Tensor):
    """A flat packed (zq14 | RGB666) buffer as three flat u8 planes (0
    where uncovered), through the one packed-layout decode
    (ops.render._decode_packed_planes); the z field is dropped."""
    rp, gp, bp, _ = R._decode_packed_planes(merged, 0.0, 1.0)
    return rp, gp, bp


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
    (entries_one, entries_all, local_minbufs, unpack, local_winner_rgb)."""
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

    def entries_all(depth, color, depth_scale, cam_to_virtual, pix_offsets=None,
                    per_stream=False):
        """All N cameras' entries from one batched (N, H, W) chain: the
        shared pixel grid broadcasts against per-camera (N, 1, 1) windows.

        ``pix_offsets``: optional (N,) int32 per-camera pixel offsets (the
        batched rig routes each stream into its own slice this way).
        ``per_stream=True`` keeps the (N, H·W) camera axis (the B7 feed)."""
        f = torch.float32
        n_local, h, w = depth.shape
        device = depth.device
        ds = depth_scale.to(f)
        scale = ds[:, None, None]
        # filter_depth_minmax semantics: truncating u16 thresholds
        # (kernels.cu:357-359), per camera.
        lo = F._u16_threshold(config.min_depth, ds, device)[:, None, None]
        hi = F._u16_threshold(config.max_depth, ds, device)[:, None, None]
        keep = (depth >= lo) & (depth <= hi)
        valid = calib.valid_roi(keep & (depth > 0))
        dm = torch.where(keep, depth, 0).to(f) * scale
        u, v = G.pixel_grid(h, w, f, device)
        c_ppx, c_ppy, c_fx, c_fy, c_coeffs = calib.windows(n_local)
        nx = (u - c_ppx) / c_fx
        ny = (v - c_ppy) / c_fy
        if calib.ref.model == Distortion.INVERSE_BROWN_CONRADY:
            nx, ny = G._undistort_inverse_brown_conrady(nx, ny, c_coeffs)
        x, y, z = dm * nx, dm * ny, dm
        t = cam_to_virtual.to(f)

        def tc(i, j):
            return t[:, i, j][:, None, None]

        # Summed left to right, term by term as mesh.py:456-458.
        xo = tc(0, 0) * x + tc(0, 1) * y + tc(0, 2) * z + tc(0, 3)
        yo = tc(1, 0) * x + tc(1, 1) * y + tc(1, 2) * z + tc(1, 3)
        zo = tc(2, 0) * x + tc(2, 1) * y + tc(2, 2) * z + tc(2, 3)
        idx, zc, ok = R.compute_pixel_indices_planar(
            xo, yo, zo, valid, fused_intrinsics, config.mirror_image
        )
        if pix_offsets is not None:
            idx = idx + pix_offsets.to(torch.int32)[:, None, None]
        shape = (n_local, -1) if per_stream else (-1,)
        okf = ok.reshape(shape)
        pix = torch.where(okf, idx.reshape(shape), INVALID_PIX).to(torch.int32)
        zbits = torch.where(okf, zc.to(f).view(torch.int32).reshape(shape), INT32_MAX)
        rgb = torch.where(okf, _rgb24_of(color, depth.dim()).reshape(shape), INT32_MAX)
        return pix, zbits, rgb

    def local_minbufs(depth, color, depth_scale, cam_to_virtual, multi_stream=False):
        """(min z bits, rgb of the winner) per fused pixel: B7 on the
        per-camera streams with ``multi_stream`` and two or more cameras,
        else B2 on the flat entries."""
        if multi_stream and depth.shape[0] >= 2:
            pix, zbits, rgb = entries_all(depth, color, depth_scale, cam_to_virtual,
                                          per_stream=True)
            return Z.zresolve_sorted_streams(pix, zbits, rgb, n_px)
        pix, zbits, rgb = entries_all(depth, color, depth_scale, cam_to_virtual)
        return Z.zresolve_sorted_entries(pix, zbits, rgb, n_px)

    def local_winner_rgb(depth, color, depth_scale, cam_to_virtual):
        """Image-only resolve (B1): the winner's rgb per fused pixel."""
        pix, zbits, rgb = entries_all(depth, color, depth_scale, cam_to_virtual)
        return Z.zresolve_winner_rgb(pix, zbits, rgb, n_px)

    def unpack(mrgb):
        # The winner's rgb alone marks coverage: a covered rgb24 is below
        # INT32_MAX, the resolve's empty value, with or without the z-buffer.
        return _finish_winner(mrgb, config, fused_intrinsics.height, fused_intrinsics.width)

    return entries_one, entries_all, local_minbufs, unpack, local_winner_rgb


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
        _, _, local_minbufs, unpack_t, local_winner = _tiled_rig_body(calib, fused, config)

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
        _, local_buffer, unpack = _packed_rig_body(calib, fused, config, z_near, z_far)

        def fn(depth, color, depth_scale, cam_to_virtual):
            check_count(depth)
            return unpack(local_buffer(depth, color, depth_scale, cam_to_virtual))

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

    if _rig_render_mode(config) == "tiled":
        _, entries_all, _, _, _ = _tiled_rig_body(calib, fused, config)
        stream_offsets = torch.repeat_interleave(
            torch.arange(batch, dtype=torch.int32, device=device) * n_px, cameras)

        def fn(depth, color, depth_scale, cam_to_virtual):
            h, w = depth.shape[-2:]
            n = batch * cameras
            color_flat = (color.reshape(n, h, w) if color.dim() == depth.dim()
                          else color.reshape(n, h, w, 3))
            p, z, rr = entries_all(depth.reshape(n, h, w), color_flat, depth_scale.reshape(-1),
                                   cam_to_virtual.reshape(n, 4, 4), pix_offsets=stream_offsets)
            _, mrgb = Z.zresolve_sorted_entries(p, z, rr, total_px)
            return _finish_winner(mrgb.reshape(batch, n_px), config, h_f, w_f)
    else:
        project_one, _, _ = _packed_rig_body(calib, fused, config, z_near, z_far)

        def fn(depth, color, depth_scale, cam_to_virtual):
            idxs, keys = [], []
            for b in range(batch):
                for ci in range(cameras):
                    idx, key = project_one(depth[b, ci], color[b, ci], depth_scale[b, ci],
                                           cam_to_virtual[b, ci], intr1=calib.at(ci),
                                           roi1=calib.roi_at(ci))
                    # Each stream into its own slice; invalid entries (the
                    # sentinel key) to the dump slot past the last stream.
                    ok = key.reshape(-1) != U32_EMPTY
                    idxs.append(torch.where(ok, idx.reshape(-1) + b * n_px, total_px))
                    keys.append(key.reshape(-1))
            merged = Z.scatter_min_u32(torch.cat(idxs).to(torch.int32), torch.cat(keys),
                                       total_px)
            return _finish_planes([p.reshape(batch, h_f, w_f)
                                   for p in _decode_rgb666_planes(merged)], config)

    fn.device = device
    return fn


