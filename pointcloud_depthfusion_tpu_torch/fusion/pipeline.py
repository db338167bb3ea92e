"""The end-to-end fusion pipeline: two framesets → one fused RGB image.

Port of pointcloud_depthfusion_tpu/fusion/pipeline.py (the reference's
FusionNode::processSyncedFrames, fusion_node.cpp:700-811), run eagerly:

    [align (B2)] → filter → deproject ×2 → transform (right composed with
    the virtual pose) → merge → project → z-resolve → color tail (B4: the
    winner's decode and color filter in one launch)

The per-pixel prep of both cameras (filter through project) is one launch
of kernel B3 (ops/cuda/fuse_prep_cuda.py) in every render mode: its masked
feed for "tiled" and "exact", which resolve on B1/B2, for "packed", whose
u32 scatter-min builds and decodes the packed keys in the same launch, and
for "indexed"; its packed keys for "pallas", the JAX package's Pallas
prep. :meth:`FusionPipeline.process_profiled` runs the same launches, with
a lap after each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics, fused_virtual_intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.ops.align import align_depth_to_color, auto_footprint
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

RENDER_MODES = ("tiled", "exact", "indexed", "packed", "pallas")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Fusion parameters (fusion_node's config_default.yaml).

    Tensors: the depth window and the virtual-camera pose. Every other
    field selects program structure, as in the JAX package.
    """

    min_depth: torch.Tensor  # 0-d f32, meters
    max_depth: torch.Tensor
    camera_translation: torch.Tensor  # (3,) meters, when set_camera_pose
    camera_rotation_deg: torch.Tensor  # (3,) degrees, when set_camera_pose
    vertical_image: bool = True
    mirror_image: bool = True
    use_median_filter: bool = False
    align_frames: bool = False
    align_footprint: object = "auto"
    set_camera_pose: bool = False
    filter_fused_color: bool = True
    roi_left: Optional[Tuple[int, int, int, int]] = None
    roi_right: Optional[Tuple[int, int, int, int]] = None
    render_mode: str = "tiled"
    # Emit the fused z-buffer beside the image. False runs the image-only
    # resolve (B1) and leaves FusionResult.zbuf None; the image is identical.
    emit_zbuf: bool = True

    @staticmethod
    def create(
        min_depth: float = 0.5,
        max_depth: float = 3.0,
        camera_translation=(0.0, 0.0, 0.0),
        camera_rotation_deg=(0.0, 0.0, 0.0),
        device=None,
        **static_fields,
    ) -> "FusionConfig":
        device = resolve_device(device)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return FusionConfig(
            min_depth=f32(min_depth),
            max_depth=f32(max_depth),
            camera_translation=f32(camera_translation),
            camera_rotation_deg=f32(camera_rotation_deg),
            **static_fields,
        )

    def to(self, device) -> "FusionConfig":
        return dataclasses.replace(
            self,
            min_depth=self.min_depth.to(device),
            max_depth=self.max_depth.to(device),
            camera_translation=self.camera_translation.to(device),
            camera_rotation_deg=self.camera_rotation_deg.to(device),
        )


@dataclasses.dataclass(frozen=True)
class FusionResult:
    """Outputs of one fused frame."""

    image: torch.Tensor  # (Hf, Wf, 3) uint8
    zbuf: Optional[torch.Tensor]  # (Hf, Wf) float32, FLT_MAX where empty
    valid_left: torch.Tensor  # (H, W) bool
    valid_right: torch.Tensor
    timestamp: torch.Tensor  # left frame's stamp (fusion_node.cpp:801)


def virtual_camera_transform(config: FusionConfig) -> torch.Tensor:
    """The explicit virtual-camera pose (fusion_node.cpp:168-180):
    M = R⁻¹ · T(-t) · Rz90, Eigen's construction order."""
    device = config.camera_translation.device
    m = G.rotz(G.deg2rad(90.0), device)
    rot = G.euler_to_matrix(G.deg2rad(config.camera_rotation_deg))
    m[:3, 3] += -config.camera_translation
    r_inv4 = torch.eye(4, dtype=m.dtype, device=device)
    r_inv4[:3, :3] = rot.T
    return G.mm(r_inv4, m)


def fused_camera_transform(config: FusionConfig, right_transform: torch.Tensor) -> torch.Tensor:
    """Virtual-camera transform for this frame: the configured pose, or the
    slerp midpoint of the (identity) left pose and the registration
    transform (fusion_node.cpp:766-771); a vertical output prerotates +90°
    about Z (fusion_node.cpp:775-778)."""
    if config.set_camera_pose:
        t = virtual_camera_transform(config)
    else:
        left = torch.eye(4, dtype=right_transform.dtype, device=right_transform.device)
        t = G.interpolate_transform(left, right_transform)
    if config.vertical_image:
        t = G.mm(G.rotz(G.deg2rad(90.0), right_transform.device), t)
    return t


def fused_poses(config: FusionConfig, right_transform: torch.Tensor):
    """(left → virtual, right → virtual) 4×4 transforms. Composing the
    right pose first saves one 9-multiply pass over the right cloud."""
    fused_t = fused_camera_transform(config, right_transform)
    return fused_t, G.mm(fused_t, right_transform.to(fused_t.dtype))


def _z_range(config: FusionConfig):
    """The packed and indexed quantization range: the virtual camera sits
    between the two physical ones, so depths stay within ~[min/2, max+1]."""
    return 0.5 * config.min_depth, config.max_depth + 1.0


def _check_config(config: FusionConfig) -> None:
    if config.render_mode not in RENDER_MODES:
        raise ValueError(
            f"unknown render_mode {config.render_mode!r} (expected tiled/"
            "exact/indexed/packed/pallas)"
        )


def _zparams(config: FusionConfig) -> torch.Tensor:
    """The packed key's (near, span, far) of the config's z range."""
    return Z.packed_zparams(*_z_range(config), config.min_depth.device)


def _camera_depth(fs: Frameset, config: FusionConfig, footprint) -> torch.Tensor:
    """A camera's raw depth, aligned to its color camera with
    ``align_frames``."""
    if not config.align_frames:
        return fs.depth
    return align_depth_to_color(fs.depth, fs.depth_scale, fs.depth_intrinsics,
                                fs.color_intrinsics, fs.depth_to_color,
                                max_footprint=footprint)


def _color_planes(left: Frameset, right: Frameset):
    """The two cameras' colors: their rgb24 planes when both carry one,
    else their (H, W, 3) u8 images."""
    if left.color_packed is not None and right.color_packed is not None:
        return left.color_packed, right.color_packed
    return left.color, right.color


def _prep(left: Frameset, right: Frameset, config: FusionConfig, fused_intrinsics: Intrinsics,
          memo: Optional[B3.Memo]):
    """B3's cameras for this pair and the packed key's z parameters (None
    for tiled/exact). ``memo``: a ``B3.Memo`` keeping both while the
    calibration and config stay; None builds them. The poses and depth
    scales are no part of them: B3 reads those from their tensors on every
    launch."""

    def cameras():
        z_near, z_far = _z_range(config)
        cams = B3.prep_cameras(
            (left.color_intrinsics, right.color_intrinsics), fused_intrinsics,
            config.min_depth, config.max_depth, config.mirror_image,
            rois=(config.roi_left, config.roi_right), z_near=z_near, z_far=z_far)
        return cams, None if config.render_mode in ("tiled", "exact") else _zparams(config)

    if memo is None:
        return cameras()
    return memo.get(
        (*B3.intrinsics_key(left.color_intrinsics), *B3.intrinsics_key(right.color_intrinsics),
         config, fused_intrinsics), cameras)


def _prep_feed(left: Frameset, right: Frameset, depth, fused_t, right_total,
               config: FusionConfig, fused_intrinsics: Intrinsics, memo: Optional[B3.Memo]):
    """Both cameras' masked feed (idx, z, ok, rgb24), their (2, H, W) valid
    planes and the packed key's z parameters: one B3 launch on ``depth``
    (the raw or aligned depth of each camera)."""
    cams, zparams = _prep(left, right, config, fused_intrinsics, memo)
    *feed, valid = B3.fuse_prep_feed(depth, _color_planes(left, right),
                                     (left.depth_scale, right.depth_scale),
                                     (fused_t, right_total), cams)
    return feed, valid, zparams


def _render(idx, zc, ok, rgb24, config: FusionConfig, fused_intrinsics: Intrinsics, zparams):
    """Resolve the masked feed (flat idx, z, ok, rgb24) in the configured
    mode: (the packed winner (H·W,) of tiled/exact or the (r, g, b) planes
    of packed/indexed, z-buffer or None)."""
    w_f, h_f = fused_intrinsics.width, fused_intrinsics.height
    n_px = w_f * h_f
    if config.render_mode == "packed":
        *planes, zb = Z.scatter_min_packed(idx, zc, ok, rgb24, n_px, zparams, planes=True,
                                           need_zbuf=True)
    elif config.render_mode == "indexed":
        covered, widx = R.indexed_winner(idx, zc, ok, n_px, zparams[0], zparams[2])
        *planes, zb = R.indexed_winner_gather(covered, widx, zc, None, None, None, rgb24=rgb24)
    else:
        # tiled and exact share one winner contract; exact always emits the
        # z-buffer
        mrgb, minz = R._resolve_exact(idx, zc, ok, rgb24, n_px,
                                      config.emit_zbuf or config.render_mode == "exact")
        return mrgb, None if minz is None else R._zbuf(minz, h_f, w_f)
    return tuple(p.reshape(h_f, w_f) for p in planes), zb.reshape(h_f, w_f)


def color_mode(config: FusionConfig) -> Optional[str]:
    """The fused-image color filter, as a B4 image mode: "median" or
    "gauss" (``use_median_filter``), None when ``filter_fused_color`` is
    off."""
    if not config.filter_fused_color:
        return None
    return "median" if config.use_median_filter else "gauss"


def _color_tail(color, config: FusionConfig, fused_intrinsics: Intrinsics) -> torch.Tensor:
    """The (H, W, 3) fused image from a packed winner or from (r, g, b)
    planes: one B4 image launch (decode or interleave, and filter)."""
    mode = color_mode(config)
    if isinstance(color, tuple):
        return filters_cuda.planes_image(color, mode)
    return filters_cuda.winner_image(color, fused_intrinsics.height, fused_intrinsics.width,
                                     mode)


def fuse_posed(
    left: Frameset,
    right: Frameset,
    fused_t: torch.Tensor,
    right_total: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
    footprints=None,
    prep_memo: Optional[B3.Memo] = None,
) -> FusionResult:
    """:func:`fuse` with the two virtual-camera poses given (see
    :func:`fused_poses`). ``footprints``: the (left, right) align splat
    caps, resolved by the caller; ``None`` takes ``config.align_footprint``
    for both. ``prep_memo``: the ``B3.Memo`` where the caller keeps B3's
    cameras across frames (``None`` builds them)."""
    _check_config(config)
    if config.render_mode == "pallas":
        return _fuse_pallas(left, right, fused_t, right_total, config, fused_intrinsics,
                            prep_memo)
    foot_l, foot_r = footprints or (config.align_footprint,) * 2
    depth = (_camera_depth(left, config, foot_l), _camera_depth(right, config, foot_r))
    feed, valid, zparams = _prep_feed(left, right, depth, fused_t, right_total, config,
                                      fused_intrinsics, prep_memo)
    color, zbuf = _render(*feed, config, fused_intrinsics, zparams)
    return FusionResult(
        image=_color_tail(color, config, fused_intrinsics), zbuf=zbuf, valid_left=valid[0],
        valid_right=valid[1], timestamp=left.timestamp,
    )


def _fuse_pallas(
    left: Frameset,
    right: Frameset,
    fused_t: torch.Tensor,
    right_total: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
    prep_memo: Optional[B3.Memo] = None,
) -> FusionResult:
    """Packed-mode fusion with the per-pixel math in kernel B3's packed-key
    output, one launch for both cameras (JAX pipeline.py:317-378), then the
    scatter-min and its decode in one launch."""
    if config.align_frames:
        raise ValueError("pallas mode expects pre-aligned depth")
    if config.roi_left is not None or config.roi_right is not None:
        raise ValueError(
            "pallas mode does not implement ROI masking; use "
            "packed/indexed/exact/tiled"
        )
    cams, zparams = _prep(left, right, config, fused_intrinsics, prep_memo)
    # valid is the depth-window validity, as in the other modes (the keys'
    # sentinel marks in-bounds projections, a different set).
    idx, key, valid = B3.fuse_prep_keys((left.depth, right.depth), (left.color, right.color),
                                        (left.depth_scale, right.depth_scale),
                                        (fused_t, right_total), cams)
    h_f, w_f = fused_intrinsics.height, fused_intrinsics.width
    *planes, zbuf = Z.scatter_min_u32(idx, key, w_f * h_f, zparams, planes=True, need_zbuf=True)
    image = _color_tail(tuple(p.reshape(h_f, w_f) for p in planes), config, fused_intrinsics)
    return FusionResult(
        image=image, zbuf=zbuf.reshape(h_f, w_f), valid_left=valid[0], valid_right=valid[1],
        timestamp=left.timestamp,
    )


def fuse(
    left: Frameset,
    right: Frameset,
    right_transform: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
) -> FusionResult:
    """Fuse one synchronized frameset pair into a virtual-camera RGB image.

    Args:
      right_transform: 4×4 right→left registration transform.
      fused_intrinsics: virtual-camera intrinsics
        (core.camera.fused_virtual_intrinsics).
    """
    fused_t, right_total = fused_poses(config, right_transform)
    return fuse_posed(left, right, fused_t, right_total, config, fused_intrinsics)


class FusionPipeline:
    """Holds config and intrinsics on one device (``device=None``: the
    card); :meth:`process` fuses each synchronized frame pair.

    The two virtual-camera poses depend only on the config and the
    registration transform, so they are computed when the transform is
    set, not per frame; B3's cameras are kept while the framesets'
    calibration stays (``B3.Memo``). With
    ``align_frames`` and ``align_footprint="auto"``, each camera's splat cap
    is read on the host (a sync on the card) by :meth:`calibrate`, which
    :meth:`process` calls on its first frame pair only: call it again when
    a camera's calibration changes. ``donate`` is accepted for API parity
    and has no effect yet.
    """

    def __init__(
        self,
        color_intrinsics_left: Intrinsics,
        config: FusionConfig,
        donate: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config.to(self.device)
        self.fused_intrinsics = fused_virtual_intrinsics(
            color_intrinsics_left.to(self.device), config.vertical_image
        )
        self._donate = donate
        self._footprints = None
        self._prep_memo = B3.Memo()
        self.set_right_transform(torch.eye(4, dtype=torch.float32))

    def set_right_transform(self, transform) -> None:
        """Registration-transform update (transformCallback equivalent)."""
        self.right_transform = torch.as_tensor(
            transform, dtype=torch.float32
        ).to(self.device)
        self._poses = fused_poses(self.config, self.right_transform)

    def calibrate(self, left: Frameset, right: Frameset) -> None:
        """Resolve each camera's align splat cap from these framesets'
        calibration (``auto_footprint``, read on the host)."""
        cfg = self.config
        if cfg.align_frames and cfg.align_footprint == "auto" and cfg.render_mode != "pallas":
            self._footprints = tuple(
                auto_footprint(fs.depth_intrinsics, fs.color_intrinsics, fs.depth_to_color)
                for fs in (left, right)
            )
        else:
            self._footprints = (cfg.align_footprint,) * 2

    def process(self, left: Frameset, right: Frameset) -> FusionResult:
        if self._footprints is None:
            self.calibrate(left, right)
        return fuse_posed(left, right, *self._poses, self.config, self.fused_intrinsics,
                          self._footprints, self._prep_memo)

    def process_profiled(self, left: Frameset, right: Frameset):
        """:meth:`process` with a fenced lap after each stage (the
        reference's getTiming, fusion_node.cpp:620-631).

        Returns (FusionResult, laps, host image): ``laps`` holds the
        milliseconds of the device stages ``prep`` ([align], then B3's one
        launch: the reference's filter, deproject, transform and merge
        stages and the projection to pixels), ``project`` (resolve and
        decode), ``filter_image`` (B4) and ``copy_from_gpu``. The stages
        are :meth:`process`'s own launches, so the image equals its image
        bit for bit. The host stages are the caller's. ``pallas`` mode
        raises, as in the JAX package, whose Pallas prep has no stage
        boundaries."""
        from pointcloud_depthfusion_tpu_torch.utils.profiling import StageTimer  # noqa: PLC0415

        cfg = self.config
        _check_config(cfg)
        if cfg.render_mode == "pallas":
            raise NotImplementedError(
                "profiling mode does not cover render_mode='pallas' (the prep kernel "
                "has no stage boundaries); profile the equivalent 'packed' mode instead"
            )
        if self._footprints is None:
            self.calibrate(left, right)
        foot_l, foot_r = self._footprints
        timer = StageTimer()
        depth = (_camera_depth(left, cfg, foot_l), _camera_depth(right, cfg, foot_r))
        feed, valid, zparams = _prep_feed(left, right, depth, *self._poses, cfg,
                                          self.fused_intrinsics, self._prep_memo)
        timer.lap("prep", *feed, valid)
        color, zbuf = _render(*feed, cfg, self.fused_intrinsics, zparams)
        timer.lap("project", *(color if isinstance(color, tuple) else (color,)))
        image = _color_tail(color, cfg, self.fused_intrinsics)
        timer.lap("filter_image", image)
        host_image = image.cpu().numpy()
        timer.lap("copy_from_gpu")
        result = FusionResult(image=image, zbuf=zbuf, valid_left=valid[0], valid_right=valid[1],
                              timestamp=left.timestamp)
        return result, timer.laps, host_image
