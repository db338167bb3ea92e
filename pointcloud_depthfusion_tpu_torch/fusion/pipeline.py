"""The end-to-end fusion pipeline: two framesets → one fused RGB image.

Port of pointcloud_depthfusion_tpu/fusion/pipeline.py (the reference's
FusionNode::processSyncedFrames, fusion_node.cpp:700-811), run eagerly:

    [align (B2)] → filter → deproject ×2 → transform (right composed with
    the virtual pose) → merge → project → z-resolve → decode → color
    filter (B4)

Every render mode of the JAX package: "tiled" and "exact" resolve on B1/B2,
"packed" and "indexed" on one u32 scatter-min, and "pallas" runs the
per-pixel prep as kernel B3 (ops/cuda/fuse_prep_cuda.py) before the same
scatter-min as "packed".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics, fused_virtual_intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.ops.align import align_depth_to_color, auto_footprint
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda
from pointcloud_depthfusion_tpu_torch.ops.cuda.fuse_prep_cuda import fuse_prep, pose_params

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


def _filter_camera(fs: Frameset, roi, config: FusionConfig, footprint):
    """Per-camera filter stage: [align] → filter. Returns (depth, valid)."""
    depth = fs.depth
    if config.align_frames:
        depth = align_depth_to_color(depth, fs.depth_scale, fs.depth_intrinsics,
                                     fs.color_intrinsics, fs.depth_to_color,
                                     max_footprint=footprint)
    return F.filter_depth(depth, fs.depth_scale, config.min_depth, config.max_depth, roi)


def _deproject_camera(fs: Frameset, depth: torch.Tensor, valid: torch.Tensor):
    """Per-camera deprojection: (x, y, z, valid) planes."""
    depth_m = depth.to(torch.float32) * fs.depth_scale
    return G.deproject_planar(depth_m, fs.color_intrinsics, valid)


def _merge(left: Frameset, right: Frameset, xyz_l, xyz_r, val_l, val_r):
    """Stack the two posed clouds and their rgb24 colors on a camera axis."""
    x, y, z = (torch.stack([a, b]) for a, b in zip(xyz_l, xyz_r))
    val = torch.stack([val_l, val_r])
    if left.color_packed is not None and right.color_packed is not None:
        rgb24 = torch.stack([left.color_packed, right.color_packed])
    else:
        rgb24 = R.pack_rgb(torch.stack([left.color, right.color]))
    return x, y, z, val, rgb24


def _render(x, y, z, val, rgb24, config: FusionConfig, fused_intrinsics: Intrinsics):
    """Project and resolve the merged cloud in the configured mode:
    ((r, g, b) planes, z-buffer or None)."""
    w_f, h_f = fused_intrinsics.width, fused_intrinsics.height
    z_near, z_far = _z_range(config)
    mirror = config.mirror_image
    if config.render_mode == "packed":
        return R.project_zbuffer_packed_planar(
            x, y, z, None, None, None, val, fused_intrinsics, mirror=mirror,
            z_near=z_near, z_far=z_far, return_planes=True, rgb24=rgb24,
        )
    if config.render_mode == "indexed":
        covered, widx = R.indexed_winner_planar(
            x, y, z, val, fused_intrinsics, mirror=mirror, z_near=z_near, z_far=z_far,
        )
        rp, gp, bp, zb = R.indexed_winner_gather(covered, widx, z, None, None, None, rgb24=rgb24)
        return tuple(p.reshape(h_f, w_f) for p in (rp, gp, bp)), zb.reshape(h_f, w_f)
    # tiled and exact share one winner contract; exact always emits the z-buffer
    return R.project_zbuffer_tiled_planar(
        x, y, z, None, None, None, val, fused_intrinsics, mirror=mirror,
        return_planes=True, need_zbuf=config.emit_zbuf or config.render_mode == "exact",
        rgb24=rgb24,
    )


def _filter_image(planes, config: FusionConfig) -> torch.Tensor:
    rp, gp, bp = planes
    if config.filter_fused_color:
        return F.filter_color_planar(rp, gp, bp, config.use_median_filter)
    return torch.stack([rp, gp, bp], dim=-1)


def fuse_posed(
    left: Frameset,
    right: Frameset,
    fused_t: torch.Tensor,
    right_total: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
    footprints=None,
    prep_poses=None,
) -> FusionResult:
    """:func:`fuse` with the two virtual-camera poses given (see
    :func:`fused_poses`). ``footprints``: the (left, right) align splat
    caps, resolved by the caller; ``None`` takes ``config.align_footprint``
    for both. ``prep_poses``: the pallas mode's (left, right)
    ``fuse_prep_cuda.pose_params`` of the two poses, built by the caller;
    ``None`` builds them."""
    _check_config(config)
    if config.render_mode == "pallas":
        return _fuse_pallas(left, right, fused_t, right_total, config, fused_intrinsics,
                            prep_poses)
    foot_l, foot_r = footprints or (config.align_footprint,) * 2
    dl, val_l = _filter_camera(left, config.roi_left, config, foot_l)
    dr, val_r = _filter_camera(right, config.roi_right, config, foot_r)
    *xyz_l, val_l = _deproject_camera(left, dl, val_l)
    *xyz_r, val_r = _deproject_camera(right, dr, val_r)
    xyz_l = G.transform_planar(*xyz_l, fused_t)
    xyz_r = G.transform_planar(*xyz_r, right_total)
    merged = _merge(left, right, xyz_l, xyz_r, val_l, val_r)
    planes, zbuf = _render(*merged, config, fused_intrinsics)
    return FusionResult(
        image=_filter_image(planes, config), zbuf=zbuf, valid_left=val_l, valid_right=val_r,
        timestamp=left.timestamp,
    )


def _fuse_pallas(
    left: Frameset,
    right: Frameset,
    fused_t: torch.Tensor,
    right_total: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
    prep_poses=None,
) -> FusionResult:
    """Packed-mode fusion with the per-pixel math in kernel B3 (JAX
    pipeline.py:317-378)."""
    if config.align_frames:
        raise ValueError("pallas mode expects pre-aligned depth")
    if config.roi_left is not None or config.roi_right is not None:
        raise ValueError(
            "pallas mode does not implement ROI masking; use "
            "packed/indexed/exact/tiled"
        )
    z_near, z_far = _z_range(config)
    preps = [
        fuse_prep(fs.depth, fs.color, fs.depth_scale, config.min_depth, config.max_depth,
                  fs.color_intrinsics, t, fused_intrinsics, config.mirror_image, z_near, z_far,
                  pose=pose)
        for fs, t, pose in zip((left, right), (fused_t, right_total), prep_poses or (None, None))
    ]
    idx = torch.cat([i.reshape(-1) for i, _ in preps])
    key = torch.cat([k.reshape(-1) for _, k in preps])
    buf = zresolve_cuda.scatter_min_u32(idx, key, fused_intrinsics.width * fused_intrinsics.height)
    image, zbuf = R.unpack_packed_buffer(buf, fused_intrinsics, z_near, z_far)
    if config.filter_fused_color:
        image = F.filter_color(image, config.use_median_filter)
    # valid_* carry the depth-window validity, as in the other modes (the
    # keys' sentinel marks in-bounds projections, a different set).
    _, val_l = F.filter_depth(left.depth, left.depth_scale, config.min_depth, config.max_depth)
    _, val_r = F.filter_depth(right.depth, right.depth_scale, config.min_depth, config.max_depth)
    return FusionResult(
        image=image, zbuf=zbuf, valid_left=val_l, valid_right=val_r,
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

    The two virtual-camera poses (and, in the pallas mode, B3's pose
    parameters) depend only on the config and the registration transform,
    so they are computed when the transform is set, not per frame. With
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
        self.set_right_transform(torch.eye(4, dtype=torch.float32))

    def set_right_transform(self, transform) -> None:
        """Registration-transform update (transformCallback equivalent)."""
        self.right_transform = torch.as_tensor(
            transform, dtype=torch.float32
        ).to(self.device)
        self._poses = fused_poses(self.config, self.right_transform)
        self._prep_poses = None
        if self.config.render_mode == "pallas":
            cfg = self.config
            self._prep_poses = tuple(
                pose_params(t, self.fused_intrinsics, cfg.min_depth, cfg.max_depth,
                            *_z_range(cfg), self.device)
                for t in self._poses
            )

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
                          self._footprints, self._prep_poses)

    def process_profiled(self, left: Frameset, right: Frameset):
        """:meth:`process` with a fenced lap after each stage (the
        reference's getTiming, fusion_node.cpp:620-631).

        Returns (FusionResult, laps, host image): ``laps`` holds the
        milliseconds of the schema's device stages, ``filter``,
        ``deproject``, ``transform_right`` (right cloud into the virtual
        camera), ``transform`` (left cloud), ``fuse`` (merge),
        ``project`` (resolve and decode), ``filter_image`` and
        ``copy_from_gpu``. The stages are :meth:`process`'s own operations
        with the right pose composed, so the image equals its image bit for
        bit (the JAX package's split programs transform the merged cloud
        instead and may differ in the last bit). The host stages are the
        caller's. ``pallas`` mode has no stage boundaries and raises, as
        in the JAX package."""
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
        fused_t, right_total = self._poses
        foot_l, foot_r = self._footprints
        timer = StageTimer()
        dl, val_l = _filter_camera(left, cfg.roi_left, cfg, foot_l)
        dr, val_r = _filter_camera(right, cfg.roi_right, cfg, foot_r)
        timer.lap("filter", dl, dr)
        *xyz_l, val_l = _deproject_camera(left, dl, val_l)
        *xyz_r, val_r = _deproject_camera(right, dr, val_r)
        timer.lap("deproject", xyz_l[0], xyz_r[0])
        xyz_r = G.transform_planar(*xyz_r, right_total)
        timer.lap("transform_right", xyz_r[0])
        xyz_l = G.transform_planar(*xyz_l, fused_t)
        timer.lap("transform", xyz_l[0])
        merged = _merge(left, right, xyz_l, xyz_r, val_l, val_r)
        timer.lap("fuse", merged[0], merged[4])
        planes, zbuf = _render(*merged, cfg, self.fused_intrinsics)
        timer.lap("project", *planes)
        image = _filter_image(planes, cfg)
        timer.lap("filter_image", image)
        host_image = image.cpu().numpy()
        timer.lap("copy_from_gpu")
        result = FusionResult(image=image, zbuf=zbuf, valid_left=val_l, valid_right=val_r,
                              timestamp=left.timestamp)
        return result, timer.laps, host_image
