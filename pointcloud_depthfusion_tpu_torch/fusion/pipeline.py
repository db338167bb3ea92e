"""The end-to-end fusion pipeline: two framesets → one fused RGB image.

Port of pointcloud_depthfusion_tpu/fusion/pipeline.py (the reference's
FusionNode::processSyncedFrames, fusion_node.cpp:700-811), run eagerly:

    filter → deproject ×2 → transform (right composed with the virtual
    pose) → merge → project → z-resolve (B1/B2) → decode → color filter (B4)

Only ``render_mode="tiled"`` is ported; the other modes raise (ROADMAP A8),
and so does ``align_frames=True`` (ROADMAP A9).
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


def _check_config(config: FusionConfig) -> None:
    if config.render_mode not in RENDER_MODES:
        raise ValueError(
            f"unknown render_mode {config.render_mode!r} (expected tiled/"
            "exact/indexed/packed/pallas)"
        )
    if config.render_mode != "tiled":
        raise NotImplementedError(
            f"render_mode={config.render_mode!r} is not ported yet (ROADMAP A8)"
        )
    if config.align_frames:
        raise NotImplementedError("align_frames=True is not ported yet (ROADMAP A9)")


def _prepare_camera(fs: Frameset, roi, config: FusionConfig):
    """Per-camera stage: filter → deproject (planar)."""
    depth, valid = F.filter_depth(fs.depth, fs.depth_scale, config.min_depth, config.max_depth, roi)
    depth_m = depth.to(torch.float32) * fs.depth_scale
    return G.deproject_planar(depth_m, fs.color_intrinsics, valid)


def fuse_posed(
    left: Frameset,
    right: Frameset,
    fused_t: torch.Tensor,
    right_total: torch.Tensor,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
) -> FusionResult:
    """:func:`fuse` with the two virtual-camera poses given (see
    :func:`fused_poses`)."""
    _check_config(config)
    xl, yl, zl, val_l = _prepare_camera(left, config.roi_left, config)
    xr, yr, zr, val_r = _prepare_camera(right, config.roi_right, config)
    xl, yl, zl = G.transform_planar(xl, yl, zl, fused_t)
    xr, yr, zr = G.transform_planar(xr, yr, zr, right_total)

    x = torch.stack([xl, xr])
    y = torch.stack([yl, yr])
    z = torch.stack([zl, zr])
    val = torch.stack([val_l, val_r])
    if left.color_packed is not None and right.color_packed is not None:
        rgb24 = torch.stack([left.color_packed, right.color_packed])
    else:
        rgb24 = R.pack_rgb(torch.stack([left.color, right.color]))
    (rp, gp, bp), zbuf = R.project_zbuffer_tiled_planar(
        x, y, z, None, None, None, val, fused_intrinsics,
        mirror=config.mirror_image, return_planes=True,
        need_zbuf=config.emit_zbuf, rgb24=rgb24,
    )
    if config.filter_fused_color:
        image = F.filter_color_planar(rp, gp, bp, config.use_median_filter)
    else:
        image = torch.stack([rp, gp, bp], dim=-1)
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

    The two virtual-camera poses depend only on the config and the
    registration transform, so they are computed when the transform is
    set, not per frame. ``donate`` is accepted for API parity and has no
    effect yet.
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
        self.set_right_transform(torch.eye(4, dtype=torch.float32))

    def set_right_transform(self, transform) -> None:
        """Registration-transform update (transformCallback equivalent)."""
        self.right_transform = torch.as_tensor(
            transform, dtype=torch.float32
        ).to(self.device)
        self._poses = fused_poses(self.config, self.right_transform)

    def process(self, left: Frameset, right: Frameset) -> FusionResult:
        return fuse_posed(left, right, *self._poses, self.config, self.fused_intrinsics)
