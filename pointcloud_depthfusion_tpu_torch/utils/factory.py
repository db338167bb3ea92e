"""Config-tree → component factories: the port's subset of
pointcloud_depthfusion_tpu/utils/factory.py.

Loads ``configs/*_default.yaml`` from the repository root (+ an optional
override file) and builds the fusion config and the registration settings
the shipped deployment runs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationSettings
from pointcloud_depthfusion_tpu_torch.utils.config import ConfigTree

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(_REPO_ROOT, "configs")


def load_node_config(
    node_key: str, default_name: str, override_path: Optional[str] = None
) -> ConfigTree:
    return ConfigTree.load(
        os.path.join(CONFIG_DIR, default_name), override_path, node_key=node_key
    )


def fusion_config_from_tree(cfg: ConfigTree, device=None) -> FusionConfig:
    """A FusionConfig on ``device`` (``None``: the card) from a
    ``fusion_node`` config tree."""
    roi_left = cfg.get("roi_left")
    roi_right = cfg.get("roi_right")
    return FusionConfig.create(
        min_depth=float(cfg.get("min_depth", 0.5)),
        max_depth=float(cfg.get("max_depth", 3.0)),
        camera_translation=tuple(cfg.get("camera_translation", (0.0, 0.0, 0.0))),
        camera_rotation_deg=tuple(cfg.get("camera_rotation", (0.0, 0.0, 0.0))),
        vertical_image=bool(cfg.get("vertical_image", True)),
        mirror_image=bool(cfg.get("mirror_image", True)),
        use_median_filter=bool(cfg.get("use_median_filter", False)),
        align_frames=bool(cfg.get("align_frames", False)),
        set_camera_pose=bool(cfg.get("set_camera_pose", False)),
        render_mode=str(cfg.get("render_mode", "tiled")),
        emit_zbuf=bool(cfg.get("emit_zbuf", True)),
        roi_left=tuple(roi_left) if roi_left else None,
        roi_right=tuple(roi_right) if roi_right else None,
        device=device,
    )


def fusion_config(
    override_path: Optional[str] = None, device=None
) -> Tuple[FusionConfig, ConfigTree]:
    cfg = load_node_config("fusion_node", "fusion_default.yaml", override_path)
    return fusion_config_from_tree(cfg, device), cfg


def registration_settings_from_tree(cfg: ConfigTree) -> RegistrationSettings:
    roi_left = cfg.get("roi_left")
    roi_right = cfg.get("roi_right")
    return RegistrationSettings(
        min_depth=float(cfg.get("min_depth", 0.5)),
        max_depth=float(cfg.get("max_depth", 3.0)),
        depth_scale_left=float(cfg.get("depth_scale_left", cfg.get("depth_scale", 0.001))),
        depth_scale_right=float(cfg.get("depth_scale_right", cfg.get("depth_scale", 0.001))),
        roi_left=tuple(roi_left) if roi_left else None,
        roi_right=tuple(roi_right) if roi_right else None,
        resolution=float(cfg.get("resolution", 0.01)),
        voxelsize=float(cfg.get("voxelsize", 0.01)),
        kernel_width=float(cfg.get("kernel_width", 0.005)),
        kernel_max_dist=float(cfg.get("kernel_max_dist", 0.025)),
        max_iterations=int(cfg.get("max_iterations", 64)),
        rotation_epsilon=float(cfg.get("rotation_epsilon", 2e-3)),
        translation_epsilon=float(cfg.get("translation_epsilon", 1e-4)),
        fitness_epsilon=float(cfg.get("fitness_epsilon", 1e-12)),
        discard_transform=bool(cfg.get("discard_transform", True)),
        angle_gate=bool(cfg.get("angle_gate", True)),
        reset_initial_guess=bool(cfg.get("reset_initial_guess", True)),
        adjust_resolution=bool(cfg.get("adjust_resolution", True)),
        initial_resolution=float(cfg.get("initial_resolution", 0.1)),
        resolution_step=float(cfg.get("resolution_step", 0.05)),
        cam_upside_down=bool(cfg.get("cam_upside_down", False)),
        transform_path=cfg.get("transform_path"),
        load_transform=bool(cfg.get("load_transform", False)),
        save_transform=bool(cfg.get("save_transform", False)),
        publish_clouds=bool(cfg.get("publish_clouds", False)),
        cloud_decimation=int(cfg.get("cloud_decimation", 2)),
        neighbor_search=str(cfg.get("neighbor_search", "direct1")),
        outlier_removal=bool(cfg.get("outlier_removal", False)),
        outlier_resolution=float(cfg.get("outlier_resolution", 0.05)),
        outlier_stddev_mul=float(cfg.get("outlier_stddev_mul", 1.0)),
    )


def registration_settings(
    override_path: Optional[str] = None,
) -> Tuple[RegistrationSettings, ConfigTree]:
    cfg = load_node_config("registration_node", "registration_default.yaml", override_path)
    return registration_settings_from_tree(cfg), cfg
