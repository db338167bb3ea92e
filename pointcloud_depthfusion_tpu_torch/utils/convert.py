"""Carry the JAX package's state into the port.

This system has no weights: its state is calibration, configuration and
the registration pose. The functions here take the JAX dataclasses' leaves
as numpy arrays (``np.asarray(leaf)`` on the caller's side) plus their
static fields, and build the port's objects on ``device`` (``None``: the
card). No jax import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
from pointcloud_depthfusion_tpu_torch.ops.voxel import VoxelGrid
from pointcloud_depthfusion_tpu_torch.registration.gicp import GICPConfig
from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationSettings


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(resolve_device(device))


def intrinsics_from_arrays(
    ppx, ppy, fx, fy, coeffs, width: int, height: int,
    model=Distortion.NONE, device=None,
) -> Intrinsics:
    return Intrinsics(
        ppx=_f32(ppx, device), ppy=_f32(ppy, device),
        fx=_f32(fx, device), fy=_f32(fy, device),
        coeffs=_f32(coeffs, device).reshape(5),
        width=int(width), height=int(height), model=Distortion(int(model)),
    )


def rig_intrinsics_from_arrays(
    leaves, width: int, height: int, model=Distortion.NONE, device=None,
) -> list:
    """A rig's per-camera intrinsics sequence: ``leaves`` holds one
    (ppx, ppy, fx, fy, coeffs) tuple per camera; width, height and the
    distortion model are shared, as the rig requires."""
    return [intrinsics_from_arrays(*leaf, width, height, model, device=device)
            for leaf in leaves]


def cam_to_virtual_from_array(cam_to_virtual, device=None) -> torch.Tensor:
    """A rig's (N, 4, 4) camera→virtual transforms as one f32 tensor."""
    return _f32(cam_to_virtual, device).reshape(-1, 4, 4)


def extrinsics_from_arrays(rotation, translation, device=None) -> Extrinsics:
    return Extrinsics(
        _f32(rotation, device).reshape(3, 3), _f32(translation, device).reshape(3)
    )


def fusion_config_from_arrays(
    min_depth, max_depth, camera_translation, camera_rotation_deg,
    device=None, **static_fields,
) -> FusionConfig:
    """``static_fields``: the JAX FusionConfig's static fields, by name."""
    return FusionConfig(
        min_depth=_f32(min_depth, device),
        max_depth=_f32(max_depth, device),
        camera_translation=_f32(camera_translation, device).reshape(3),
        camera_rotation_deg=_f32(camera_rotation_deg, device).reshape(3),
        **static_fields,
    )


def frameset_from_arrays(
    depth, color, color_intrinsics: Intrinsics,
    depth_intrinsics: Intrinsics = None, depth_to_color: Extrinsics = None,
    depth_scale=0.001, timestamp=0.0, timestamp_epoch=0.0, color_packed=None,
    device=None,
) -> Frameset:
    """A Frameset from the JAX Frameset's arrays; ``timestamp`` and
    ``timestamp_epoch`` are taken as already split."""
    device = resolve_device(device)
    if depth_intrinsics is None:
        depth_intrinsics = color_intrinsics
    if depth_to_color is None:
        depth_to_color = Extrinsics.identity(device)
    return Frameset(
        depth=torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device),
        color=torch.from_numpy(np.asarray(color).astype(np.uint8)).to(device),
        depth_intrinsics=depth_intrinsics.to(device),
        color_intrinsics=color_intrinsics.to(device),
        depth_to_color=depth_to_color.to(device),
        depth_scale=_f32(depth_scale, device),
        timestamp=_f32(timestamp, device),
        timestamp_epoch=_f32(timestamp_epoch, device),
        color_packed=None if color_packed is None else torch.from_numpy(
            np.asarray(color_packed).astype(np.int32)).to(device),
    )


def pose_from_array(right_transform, device=None) -> torch.Tensor:
    """The 4×4 right→left registration transform as an f32 tensor."""
    return _f32(right_transform, device).reshape(4, 4)


def gicp_config_from_arrays(
    resolution, voxel_size, rotation_eps, translation_eps, fitness_eps, fitness_rel_eps,
    kernel_width, kernel_max_dist, damping, iteration_cap, device=None, **static_fields,
) -> GICPConfig:
    """``static_fields``: the JAX GICPConfig's static fields, by name;
    ``iteration_cap`` becomes the host int the port's loop is bounded by."""
    return GICPConfig(
        resolution=_f32(resolution, device), voxel_size=_f32(voxel_size, device),
        rotation_eps=_f32(rotation_eps, device), translation_eps=_f32(translation_eps, device),
        fitness_eps=_f32(fitness_eps, device), fitness_rel_eps=_f32(fitness_rel_eps, device),
        kernel_width=_f32(kernel_width, device), kernel_max_dist=_f32(kernel_max_dist, device),
        damping=_f32(damping, device), iteration_cap=int(np.asarray(iteration_cap)),
        **static_fields,
    )


def voxel_grid_from_arrays(count, mean, cov, coords, resolution, device=None) -> VoxelGrid:
    device = resolve_device(device)
    return VoxelGrid(
        count=_f32(count, device).reshape(-1),
        mean=_f32(mean, device).reshape(-1, 3),
        cov=_f32(cov, device).reshape(-1, 3, 3),
        coords=torch.from_numpy(np.asarray(coords).astype(np.int32)).to(device).reshape(-1, 3),
        resolution=_f32(resolution, device),
    )


def registration_settings_from_dict(settings: dict) -> RegistrationSettings:
    """Settings from ``dataclasses.asdict`` of the JAX RegistrationSettings;
    an unknown field raises."""
    names = {f.name for f in dataclasses.fields(RegistrationSettings)}
    unknown = sorted(set(settings) - names)
    if unknown:
        raise ValueError(f"unknown registration settings {unknown}")
    return RegistrationSettings(**settings)
