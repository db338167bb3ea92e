"""PyTorch/CUDA port of pointcloud_depthfusion_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module. Plain tensor code is
PyTorch; the kernels the JAX package wrote in Pallas are CUDA C++ under
``csrc/``, built with nvcc for sm_90a at first use (ops/cuda/_build.py).
This package never imports jax.

Top-level convenience exports are lazy (PEP 562), the JAX package's names:
importing the package loads no submodule and touches no device.

    from pointcloud_depthfusion_tpu_torch import FusionPipeline, Frameset
"""

from __future__ import annotations

__version__ = "0.1.0"  # keep in sync with pyproject.toml

_EXPORTS = {
    # core
    "Intrinsics": "pointcloud_depthfusion_tpu_torch.core.camera",
    "Extrinsics": "pointcloud_depthfusion_tpu_torch.core.camera",
    "CameraInfo": "pointcloud_depthfusion_tpu_torch.core.camera",
    "Distortion": "pointcloud_depthfusion_tpu_torch.core.camera",
    "fused_virtual_intrinsics": "pointcloud_depthfusion_tpu_torch.core.camera",
    "Frameset": "pointcloud_depthfusion_tpu_torch.core.frameset",
    "HostFrameset": "pointcloud_depthfusion_tpu_torch.core.frameset",
    "PointCloud": "pointcloud_depthfusion_tpu_torch.core.pointcloud",
    # fusion
    "FusionConfig": "pointcloud_depthfusion_tpu_torch.fusion.pipeline",
    "FusionPipeline": "pointcloud_depthfusion_tpu_torch.fusion.pipeline",
    "fuse": "pointcloud_depthfusion_tpu_torch.fusion.pipeline",
    # registration
    "GICPConfig": "pointcloud_depthfusion_tpu_torch.registration.gicp",
    "gicp_register": "pointcloud_depthfusion_tpu_torch.registration.gicp",
    "RegistrationPipeline": "pointcloud_depthfusion_tpu_torch.registration.pipeline",
    "RegistrationSettings": "pointcloud_depthfusion_tpu_torch.registration.pipeline",
    # rigs / parallel
    "rig_fuse": "pointcloud_depthfusion_tpu_torch.parallel.mesh",
    "rig_fuse_sharded": "pointcloud_depthfusion_tpu_torch.parallel.mesh",
    "batched_rig_fuse": "pointcloud_depthfusion_tpu_torch.parallel.mesh",
    "make_camera_mesh": "pointcloud_depthfusion_tpu_torch.parallel.mesh",
    # io
    "DeviceFeeder": "pointcloud_depthfusion_tpu_torch.io.feeder",
    "RigFeeder": "pointcloud_depthfusion_tpu_torch.io.feeder",
    "SyntheticSource": "pointcloud_depthfusion_tpu_torch.io.feeder",
    "RecordedSource": "pointcloud_depthfusion_tpu_torch.io.recorded",
    "NetworkSource": "pointcloud_depthfusion_tpu_torch.io.network",
    "SyntheticScene": "pointcloud_depthfusion_tpu_torch.io.synthetic",
    # nodes
    "CameraNode": "pointcloud_depthfusion_tpu_torch.nodes.camera_node",
    "FusionNodeApp": "pointcloud_depthfusion_tpu_torch.nodes.fusion_node",
    "RegistrationNodeApp": "pointcloud_depthfusion_tpu_torch.nodes.registration_node",
    "RigFusionNodeApp": "pointcloud_depthfusion_tpu_torch.nodes.rig_node",
    "ImageNode": "pointcloud_depthfusion_tpu_torch.nodes.image_node",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
