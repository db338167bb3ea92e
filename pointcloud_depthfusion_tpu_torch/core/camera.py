"""Camera models: pinhole intrinsics, distortion, depth→color extrinsics.

Port of pointcloud_depthfusion_tpu/core/camera.py. Intrinsics and
Extrinsics hold 0-d / small f32 tensors on one device; width, height and
the distortion model are plain Python values.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.device import resolve_device


class Distortion(enum.IntEnum):
    """Distortion model enumeration (RealSense model set)."""

    NONE = 0
    MODIFIED_BROWN_CONRADY = 1
    INVERSE_BROWN_CONRADY = 2
    FTHETA = 3
    BROWN_CONRADY = 4
    KANNALA_BRANDT4 = 5


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera intrinsics with 5-coefficient distortion.

    ``ppx/ppy/fx/fy`` are 0-d f32 tensors and ``coeffs`` a (5,) f32 tensor,
    all on one device.
    """

    ppx: torch.Tensor
    ppy: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    coeffs: torch.Tensor  # (5,)
    width: int
    height: int
    model: Distortion = Distortion.NONE

    @staticmethod
    def create(
        width: int,
        height: int,
        fx: float,
        fy: float,
        ppx: float,
        ppy: float,
        model: Distortion = Distortion.NONE,
        coeffs=(0.0, 0.0, 0.0, 0.0, 0.0),
        device=None,
    ) -> "Intrinsics":
        """Intrinsics on ``device`` (``None``: the card, see
        :func:`~pointcloud_depthfusion_tpu_torch.device.resolve_device`)."""
        device = resolve_device(device)
        return Intrinsics(
            ppx=_f32(ppx, device),
            ppy=_f32(ppy, device),
            fx=_f32(fx, device),
            fy=_f32(fy, device),
            coeffs=_f32(np.asarray(coeffs, np.float32), device),
            width=int(width),
            height=int(height),
            model=Distortion(model),
        )

    @property
    def device(self) -> torch.device:
        return self.fx.device

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    def to(self, device) -> "Intrinsics":
        return dataclasses.replace(
            self,
            ppx=self.ppx.to(device),
            ppy=self.ppy.to(device),
            fx=self.fx.to(device),
            fy=self.fy.to(device),
            coeffs=self.coeffs.to(device),
        )

    def transposed(self) -> "Intrinsics":
        """Swap x/y axes (vertical output image, fusion_node.cpp:156-162)."""
        return Intrinsics(
            ppx=self.ppy,
            ppy=self.ppx,
            fx=self.fy,
            fy=self.fx,
            coeffs=self.coeffs,
            width=self.height,
            height=self.width,
            model=self.model,
        )

    def with_centered_pp(self) -> "Intrinsics":
        """Principal point forced to the image center, with the reference's
        C++ integer division ``ppx = width / 2`` (fusion_node.cpp:164-165)."""
        return dataclasses.replace(
            self,
            ppx=_f32(float(self.width // 2), self.ppx.device),
            ppy=_f32(float(self.height // 2), self.ppy.device),
        )


@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """Rigid transform between two sensors: ``p' = rotation @ p + translation``."""

    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)

    @staticmethod
    def identity(device=None) -> "Extrinsics":
        device = resolve_device(device)
        return Extrinsics(
            torch.eye(3, dtype=torch.float32, device=device),
            torch.zeros(3, dtype=torch.float32, device=device),
        )

    @staticmethod
    def create(rotation, translation, device=None) -> "Extrinsics":
        device = resolve_device(device)
        return Extrinsics(
            _f32(np.asarray(rotation, np.float32), device).reshape(3, 3),
            _f32(np.asarray(translation, np.float32), device).reshape(3),
        )

    @staticmethod
    def from_column_major_flat(rotation9, translation3, device=None) -> "Extrinsics":
        """Build from the wire format: float32[9] column-major R
        (GetCameraParameters.srv; effective matrix = reshape(9, order='F'))."""
        r = np.asarray(rotation9, dtype=np.float32).reshape(3, 3, order="F")
        return Extrinsics.create(r, translation3, device)

    def to(self, device) -> "Extrinsics":
        return Extrinsics(self.rotation.to(device), self.translation.to(device))

    def as_matrix(self) -> torch.Tensor:
        """Return the 4×4 homogeneous transform."""
        m = torch.eye(4, dtype=self.rotation.dtype, device=self.rotation.device)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Host-side calibration record (ROS sensor_msgs/CameraInfo shape).

    ``k`` is the row-major 3×3 camera matrix [fx 0 ppx; 0 fy ppy; 0 0 1],
    ``d`` the distortion coefficients.
    """

    width: int
    height: int
    k: np.ndarray  # (9,)
    d: np.ndarray  # (5,)
    distortion_model: str = "plumb_bob"

    @staticmethod
    def from_intrinsics(intr: Intrinsics) -> "CameraInfo":
        k = np.zeros(9, np.float64)
        k[0] = float(intr.fx)
        k[4] = float(intr.fy)
        k[2] = float(intr.ppx)
        k[5] = float(intr.ppy)
        k[8] = 1.0
        return CameraInfo(
            width=intr.width,
            height=intr.height,
            k=k,
            d=intr.coeffs.cpu().numpy().astype(np.float64),
        )


def camera_info_to_intrinsics(
    info: CameraInfo,
    model: Distortion = Distortion.BROWN_CONRADY,
    legacy_int_truncation: bool = True,
    device=None,
) -> Intrinsics:
    """Convert a CameraInfo record to Intrinsics.

    The reference truncates fx/fy/ppx/ppy to int here
    (fusion_node.cpp:574-577); ``legacy_int_truncation=False`` keeps full
    precision. ``d`` is padded or cut to exactly 5 coefficients.
    """
    cast = (lambda v: float(int(v))) if legacy_int_truncation else float
    return Intrinsics.create(
        width=int(info.width),
        height=int(info.height),
        fx=cast(info.k[0]),
        fy=cast(info.k[4]),
        ppx=cast(info.k[2]),
        ppy=cast(info.k[5]),
        model=model,
        coeffs=tuple(
            (list(float(c) for c in np.asarray(info.d)[:5]) + [0.0] * 5)[:5]
        ),
        device=device,
    )


def fused_virtual_intrinsics(color_left: Intrinsics, vertical_image: bool) -> Intrinsics:
    """Virtual-camera intrinsics: the left color intrinsics, transposed for a
    vertical output, principal point at the image center
    (fusion_node.cpp:150-165)."""
    intr = color_left.transposed() if vertical_image else color_left
    return intr.with_centered_pp()


#: Per-model stream presets (resolution, fps, depth scale), from the
#: reference camera configuration (realsense.cpp:226-236).
CAMERA_MODEL_PRESETS = {
    "D455": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "D435": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "D415": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "L515": dict(depth_size=(1024, 768), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.00025),
}


def model_preset(model: str) -> dict:
    """Stream preset for a camera model name (case-insensitive)."""
    key = model.upper().replace("INTEL REALSENSE ", "")
    if key not in CAMERA_MODEL_PRESETS:
        raise KeyError(
            f"unknown camera model {model!r}; known: {sorted(CAMERA_MODEL_PRESETS)}"
        )
    return dict(CAMERA_MODEL_PRESETS[key])


def d455_default_intrinsics(
    width: int = 848, height: int = 480, device=None
) -> Intrinsics:
    """D455-like pinhole intrinsics (~631 px focal length at 1280×720,
    scaled to the requested resolution)."""
    fx = 631.0 * width / 1280.0
    fy = 631.0 * height / 720.0
    return Intrinsics.create(
        width, height, fx=fx, fy=fy, ppx=width / 2.0, ppy=height / 2.0,
        device=device,
    )


def intrinsics_as_numpy(intr: Intrinsics) -> Tuple[float, float, float, float]:
    return (float(intr.fx), float(intr.fy), float(intr.ppx), float(intr.ppy))
