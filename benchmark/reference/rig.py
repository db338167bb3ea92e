"""The plain reference of the rig tier's fused images.

Plain PyTorch, importing nothing of the program: the N-camera image of
``RigFusionNodeApp`` (nodes/rig_node.py) on ``reference/fusion.py``'s
arithmetic. For each set of frames:

- each camera's points in the virtual camera, from the handed-in
  ``cam_to_virtual[i]`` (camera i -> virtual frame) and the camera's own
  intrinsics as the frames carry them (``project_camera``);
- the nearest point of each virtual pixel over all cameras, ties to the
  smaller rgb24 (``resolve``);
- the colour decode, black where no point landed (``color_image``).

Where it departs from the rig node's docstring semantics:

- the calibration is held where it was handed in: the node's adjacent-pair
  sweeps, which would re-anchor ``cam_to_virtual`` while it streams, are
  off in the configurations this reference serves (``registration_every``
  0), and a configuration with them on raises;
- the virtual camera is camera 0's intrinsics with the principal point at
  the centre by C integer division, not transposed (``vertical_image``
  false) and not truncated: the rig takes each camera's intrinsics from
  its source, with no calibration handshake between;
- only the exact resolve is computed (``render_mode`` tiled or exact, the
  lossy ``packed`` one raises), the fused colour unfiltered, no ROIs and
  no lens distortion, as the served configuration has them.

``dtype`` selects the precision of the per-point geometry: float32 is what
the configurations state; the control runs the same code in bfloat16.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from benchmark.reference.fusion import (
    color_image,
    pack_rgb24,
    project_camera,
    resolve,
    virtual_intrinsics,
)

# Pose products in full float32: TF32 would move projected pixels.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cam_to_virtual(poses: Sequence[np.ndarray], device) -> torch.Tensor:
    """(N, 4, 4) float32: each camera's camera->world pose, which is its
    camera->virtual transform when the virtual frame is the world's (the
    loaded calibration of the served configuration)."""
    return torch.as_tensor(np.stack(poses).astype(np.float32), device=device)


def check_supported(rig: dict) -> None:
    """Raise for a rig node setting this reference does not compute."""
    if rig["registration_every"] or rig["vertical_image"] or rig["filter_fused_color"]:
        raise ValueError("the rig reference computes the image of a fixed calibration, "
                         "not transposed and not filtered")
    if rig["render_mode"] not in ("tiled", "exact"):
        raise ValueError("the rig reference computes the exact resolve only")


def fuse_rig_image(depths: torch.Tensor, colors: torch.Tensor, scale: float, intr: dict,
                   poses: torch.Tensor, rig: dict, dtype=torch.float32) -> torch.Tensor:
    """The fused (H, W, 3) uint8 image of one set: ``depths`` (N, H, W)
    int32 uint16 values, ``colors`` (N, H, W, 3) uint8, ``poses`` (N, 4, 4)
    camera->virtual float32; ``rig``: the configuration's depth window and
    mirror."""
    virt = virtual_intrinsics(intr, vertical=False)
    points = [project_camera(d, pack_rgb24(c), scale, intr, p, virt, rig["mirror_image"],
                             rig["min_depth"], rig["max_depth"], dtype)
              for d, c, p in zip(depths, colors, poses)]
    winner = resolve(points, virt["width"] * virt["height"])
    return color_image(winner, virt["height"], virt["width"], gauss=False)
