"""Shared inputs of the port's rig tests (tests/test_torch_rig*.py): the
synthetic arc rig of configs/deployment_rig4.yaml at a small size, its
intrinsics in both packages, and the calls that run one rig_fuse step of
either package on the same numpy arrays."""

import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_depthfusion_tpu.core.camera import Distortion as JDist
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig as JConfig
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig as TConfig
from pointcloud_depthfusion_tpu_torch.io.feeder import SyntheticSource
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses
from pointcloud_depthfusion_tpu_torch.utils import convert

W, H, N = 106, 60, 4
BC_COEFFS = (0.06, -0.02, 0.001, -0.0015, 0.004)
ROIS = [(8, 4, 80, 40), None, (-1, -1, -1, -1), (20, 10, 60, 45)]


def jax_intrinsics(per_camera: bool):
    """Shared D455-like intrinsics, or four per-camera ones with different
    fx/fy/ppx/ppy under the inverse Brown-Conrady model, camera 1 with
    real coefficients."""
    if not per_camera:
        return JIntr.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2)
    return [JIntr.create(W, H, fx=78.0 + 3.0 * i, fy=80.0 + 2.0 * i, ppx=W / 2 + (i - 1) * 1.5,
                         ppy=H / 2 - i, model=JDist.INVERSE_BROWN_CONRADY,
                         coeffs=BC_COEFFS if i == 1 else (0.0,) * 5)
            for i in range(N)]


def torch_intrinsics(j):
    """The port's intrinsics with the same leaves as the JAX ones ``j``."""
    def leaves(it):
        return tuple(np.asarray(getattr(it, f)) for f in ("ppx", "ppy", "fx", "fy", "coeffs"))

    if isinstance(j, JIntr):
        return convert.intrinsics_from_arrays(*leaves(j), j.width, j.height, j.model,
                                              device="cpu")
    return convert.rig_intrinsics_from_arrays([leaves(it) for it in j], j[0].width,
                                              j[0].height, j[0].model, device="cpu")


def arc_frames(n=N, seed=0, span=0.8):
    """n synthetic cameras on the deployment_rig4 arc (37.5 deg/m toe-in):
    (depth (n, H, W) u16, color (n, H, W, 3) u8, cam_to_virtual (n, 4, 4))."""
    host = convert.intrinsics_from_arrays(W / 2, H / 2, 80.0, 80.0, np.zeros(5), W, H,
                                          device="cpu")
    poses = rig_arc_poses(n, span=span, toe_in_deg_per_m=37.5)
    fs = [SyntheticScene().render(host, p, depth_noise_std=0.002, hole_fraction=0.01,
                                  seed=seed + i) for i, p in enumerate(poses)]
    return (np.stack([f.depth for f in fs]), np.stack([f.color for f in fs]),
            np.stack(poses).astype(np.float32))


def both_configs(**kw):
    """The same FusionConfig in both packages: the rig's settings plus ``kw``."""
    base = dict(vertical_image=False, mirror_image=False, filter_fused_color=False)
    base.update(kw)
    return JConfig.create(**base), TConfig.create(device="cpu", **base)


def run_jax(fn, depth, color, c2v):
    n = depth.shape[0]
    return np.asarray(fn(jnp.asarray(depth), jnp.asarray(color), jnp.full((n,), 0.001, jnp.float32),
                         jnp.asarray(c2v)))


def run_torch(fn, depth, color, c2v):
    n = depth.shape[0]
    return fn(torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(color),
              torch.full((n,), 0.001), convert.cam_to_virtual_from_array(c2v, device="cpu"))


def small_intrinsics(w=32, h=24, f=25.0):
    return TIntr.create(w, h, fx=f, fy=f, ppx=w / 2, ppy=h / 2, device="cpu")


class FiniteSource(SyntheticSource):
    """A SyntheticSource that ends after ``n_frames``."""

    def __init__(self, *a, n_frames=5, **kw):
        super().__init__(*a, **kw)
        self.n_frames = n_frames

    def next_frame(self):
        if self.frame_idx >= self.n_frames:
            return None
        return super().next_frame()


def arc_sources(n, intr, cls=SyntheticSource, **kw):
    """n streaming cameras on the arc, camera i seeded i + 1."""
    poses = rig_arc_poses(n, toe_in_deg_per_m=37.5)
    return [cls(SyntheticScene(), intr, poses[i], seed=i + 1, **kw) for i in range(n)]
