"""Shared inputs of the port's sharded-rig tests
(tests/test_torch_sharded_*.py, tests/test_torch_multihost.py): the
4-camera arc of tests/test_parallel.py at 64×48 in both packages, and the
steps of either package on the same numpy arrays. A helper module, not a
test file."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig as JConfig
from pointcloud_depthfusion_tpu.parallel import mesh as JM
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig as TConfig
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
from pointcloud_depthfusion_tpu_torch.parallel import mesh as TM
from pointcloud_depthfusion_tpu_torch.parallel.multihost import rig_poses

W, H, N = 64, 48, 4
ROIS = [(8, 4, 40, 32), None, (0, 0, 32, 48), (16, 8, 40, 40)]
RIG = dict(vertical_image=False, mirror_image=False, filter_fused_color=False)


def leaves(per_camera: bool):
    """(fx, fy, ppx, ppy) of the shared camera, or of the four per-camera
    ones of tests/test_parallel.py:296 (_het_intrinsics)."""
    if not per_camera:
        return [(50.0, 50.0, W / 2, H / 2)]
    return [(45.0 + 4.0 * i, 48.0 + 3.0 * i, W / 2 + (i - 1) * 1.5, H / 2 - i) for i in range(N)]


def intrinsics(per_camera: bool, pkg: str):
    cls = JIntr if pkg == "jax" else TIntr
    kw = {} if pkg == "jax" else {"device": "cpu"}
    made = [cls.create(W, H, fx=fx, fy=fy, ppx=px, ppy=py, **kw)
            for fx, fy, px, py in leaves(per_camera)]
    return made if per_camera else made[0]


def frames(per_camera: bool, tie: bool = False):
    """N cameras of the arc: (depth u16, color u8, cam_to_virtual f32). With
    ``tie`` camera 2 repeats camera 0's pose and depth with another color,
    so every pixel both reach ties in z across the shards of a 2- or
    4-shard mesh."""
    intr = intrinsics(per_camera, "torch")
    poses = rig_poses(0, N, N)
    if tie:
        poses[2] = poses[0]
    fs = [SyntheticScene().render(intr[i] if per_camera else intr, poses[i], seed=i)
          for i in range(N)]
    depth = np.stack([f.depth for f in fs])
    color = np.stack([f.color for f in fs])
    if tie:
        depth[2] = depth[0]
        color[2] = 255 - color[0]
    return depth, color, np.stack(poses)


@functools.lru_cache(maxsize=None)
def jax_step(shards: int, mode: str, per_camera: bool):
    """One JAX sharded step per case, built once (each compiles)."""
    intr = intrinsics(per_camera, "jax")
    cfg = JConfig.create(render_mode=mode, **RIG)
    ref = intr[0] if per_camera else intr
    return JM.rig_fuse_sharded(JM.make_camera_mesh(shards), intr, ref, cfg,
                               rois=ROIS if per_camera else None)


def torch_step(shards: int, mode: str, per_camera: bool):
    """The port's sharded step (``shards`` = 0: the single-device rig)."""
    intr = intrinsics(per_camera, "torch")
    cfg = TConfig.create(render_mode=mode, device="cpu", **RIG)
    ref = intr[0] if per_camera else intr
    rois = ROIS if per_camera else None
    if shards == 0:
        return TM.rig_fuse(intr, ref, cfg, rois=rois, device="cpu")
    return TM.rig_fuse_sharded(TM.make_camera_mesh(shards, device="cpu"), intr, ref, cfg,
                               rois=rois)


def run_jax(fn, depth, color, c2v):
    return np.asarray(fn(jnp.asarray(depth), jnp.asarray(color),
                         jnp.full((len(depth),), 0.001, jnp.float32), jnp.asarray(c2v)))


def run_torch(fn, depth, color, c2v):
    return fn(torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(color),
              torch.full((len(depth),), 0.001), torch.from_numpy(c2v)).numpy()
