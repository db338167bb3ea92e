"""The merge and the streaming side of the port's camera-sharded rig on
the CPU: a z-tie across shards against the JAX package's sharded step, the
single MIN over ``minz << 32 | mrgb`` against JAX's two ``pmin``s, the
errors (no fallback), and ``RigFeeder(mesh=)`` and
``RigFusionNodeApp(mesh=)`` (tests/test_parallel.py:602, :704).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig as TConfig
from pointcloud_depthfusion_tpu_torch.io.feeder import SyntheticSource
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
from pointcloud_depthfusion_tpu_torch.parallel import mesh as TM
from pointcloud_depthfusion_tpu_torch.parallel.multihost import rig_poses
from torch_sharded_common import (H, N, RIG, W, frames, intrinsics, jax_step, run_jax,
                                  run_torch, torch_step)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_rig_cross_shard_tie_matches_jax():
    """Camera 2 (shard 2 of 4) ties camera 0 (shard 0) in z on every pixel
    both reach, with another color: the single MIN over ``minz << 32 |
    mrgb`` picks the smaller rgb as JAX's two pmins do."""
    depth, color, c2v = frames(False, tie=True)
    cfg = TConfig.create(device="cpu", **RIG)
    calib = TM._RigCalibration(intrinsics(False, "torch"), None, "cpu")
    minbufs = TM._tiled_rig_body(calib, intrinsics(False, "torch"), cfg)[2]
    bufs = [minbufs(torch.from_numpy(depth[i:i + 1].astype(np.int32)),
                    torch.from_numpy(color[i:i + 1]), torch.full((1,), 0.001),
                    torch.from_numpy(c2v[i:i + 1])) for i in (0, 2)]
    ties = (bufs[0][0] == bufs[1][0]) & (bufs[0][0] != TM.INT32_MAX) & (bufs[0][1] != bufs[1][1])
    assert int(ties.sum()) > 1000
    got = run_torch(torch_step(4, "tiled", False), depth, color, c2v)
    np.testing.assert_array_equal(got, run_jax(jax_step(4, "tiled", False), depth, color, c2v))


def test_single_min_merge_equals_two_pmins():
    """The merge of the tiled shards: one MIN of int64 ``minz << 32 | mrgb``
    equals JAX's ``gz = pmin(minz)``, then ``pmin(where(minz == gz, mrgb,
    INT32_MAX))``, ties and empty pixels included."""
    rng = np.random.default_rng(0)
    n_px, shards = 4096, 3
    minz = rng.integers(0x3E000000, 0x3E000010, (shards, n_px)).astype(np.int32)
    mrgb = rng.integers(0, 1 << 24, (shards, n_px)).astype(np.int32)
    empty = rng.random((shards, n_px)) < 0.3
    minz[empty] = mrgb[empty] = 0x7FFFFFFF
    gz = minz.min(0)
    want = np.where(minz == gz, mrgb, 0x7FFFFFFF).min(0)
    mesh = TM.make_camera_mesh(shards, device="cpu")
    keys = [(torch.from_numpy(z).to(torch.int64) << 32) | torch.from_numpy(c).to(torch.int64)
            for z, c in zip(minz, mrgb)]
    merged = TM._merge_min(mesh, keys)
    assert ((minz == gz).sum(0) > 1).sum() > 100  # ties across shards
    np.testing.assert_array_equal((merged >> 32).numpy(), gz)
    np.testing.assert_array_equal((merged & 0xFFFFFFFF).numpy(), want)


def test_sharded_rig_errors_and_no_fallback():
    """Per-camera calibration shorter than the camera axis raises (JAX's
    message), as do a shard count that does not divide the cameras, the
    image-only resolve, a CUDA mesh without a card, and RigFeeder over a
    mesh that does not divide its cameras."""
    intr = intrinsics(True, "torch")[:2]
    cfg = TConfig.create(device="cpu", **RIG)
    fn = TM.rig_fuse_sharded(TM.make_camera_mesh(2, device="cpu"), intr, intr[0], cfg)
    z = (torch.zeros((N, H, W), dtype=torch.int32), torch.zeros((N, H, W, 3), dtype=torch.uint8),
         torch.full((N,), 0.001), torch.eye(4).expand(N, 4, 4))
    with pytest.raises(ValueError, match="calibration"):
        fn(*z)
    shared = TM.rig_fuse_sharded(TM.make_camera_mesh(4, device="cpu"), intr[0], intr[0], cfg)
    with pytest.raises(ValueError, match="not divisible"):
        shared(*(t[:3] for t in z))
    with pytest.raises(ValueError, match="emit_zbuf"):
        TM.rig_fuse_sharded(TM.make_camera_mesh(2, device="cpu"), intr[0], intr[0],
                            dataclasses.replace(cfg, emit_zbuf=False))
    mesh = TM.make_camera_mesh(2, device="cpu")
    assert mesh.shape == {"cam": 2} and mesh.devices == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        for call in (lambda: TM.make_camera_mesh(2), lambda: TM.make_camera_mesh(2, device="cuda")):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    from pointcloud_depthfusion_tpu_torch.io.feeder import RigFeeder

    sources = [SyntheticSource(SyntheticScene(), intr[0], np.eye(4), seed=i) for i in range(3)]
    with pytest.raises(ValueError, match="not divisible"):
        RigFeeder(sources, mesh=mesh)


def test_rig_feeder_and_node_sharded_streaming():
    """RigFeeder(mesh=) delivers each shard's cameras on its shard
    (ShardedCameras), rig_fuse_sharded takes the batch as it is, and the
    image equals the JAX package's sharded step on the same host frames
    (tests/test_parallel.py:704); RigFusionNodeApp(mesh=) fuses the same
    frames with the z-buffer resolve."""
    from pointcloud_depthfusion_tpu_torch.io.feeder import RigFeeder
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp

    intr = intrinsics(False, "torch")
    poses = rig_poses(0, N, N)
    c2v = np.stack(poses)

    def sources():
        return [SyntheticSource(SyntheticScene(), intr, poses[i], seed=i + 1,
                                timestamp_jitter_s=0.003) for i in range(N)]

    mesh = TM.make_camera_mesh(N, device="cpu")
    fn = torch_step(4, "tiled", False)
    host_sets = []
    with RigFeeder(sources(), mesh=mesh) as feeder:
        for _ in range(3):
            batch = feeder.get(timeout=30.0)
            assert isinstance(batch.depth, TM.ShardedCameras)
            assert batch.depth.shape == (N, H, W) and len(batch.depth.shards) == N
            assert all(s.shape == (1, H, W) for s in batch.depth.shards)
            img = fn(batch.depth, batch.color, batch.depth_scale, torch.from_numpy(c2v)).numpy()
            d = np.stack([f.depth for f in batch.host_frames])
            c = np.stack([f.color for f in batch.host_frames])
            np.testing.assert_array_equal(img, run_jax(jax_step(4, "tiled", False), d, c, c2v))
            assert max(batch.timestamps) - min(batch.timestamps) <= 0.017
            host_sets.append((d, c))
    app = RigFusionNodeApp(sources(), intr, c2v, mesh=TM.make_camera_mesh(2, device="cpu"))
    assert app.config.emit_zbuf and app.device == torch.device("cpu")
    images = []
    app.subscribe_fused(lambda img, stamps: images.append(img))
    assert app.run(max_frames=3) == 3
    for img, (d, c) in zip(images, host_sets):
        np.testing.assert_array_equal(img, run_torch(fn, d, c, c2v))
