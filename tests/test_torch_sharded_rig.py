"""The port's camera-sharded rig on the CPU: ``rig_fuse_sharded`` over
``make_camera_mesh(2)`` and ``(4)`` in both modes, with shared and with
per-camera intrinsics and ROIs, held bit for bit to the JAX package's over
its virtual CPU devices (tests/test_parallel.py:75-221, :363, :571) and to
the port's single-device rig.

Each file of the sharded tests holds at most four cases: xdist's loadfile
schedule hands out files with fewer cases last, behind the slowest JAX
test file, so these run beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.parallel import mesh as JM
from pointcloud_depthfusion_tpu_torch.parallel import mesh as TM
from torch_sharded_common import (H, ROIS, W, frames, intrinsics, jax_step, run_jax, run_torch,
                                  torch_step)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,shards,per_camera", [
    ("tiled", 2, True), ("packed", 4, True), ("tiled", 4, False), ("packed", 2, False)])
def test_sharded_rig_bit_exact_to_jax(mode, shards, per_camera):
    """Both modes over 2 and 4 shards, shared and per-camera intrinsics
    with ROIs: bit for bit the JAX package's sharded step, and the port's
    single-device rig."""
    args = frames(per_camera)
    got = run_torch(torch_step(shards, mode, per_camera), *args)
    want = run_jax(jax_step(shards, mode, per_camera), *args)
    assert got.shape == (H, W, 3) and got.any(-1).mean() > 0.6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, run_torch(torch_step(0, mode, per_camera), *args))
    if per_camera:
        # The calibration's per-shard windows and ROI masks at shard 1 of 2.
        jc = JM._RigCalibration(intrinsics(True, "jax"), ROIS)
        tc = TM._RigCalibration(intrinsics(True, "torch"), ROIS, "cpu")
        for j, t in zip(jc.windows(2, 2), tc.windows(2, 2)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        valid = np.random.default_rng(0).random((2, H, W)) < 0.7
        np.testing.assert_array_equal(tc.valid_roi(torch.from_numpy(valid), 2).numpy(),
                                      np.asarray(jc.valid_roi(jnp.asarray(valid), 2)))
        assert tc.per_camera and tc.at(1, 2).fx == intrinsics(True, "torch")[3].fx
