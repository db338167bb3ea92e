"""The port's PointCloud (core/pointcloud.py) against the JAX package on
the CPU, following tests/test_pointcloud.py.

Bars: deprojected points within rtol 2e-7 (XLA's CPU division misrounds
some quotients, ROADMAP queue C), masks, colors and counts equal;
projections of the same cloud bit for bit.
"""

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.frameset import Frameset as JFrameset
from pointcloud_depthfusion_tpu.core.pointcloud import PointCloud as JCloud
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset as TFrameset
from pointcloud_depthfusion_tpu_torch.core.pointcloud import PointCloud as TCloud

INTR = dict(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def framesets():
    """The same 64×48 synthetic frame (the left camera of the dual rig) in
    both packages, stamped 12345.678 s."""
    fs = SyntheticScene().render(JIntr.create(64, 48, **INTR), two_camera_rig()[0])
    j = JFrameset.create(fs.depth, fs.color, JIntr.create(64, 48, **INTR), timestamp=12345.678)
    t = TFrameset.create(fs.depth, fs.color, TIntr.create(64, 48, device="cpu", **INTR),
                         timestamp=12345.678, device="cpu")
    return j, t


def _cloud(c) -> tuple:
    return tuple(np.asarray(a) for a in (c.points, c.colors, c.valid))


@pytest.mark.parametrize("window", [dict(min_depth=0.5, max_depth=4.0), dict(),
                                    dict(roi=(4, 4, 10, 10))])
def test_deproject_transform_project_match_jax(framesets, window):
    """deproject (with a depth window, none, and a ROI alone), transform,
    append, count, to_host, and project in exact, tiled and packed modes."""
    jf, tf = framesets
    jc, tc = JCloud.deproject(jf, **window), TCloud.deproject(tf, **window)
    (jp, jcol, jv), (tp, tcol, tv) = _cloud(jc), _cloud(tc)
    np.testing.assert_allclose(tp, jp, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_array_equal(tv, jv)
    assert int(tc.count()) == int(jc.count()) and tc.capacity == jc.capacity == 64 * 48
    if "roi" in window:
        assert int(tc.count()) <= 100
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.1, 0, 0]
    moved = tc.transform(t)
    np.testing.assert_allclose(moved.points.numpy(), np.asarray(jc.transform(t).points),
                               rtol=1e-6, atol=1e-6)
    merged = tc.append(moved)
    assert merged.capacity == 2 * tc.capacity and int(merged.count()) == 2 * int(tc.count())
    for got, want in zip(tc.to_host(), jc.to_host()):
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    # The same cloud through both renders: JAX's points in the port.
    same = TCloud(torch.from_numpy(jp.copy()), torch.from_numpy(jcol.copy()),
                  torch.from_numpy(jv.copy()))
    intr_t, intr_j = TIntr.create(64, 48, device="cpu", **INTR), JIntr.create(64, 48, **INTR)
    for mode in ("exact", "tiled", "packed"):
        for mirror in (False, True):
            img, zbuf = same.project(intr_t, mirror, mode)
            jimg, jzbuf = jc.project(intr_j, mirror, mode)
            np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
            np.testing.assert_array_equal(zbuf.numpy(), np.asarray(jzbuf))
    with pytest.raises(ValueError, match="packed"):
        tc.project(intr_t, mode="indexed")


def test_reprojection_and_aligned_shape(framesets):
    """Re-projecting an unmoved cloud reproduces the covered color pixels
    (tests/test_pointcloud.py:21); a depth that is not color-aligned
    raises."""
    _, tf = framesets
    img, zbuf = TCloud.deproject(tf, min_depth=0.5, max_depth=4.0).project(tf.color_intrinsics)
    covered = (zbuf < 1e37).numpy()
    assert covered.mean() > 0.8
    np.testing.assert_array_equal(img.numpy()[covered], tf.color.numpy()[covered])
    bad = TFrameset.create(np.zeros((24, 32), np.uint16), np.zeros((48, 64, 3), np.uint8),
                           tf.color_intrinsics, device="cpu")
    with pytest.raises(ValueError, match="aligned"):
        TCloud.deproject(bad)
