"""The rest of the JAX package's library surface that PointCloud brings to
the port, against the JAX package on the CPU: Frameset.depth_metric and
to_host, io.artifacts' PLY writer and readers and load_png (PLY files
byte for byte), StageTimer.reset, get_current_rss_bytes and the lazy
package exports.
"""

import os

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.frameset import Frameset as JFrameset
from pointcloud_depthfusion_tpu.core.pointcloud import PointCloud as JCloud
from pointcloud_depthfusion_tpu.io import artifacts as JA
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset as TFrameset
from pointcloud_depthfusion_tpu_torch.core.pointcloud import PointCloud as TCloud
from pointcloud_depthfusion_tpu_torch.io import artifacts as TA
from pointcloud_depthfusion_tpu_torch.utils import profiling

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


def test_frameset_depth_metric_and_to_host(framesets):
    jf, tf = framesets
    np.testing.assert_array_equal(tf.depth_metric().numpy(), np.asarray(jf.depth_metric()))
    jh, th = jf.to_host(), tf.to_host()
    assert th.depth.dtype == jh.depth.dtype == np.uint16
    np.testing.assert_array_equal(th.depth, jh.depth)
    np.testing.assert_array_equal(th.color, jh.color)
    assert th.timestamp == jh.timestamp and th.depth_scale == jh.depth_scale

def test_ply_and_png_match_jax(framesets, tmp_path):
    """save_ply writes JAX's bytes (binary and ascii, with and without
    colors; PointCloud.save_ply too); load_ply and load_png read what
    JAX's read."""
    jf, tf = framesets
    pts, cols = TCloud.deproject(tf).to_host()
    for binary in (True, False):
        for colors in (cols, None):
            a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
            TA.save_ply(a, pts, colors, binary=binary)
            JA.save_ply(b, pts, colors, binary=binary)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), (binary, colors is None)
            for got, want in zip(TA.load_ply(a, return_colors=True),
                                 JA.load_ply(b, return_colors=True)):
                np.testing.assert_array_equal(got, want)
    a, b = str(tmp_path / "cloud_port.ply"), str(tmp_path / "cloud_jax.ply")
    TCloud.deproject(tf).save_ply(a)
    JCloud.deproject(jf).save_ply(b)
    assert TA.load_ply(a).shape == (int(TCloud.deproject(tf).count()), 3)
    np.testing.assert_allclose(TA.load_ply(a), JA.load_ply(b), rtol=2e-7, atol=0)
    for name, img in (("depth.png", tf.to_host().depth), ("color.png", tf.to_host().color)):
        path = str(tmp_path / name)
        TA.save_png(path, img)
        got, want = TA.load_png(path), JA.load_png(path)
        assert got.dtype == want.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(want, img)

def test_stage_timer_reset_rss_and_package_exports():
    """StageTimer.reset clears the laps; the resident set size is read from
    /proc; every lazy export of the JAX package's __init__ resolves in the
    port's."""
    import pointcloud_depthfusion_tpu as jpkg
    import pointcloud_depthfusion_tpu_torch as tpkg

    timer = profiling.StageTimer()
    timer.lap("a")
    timer.reset()
    assert timer.laps == {}
    assert timer.lap("b") >= 0.0 and list(timer.laps) == ["b"]
    rss = profiling.get_current_rss_bytes()
    assert rss > (1 << 20) if os.path.exists("/proc/self/statm") else rss == 0
    assert tpkg.__all__ == jpkg.__all__ and tpkg.__version__ == jpkg.__version__
    assert tpkg.PointCloud is TCloud and callable(tpkg.make_camera_mesh)
    assert callable(tpkg.rig_fuse_sharded)
    with pytest.raises(AttributeError):
        tpkg.not_a_name  # noqa: B018
