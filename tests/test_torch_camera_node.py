"""The port's host tier against the JAX package on the same host data:
CameraNode's filter bank and option handling, the ApproximateTime pairer,
the factory's node kwargs and the image sink. All numpy on both sides, so
every comparison is exact."""

import os

import numpy as np
import pytest

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset as JHost
from pointcloud_depthfusion_tpu.io.feeder import ApproximateTimePairer as JPairer
from pointcloud_depthfusion_tpu.io.feeder import FramesetSource as JSource
from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode as JCam
from pointcloud_depthfusion_tpu.nodes import image_node as JImg
from pointcloud_depthfusion_tpu.utils import factory as JFac
from pointcloud_depthfusion_tpu.utils.config import ConfigTree as JTree
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset as THost
from pointcloud_depthfusion_tpu_torch.io.feeder import ApproximateTimePairer as TPairer
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource as TSource
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode as TCam
from pointcloud_depthfusion_tpu_torch.nodes import image_node as TImg
from pointcloud_depthfusion_tpu_torch.utils import factory as TFac
from pointcloud_depthfusion_tpu_torch.utils.config import ConfigTree as TTree

H, W = 24, 32


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(400, 3500, (H, W)).astype(np.int32)
    out = []
    for k in range(n):
        d = np.clip(base + rng.integers(-25, 26, (H, W)), 0, 65535).astype(np.uint16)
        d[rng.random((H, W)) < 0.1] = 0
        c = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        out.append((d, c, k / 30.0))
    return out


def _sources(frames):
    kw = dict(fx=30.0, fy=31.0, ppx=16.0, ppy=12.0)

    class JList(JSource):
        intrinsics = JIntr.create(W, H, **kw)

        def __init__(self):
            self.i = 0

        def next_frame(self):
            if self.i == len(frames):
                return None
            d, c, t = frames[self.i]
            self.i += 1
            return JHost(depth=d, color=c, timestamp=t)

    class TList(TSource):
        intrinsics = TIntr.create(W, H, device="cpu", **kw)

        def __init__(self):
            self.i = 0

        def next_frame(self):
            if self.i == len(frames):
                return None
            d, c, t = frames[self.i]
            self.i += 1
            return THost(depth=d, color=c, timestamp=t)

    return JList(), TList()


BANKS = {
    "reference (temporal only)": {},
    "all in depth": dict(decimation_filter=True, threshold_filter=True, threshold_min_m=0.6,
                         threshold_max_m=3.0, spatial_filter=True, hole_filling=True,
                         hole_fill_mode="nearest"),
    "disparity domain": dict(disparity_domain=True, spatial_filter=True, spatial_magnitude=1,
                             hole_filling=True, hole_fill_mode="left"),
    "no temporal": dict(temporal_filter=False, hole_filling=True),
}


@pytest.mark.parametrize("bank", list(BANKS))
def test_filter_bank_matches_jax(bank):
    frames = _frames(4, seed=len(bank))
    js, ts = _sources(frames)
    jc, tc = JCam("cam", js, **BANKS[bank]), TCam("cam", ts, **BANKS[bank])
    got_j, got_t = [], []
    jc.subscribe_frameset(got_j.append)
    tc.subscribe_frameset(got_t.append)
    jc.spin(realtime=False)
    tc.spin(realtime=False)
    assert len(got_t) == len(got_j) == 4
    for a, b in zip(got_j, got_t):
        assert b.depth.dtype == a.depth.dtype and b.depth.shape == a.depth.shape
        np.testing.assert_array_equal(b.depth, a.depth)
        np.testing.assert_array_equal(b.color, a.color)
        assert b.timestamp == a.timestamp
    pj, pt = jc.get_camera_parameters(), tc.get_camera_parameters()
    for f in ("depth_info", "color_info"):
        a, b = getattr(pj, f), getattr(pt, f)
        assert (a.width, a.height) == (b.width, b.height)
        np.testing.assert_array_equal(a.k, b.k)
        np.testing.assert_array_equal(a.d, b.d)
    np.testing.assert_array_equal(pj.extrinsic_rotation, pt.extrinsic_rotation)
    np.testing.assert_array_equal(pj.extrinsic_translation, pt.extrinsic_translation)


def test_options_coerce_and_reject_like_jax():
    """String values from YAML or a runtime set coerce to each option's
    type as in JAX; a bad enum value is rejected when set."""
    values = {
        "sensor.depth.temporal_filter": "false", "sensor.depth.decimation_magnitude": "3.0",
        "sensor.depth.spatial_alpha": "0.5", "sensor.depth.hole_fill_mode": "left",
        "sensor.depth.hole_fraction": 0.0, "fps": "15", "verbose": "0",
        "profiling.publish_fps": "off",
    }
    nodes = []
    for cam, tree, src in ((JCam, JTree, _sources([])[0]), (TCam, TTree, _sources([])[1])):
        src.sensor_options = lambda: {"depth": {"hole_fraction": 0.01}}
        src.hole_fraction = 0.01
        node, cfg = cam("cam", src), tree()
        for k, v in values.items():
            cfg.set(k, v)
        node.attach_config(cfg)
        cfg.set("sensor.depth.threshold_max_m", "2.5")
        cfg.set("sensor.depth.hole_filling", "yes")
        cfg.set("debug.enable_debug", "true")
        with pytest.raises(ValueError, match="hole_fill_mode"):
            cfg.set("sensor.depth.hole_fill_mode", "middle")
        nodes.append((node, src))
    (jn, jsrc), (tn, tsrc) = nodes
    assert tn.sensor_options() == jn.sensor_options()
    for n in (jn, tn):
        assert n.sensor_options()["depth"]["decimation_magnitude"] == 3
    assert (tn.fps, tn.verbose, tn.debug_save_data, tn.fps_counter.publish) == \
        (jn.fps, jn.verbose, jn.debug_save_data, jn.fps_counter.publish)
    assert tsrc.hole_fraction == jsrc.hole_fraction == 0.0


def _stamps(seed):
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.uniform(0.02, 0.045, 60))
    b = np.cumsum(rng.uniform(0.02, 0.045, 60)) + rng.uniform(-0.01, 0.01)
    keep = rng.random(60) > 0.15  # dropped frames on one stream
    return a, b[keep]


@pytest.mark.parametrize("seed", [0, 1])
def test_pairer_matches_jax(seed):
    a, b = _stamps(seed)
    events = sorted([(t, 0) for t in a] + [(t + 0.004, 1) for t in b])  # arrival order
    for interval, qsize in ((0.017, 10), (0.005, 3)):
        pj, pt = JPairer(interval, qsize), TPairer(interval, qsize)
        out_j, out_t = [], []
        for t, s in events:
            out_j += [(x.timestamp, y.timestamp) for x, y in pj.push(s, JHost(None, None, t))]
            out_t += [(x.timestamp, y.timestamp) for x, y in pt.push(s, THost(None, None, t))]
        assert out_t == out_j and len(out_t) > 10
        assert (pt.dropped, pt.emitted) == (pj.dropped, pj.emitted)


def test_factory_node_kwargs_match_jax(tmp_path):
    override = tmp_path / "fusion.yaml"
    override.write_text(
        "fusion_node:\n  save_data: true\n  qos: {lifespan_s: 0}\n"
        "  profiling: {enable_profiling: true, log_size: 7}\n  sync: {queue_size: 4}\n")
    reg = tmp_path / "reg.yaml"
    reg.write_text("registration_node:\n  spin_rate: 2.0\n  profiling: {enable_profiling: true}\n")
    for path in (None, str(override)):
        _, jt = JFac.fusion_config(path)
        _, tt = TFac.fusion_config(path, device="cpu")
        assert TFac.fusion_node_kwargs_from_tree(tt) == JFac.fusion_node_kwargs_from_tree(jt)
    for path in (None, str(reg)):
        _, jt = JFac.registration_settings(path)
        _, tt = TFac.registration_settings(path)
        assert TFac.registration_node_kwargs_from_tree(tt) == \
            JFac.registration_node_kwargs_from_tree(jt)
    for name in ("camera_left", "camera_right", "cam2"):
        assert TFac.camera_config(name).as_dict() == JFac.camera_config(name).as_dict()


def test_image_node_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.integers(0, 4000, (8, 12)).astype(np.uint16)
    np.testing.assert_array_equal(TImg.depth_to_u8(depth), JImg.depth_to_u8(depth))
    counts = []
    for mod, sub in ((JImg, "jax"), (TImg, "torch")):
        node = mod.ImageNode(out_dir=str(tmp_path / sub), every_n=2, max_saved=2)
        for k in range(5):
            img = rng.integers(0, 256, (8, 12, 3)).astype(np.uint8)
            node(img, k / 30)
            node.on_depth(depth, k / 30)
            node.on_frameset(JHost(depth[::2, ::2], img, k / 30))
        counts.append((node.received, node.saved, sorted(os.listdir(tmp_path / sub))))
    assert counts[0] == counts[1]


def test_image_node_display_close_fires_on_close():
    closed = []

    def display(image, timestamp, kind=None):
        raise TImg.WindowClosed(kind)

    node = TImg.ImageNode(display=display, on_close=lambda: closed.append(1))
    node(np.zeros((2, 2, 3), np.uint8), 0.0)
    node(np.zeros((2, 2, 3), np.uint8), 0.1)
    assert node.closed.is_set() and closed == [1]


def test_camera_node_topics_debug_dump_and_fps_sink(tmp_path):
    """The depth and small-preview topics, the debug PNG dump and the FPS
    sink's publish gate."""
    from pointcloud_depthfusion_tpu_torch.utils.profiling import FpsCounter

    _, ts = _sources(_frames(3))
    cam = TCam("cam", ts, small_image_width=8, small_image_height=6)
    cam.debug_save_data, cam.debug_save_dir = True, str(tmp_path / "dbg")
    depths, smalls = [], []
    cam.subscribe_depth(lambda d, t: depths.append(t))
    cam.subscribe_color_small(lambda img, t: smalls.append(img.shape))
    cam.start(realtime=False)._thread.join(timeout=30)  # the source ends after 3 frames
    assert not cam._thread.is_alive()
    cam.stop()
    assert depths == [0.0, 1 / 30, 2 / 30] and smalls == [(6, 8, 3)] * 3
    assert len(os.listdir(tmp_path / "dbg")) == 6
    sent = []
    fps = FpsCounter(report_every_s=0.0, sink=sent.append)
    assert fps.tick() is not None and len(sent) == 1
    fps.publish = False
    assert fps.tick() is not None and len(sent) == 1
