"""The port's dual deployment tier on the CPU: FusionPipeline's profiled
mode, FusionNodeApp, and ``launch.run_deployment`` against the JAX
package's on one manifest (DeviceFeeder's own tests are in
tests/test_torch_feeder.py)."""

import os

import numpy as np
import pytest
import torch

import pointcloud_depthfusion_tpu.runtime as jax_runtime
import pointcloud_depthfusion_tpu_torch.runtime as torch_runtime
from pointcloud_depthfusion_tpu.nodes import image_node as JImg
from pointcloud_depthfusion_tpu.nodes import launch as JL
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource, SyntheticSource
from pointcloud_depthfusion_tpu_torch.io.synthetic import (
    SyntheticScene,
    right_to_left_transform,
    two_camera_rig,
)
from pointcloud_depthfusion_tpu_torch.nodes import image_node as TImg
from pointcloud_depthfusion_tpu_torch.nodes import launch as TL
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
from pointcloud_depthfusion_tpu_torch.utils.profiling import FUSION_STAGE_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_BUDGET = 1e-3  # the parity gate's cross-backend budget (tpu_check.py:55)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intr(w=48, h=32):
    fx = 631.0 * w / 848.0
    return Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")


class _Replay(FramesetSource):
    def __init__(self, frames, intr):
        self.frames, self._intr, self.i = list(frames), intr, 0

    @property
    def intrinsics(self):
        return self._intr

    def next_frame(self):
        if self.i == len(self.frames):
            return None
        self.i += 1
        return self.frames[self.i - 1]


def _streams(n, intr, noise=0.002):
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    scene = SyntheticScene()
    return [[scene.render(intr, pose, depth_noise_std=noise, hole_fraction=0.01,
                          seed=2 * k + i, timestamp=k / 30.0) for k in range(n)]
            for i, pose in enumerate((wl, wr))], right_to_left_transform(wl, wr)


@pytest.mark.parametrize("mode", ["tiled", "exact", "indexed", "packed", "tiled+align"])
def test_process_profiled_equals_process(mode):
    intr = _intr()
    (left, right), t_rl = _streams(1, intr)
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset

    fs = [Frameset.create(f.depth, f.color, intr, device="cpu") for f in (left[0], right[0])]
    cfg = FusionConfig.create(render_mode=mode.split("+")[0], align_frames="align" in mode,
                              emit_zbuf=False, device="cpu")
    pipe = FusionPipeline(intr, cfg, device="cpu")
    pipe.set_right_transform(t_rl)
    res = pipe.process(*fs)
    prof, laps, host = pipe.process_profiled(*fs)
    assert torch.equal(prof.image, res.image)
    np.testing.assert_array_equal(host, res.image.numpy())
    assert set(laps) == {"prep", "project", "filter_image", "copy_from_gpu"}
    assert set(laps) <= set(FUSION_STAGE_FIELDS) and all(v >= 0 for v in laps.values())


def test_process_profiled_refuses_pallas():
    pipe = FusionPipeline(_intr(), FusionConfig.create(render_mode="pallas", device="cpu"),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="packed"):
        pipe.process_profiled(None, None)


def _node(tmp_path, async_readback, n=4, **kw):
    intr = _intr()
    (left, right), t_rl = _streams(n, intr)
    cams = [CameraNode(name, _Replay(frames, intr))
            for name, frames in (("camera_left", left), ("camera_right", right))]
    app = FusionNodeApp(*cams, async_readback=async_readback, device="cpu", **kw)
    app.on_transform(t_rl)
    out = []
    app.subscribe_fused(lambda img, ts: out.append((ts, img.copy())))
    return app, out


def test_fusion_node_async_readback_and_profiling_publish_the_same_frames(tmp_path):
    """Every mode publishes frame k while process_pair(k) runs (the async
    readback through its pinned buffer too), the same frames in the same
    order; the profiling mode logs the stage CSV and the save_data mode
    dumps the same PNGs."""
    runs = {}
    for name, kw in (("sync", dict(async_readback=False, save_data_dir=str(tmp_path / "sync"))),
                     ("async", dict(async_readback=True, save_data_dir=str(tmp_path / "save"))),
                     ("profiled", dict(async_readback=True,
                                       profiling_path=str(tmp_path / "prof.csv")))):
        app, out = _node(tmp_path, **kw)
        msgs, published_in = [], []
        app.subscribe_sync_debug(msgs.append)
        app.subscribe_fused(lambda img, ts, app=app: published_in.append(app.frames_processed))
        assert app.run() == 4 and len(msgs) == 4
        assert published_in == [0, 1, 2, 3]  # before the call that made it returns
        runs[name] = out
    assert [t for t, _ in runs["sync"]] == [k / 30.0 for k in range(4)]
    for name in ("async", "profiled"):
        assert [t for t, _ in runs[name]] == [t for t, _ in runs["sync"]]
        for (_, a), (_, b) in zip(runs[name], runs["sync"]):
            np.testing.assert_array_equal(a, b)
    assert len(os.listdir(tmp_path / "save")) == 4 * 5
    assert sorted(os.listdir(tmp_path / "save")) == sorted(os.listdir(tmp_path / "sync"))
    for f in os.listdir(tmp_path / "sync"):
        assert (tmp_path / "save" / f).read_bytes() == (tmp_path / "sync" / f).read_bytes()
    rows = (tmp_path / "prof.csv").read_text().splitlines()
    assert rows[0].split(",") == FUSION_STAGE_FIELDS and len(rows) == 5


def _manifest(tmp_path):
    """configs/deployment_dual.yaml at 80×48: 6 frames, registration every
    3, the viewer in tmp_path. Both cameras render without noise or holes
    (their sensor options, set through camera override configs) so every
    frame of a camera is the same: the registration node ticks on the
    latest pair the feeder thread has captured, which differs between runs
    of either package, and this makes it not matter. The fusion override
    turns the QoS lifespan off, so a slow first frame drops no pair."""
    cam = tmp_path / "cameras.yaml"
    cam.write_text("".join(f"{n}:\n  sensor:\n    depth: {{depth_noise_std: 0.0, "
                           f"hole_fraction: 0.0}}\n" for n in ("camera_left", "camera_right")))
    fusion = tmp_path / "fusion.yaml"
    fusion.write_text("fusion_node:\n  qos: {lifespan_s: 0}\n")
    m = dict(JL.load_manifest(os.path.join(REPO, "configs", "deployment_dual.yaml")))
    m["cameras"] = [dict(c, config=str(cam)) for c in m["cameras"]]
    m.update(width=80, height=48, frames=6, fusion={"config": str(fusion)},
             registration={"every_n_frames": 3})
    return m


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_dual_deployment_matches_jax(tmp_path, monkeypatch, native):
    """The slice end to end: two CameraNodes → DeviceFeeder →
    FusionNodeApp with RegistrationNodeApp ticks → ImageNode, against the
    JAX package's run_deployment on the same manifest, with both
    packages' synthetic cameras on the numpy renderer (the native runtime
    switched off on both sides) or on the native one. Fused frames within
    the parity budget (XLA's CPU jit contracts FMAs, ROADMAP queue C), the
    same count, stamps, shape and coverage; the last tick's fitness within
    1e-5."""
    if native:
        assert jax_runtime.is_available() and torch_runtime.is_available()
    else:
        monkeypatch.setattr(jax_runtime, "is_available", lambda: False)
        monkeypatch.setattr(torch_runtime, "is_available", lambda: False)
    kinds = []

    def build(*args, orig=TL._build_camera):
        cam = orig(*args)
        kinds.append(type(cam.source).__name__)
        return cam

    monkeypatch.setattr(TL, "_build_camera", build)
    seen = {}
    for key, mod in (("jax", JImg), ("torch", TImg)):
        frames = seen.setdefault(key, [])

        def record(self, image, ts, frames=frames, orig=mod.ImageNode.__call__):
            frames.append((ts, np.array(image)))
            orig(self, image, ts)

        monkeypatch.setattr(mod.ImageNode, "__call__", record)
    m = _manifest(tmp_path)
    summaries = {}
    for key, run in (("jax", lambda mm: JL.run_deployment(mm, cpu=True)),
                     ("torch", lambda mm: TL.run_deployment(mm, device="cpu"))):
        mm = dict(m, viewer={"out_dir": str(tmp_path / key), "every_n": 2})
        summaries[key] = run(mm)
    sj, st = summaries["jax"], summaries["torch"]
    assert st["tier"] == sj["tier"] == "dual"
    assert st["frames"] == sj["frames"] == 6 and len(seen["torch"]) == len(seen["jax"]) == 6
    assert st["fused_shape"] == sj["fused_shape"] == [80, 48, 3]
    assert abs(st["fused_coverage"] - sj["fused_coverage"]) <= 1e-3 and st["fused_coverage"] > 0.3
    assert st["saved_pngs"] == sj["saved_pngs"] == 3
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert abs(st["registration_fitness"] - sj["registration_fitness"]) <= 1e-5
    for (tj, ij), (tt, it) in zip(seen["jax"], seen["torch"]):
        assert tt == tj
        assert (ij != it).any(-1).mean() <= PIXEL_BUDGET
    assert kinds == ["NativeSyntheticSource" if native else "SyntheticSource"] * 2


def test_rig_deployment_and_unported_sources(tmp_path, monkeypatch):
    """Three cameras compose the rig tier on RigFusionNodeApp; with a
    recording among them the rig starts from the identity calibration;
    a tcp:// camera (a camera host serving that recording) and a served
    camera run in the rig too, and served_ports names the bound port."""
    m = {"width": 64, "height": 48,
         "cameras": [{"name": f"cam{i}", "source": "synthetic", "seed": 10 + i, "pose": i}
                     for i in range(3)],
         "registration": {"every_n_frames": 0},
         "viewer": {"out_dir": str(tmp_path / "rig"), "every_n": 2}}
    s = TL.run_deployment(m, device="cpu", frames=3)
    assert (s["tier"], s["cameras"], s["frames"], s["fused_shape"]) == ("rig", 3, 3, [48, 64, 3])
    assert s["fused_coverage"] > 0.3 and s["saved_pngs"] == 2
    from pointcloud_depthfusion_tpu_torch.nodes import camera_node, rig_node

    rec = str(tmp_path / "rec.npz")
    monkeypatch.setattr("sys.argv", ["camera_node", "--width", "64", "--height", "48",
                                     "--frames", "2", "--out", rec])
    camera_node.main()
    initial = []

    def init(self, cams, intrs, c2v, orig=rig_node.RigFusionNodeApp.__init__, **kw):
        initial.append(c2v)
        orig(self, cams, intrs, c2v, **kw)

    monkeypatch.setattr(rig_node.RigFusionNodeApp, "__init__", init)
    replayed = dict(m, cameras=[dict(m["cameras"][0], source=rec)] + m["cameras"][1:])
    s = TL.run_deployment(replayed, device="cpu", frames=2)
    assert (s["tier"], s["frames"], s["fused_shape"]) == ("rig", 2, [48, 64, 3])
    np.testing.assert_array_equal(initial[-1], np.eye(4, dtype=np.float32)[None].repeat(3, 0))
    from pointcloud_depthfusion_tpu_torch.io.network import FramesetStreamServer
    from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource

    with FramesetStreamServer(RecordedSource(rec, loop=True), fps=0.0, queue_size=8,
                              max_frames=2) as server:
        remote = dict(m, cameras=[dict(m["cameras"][0], source=f"tcp://127.0.0.1:{server.port}"),
                                  dict(m["cameras"][1], serve="127.0.0.1:0"), m["cameras"][2]])
        s = TL.run_deployment(remote, device="cpu", frames=2)
    assert (s["tier"], s["frames"], s["fused_shape"]) == ("rig", 2, [48, 64, 3])
    assert len(s["served_ports"]) == 1 and s["served_ports"][0] > 0
    np.testing.assert_array_equal(initial[-1], np.eye(4, dtype=np.float32)[None].repeat(3, 0))
    with pytest.raises(ValueError, match="at least 2"):
        TL.run_deployment({"cameras": m["cameras"][:1]}, device="cpu")
    bad_yaml = tmp_path / "bad.yaml"
    bad_yaml.write_text("deployment: {}\n")
    with pytest.raises(ValueError, match="cameras"):
        TL.load_manifest(str(bad_yaml))


def test_registration_node_spins_on_its_thread(tmp_path):
    """Ticks on the latest synchronized pair the cameras published, on the
    node's own thread; stop() writes the profiling CSV."""
    from pointcloud_depthfusion_tpu_torch.nodes.registration_node import RegistrationNodeApp

    intr = _intr()
    (left, right), _ = _streams(2, intr)
    cams = [CameraNode(n, _Replay(f, intr)) for n, f in (("l", left), ("r", right))]
    reg = RegistrationNodeApp(*cams, spin_rate_hz=1000.0, profiling_path=str(tmp_path / "r.csv"),
                              device="cpu")
    got = []
    reg.subscribe_transform(got.append)
    assert reg.tick() is None  # no pair yet
    for _ in range(2):
        for c in cams:
            c.capture()
    reg.start(max_ticks=2)
    reg._thread.join(timeout=120)
    assert not reg._thread.is_alive()
    reg.stop()
    assert len(got) == 2 and all(t.shape == (4, 4) for t in got)
    assert len((tmp_path / "r.csv").read_text().splitlines()) == 3


def test_synthetic_source_options_reflect_into_camera_node():
    src = SyntheticSource(SyntheticScene(), _intr(), np.eye(4), seed=1)
    cam = CameraNode("cam", src)
    assert cam.sensor_options()["depth"]["hole_fraction"] == 0.01
    assert cam._set_option("color", "jitter", "0.002") and src.jitter == 0.002
