"""The port's two-host deployment tier against the JAX package's on the
CPU: ``run_deployment`` with a ``tcp://`` camera and with ``serve:`` and a
remote client, ``CameraNode.main --source tcp://``, the synthetic sources'
``motion=``, ``FusionNodeApp.attach_config`` and the demo.

Every server binds port 0. Both packages' synthetic cameras render with the
numpy renderer (the native runtimes patched off), except in the native
``motion=`` case."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import pointcloud_depthfusion_tpu.runtime as jax_runtime
import pointcloud_depthfusion_tpu_torch.runtime as torch_runtime
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.io import feeder as JFeed
from pointcloud_depthfusion_tpu.io import network as JN
from pointcloud_depthfusion_tpu.nodes import camera_node as JCamNode
from pointcloud_depthfusion_tpu.nodes import demo as JDemo
from pointcloud_depthfusion_tpu.nodes import image_node as JImg
from pointcloud_depthfusion_tpu.nodes import launch as JL
from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp as JFusionApp
from pointcloud_depthfusion_tpu.utils import factory as JFac
from pointcloud_depthfusion_tpu.utils.config import ConfigTree as JTree
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.io import feeder as TFeed
from pointcloud_depthfusion_tpu_torch.io import network as TN
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu_torch.nodes import camera_node as TCamNode
from pointcloud_depthfusion_tpu_torch.nodes import demo as TDemo
from pointcloud_depthfusion_tpu_torch.nodes import image_node as TImg
from pointcloud_depthfusion_tpu_torch.nodes import launch as TL
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode as TCam
from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp as TFusionApp
from pointcloud_depthfusion_tpu_torch.utils import factory as TFac
from pointcloud_depthfusion_tpu_torch.utils.config import ConfigTree as TTree

W, H = 64, 48
PIXEL_BUDGET = 1e-3  # the parity gate's cross-backend budget (tpu_check.py:55)
PKG = {"jax": (JN, JL, JImg, JFeed, JIntr), "port": (TN, TL, TImg, TFeed, TIntr)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_renderers(monkeypatch):
    monkeypatch.setattr(jax_runtime, "is_available", lambda: False)
    monkeypatch.setattr(torch_runtime, "is_available", lambda: False)


def _camera_source(pkg, pose="right", seed=20, w=W, h=H, **kw):
    """A manifest-like synthetic camera (launch's intrinsics) as a source
    of ``pkg``."""
    _, _, _, feed, intr_cls = PKG[pkg]
    fx = 631.0 * w / 848.0
    extra = {} if pkg == "jax" else {"device": "cpu"}
    intr = intr_cls.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, **extra)
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    return feed.SyntheticSource(SyntheticScene(), intr, wr if pose == "right" else wl,
                                depth_noise_std=0.002, seed=seed, **kw)


def _keep_all(tmp_path):
    """A fusion override with the QoS lifespan off: JAX's first-frame
    compile then drops no pair."""
    path = tmp_path / "fusion_keep_all.yaml"
    path.write_text("fusion_node:\n  qos: {lifespan_s: 0}\n")
    return str(path)


def _record_fused(monkeypatch):
    seen = {}
    for key, mod in (("jax", JImg), ("port", TImg)):
        frames = seen.setdefault(key, [])

        def record(self, image, ts, frames=frames, orig=mod.ImageNode.__call__):
            frames.append((ts, np.array(image)))
            orig(self, image, ts)

        monkeypatch.setattr(mod.ImageNode, "__call__", record)
    return seen


def _assert_fused_match(seen, n):
    assert len(seen["jax"]) == len(seen["port"]) == n
    for (tj, ij), (tt, it) in zip(seen["jax"], seen["port"]):
        assert tt == tj and it.shape == ij.shape
        assert (ij != it).any(-1).mean() <= PIXEL_BUDGET


def _run(pkg, manifest, frames):
    launch = PKG[pkg][1]
    return (launch.run_deployment(manifest, cpu=True, frames=frames) if pkg == "jax"
            else launch.run_deployment(manifest, device="cpu", frames=frames))


@pytest.mark.parametrize("codec", ["png", "raw"])
def test_tcp_camera_deployment_matches_jax(tmp_path, monkeypatch, numpy_renderers, codec):
    """A local synthetic camera and a ``tcp://`` camera served by a camera
    host of the same package, unpaced, with a queue deep enough that
    nothing drops: the port's run_deployment fuses the JAX one's frames,
    stamps, shape and coverage."""
    seen = _record_fused(monkeypatch)
    summaries = {}
    for pkg in ("jax", "port"):
        server = PKG[pkg][0].FramesetStreamServer(_camera_source(pkg), fps=0.0, queue_size=16,
                                                  max_frames=4, codec=codec,
                                                  name="camera_right").start()
        try:
            manifest = {"width": W, "height": H, "fusion": {"config": _keep_all(tmp_path)},
                        "cameras": [{"name": "camera_left", "source": "synthetic", "seed": 10,
                                     "pose": "left"},
                                    {"name": "camera_right",
                                     "source": f"tcp://127.0.0.1:{server.port}"}],
                        "registration": {"every_n_frames": 0},
                        "viewer": {"out_dir": str(tmp_path / pkg), "every_n": 2}}
            summaries[pkg] = _run(pkg, manifest, 4)
        finally:
            server.stop()
        assert server.frames_dropped == 0
    sj, st = summaries["jax"], summaries["port"]
    assert st["frames"] == sj["frames"] == 4 and st["served_ports"] == sj["served_ports"] == []
    assert st["fused_shape"] == sj["fused_shape"] == [W, H, 3]
    assert abs(st["fused_coverage"] - sj["fused_coverage"]) <= 1e-3 and st["fused_coverage"] > 0.3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    _assert_fused_match(seen, 4)


def _read_until_closed(client, got):
    """A remote client's reader. stop() at the end of the deployment closes
    the connection, in both packages, possibly before the end marker."""
    try:
        while (fs := client.next_frame()) is not None:
            got.append(fs)
    except ConnectionError:
        pass


def test_served_camera_feeds_local_fusion_and_remote_client(tmp_path, monkeypatch,
                                                           numpy_renderers):
    """``serve:`` on a camera: the local deployment fuses every pair while a
    remote client, connected before the first capture, receives the
    camera's filtered frames through the tee. The port's fused frames and
    the frames its client received equal the JAX package's; served_ports
    names the bound port."""
    seen = _record_fused(monkeypatch)
    clients, ports, received = {}, {}, {}
    for pkg in ("jax", "port"):
        mod = PKG[pkg][0]

        def start(self, pkg=pkg, orig=mod.FramesetStreamServer.start):
            orig(self)
            ports[pkg] = self.port
            client = clients[pkg] = mod.NetworkSource("127.0.0.1", self.port)
            got = received[pkg] = []
            threading.Thread(target=_read_until_closed, args=(client, got), daemon=True).start()
            return self

        monkeypatch.setattr(mod.FramesetStreamServer, "start", start)
    summaries = {}
    for pkg in ("jax", "port"):
        manifest = {"width": W, "height": H, "fusion": {"config": _keep_all(tmp_path)},
                    "cameras": [{"name": "camera_left", "source": "synthetic", "seed": 10,
                                 "pose": "left", "serve": "127.0.0.1:0"},
                                {"name": "camera_right", "source": "synthetic", "seed": 20,
                                 "pose": "right"}],
                    "registration": {"every_n_frames": 0},
                    "viewer": {"out_dir": str(tmp_path / pkg), "every_n": 3}}
        summaries[pkg] = _run(pkg, manifest, 6)
    for pkg, s in summaries.items():
        assert s["frames"] == 6 and s["served_ports"] == [ports[pkg]]
    _assert_fused_match(seen, 6)
    for pkg in ("jax", "port"):  # the server's end reaches the client
        for _ in range(500):
            if clients[pkg]._ended:
                break
            threading.Event().wait(0.01)
        assert clients[pkg]._ended and received[pkg], pkg
    jax_by_stamp = {f.timestamp: f for f in received["jax"]}
    assert set(jax_by_stamp) & {f.timestamp for f in received["port"]}
    for fs in received["port"]:
        if fs.timestamp in jax_by_stamp:
            np.testing.assert_array_equal(fs.depth, jax_by_stamp[fs.timestamp].depth)
            np.testing.assert_array_equal(fs.color, jax_by_stamp[fs.timestamp].color)


def test_camera_node_main_records_a_tcp_camera_like_jax(tmp_path, monkeypatch):
    """``--source tcp://`` records what the camera host sends, without the
    node's temporal filter, into the same ``.npz`` as the JAX CLI writes
    from the same stream; each CLI reads the other package's server."""
    outs = {}
    for server_pkg, cli in (("jax", "port"), ("port", "jax")):
        outs[cli] = str(tmp_path / f"{cli}.npz")
        with PKG[server_pkg][0].FramesetStreamServer(
                _camera_source(server_pkg, w=40, h=30), fps=0.0, queue_size=8, max_frames=3,
                name="camera_right") as server:
            argv = ["--name", "camera_right", "--source", f"tcp://127.0.0.1:{server.port}",
                    "--frames", "3", "--out", outs[cli]]
            if cli == "port":
                TCamNode.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["camera_node", *argv])
                JCamNode.main()
    want = _camera_source("port", w=40, h=30)
    with np.load(outs["port"]) as a, np.load(outs["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in range(3):
            np.testing.assert_array_equal(a["depth"][k], want.next_frame().depth)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_motion_frames_match_jax(native):
    """``motion=`` moves the camera every frame, in both synthetic sources,
    and the port's frames equal the JAX package's for the same seed."""
    if native:
        assert jax_runtime.is_available() and torch_runtime.is_available()
    frames = {}
    for pkg in ("jax", "port"):
        feed = PKG[pkg][3]
        src = _camera_source(pkg, pose="left", seed=10)
        cls = feed.NativeSyntheticSource if native else feed.SyntheticSource
        moving = cls(src.scene, src.intrinsics, src.pose, depth_noise_std=0.002, seed=10,
                     motion=TDemo.sway_motion(src.pose, 0.2, 0.0))
        frames[pkg] = [moving.next_frame() for _ in range(3)]
    still = cls(src.scene, src.intrinsics, src.pose, depth_noise_std=0.002, seed=10).next_frame()
    for j, t in zip(frames["jax"], frames["port"]):
        np.testing.assert_array_equal(t.depth, j.depth)
        np.testing.assert_array_equal(t.color, j.color)
        assert t.timestamp == j.timestamp
    assert not np.array_equal(frames["port"][0].depth, frames["port"][2].depth)
    np.testing.assert_array_equal(still.depth, frames["port"][0].depth)  # sway(0) = 0


def _fusion_app(pkg):
    feed, intr_cls = PKG[pkg][3], PKG[pkg][4]
    cam_cls = JCamNode.CameraNode if pkg == "jax" else TCam
    cams = [cam_cls(name, _camera_source(pkg, pose=pose, seed=seed))
            for name, pose, seed in (("camera_left", "left", 10), ("camera_right", "right", 20))]
    if pkg == "jax":
        from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig

        cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                                  filter_fused_color=False)
        return JFusionApp(*cams, config=cfg, async_readback=False), JTree()
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig

    cfg = FusionConfig.create(vertical_image=False, mirror_image=False, filter_fused_color=False,
                              device="cpu")
    return TFusionApp(*cams, config=cfg, async_readback=False, device="cpu"), TTree()


def test_fusion_node_attach_config_matches_jax(tmp_path):
    """tests/test_nodes.py::test_runtime_debug_namespace_fusion on the port:
    debug.save_data and profiling.enable_profiling toggled mid-run through
    the attached tree; after each step the two packages' nodes hold the
    same state, and the port's dumps and stage rows appear."""

    def state(app):
        return (app.save_data_dir, None if app.stage_log is None else app.stage_log.path,
                app.fps_counter.publish)

    apps = {pkg: _fusion_app(pkg) for pkg in ("jax", "port")}
    dump_dir, prof_path = str(tmp_path / "fusedump"), str(tmp_path / "prof.csv")
    os.makedirs(dump_dir)
    steps = [None, ("debug.save_data_dir", dump_dir), ("debug.save_data", True),
             ("profiling.log_path", prof_path), ("profiling.enable_profiling", True),
             ("profiling.publish_fps", "false")]
    for step in steps:
        for app, tree in apps.values():
            if step is None:
                app.attach_config(tree)
            else:
                tree.set(*step)
        assert state(apps["port"][0]) == state(apps["jax"][0]), step
    app, tree = apps["port"]
    assert (app.save_data_dir, app.stage_log.path, app.fps_counter.publish) == (
        dump_dir, prof_path, False)
    with app.feeder as feeder:
        app.process_pair(feeder.get(timeout=30.0))
    assert any(p.endswith("_fused.png") for p in os.listdir(dump_dir))
    assert app.stage_log.rows  # profiled laps recorded
    for step in (("profiling.enable_profiling", False), ("debug.save_data", False)):
        for a, t in apps.values():
            t.set(*step)
        assert state(apps["port"][0]) == state(apps["jax"][0]), step
    assert app.stage_log is None and app.save_data_dir is None
    assert open(prof_path).read().splitlines()[0].startswith("loop,")  # flushed on the way off


def test_demo_matches_jax(tmp_path, monkeypatch, capsys, numpy_renderers):
    """The demo at 64×48 for 4 frames on the CPU without registration: the
    same summary keys and frame count as the JAX demo, the same fused PNGs
    within PIXEL_BUDGET, and the left camera's views (saved for every
    frame its feeder captured, a number that depends on how far the
    feeder ran ahead) equal where both saved one. Both demos keep every
    pair (the YAML's 1 s lifespan would let the JAX compile drop some)."""
    for fac in (JFac, TFac):
        orig = fac.fusion_node_kwargs_from_tree
        monkeypatch.setattr(fac, "fusion_node_kwargs_from_tree",
                            lambda tree, orig=orig: dict(orig(tree), lifespan_s=None))
    args = ["--cpu", "--frames", "4", "--width", str(W), "--height", str(H),
            "--registration-every", "0", "--sway", "0.05"]
    summaries = {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / pkg)
        if pkg == "port":
            TDemo.main([*args, "--out", out, "--gif", str(tmp_path / "port.gif")])
        else:
            monkeypatch.setattr(sys, "argv", ["demo", *args, "--out", out])
            JDemo.main()
        summaries[pkg] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(summaries["port"]) == sorted(summaries["jax"])
    assert summaries["port"]["frames"] == summaries["jax"]["frames"] == 4
    names = {pkg: set(os.listdir(tmp_path / pkg)) for pkg in ("port", "jax")}
    assert summaries["port"]["saved_pngs"] == len(names["port"])
    fused = {n for n in names["port"] if n.startswith("fused_")}
    assert len(fused) == 4 and fused == {n for n in names["jax"] if n.startswith("fused_")}
    assert {n.split("_")[0] for n in names["port"]} == {"fused", "depth", "frameset", "small"}
    assert os.path.getsize(tmp_path / "port.gif") > 0
    from PIL import Image

    for name in sorted(names["port"] & names["jax"]):
        a, b = (np.asarray(Image.open(tmp_path / pkg / name)) for pkg in ("port", "jax"))
        assert a.shape == b.shape, name
        if "fused" in name:
            assert (a != b).reshape(*a.shape[:2], -1).any(-1).mean() <= PIXEL_BUDGET, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_demo_without_a_card_raises(monkeypatch, tmp_path):
    """Without --cpu the demo runs on the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDemo.main(["--frames", "1", "--out", str(tmp_path)])
