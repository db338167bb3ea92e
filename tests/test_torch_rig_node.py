"""The port's rig node on the CPU: RigFusionNodeApp against the JAX
package's on the same prerendered frames (inline sweeps, from a cold and a
loaded start), and held to the bars of the JAX package's own tests
(tests/test_nodes.py:561-760).
"""

import functools
import json
import tempfile

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset as JHostFrameset
from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp as JRigFusionNodeApp
from pointcloud_depthfusion_tpu.utils.profiling import FpsCounter as JFpsCounter
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource, RigFeeder
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses
from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp
from pointcloud_depthfusion_tpu_torch.parallel.mesh import make_camera_mesh, rig_fuse
from pointcloud_depthfusion_tpu_torch.utils.profiling import FpsCounter
from torch_rig_common import arc_sources, small_intrinsics

# The registration tick's bar, port against JAX on the CPU
# (tests/test_torch_registration.py).
TRANSFORM_ATOL = 5e-3
PIXEL_BUDGET = 1e-3
# The scenario of tests/test_nodes.py:561-644: 3 converging cameras at
# 106×60, inline sweeps on every frame, from perturbed guesses (the node
# test's, which the cold sweeps replace by annealing from identity) or from
# a small perturbation loaded as a trusted calibration (warm sweeps).
NODE_CAMERAS, NODE_W, NODE_H, NODE_F = 3, 106, 60, 80.0
# start: (yaw degrees, x metres) per camera index off the truth, frames
STARTS = {"cold": (2.0, 0.03, 5), "loaded": (0.5, 0.01, 3)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _converging_poses():
    """Camera left of center toes right and vice versa (tests/test_nodes.py:584-597)."""
    poses = []
    for i in range(NODE_CAMERAS):
        x = 0.4 * (i / (NODE_CAMERAS - 1) - 0.5) * 2
        yaw = np.deg2rad(-15.0 * x / 0.4)
        m = np.eye(4)
        m[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        m[:3, 3] = [x, 0, 0]
        poses.append(m)
    return poses


def _perturbed(poses, deg, m):
    """Each pose moved by deg·i of yaw and m·i along x, i its camera index."""
    out = []
    for i, pose in enumerate(poses):
        a = np.deg2rad(deg * i)
        r = np.eye(4)
        r[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        r[0, 3] = m * i
        out.append(pose @ r)
    return np.stack(out).astype(np.float32)


class ReplaySource(FramesetSource):
    """A finite camera stream of prerendered host framesets."""

    def __init__(self, frames, intr):
        self._frames = list(frames)
        self._intr = intr

    @property
    def intrinsics(self):
        return self._intr

    def next_frame(self):
        return self._frames.pop(0) if self._frames else None


@functools.lru_cache(maxsize=None)
def _node_run(package, start):
    """One RigFusionNodeApp.run of ``package`` ("jax" or "torch") over the
    same prerendered frames: (app, [(image, cam_to_virtual it fused with)],
    [cam_to_virtual after each sweep], initial guess)."""
    deg, m, n_frames = STARTS[start]
    poses = _converging_poses()
    intr = small_intrinsics(NODE_W, NODE_H, NODE_F)
    scene = SyntheticScene()
    streams = [[scene.render(intr, poses[i], depth_noise_std=0.002, hole_fraction=0.01,
                             seed=10 * k + i, timestamp=k / 30.0) for k in range(n_frames)]
               for i in range(NODE_CAMERAS)]
    init = _perturbed(poses, deg, m)
    if package == "jax":
        intr = JIntr.create(NODE_W, NODE_H, fx=NODE_F, fy=NODE_F, ppx=NODE_W / 2, ppy=NODE_H / 2)
        streams = [[JHostFrameset(depth=f.depth, color=f.color, depth_scale=f.depth_scale,
                                  timestamp=f.timestamp) for f in s] for s in streams]
        app = JRigFusionNodeApp([ReplaySource(s, intr) for s in streams], intr, init,
                                registration_every=1, registration_async=False)
    else:
        app = RigFusionNodeApp([ReplaySource(s, intr) for s in streams], intr, init,
                               registration_every=1, registration_async=False, device="cpu")
    if start == "loaded":
        with tempfile.TemporaryDirectory() as tmp:
            app.save_calibration(f"{tmp}/rig_calibration.txt")
            assert app.load_calibration(f"{tmp}/rig_calibration.txt")
    imgs, chains = [], []
    app.subscribe_fused(lambda img, ts: imgs.append((img, app.cam_to_virtual)))
    app.subscribe_transforms(chains.append)
    assert app.run() == n_frames
    return app, imgs, chains, init


def test_rig_mesh_raises():
    """A camera mesh whose shards do not divide the cameras raises in the
    feeder and in the node (the sharded paths themselves:
    tests/test_torch_sharded_merge.py)."""
    intr = small_intrinsics()
    mesh = make_camera_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        RigFeeder(arc_sources(3, intr), mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        RigFusionNodeApp(arc_sources(3, intr), intr, np.eye(4)[None].repeat(3, 0), mesh=mesh)


def test_rig_node_streams_and_recalibrates():
    """3 converging cameras fuse end to end while the per-pair sweep
    calibrates the rig from perturbed guesses (the scenario of
    tests/test_nodes.py:561-644, shipped default settings, inline sweeps):
    each pair within 1.5° and 0.03 m of the truth, camera 0 untouched."""
    app, imgs, chains, init = _node_run("torch", "cold")
    poses = _converging_poses()
    assert len(imgs) == 5 and app.registration_ticks == 5 and len(chains) == 5
    assert imgs[0][0].shape == (NODE_H, NODE_W, 3) and imgs[0][0].dtype == np.uint8
    assert (imgs[-1][0].sum(-1) > 0).mean() > 0.5
    c = app.cam_to_virtual
    for i in range(NODE_CAMERAS - 1):
        d = np.linalg.inv(np.linalg.inv(poses[i]) @ poses[i + 1]) @ (np.linalg.inv(c[i]) @ c[i + 1])
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        assert ang < 1.5, (i, ang)
        assert np.linalg.norm(d[:3, 3]) < 0.03, (i, d[:3, 3])
    np.testing.assert_array_equal(c[0], init[0])
    # The last frame fused with the calibration of its own (inline) sweep.
    img, c2v = imgs[-1]
    np.testing.assert_array_equal(c2v, c)
    assert app.frames_processed == 5


@pytest.mark.parametrize("start", list(STARTS))
def test_rig_node_matches_jax(start):
    """The port's node and the JAX package's on the same frames: every
    sweep's cam_to_virtual within the registration tick's bar, the same
    gating, rebuild and reset flags in every pair pipeline, camera 0
    untouched, and each fused frame within the parity budget."""
    t_app, t_imgs, t_chains, init = _node_run("torch", start)
    j_app, j_imgs, j_chains, _ = _node_run("jax", start)
    assert t_app.registration_ticks == j_app.registration_ticks == STARTS[start][2]
    for k, (got, want) in enumerate(zip(t_chains, j_chains, strict=True)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_ATOL, err_msg=f"sweep {k}")
        np.testing.assert_array_equal(got[0], init[0])
    for tp, jp in zip(t_app._pair_pipes, j_app._pair_pipes, strict=True):
        flags = [[(t.discarded, t.guess_reset, t.target_grid_rebuilt) for t in p.telemetry]
                 for p in (tp, jp)]
        assert flags[0] == flags[1]
        assert tp.initial_phase == jp.initial_phase
    for (got, _), (want, _) in zip(t_imgs, j_imgs, strict=True):
        assert (got != want).any(-1).mean() <= PIXEL_BUDGET


def test_rig_node_fuses_what_rig_fuse_fuses():
    """process_batch uploads cam_to_virtual and runs rig_fuse on the batch;
    the node hands its QoS lifespan to the feeder."""
    n = 3
    intr = small_intrinsics(64, 48, 50.0)
    poses = np.stack(rig_arc_poses(n, toe_in_deg_per_m=37.5)).astype(np.float32)
    app = RigFusionNodeApp(arc_sources(n, intr), intr, poses, lifespan_s=30.0, device="cpu")
    assert app.feeder.lifespan_s == 30.0
    fn = rig_fuse(intr, app.fused_intrinsics, app.config, device="cpu")
    with app.feeder as feeder:
        batch = feeder.get(timeout=30.0)
        got = app.process_batch(batch)
    want = fn(batch.depth, batch.color, batch.depth_scale, torch.from_numpy(poses))
    np.testing.assert_array_equal(got, want.numpy())
    assert batch.color.dim() == 3  # the node uploads pre-packed color
    assert app.feeder.dropped_stale == 0


def test_rig_node_leaves_the_fps_line_to_the_counter(capsys):
    """process_batch writes nothing to stdout, as FusionNodeApp: it ticks
    its counter, which hands each report to its sink."""
    n = 3
    intr = small_intrinsics(64, 48, 50.0)
    poses = np.stack(rig_arc_poses(n, toe_in_deg_per_m=37.5)).astype(np.float32)
    app = RigFusionNodeApp(arc_sources(n, intr), intr, poses, device="cpu")
    app.fps_counter.report_every_s = 0.0
    lines = []
    app.fps_counter.sink = lines.append
    with app.feeder as feeder:
        for _ in range(2):
            app.process_batch(feeder.get(timeout=30.0))
    assert capsys.readouterr().out == ""
    assert len(lines) == 2 and app.frames_processed == 2
    assert json.loads(lines[-1]).keys() == {"rig_fusion/fps", "lastCurrMSec"}


def test_fps_counter_reports_like_jax():
    """The node's FPS message: the JAX package's keys, once per window."""
    got = FpsCounter("rig_fusion/fps", report_every_s=0.0).tick()
    want = JFpsCounter("rig_fusion/fps", report_every_s=0.0).tick()
    assert json.loads(got).keys() == json.loads(want).keys() == {"rig_fusion/fps", "lastCurrMSec"}
    slow = FpsCounter(report_every_s=60.0)
    assert slow.tick() is None and slow.frame_count == 1


def test_rig_node_calibration_persistence(tmp_path):
    """The calibration round trip (a corrupt or missing file leaves the
    state untouched), then the loaded calibration seeding the pair
    pipelines, built before the load (registration_every > 0) or lazily
    after it, with the anneal skipped."""
    n = 3
    intr = small_intrinsics(64, 48, 50.0)
    app = RigFusionNodeApp(arc_sources(n, intr), intr,
                           np.stack(rig_arc_poses(n, toe_in_deg_per_m=37.5)), device="cpu")
    path = str(tmp_path / "rig_calibration.txt")
    app.save_calibration(path)
    eye = np.eye(4)[None].repeat(n, 0)
    loaded = RigFusionNodeApp(arc_sources(n, intr), intr, eye, device="cpu")
    assert loaded._pair_pipes is None
    assert loaded.load_calibration(path)
    np.testing.assert_allclose(loaded.cam_to_virtual, app.cam_to_virtual, atol=1e-6)
    (tmp_path / "bad.txt").write_text("not a matrix")
    before = loaded.cam_to_virtual.copy()
    assert not loaded.load_calibration(str(tmp_path / "bad.txt"))
    assert not loaded.load_calibration(str(tmp_path / "missing.txt"))
    np.testing.assert_array_equal(loaded.cam_to_virtual, before)

    eager = RigFusionNodeApp(arc_sources(n, intr), intr, eye, registration_every=4, device="cpu")
    pipes = eager._pair_pipes
    assert pipes is not None and pipes[0].initial_phase
    assert pipes[0].device == torch.device("cpu")
    assert eager.load_calibration(path)
    c2v = eager.cam_to_virtual.astype(np.float64)
    for group in (pipes, loaded._ensure_pair_pipes()):
        for i, pipe in enumerate(group):
            rel = np.linalg.inv(c2v[i]) @ c2v[i + 1]
            np.testing.assert_allclose(pipe.initial_transform, rel.astype(np.float32), atol=1e-6)
            assert not pipe.initial_phase and pipe._warm_start
