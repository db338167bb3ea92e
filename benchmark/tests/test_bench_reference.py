"""The plain reference against the port's CPU path, at a small size.

These show that the two agree where they should, not that either is right
alone: the temporal filter, the fused poses, the dual image through
FusionPipeline, and the PyTorch scene against the numpy scene of
``io/synthetic.py``.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import fusion as ref
from benchmark.scene import render
from benchmark.tests._common import shrink

torch.set_num_threads(2)


def _config(name):
    return shrink(json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text()))


def _pool(config, seed, frames=4):
    return render.render_pool(config, frames, seed, "cpu")


def _port_intr(i):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics

    return Intrinsics.create(i["width"], i["height"], fx=i["fx"], fy=i["fy"], ppx=i["ppx"],
                             ppy=i["ppy"], device="cpu")


def test_scene_matches_numpy_scene():
    from pointcloud_depthfusion_tpu_torch.io.synthetic import Sphere, SyntheticScene

    config = _config("dual_d455_720p")
    sc = config["scene"]
    centers = np.asarray([s["center"] for s in sc["spheres"]], np.float64)
    scene = SyntheticScene(plane_z=sc["plane_z"], checker_period=sc["checker_period"],
                           max_depth=sc["max_depth"],
                           spheres=[Sphere(np.asarray(s["center"]), s["radius"],
                                           np.asarray(s["color"])) for s in sc["spheres"]])
    for pose in render.camera_poses(config["rig"]):
        want = scene.render(_port_intr(config["intrinsics"]), pose, depth_scale=0.001)
        dm, col = render.render_depth_color(config["intrinsics"], pose,
                                            torch.from_numpy(centers)[None], sc, "cpu")
        depth, color = render.quantize(dm, col, 0.001, 0.0, 0.0, torch.Generator())
        assert np.array_equal(depth[0].numpy(), want.depth.astype(np.int32))
        assert np.array_equal(color[0].numpy(), want.color)


def test_temporal_filter_matches_camera_node():
    from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode

    config = _config("dual_d455_720p")
    pool = _pool(config, 31)
    order = [0, 1, 3, 2, 0, 3, 3, 1]

    class Source:
        intrinsics = _port_intr(config["intrinsics"])
        k = 0

        def next_frame(self):
            d = pool["depth"][0, order[self.k]].numpy().astype(np.uint16)
            self.k += 1
            return HostFrameset(depth=d, color=pool["color"][0, 0].numpy(), timestamp=0.0)

    cam = CameraNode("c", Source(), temporal_alpha=0.4, temporal_delta=20.0)
    got = [cam.next_frame().depth.astype(np.int32) for _ in order]
    # Frame k shows pool frame k mod P: hand the replay the order's frames.
    replay = ref.TemporalReplay(pool["depth"][0][order], 0.4, 20.0, True)
    want = replay.filtered(list(range(len(order))), set(range(len(order))))
    for k in range(len(order)):
        assert np.array_equal(got[k], want[k].numpy())


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_dual_image_matches_fusion_pipeline(seed):
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline

    config = _config("dual_d455_720p")
    f = config["fusion_node"]
    pool = _pool(config, seed)
    t_rl = render.right_to_left(pool["poses"])
    full = config["intrinsics"]
    shaken = ref.handshake_intrinsics(full)
    fusion = FusionConfig.create(min_depth=f["min_depth"], max_depth=f["max_depth"],
                                 vertical_image=True, mirror_image=True, device="cpu")
    pipe = FusionPipeline(_port_intr(shaken), fusion, device="cpu")
    pipe.set_right_transform(t_rl)
    poses = ref.fused_poses(t_rl, True, "cpu")
    for a, b in zip(poses, pipe._poses):
        assert torch.equal(a, b)
    virt = ref.virtual_intrinsics(shaken, True)
    for k in range(pool["depth"].shape[1]):
        fs = [Frameset.create(pool["depth"][c, k], pool["color"][c, k], _port_intr(full),
                              device="cpu") for c in range(2)]
        got = pipe.process(*fs).image
        want = ref.fuse_image([pool["depth"][c, k] for c in range(2)],
                              [pool["color"][c, k] for c in range(2)], [0.001] * 2, [full] * 2,
                              poses, virt, f)
        assert torch.equal(got, want)


def test_pose_matches_port_when_quaternion_w_is_negative():
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, fused_poses

    rot = render.yaw_pose(0.1, 200.0).astype(np.float32)  # a turn past 180 deg
    want = fused_poses(FusionConfig.create(device="cpu"), torch.from_numpy(rot))
    got = ref.fused_poses(rot, True, "cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_configs_name_their_file_and_driver():
    manifest = harness.load_manifest()
    for entry in manifest["configs"]:
        config = json.loads((harness.REPO_DIR / entry["file"]).read_text())
        assert config["name"] == entry["name"]
        assert config["reduced"] == entry["reduced"]
        assert all(key in config for key in config["reduced"])
        assert (harness.BENCH_DIR / "drivers" / f"{config['driver']}.py").is_file()
