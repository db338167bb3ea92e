"""``parallel.multihost`` of the port on the CPU: two gloo processes with
two CPU shards each fuse the 4-camera rig of tests/test_multihost.py, and
their image equals the single-process port's sharded step (which
tests/test_torch_sharded_rig.py holds to the JAX package).
"""

import os
import socket
import subprocess
import sys

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
from pointcloud_depthfusion_tpu_torch.parallel.multihost import rig_poses
from torch_sharded_common import H, N, W, run_torch, torch_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_rig_matches_single_process(tmp_path):
    """Two gloo processes of ``parallel.multihost`` with two CPU shards each
    fuse the 4-camera rig; the image equals the single-process port's
    sharded step over make_camera_mesh(4), which the tests above hold to
    JAX."""
    port, out = _free_port(), str(tmp_path / "fused.npy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pointcloud_depthfusion_tpu_torch.parallel.multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id", str(pid),
         "--local-devices", "2"] + (["--out", out] if pid == 0 else []),
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
        assert "coverage" in log and '"backend": "gloo"' in log
    host = TIntr.create(W, H, fx=50.0, fy=50.0, ppx=W / 2, ppy=H / 2, device="cpu")
    poses = rig_poses(0, N, N)
    fs = [SyntheticScene().render(host, m) for m in poses]
    want = run_torch(torch_step(4, "tiled", False), np.stack([f.depth for f in fs]),
                     np.stack([f.color for f in fs]), np.stack(poses))
    np.testing.assert_array_equal(np.load(out), want)


def test_process_group_paths_in_one_process():
    """The process-group branches (the rig's MIN all_reduce, the sharded
    solve's 29-scalar SUM, the batched solves' gather) over a one-process
    gloo group give what the same calls give with no group."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import oracles
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import CameraMesh
    from pointcloud_depthfusion_tpu_torch.registration import distributed as D
    from pointcloud_depthfusion_tpu_torch.registration import gicp as TGI

    host = TIntr.create(W, H, fx=50.0, fy=50.0, ppx=W / 2, ppy=H / 2, device="cpu")
    poses = rig_poses(0, N, N)
    fs = [SyntheticScene().render(host, m) for m in poses]
    args = (torch.from_numpy(np.stack([f.depth for f in fs]).astype(np.int32)),
            torch.from_numpy(np.stack([f.color for f in fs])), torch.full((N,), 0.001),
            torch.from_numpy(np.stack(poses)))
    cloud = torch.from_numpy(oracles.make_bunny_like_cloud(400).astype(np.float32))
    t = torch.eye(4)
    t[0, 3] = 0.02
    src, tgt = cloud @ t[:3, :3].T + t[:3, 3], cloud
    ones = torch.ones(len(cloud), dtype=torch.bool)
    cfg = TGI.GICPConfig.create(resolution=0.05, voxel_size=0.02, max_iterations=8,
                                table_size=1 << 12, device="cpu")
    cpu2 = (torch.device("cpu"),) * 2
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
        from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse_sharded

        rig_cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                                      filter_fused_color=False, device="cpu")
        for mode in ("tiled", "packed"):
            c = dataclasses.replace(rig_cfg, render_mode=mode)
            got, want = (rig_fuse_sharded(CameraMesh(cpu2, "cam", g), host, host, c)(*args)
                         for g in (dist.group.WORLD, None))
            assert torch.equal(got, want), mode
        got, want = (D.gicp_register_sharded(CameraMesh(cpu2, "pt", g), src, ones, tgt, ones,
                                             torch.eye(4), cfg)
                     for g in (dist.group.WORLD, None))
        assert torch.equal(got.transform, want.transform)
        assert int(got.num_correspondences) == int(want.num_correspondences) > 0
        pairs = [torch.stack([a, b]) for a, b in ((src, tgt), (ones, ones), (tgt, src),
                                                  (ones, ones))]
        got, want = (D.gicp_register_batched(CameraMesh(cpu2, "pair", g), *pairs,
                                             torch.eye(4).expand(2, 4, 4), cfg)
                     for g in (dist.group.WORLD, None))
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    finally:
        dist.destroy_process_group()
