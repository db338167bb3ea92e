"""The rig cell at 160x90 on the CPU: four cameras on the arc through
``RigFusionNodeApp``. Sound runs come out correct, the plain reference
equals ``rig_fuse`` bit for bit, planted faults and the control come out
not correct, the reference loads nothing of the program, and the cell comes
in as new files and entries alone."""

import json
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.scene import render
from benchmark.tests._common import checkout, run_small, shrink

CELL = "rig4-720p-paced30"
CONFIG = "rig4_d455_720p"
#: What this cell added to the benchmark: files, and manifest entries by name.
NEW_FILES = ("configs/rig4_d455_720p.json", "drivers/rig_node.py", "reference/rig.py",
             "traffic/paced30.json", "metrics/rig_feeder.capture_ms.lat.py",
             "metrics/rig_feeder.upload_ms.lat.py", "metrics/rig_feeder.wait_ms.lat.py",
             "metrics/rig.step_host_ms.lat.py", "metrics/rig.readback_ms.lat.py",
             "metrics/rig_kernels_roofline.py")
SPANS = ("rig_feeder.capture_ms.lat", "rig_feeder.upload_ms.lat", "rig_feeder.wait_ms.lat",
         "rig.step_host_ms.lat", "rig.readback_ms.lat")

torch.set_num_threads(2)


def _config():
    return shrink(json.loads((harness.BENCH_DIR / "configs" / f"{CONFIG}.json").read_text()))


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 987654321012])
def test_sound_run_is_correct(seed):
    out = run_small(CELL, seed=seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["image_mismatch_share"]["value"] == 0.0
    assert out["attempted"] == 30 and len(out["record"].samples) > 0
    assert set(out["metrics"]) == {"latency_p95_ms", "setup_s"}
    assert np.stack([s.depth for s in out["record"].sources]).shape == (4, 60, 90, 160)


def test_traced_run_reports_the_rig_spans():
    """Every span metric, read from the window before the profiler starts;
    the roofline reads device kernels, which the CPU has none of."""
    out = run_small(CELL, seconds=4.0, trace=True)
    assert out["correct"], out["checks"]
    for name in SPANS:
        assert out["metrics"][name]["value"] >= 0.0, name
    assert out["metrics"]["rig.step_host_ms.lat"]["value"] > 0.0
    assert "rig_kernels_roofline" not in out["metrics"]


def _port_intr(i):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics

    return Intrinsics.create(i["width"], i["height"], fx=i["fx"], fy=i["fy"], ppx=i["ppx"],
                             ppy=i["ppy"], device="cpu")


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_reference_matches_rig_fuse(seed, packed):
    """The reference's image and the program's rig step on the same frames
    and calibration, bit for bit, with the colour packed on the way (as the
    node's feeder does) or not."""
    from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu_torch.ops.render import pack_rgb
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse

    driver = harness.driver_module("rig_node")
    config = _config()
    pool = render.render_pool(config, 3, seed, "cpu")
    intr = _port_intr(config["intrinsics"])
    fusion = driver.fusion_config(config, "cpu")
    fn = rig_fuse([intr] * 4, fused_virtual_intrinsics(intr, False), fusion, device="cpu")
    c2v = torch.from_numpy(np.stack(pool["poses"]).astype(np.float32))
    scale = torch.full((4,), config["depth_scale"], dtype=torch.float32)
    want = driver.reference_images(config, pool, None, [0, 1, 2, 3], "cpu")
    for k in range(4):
        color = pool["color"][:, k % 3]
        got = fn(pool["depth"][:, k % 3], pack_rgb(color) if packed else color, scale, c2v)
        assert torch.equal(got, want[k]), k
        assert (want[k].sum(-1) > 0).float().mean() > 0.5


def test_rig_node_defaults_are_the_configuration():
    """The configuration's node settings are RigFusionNodeApp's own
    defaults, as launch._run_rig builds it."""
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp

    config = _config()
    driver = harness.driver_module("rig_node")

    class Source:
        intrinsics = _port_intr(config["intrinsics"])

        def next_frame(self):
            return None

    app = RigFusionNodeApp([Source() for _ in range(4)], Source.intrinsics,
                           np.eye(4, dtype=np.float32)[None].repeat(4, 0), device="cpu")
    mine = driver.fusion_config(config, "cpu")
    for field in ("vertical_image", "mirror_image", "use_median_filter", "filter_fused_color",
                  "align_frames", "render_mode", "emit_zbuf"):
        assert getattr(app.config, field) == getattr(mine, field), field
    assert torch.equal(app.config.min_depth, mine.min_depth)
    assert torch.equal(app.config.max_depth, mine.max_depth)
    r = config["rig_node"]
    assert (app.feeder.pack_color, app.feeder.lifespan_s, app.registration_every) == (
        r["pack_color"], r["lifespan_s"] or None, r["registration_every"])
    driver._check_feeder(app.feeder, r)


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_reference_pose_is_the_arc_of_the_manifest(seed):
    """The configuration's arc is the rig manifest's: launch._camera_pose
    of each camera of configs/deployment_rig4.yaml."""
    from pointcloud_depthfusion_tpu_torch.nodes.launch import _camera_pose

    pool = render.render_pool(_config(), 1, seed, "cpu")
    for i, pose in enumerate(pool["poses"]):
        assert np.abs(pose - _camera_pose({"pose": i}, i, 4)).max() <= 1e-12


def _shift_camera_3(depth, color, scale, c2v):
    c2v = c2v.clone()
    c2v[3, 0, 3] += 0.01
    return depth, color, scale, c2v


def _swap_colours(depth, color, scale, c2v):
    return depth, color[[1, 0, 2, 3]], scale, c2v


@pytest.mark.parametrize("plant", [_shift_camera_3, _swap_colours])
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, plant):
    """A fault planted in every rig step the node runs: camera 3's
    cam_to_virtual 1 cm off along x, or camera 0's and camera 1's colours
    swapped."""
    from pointcloud_depthfusion_tpu_torch.nodes import rig_node

    make = rig_node.rig_fuse

    def rig_fuse(*a, **kw):
        fn = make(*a, **kw)

        def planted(*args):
            return fn(*plant(*args))

        planted.device = fn.device
        return planted

    monkeypatch.setattr(rig_node, "rig_fuse", rig_fuse)
    out = run_small(CELL)
    assert not out["correct"], out["checks"]


def test_lower_precision_control_is_not_correct():
    readings = control.control(CELL, 5, torch.device("cpu"), config_hook=shrink)
    assert set(readings) == {"image_mismatch_share"}
    assert readings["image_mismatch_share"] > _config()["check"]["image_mismatch_share"]


def test_reference_loads_nothing_of_the_program(tmp_path):
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(harness.REPO_DIR)!r})
        import benchmark.reference.rig
        print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not {"pointcloud_depthfusion_tpu_torch", "pointcloud_depthfusion_tpu", "jax"} & tops


def _files(repo):
    return {p: p.read_bytes() for p in repo.rglob("*") if p.is_file()}


def test_cell_comes_in_as_new_files_alone(tmp_path):
    """Over a checkout without this cell's files and entries, the cell's
    files and entries are added and run correct, and no file that was
    there changes."""
    repo = checkout(tmp_path)
    bench = repo / "benchmark"
    saved = tmp_path / "saved"
    for name in NEW_FILES:
        (saved / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.move(bench / name, saved / name)
    with_rig = json.loads((repo / "BENCHMARK.json").read_text())
    manifest = json.loads(json.dumps(with_rig))
    manifest["configs"] = [c for c in manifest["configs"] if c["name"] != CONFIG]
    manifest["workloads"] = [w for w in manifest["workloads"] if w["name"] != CELL]
    manifest["per_layer"] = [m for m in manifest["per_layer"]
                             if m.get("workloads") != [CELL]]
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    (repo / "BENCHMARK.json").write_text(json.dumps(manifest))
    with pytest.raises(StopIteration):
        run_small(CELL, repo=repo)
    before = _files(repo)

    for name in NEW_FILES:
        shutil.copy(saved / name, bench / name)
    (repo / "BENCHMARK.json").write_text(json.dumps(with_rig))
    out = run_small(CELL, repo=repo, trace=True, seconds=4.0)
    assert out["correct"], out["checks"]
    assert set(SPANS) <= set(out["metrics"])
    assert [p for p, b in before.items()
            if p.read_bytes() != b and p.name != "BENCHMARK.json"] == []
