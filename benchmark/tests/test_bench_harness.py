"""The harness at a small size on the CPU: sound runs come out correct,
every planted fault and the control come out not correct, nothing loads
JAX or the JAX package, the reference loads nothing of the program, and a
new metric, a new cell, a rig of four cameras and a driver with its own
output check run without an edit to any existing file."""

import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.scene import render
from benchmark.tests._common import checkout, fault, run_small, shrink

CELLS = ["dual720-paced15", "dual720-max"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["image_mismatch_share"]["value"] == 0.0
    assert out["attempted"] > 0 and out["record"].samples
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("kind", ["altered", "stale", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, cell, kind):
    with fault(monkeypatch, kind):
        out = run_small(cell)
    assert not out["correct"], (kind, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_control_is_not_correct(cell):
    manifest = harness.load_manifest()
    config = harness.load_config(manifest, next(
        w["config"] for w in manifest["workloads"] if w["name"] == cell))
    readings = control.control(cell, 5, torch.device("cpu"), config_hook=shrink)
    assert set(readings) == {"image_mismatch_share"}
    assert readings["image_mismatch_share"] > config["check"]["image_mismatch_share"]


def test_no_jax_loaded_and_reference_independent(tmp_path):
    """A cell's set-up and run in a fresh process load neither jax nor the
    JAX package (top-level names compared whole; the port's own name starts
    with the JAX package's), and the reference alone loads nothing of the
    program."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(harness.REPO_DIR)!r})
        import benchmark.reference.fusion, benchmark.scene.render
        ref_tops = sorted({{m.split('.')[0] for m in sys.modules}})
        from benchmark.tests._common import run_small
        out = run_small("dual720-paced15", seconds=0.5)
        from benchmark import harness
        print(json.dumps({{"ref": ref_tops, "bad": harness.loaded_forbidden(),
                          "tops": sorted({{m.split('.')[0] for m in sys.modules}}),
                          "correct": out["correct"]}}))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["bad"] == []
    assert "pointcloud_depthfusion_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "pointcloud_depthfusion_tpu"} & set(got["tops"])
    assert "pointcloud_depthfusion_tpu_torch" not in got["ref"]


def test_new_metric_and_cell_run_without_editing_a_file(tmp_path):
    repo = checkout(tmp_path)
    before = {p: p.read_bytes() for p in repo.rglob("*") if p.is_file()}
    (repo / "benchmark" / "metrics" / "published_share.fps.py").write_text(textwrap.dedent('''
        UNIT = "%"
        MOVES = "fps"
        TRACE = True


        def read(rec):
            frames = rec.window_frames()
            return 100.0 * sum(1 for k in frames if k in rec.published) / len(frames)
    '''))
    (repo / "benchmark" / "traffic" / "max_short_warmup.json").write_text(json.dumps(
        {"loop": "closed", "warmup_frames": 5, "pool_frames": 8}))
    manifest = json.loads((repo / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "dual720-max-short", "config": "dual_d455_720p",
                                  "traffic": "max_short_warmup", "chips": 1, "why": "a test"})
    manifest["end_to_end"][0]["workloads"].append("dual720-max-short")
    manifest["per_layer"].append({"name": "published_share.fps", "unit": "%",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "nodes/fusion_node", "moves": "fps",
                                  "workloads": ["dual720-max-short"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = run_small("dual720-max-short", trace=True, repo=repo)
    assert out["correct"]
    assert 0.0 < out["metrics"]["published_share.fps"]["value"] <= 100.0
    changed = [p for p, b in before.items() if p.read_bytes() != b and p.name != "BENCHMARK.json"]
    assert changed == []


def _files(repo: pathlib.Path) -> dict:
    return {p: p.read_bytes() for p in repo.rglob("*") if p.is_file()}


def _changed(before: dict) -> list:
    return [p for p, b in before.items() if p.read_bytes() != b and p.name != "BENCHMARK.json"]


def _add_config(repo: pathlib.Path, name: str, driver: str, cell: str, traffic: str,
                **changes) -> None:
    """Add configuration ``name`` (the dual one with ``changes`` and
    ``driver``) and a cell of it under ``traffic`` to the checkout's
    manifest, as new files and entries."""
    config = json.loads((repo / "benchmark" / "configs" / "dual_d455_720p.json").read_text())
    config.update(name=name, driver=driver, **changes)
    (repo / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(config))
    manifest = json.loads((repo / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": name, "source": "a test",
                                "file": f"benchmark/configs/{name}.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                                  "chips": 1, "why": "a test"})
    (repo / "BENCHMARK.json").write_text(json.dumps(manifest))


#: A driver of any number of cameras: one frame from each camera a set,
#: published as the per-pixel brightest colour of the set.
BRIGHTEST = """
import types

import numpy as np
import torch


class Frame:
    def __init__(self, depth, color, timestamp, depth_scale):
        self.depth, self.color, self.timestamp = depth, color, timestamp


def host_frameset():
    return Frame


def build(config, pool, rec, device, make_source):
    sources = [make_source(None, c) for c in range(len(pool["poses"]))]

    def run():
        while True:
            frames = [s.next_frame() for s in sources]
            if any(f is None for f in frames):
                return
            rec.on_image(np.stack([f.color for f in frames]).max(0), frames[0].timestamp)

    return types.SimpleNamespace(sources=sources, kernels=[], run=run,
                                 close=lambda: None, drops=lambda: {})


def reference_images(config, pool, rec, frames, device, dtype=torch.float32):
    p = pool["color"].shape[1]
    return {k: pool["color"][:, k % p].amax(0) for k in frames}
"""

#: A driver whose node publishes a 4x4 transform a pair (the true
#: right->left one, its x shifted by the pair's mean depths), with its own
#: comparison; ERROR is added to every transform it publishes.
TRANSFORM = """
import types

import numpy as np
import torch

from benchmark.scene.render import right_to_left

ERROR = 0.0


class Frame:
    def __init__(self, depth, color, timestamp, depth_scale):
        self.depth, self.timestamp, self.depth_scale = depth, timestamp, depth_scale


def host_frameset():
    return Frame


def build(config, pool, rec, device, make_source):
    sources = [make_source(None, c) for c in range(2)]
    base = right_to_left(pool["poses"]).astype(np.float64)

    def run():
        while True:
            left, right = (s.next_frame() for s in sources)
            if left is None or right is None:
                return
            t = base.copy()
            t[0, 3] += 0.01 * config["depth_scale"] * (left.depth.mean() - right.depth.mean())
            rec.on_image(t + ERROR, left.timestamp)

    return types.SimpleNamespace(sources=sources, kernels=[], run=run,
                                 close=lambda: None, drops=lambda: {})


def reference_images(config, pool, rec, frames, device, dtype=torch.float32):
    p = pool["depth"].shape[1]
    base = torch.as_tensor(right_to_left(pool["poses"]), device=device).to(dtype)
    out = {}
    for k in frames:
        left, right = (pool["depth"][c, k % p].to(dtype).mean() for c in range(2))
        t = base.clone()
        t[0, 3] += 0.01 * config["depth_scale"] * (left - right)
        out[k] = t
    return out


def compare(got, ref, config, pool):
    err = 0.0
    for k, t in got.items():
        diff = torch.as_tensor(t).double().cpu() - ref[k].double().cpu()
        err = max(err, float(diff.abs().max()))
    return {"transform_abs_err": err}
"""


def test_rig_of_four_cameras_runs_from_new_files(tmp_path):
    """An ``arc`` rig of four cameras, its driver and its cell come in as
    new files and manifest entries, and run correct."""
    repo = checkout(tmp_path)
    before = _files(repo)
    (repo / "benchmark" / "drivers" / "brightest.py").write_text(BRIGHTEST)
    _add_config(repo, "rig4_test", "brightest", "rig4-test-max", "max",
                rig={"kind": "arc", "cameras": 4, "span_m": 0.8, "toe_in_deg_per_m": 37.5})
    out = run_small("rig4-test-max", repo=repo)
    assert out["correct"], out["checks"]
    assert out["checks"]["image_mismatch_share"]["value"] == 0.0
    pool = np.stack([s.depth for s in out["record"].sources])
    assert pool.shape == (4, 60, 90, 160)
    assert _changed(before) == []


@pytest.fixture
def transform_checkout(tmp_path):
    """A checkout with a pair cell whose driver publishes transforms and
    compares them itself (limit 1e-6 on the widest entry's error)."""
    repo = checkout(tmp_path)
    before = _files(repo)
    (repo / "benchmark" / "drivers" / "transform.py").write_text(TRANSFORM)
    _add_config(repo, "dual_transform", "transform", "dual-transform-max", "max",
                check={"transform_abs_err": 1e-6})
    yield repo
    assert _changed(before) == []


def test_driver_compare_decides_correct(monkeypatch, transform_checkout):
    repo = transform_checkout
    out = run_small("dual-transform-max", repo=repo)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"transform_abs_err"}
    assert out["checks"]["transform_abs_err"]["limit"] == 1e-6
    assert out["checks"]["transform_abs_err"]["value"] <= 1e-6

    with pytest.raises(KeyError, match="transform_abs_err"):
        run_small("dual-transform-max", repo=repo, hook=lambda c: dict(c, check={}))
    # A limit that no number meets would be a gate silently not applied.
    with pytest.raises(KeyError, match="rotation_err_deg"):
        run_small("dual-transform-max", repo=repo,
                  hook=lambda c: dict(c, check=dict(c["check"], rotation_err_deg=0.01)))

    load = harness.driver_module

    def planted(name, bench=harness.BENCH_DIR):
        mod = load(name, bench)
        mod.ERROR = 1e-4
        return mod

    monkeypatch.setattr(harness, "driver_module", planted)
    out = run_small("dual-transform-max", repo=repo)
    assert not out["correct"]
    assert out["checks"]["transform_abs_err"]["value"] > 1e-6


@pytest.mark.parametrize("driver, name", [("transform", "transform_abs_err"),
                                          ("fusion_node", "image_mismatch_share")])
def test_empty_sample_is_not_correct(transform_checkout, driver, name):
    config = {"check": {name: 1e-3}}
    mod = harness.driver_module(driver, transform_checkout / "benchmark")
    checks, correct = harness.check_outputs(mod, {}, {}, config, {})
    assert not correct
    assert list(checks) == [name]


def test_control_runs_the_drivers_compare(transform_checkout):
    repo = transform_checkout
    readings = control.control("dual-transform-max", 5, torch.device("cpu"), config_hook=shrink,
                               repo=repo, bench=repo / "benchmark")
    assert set(readings) == {"transform_abs_err"}
    assert readings["transform_abs_err"] > 1e-6


def test_camera_poses_pair_and_arc():
    """``pair`` is the rig it always was, bit for bit; ``arc`` places the
    port's ``rig_arc_poses``."""
    from pointcloud_depthfusion_tpu_torch.io.synthetic import rig_arc_poses

    c, s = 0.984807753012208, 0.17364817766693033
    want = [[[c, 0.0, s, -0.3], [0.0, 1.0, 0.0, 0.0], [-s, 0.0, c, 0.0], [0.0, 0.0, 0.0, 1.0]],
            [[c, 0.0, -s, 0.3], [0.0, 1.0, 0.0, 0.0], [s, 0.0, c, 0.0], [0.0, 0.0, 0.0, 1.0]]]
    got = render.camera_poses({"kind": "pair", "baseline_m": 0.6, "toe_in_deg": 10.0})
    assert np.array_equal(np.stack(got), np.asarray(want))
    for n in (2, 4, 8):
        for span, toe in ((0.8, 37.5), (1.3, 12.0)):
            got = render.camera_poses({"kind": "arc", "cameras": n, "span_m": span,
                                       "toe_in_deg_per_m": toe})
            want = rig_arc_poses(n, span=span, toe_in_deg_per_m=toe)
            assert len(got) == n
            assert np.abs(np.stack(got) - np.stack(want)).max() <= 1e-12
    with pytest.raises(ValueError):
        render.camera_poses({"kind": "arc", "cameras": 1, "span_m": 0.8, "toe_in_deg_per_m": 0})


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """One short run of a cell through the command line, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                          "dual720-max", "--seed", "3000000017", "--seconds", "2", "--trace",
                          "0"], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
