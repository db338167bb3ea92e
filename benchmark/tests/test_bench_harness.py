"""The harness at a small size on the CPU: sound runs come out correct,
every planted fault and the control come out not correct, nothing loads
JAX or the JAX package, the reference loads nothing of the program, and a
new metric and cell run without an edit to any existing file."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import control, harness
from benchmark.tests._common import checkout, fault, run_small, shrink

CELLS = ["dual720-paced30", "dual720-max"]


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
    share = control.control(cell, 5, torch.device("cpu"), config_hook=shrink)
    assert share > config["check"]["image_mismatch_share"]


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
        out = run_small("dual720-paced30", seconds=0.5)
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
