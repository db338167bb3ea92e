"""Boundaries of the PyTorch port: it never imports jax, importing it
builds nothing, CPU tensors never reach the CUDA build, and a missing or
failing nvcc raises."""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pointcloud_depthfusion_tpu_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )


def test_port_imports_no_jax():
    """Importing every port module, and resolving every pdf-torch-* console
    script, loads no jax, builds nothing and initialises no CUDA."""
    import tomllib

    mods = _port_modules()
    for m in ("fusion.pipeline", "parallel.mesh", "io.feeder", "nodes.rig_node",
              "utils.profiling", "io.artifacts", "ops.cuda.morph_cuda", "ops.host_filters",
              "nodes.camera_node", "nodes.fusion_node", "nodes.registration_node",
              "nodes.image_node", "nodes.launch", "utils.factory", "runtime.bindings",
              "io.recorded", "io.encoded", "io.network", "io.realsense_host", "nodes.demo"):
        assert f"pointcloud_depthfusion_tpu_torch.{m}" in mods, m
    with open(REPO / "pyproject.toml", "rb") as fh:
        scripts = sorted(v for k, v in tomllib.load(fh)["project"]["scripts"].items()
                         if k.startswith("pdf-torch-"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"for t in {scripts!r}:\n"
        "    m, _, fn = t.partition(':'); assert callable(getattr(sys.modules[m], fn)), t\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pointcloud_depthfusion_tpu.') or m == 'pointcloud_depthfusion_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n"
        "from pointcloud_depthfusion_tpu_torch.runtime import bindings\n"
        "from pointcloud_depthfusion_tpu_torch.ops.cuda import _build\n"
        "assert bindings._lib is None and _build._lib is None, 'an import built a library'\n"
        "import torch; assert not torch.cuda.is_initialized()\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _refuse_build():
    raise AssertionError("a CPU tensor reached the CUDA kernel build")


def test_cpu_pipeline_never_builds_kernels(monkeypatch):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, fuse_prep_cuda, zresolve_cuda

    monkeypatch.setattr(_build, "load", _refuse_build)
    counters = (zresolve_cuda.launches, filters_cuda.launches, fuse_prep_cuda.launches)
    before = tuple(dict(c) for c in counters)
    rng = np.random.default_rng(0)
    intr = Intrinsics.create(32, 24, fx=30.0, fy=30.0, ppx=16.0, ppy=12.0, device="cpu")
    fs = [Frameset.create(rng.integers(400, 3000, (24, 32)).astype(np.uint16),
                          rng.integers(0, 256, (24, 32, 3)).astype(np.uint8), intr,
                          device="cpu")
          for _ in range(2)]
    for zbuf in (True, False):
        for median in (True, False):
            cfg = FusionConfig.create(emit_zbuf=zbuf, use_median_filter=median, device="cpu")
            res = FusionPipeline(intr, cfg, device="cpu").process(*fs)
            assert res.image.shape == (32, 24, 3)
    for mode in ("exact", "indexed", "packed", "pallas"):
        cfg = FusionConfig.create(render_mode=mode, align_frames=mode != "pallas", device="cpu")
        assert FusionPipeline(intr, cfg, device="cpu").process(*fs).image.shape == (32, 24, 3)
    assert counters == before


def test_cpu_rig_never_builds_kernels(monkeypatch):
    """Every rig path on CPU tensors (tiled with and without the z-buffer,
    multi-stream, packed, the color filters, batched) runs the plain
    versions and counts no launch."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, zresolve_cuda
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import batched_rig_fuse, rig_fuse

    monkeypatch.setattr(_build, "load", _refuse_build)
    counters = (zresolve_cuda.launches, filters_cuda.launches)
    before = tuple(dict(c) for c in counters)
    intr = Intrinsics.create(32, 24, fx=25.0, fy=25.0, ppx=16.0, ppy=12.0, device="cpu")
    poses = rig_arc_poses(4, toe_in_deg_per_m=37.5)
    fs = [SyntheticScene().render(intr, p) for p in poses]
    depth = torch.from_numpy(np.stack([f.depth for f in fs]).astype(np.int32))
    color = torch.from_numpy(np.stack([f.color for f in fs]))
    scale, c2v = torch.full((4,), 0.001), torch.from_numpy(np.stack(poses).astype(np.float32))
    for mode, zbuf, multi, median in (("tiled", False, False, False), ("tiled", True, False, True),
                                      ("tiled", True, True, False), ("packed", True, False, True)):
        cfg = FusionConfig.create(render_mode=mode, emit_zbuf=zbuf, use_median_filter=median,
                                  vertical_image=False, device="cpu")
        assert rig_fuse(intr, intr, cfg, multi_stream=multi, device="cpu")(
            depth, color, scale, c2v).shape == (24, 32, 3)
        assert batched_rig_fuse(intr, intr, cfg, 2, 2, device="cpu")(
            depth.reshape(2, 2, 24, 32), color.reshape(2, 2, 24, 32, 3), scale.reshape(2, 2),
            c2v.reshape(2, 2, 4, 4)).shape == (2, 24, 32, 3)
    assert counters == before


def test_cpu_deployment_never_builds_kernels(monkeypatch, tmp_path):
    """``run_deployment`` on the CPU (dual tier with registration ticks,
    the morphology and spatial filters, and the rig tier) runs every
    kernel's plain version and counts no launch."""
    from pointcloud_depthfusion_tpu_torch.nodes.launch import run_deployment
    from pointcloud_depthfusion_tpu_torch.ops import filters
    from pointcloud_depthfusion_tpu_torch.ops.cuda import (
        filters_cuda, morph_cuda, segsum_cuda, spatial_cuda, zresolve_cuda,
    )

    monkeypatch.setattr(_build, "load", _refuse_build)
    counters = (zresolve_cuda.launches, filters_cuda.launches, segsum_cuda.launches,
                morph_cuda.launches, spatial_cuda.launches)
    before = tuple(dict(c) for c in counters)
    cams = [{"name": n, "source": "synthetic", "seed": s, "pose": p}
            for n, s, p in (("camera_left", 10, "left"), ("camera_right", 20, "right"))]
    dual = run_deployment({"width": 48, "height": 32, "cameras": cams,
                           "registration": {"every_n_frames": 2},
                           "viewer": {"out_dir": str(tmp_path)}}, device="cpu", frames=3)
    assert dual["frames"] == 3 and dual["registration_fitness"] is not None
    rig = run_deployment({"width": 48, "height": 32, "registration": {"every_n_frames": 0},
                          "cameras": [{"name": f"c{i}", "seed": i} for i in range(3)]},
                         device="cpu", frames=2)
    assert rig["frames"] == 2
    depth = torch.from_numpy(np.random.default_rng(0).integers(0, 3000, (24, 32)).astype(np.int32))
    filters.filter_depth(depth, 0.001, 0.5, 3.0, use_morphology=True)
    filters.spatial_filter(depth, holes_fill=3)
    assert counters == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc_candidates", lambda: [str(tmp_path / "no-nvcc")])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target sm_90a' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc_candidates", lambda: [str(fake)])
    with pytest.raises(RuntimeError, match="no such target sm_90a"):
        _build.load()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_flags_and_sources():
    import pointcloud_depthfusion_tpu_torch.core.geometry  # noqa: F401  (turns TF32 off)

    assert [p.name for p in _build.sources()] == [
        "filters3x3.cu", "fuse_prep.cu", "morph.cu", "segsum.cu", "spatial.cu", "zresolve.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fPIC" in flags
    assert "-shared" in _build.LINK_FLAGS
    assert _build.BUILD_ROOT == REPO / "build" / "torch_kernels"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_entry_points_default_to_the_card():
    """``device=None`` means the card: without one every entry point raises
    and names ``device='cpu'``; with one its tensors land on ``cuda``."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
    from pointcloud_depthfusion_tpu_torch.io.feeder import DeviceFeeder, RigFeeder, SyntheticSource
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu_torch.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu_torch.nodes.launch import run_deployment
    from pointcloud_depthfusion_tpu_torch.nodes.registration_node import RegistrationNodeApp
    from pointcloud_depthfusion_tpu_torch.nodes.rig_node import RigFusionNodeApp
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import batched_rig_fuse, rig_fuse
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline
    from pointcloud_depthfusion_tpu_torch.utils import convert

    host = Intrinsics.create(8, 6, 5.0, 5.0, 4.0, 3.0, device="cpu")
    depth, color = np.zeros((6, 8), np.uint16), np.zeros((6, 8, 3), np.uint8)
    sources = [SyntheticSource(SyntheticScene(), host, np.eye(4), seed=i) for i in range(2)]
    cams = [CameraNode(f"cam{i}", s) for i, s in enumerate(sources)]
    cpu_cfg = FusionConfig.create(device="cpu")
    calls = {
        "Intrinsics.create": lambda: Intrinsics.create(8, 6, 5.0, 5.0, 4.0, 3.0).fx,
        "Extrinsics.identity": lambda: Extrinsics.identity().rotation,
        "Frameset.create": lambda: Frameset.create(depth, color, host).depth,
        "FusionConfig.create": lambda: FusionConfig.create().min_depth,
        "FusionPipeline": lambda: FusionPipeline(host, FusionConfig.create(device="cpu")).right_transform,
        "RegistrationPipeline": lambda: RegistrationPipeline(host, host).intr_left.fx,
        "convert.pose_from_array": lambda: convert.pose_from_array(np.eye(4)),
        "convert.cam_to_virtual_from_array":
            lambda: convert.cam_to_virtual_from_array(np.eye(4)[None]),
        "rig_fuse": lambda: rig_fuse(host, host, cpu_cfg),
        "batched_rig_fuse": lambda: batched_rig_fuse(host, host, cpu_cfg, 2, 2),
        "RigFeeder": lambda: RigFeeder(sources),
        "RigFusionNodeApp": lambda: RigFusionNodeApp(sources, host, np.eye(4)[None].repeat(2, 0)),
        "DeviceFeeder": lambda: DeviceFeeder(*sources),
        "FusionNodeApp": lambda: FusionNodeApp(*cams).pipeline.right_transform,
        "RegistrationNodeApp": lambda: RegistrationNodeApp(*cams).pipeline.intr_left.fx,
        "run_deployment": lambda: types.SimpleNamespace(device=torch.device(run_deployment(
            {"width": 8, "height": 6, "cameras": [{"name": "a"}, {"name": "b"}]},
            frames=1)["device"])),
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
