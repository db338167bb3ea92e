"""Boundaries of the PyTorch port: it never imports jax, CPU tensors never
reach the CUDA build, and a missing or failing nvcc raises."""

import os
import pathlib
import subprocess
import sys

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
    mods = _port_modules()
    assert "pointcloud_depthfusion_tpu_torch.fusion.pipeline" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pointcloud_depthfusion_tpu.') or m == 'pointcloud_depthfusion_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n"
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
    from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda, zresolve_cuda

    monkeypatch.setattr(_build, "load", _refuse_build)
    before = (dict(zresolve_cuda.launches), dict(filters_cuda.launches))
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
    assert (zresolve_cuda.launches, filters_cuda.launches) == before


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

    assert [p.name for p in _build.sources()] == ["filters3x3.cu", "segsum.cu", "zresolve.cu"]
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
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import RegistrationPipeline
    from pointcloud_depthfusion_tpu_torch.utils import convert

    host = Intrinsics.create(8, 6, 5.0, 5.0, 4.0, 3.0, device="cpu")
    depth, color = np.zeros((6, 8), np.uint16), np.zeros((6, 8, 3), np.uint8)
    calls = {
        "Intrinsics.create": lambda: Intrinsics.create(8, 6, 5.0, 5.0, 4.0, 3.0).fx,
        "Extrinsics.identity": lambda: Extrinsics.identity().rotation,
        "Frameset.create": lambda: Frameset.create(depth, color, host).depth,
        "FusionConfig.create": lambda: FusionConfig.create().min_depth,
        "FusionPipeline": lambda: FusionPipeline(host, FusionConfig.create(device="cpu")).right_transform,
        "RegistrationPipeline": lambda: RegistrationPipeline(host, host).intr_left.fx,
        "convert.pose_from_array": lambda: convert.pose_from_array(np.eye(4)),
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
