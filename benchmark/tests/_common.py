"""Shared helpers of the benchmark's CPU tests: small configurations, and
the faults planted under the timed path."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import pathlib
import shutil
import time

import torch

from benchmark import harness

SMALL = (160, 90)


def checkout(tmp_path: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark and its manifest; returns its root."""
    repo = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.REPO_DIR / "BENCHMARK.json", repo / "BENCHMARK.json")
    return repo


def shrink(config: dict, size=SMALL) -> dict:
    """The configuration at a small size, the field of view kept."""
    config = copy.deepcopy(config)
    w, h = size
    i = config["intrinsics"]
    s = w / i["width"]
    config["intrinsics"] = dict(width=w, height=h, fx=i["fx"] * s, fy=i["fy"] * s,
                                ppx=w / 2, ppy=h / 2)
    return config


def run_small(cell: str, seed: int = 987654321012, seconds: float = 1.0, trace: bool = False,
              repo=None, **kw) -> dict:
    """One run of ``cell`` at the small size on the CPU, from ``repo`` (a
    :func:`checkout`) or this one."""
    torch.set_num_threads(2)
    if repo is not None:
        kw.update(repo=repo, bench=repo / "benchmark")
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), config_hook=shrink, **kw)


# -- faults ---------------------------------------------------------------------


def _altered(image: torch.Tensor) -> torch.Tensor:
    """The image with a 12x12 block's bits flipped."""
    image = image.clone()
    image[20:32, 20:32] ^= 0x55
    return image


@contextlib.contextmanager
def fault(monkeypatch, kind: str):
    """Plant ``kind`` under the timed path of the fusion node: ``altered``
    (an answer altered where it is produced), ``stale`` (the step returns
    its first state for ever), ``half`` (half of the cameras left out)."""
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionPipeline  # noqa: PLC0415

    orig = FusionPipeline.process
    first = {}

    def process(self, left, right):
        if kind == "half":
            right = dataclasses.replace(right, depth=torch.zeros_like(right.depth))
        out = orig(self, left, right)
        if kind == "altered":
            return dataclasses.replace(out, image=_altered(out.image))
        if kind == "stale":
            return first.setdefault("res", out)
        return out

    monkeypatch.setattr(FusionPipeline, "process", process)
    yield
