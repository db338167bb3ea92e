"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; without a device every test skips. This file
imports no jax, so on a machine without it run it as

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _entries(n, n_px, seed, device):
    rng = np.random.default_rng(seed)
    pix = rng.integers(-2, n_px + 3, n).astype(np.int32)
    pix[rng.random(n) < 0.1] = Z.INVALID_PIX
    z = rng.integers(-50, 50, n).astype(np.int32)
    rgb = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    return (torch.from_numpy(a).to(device) for a in (pix, z, rgb))


@pytest.mark.parametrize("n,n_px", [(0, 5), (1, 1), (1000, 257), (70_001, 3000)])
def test_resolve_kernel_matches_plain(cuda, n, n_px):
    pix, z, rgb = _entries(n, n_px, n + n_px, cuda)
    before = dict(Z.launches)
    for r in (rgb, None):
        got = Z.zresolve_sorted_entries(pix, z, r, n_px)
        want = Z.zresolve_sorted_entries_plain(pix, z, r, n_px)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(Z.zresolve_winner_rgb(pix, z, rgb, n_px),
                       Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px))
    torch.cuda.synchronize()
    assert Z.launches["zresolve_sorted_entries"] == before["zresolve_sorted_entries"] + 2
    assert Z.launches["zresolve_winner_rgb"] == before["zresolve_winner_rgb"] + 1


@pytest.mark.parametrize("h,w", [(0, 5), (1, 1), (2, 5), (3, 3), (3, 4), (7, 129), (131, 33)])
def test_filter_kernel_matches_plain(cuda, h, w):
    g = torch.Generator(device=cuda).manual_seed(h * w)
    p = torch.randint(0, 256, (h, w), generator=g, device=cuda, dtype=torch.uint8)
    assert torch.equal(B4.gauss3x3_plane(p), B4.gauss3x3_plane_plain(p))
    assert torch.equal(B4.median3x3_plane(p), B4.median3x3_plane_plain(p))
    torch.cuda.synchronize()


def test_kernels_reject_what_they_do_not_take(cuda):
    p = torch.zeros((8, 6), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        B4.gauss3x3_plane(p.t())
    i = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        Z.zresolve_winner_rgb(i, i, torch.zeros(16, dtype=torch.int32, device=cuda)[::2], 4)
    with pytest.raises(ValueError):
        Z.zresolve_winner_rgb(i, i, i.cpu(), 4)


def test_pipeline_on_card_matches_cpu(cuda):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
    from pointcloud_depthfusion_tpu_torch.io.synthetic import (
        SyntheticScene, right_to_left_transform, two_camera_rig,
    )

    w, h = 160, 120
    wl, wr = two_camera_rig()
    host = Intrinsics.create(w, h, fx=119.0, fy=119.0, ppx=80.0, ppy=60.0)
    frames = [SyntheticScene().render(host, pose, seed=i) for i, pose in enumerate((wl, wr))]
    out = {}
    for dev in ("cpu", cuda):
        intr = host.to(dev)
        pipe = FusionPipeline(intr, FusionConfig.create(), device=dev)
        pipe.set_right_transform(right_to_left_transform(wl, wr))
        fs = [Frameset.create(f.depth, f.color, intr, device=dev) for f in frames]
        out[str(dev)] = pipe.process(*fs)
    gpu, cpu = out["cuda"], out["cpu"]
    assert (gpu.image.cpu() != cpu.image).any(-1).float().mean() <= 1e-3
    assert (gpu.zbuf.cpu() < 1e38).float().mean() > 0.5
