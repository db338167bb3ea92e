"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; without a device every test skips. This file
imports no jax, so on a machine without it run it as

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6
from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5
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
        want = Z.zresolve_sorted_entries_plain(pix, z, r, n_px)
        for legacy in (False, True):
            got = Z.zresolve_sorted_entries(pix, z, r, n_px, legacy_feed=legacy)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(Z.zresolve_winner_rgb(pix, z, rgb, n_px),
                       Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px))
    torch.cuda.synchronize()
    assert Z.launches["zresolve_sorted_entries"] == before["zresolve_sorted_entries"] + 2
    assert Z.launches["zresolve_sorted_entries_legacy"] == before["zresolve_sorted_entries_legacy"] + 2
    assert Z.launches["zresolve_winner_rgb"] == before["zresolve_winner_rgb"] + 1


@pytest.mark.parametrize("h,w", [(0, 5), (1, 1), (2, 5), (3, 3), (3, 4), (7, 129), (131, 33)])
def test_filter_kernel_matches_plain(cuda, h, w):
    g = torch.Generator(device=cuda).manual_seed(h * w)
    p = torch.randint(0, 256, (h, w), generator=g, device=cuda, dtype=torch.uint8)
    assert torch.equal(B4.gauss3x3_plane(p), B4.gauss3x3_plane_plain(p))
    assert torch.equal(B4.median3x3_plane(p), B4.median3x3_plane_plain(p))
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,w", [(0, 5), (1, 1), (2, 5), (5, 1), (3, 3), (7, 13), (17, 129),
                                 (131, 33), (848, 480)])
def test_image_kernel_matches_plain(cuda, h, w):
    """B4's image kernel in every input form and mode, bit for bit against
    its plain version on the card and on the CPU; one launch a call,
    counted by mode."""
    g = torch.Generator(device=cuda).manual_seed(h * 1000 + w)
    mrgb = torch.randint(0, 1 << 24, (2, h * w), generator=g, device=cuda, dtype=torch.int32)
    mrgb[torch.rand((2, h * w), generator=g, device=cuda) < 0.2] = B4.INT32_MAX
    img = torch.randint(0, 256, (h, w, 3), generator=g, device=cuda, dtype=torch.uint8)
    planes = [img[..., c].contiguous() for c in range(3)]
    cases = [
        (lambda t, m: B4.winner_image(t, h, w, m), lambda t, m: B4.winner_image_plain(t, h, w, m),
         mrgb),
        (lambda t, m: B4.winner_image(t, h, w, m), lambda t, m: B4.winner_image_plain(t, h, w, m),
         torch.cat([mrgb[0, :1], mrgb[0]])[1:]),  # 4 B past a 16 B boundary
        (B4.planes_image, B4.planes_image_plain, planes),
        (B4.interleaved_image, B4.interleaved_image_plain, img),
        (B4.interleaved_image, B4.interleaved_image_plain, img[..., 1:].contiguous()),
        (B4.interleaved_image, B4.interleaved_image_plain,
         torch.cat([img, planes[0][..., None]], dim=-1)),
        (B4.interleaved_image, B4.interleaved_image_plain, planes[2]),
    ]
    before = dict(B4.launches)
    for kernel, plain, x in cases:
        host_x = [t.cpu() for t in x] if isinstance(x, list) else x.cpu()
        for mode in (None, "gauss", "median"):
            got = kernel(x, mode)
            assert torch.equal(got, plain(x, mode)), (mode, got.shape)
            assert torch.equal(got.cpu(), kernel(host_x, mode)), (mode, got.shape)
    torch.cuda.synchronize()
    for name in ("color_image", "gauss3x3_image", "median3x3_image"):
        assert B4.launches[name] - before[name] == (len(cases) if h * w else 0)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 6])
def test_color_filters_of_any_channel_count_run_b4(cuda, c):
    """median_filter and gauss_filter of a u8 (H, W, C) image run B4, one
    launch per four channels, equal to the CPU bit for bit."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as TF

    g = torch.Generator(device=cuda).manual_seed(c)
    img = torch.randint(0, 256, (37, 61, c), generator=g, device=cuda, dtype=torch.uint8)
    for fn, name in ((TF.gauss_filter, "gauss3x3_image"), (TF.median_filter, "median3x3_image")):
        before = B4.launches[name]
        got = fn(img)
        assert B4.launches[name] - before == (c + 3) // 4
        assert torch.equal(got.cpu(), fn(img.cpu()))


@pytest.mark.parametrize("h,w", [(0, 5), (1, 1), (1, 9), (2, 2), (5, 3), (7, 129), (131, 33),
                                 (480, 848)])
def test_morph_kernel_matches_plain(cuda, h, w):
    g = torch.Generator(device=cuda).manual_seed(h * 1000 + w)
    masks = [torch.randint(0, 2, (h, w), generator=g, device=cuda, dtype=torch.uint8),
             torch.randint(0, 256, (h, w), generator=g, device=cuda, dtype=torch.uint8),
             torch.zeros((h, w), device=cuda, dtype=torch.uint8),
             torch.ones((h, w), device=cuda, dtype=torch.uint8)]
    before = B6.launches["morph_plane"]
    for m in masks:
        for dilate in (False, True):
            assert torch.equal(B6.morph_plane(m, dilate), B6.morph_plane_plain(m, dilate))
    torch.cuda.synchronize()
    assert B6.launches["morph_plane"] == before + (8 if h * w else 0)
    with pytest.raises(ValueError, match="contiguous"):
        B6.morph_plane(torch.zeros((8, 6), dtype=torch.uint8, device=cuda).t(), True)


def test_filter_depth_with_morphology_on_card_matches_cpu(cuda):
    """Four B6 launches per call; bit-identical to the CPU's plain run."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    rng = np.random.default_rng(5)
    depth = rng.integers(300, 3300, (120, 160)).astype(np.int32)
    depth[rng.random(depth.shape) < 0.02] = 0
    for roi in (None, (10, 5, 100, 80)):
        out = {}
        for dev in ("cpu", cuda):
            before = B6.launches["morph_plane"]
            out[str(dev)] = F.filter_depth(torch.from_numpy(depth).to(dev),
                                           torch.tensor(0.001, device=dev),
                                           torch.tensor(0.5, device=dev),
                                           torch.tensor(3.0, device=dev), roi,
                                           use_morphology=True)
            torch.cuda.synchronize()
            assert B6.launches["morph_plane"] - before == (4 if dev == cuda else 0)
        for a, b in zip(out["cuda"], out["cpu"]):
            assert torch.equal(a.cpu(), b)


# Segment sums (B5): the kernel adds each slot's entries in entry order, so
# it equals the plain version run on the CPU bit for bit. The plain version
# on the card adds with atomics in a varying order: against it, counts (a
# channel of ones) and the representative index are exact and the sums are
# held to rtol 1e-5 / atol 1e-6 (the parity gate's bar for voxel means,
# tpu_check.py:389-397) scaled by each slot's sum of magnitudes.
@pytest.mark.parametrize("n,c,n_slots,spread", [
    (0, 10, 64, 64), (1, 1, 1, 1), (1000, 16, 7, 7), (4099, 10, 1 << 10, 1 << 10),
    (70_001, 10, 1 << 15, 300), (70_001, 10, 1 << 15, 1 << 15), (513, 3, 0, 1),
    # long runs (a coarse voxel): thousands of entries a slot
    (230_400, 10, 1 << 15, 40), (100_000, 16, 1000, 3),
    # more than 2^16 slots: three radix passes
    (50_000, 2, (1 << 16) + 3, (1 << 16) + 3),
])
def test_segsum_kernel_matches_plain(cuda, n, c, n_slots, spread):
    g = torch.Generator(device=cuda).manual_seed(n + c)
    slot = torch.randint(0, max(spread, 1), (n,), generator=g, device=cuda, dtype=torch.int32)
    slot[::5] = B5.padded_slots(n_slots)
    slot[1::11] = -1
    vals = torch.randn((n, c), generator=g, device=cuda)
    vals[:, 0] = 1.0
    before = B5.launches["segsum_sorted"]
    ks, kr = B5.segsum_sorted(slot, vals, n_slots)
    ps, pr = B5.segsum_sorted_plain(slot, vals, n_slots)
    mag, _ = B5.segsum_sorted_plain(slot, vals.abs(), n_slots)
    torch.cuda.synchronize()
    assert B5.launches["segsum_sorted"] == before + 1
    assert ks.shape == (n_slots, c) and kr.dtype == torch.int32
    assert torch.equal(kr, pr) and torch.equal(ks[:, 0], ps[:, 0])
    assert bool(((ks - ps).abs() <= 1e-5 * mag + 1e-6).all())
    cs, cr = B5.segsum_sorted(slot.cpu(), vals.cpu(), n_slots)
    assert torch.equal(ks.cpu(), cs) and torch.equal(kr.cpu(), cr)
    again, _ = B5.segsum_sorted(slot, vals, n_slots)
    assert torch.equal(again, ks)


def test_segsum_all_invalid_and_one_slot(cuda):
    vals = torch.ones((300, 10), device=cuda)
    none = torch.full((300,), B5.padded_slots(64), dtype=torch.int32, device=cuda)
    s, r = B5.segsum_sorted(none, vals, 64)
    assert not bool(s.any()) and bool((r == B5.INT32_MAX).all())
    one = torch.zeros(300, dtype=torch.int32, device=cuda)
    s, r = B5.segsum_sorted(one, vals, 1)
    assert s.tolist() == [[300.0] * 10] and r.tolist() == [0]


def test_kernels_reject_what_they_do_not_take(cuda):
    p = torch.zeros((8, 6), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        B4.gauss3x3_plane(p.t())
    with pytest.raises(ValueError, match="contiguous"):
        B4.interleaved_image(p.t(), "gauss")
    with pytest.raises(ValueError, match="contiguous"):
        B4.winner_image(torch.zeros((6, 8), dtype=torch.int32, device=cuda).t(), 2, 3)
    with pytest.raises(ValueError, match="int32"):
        B4.winner_image(torch.zeros(48, dtype=torch.int64, device=cuda), 6, 8)
    with pytest.raises(ValueError, match="planes on"):
        B4.planes_image([p, p, p.cpu()], "median")
    with pytest.raises(ValueError, match="uint8"):
        B4.planes_image([p, p, p.to(torch.int32)], "median")
    with pytest.raises(ValueError, match="65535"):
        B4.winner_image(torch.zeros((65536, 1), dtype=torch.int32, device=cuda), 1, 1)
    i = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        Z.zresolve_winner_rgb(i, i, torch.zeros(16, dtype=torch.int32, device=cuda)[::2], 4)
    with pytest.raises(ValueError):
        Z.zresolve_winner_rgb(i, i, i.cpu(), 4)
    with pytest.raises(ValueError, match="channels"):
        B5.segsum_sorted(i, torch.zeros((8, 17), device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        B5.segsum_sorted(i, torch.zeros((10, 8), device=cuda).t(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        Z.scatter_min_u32(i, torch.zeros(16, dtype=torch.int32, device=cuda)[::2], 4)
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics

    intr = Intrinsics.create(6, 8, 5.0, 5.0, 3.0, 4.0, device=cuda)
    depth = torch.zeros((6, 8), dtype=torch.int32, device=cuda)
    color = torch.zeros((8, 6, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        B3.fuse_prep(depth.t(), color, 0.001, 0.5, 3.0, intr, torch.eye(4, device=cuda), intr,
                     False, 0.25, 4.0)


@pytest.mark.parametrize("n,n_slots", [(0, 5), (1, 1), (1000, 257), (70_001, 3000)])
def test_scatter_min_u32_matches_plain(cuda, n, n_slots):
    rng = np.random.default_rng(n + n_slots)
    idx = torch.from_numpy(rng.integers(-2, n_slots + 2, n).astype(np.int32)).to(cuda)
    key = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)).to(cuda)
    key[::7] = -1
    before = Z.launches["scatter_min_u32"]
    got = Z.scatter_min_u32(idx, key, n_slots)
    want = Z.scatter_min_u32_plain(idx, key, n_slots)
    torch.cuda.synchronize()
    assert Z.launches["scatter_min_u32"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), Z.scatter_min_u32(idx.cpu(), key.cpu(), n_slots))


@pytest.mark.parametrize("w,h,mirror", [(128, 64, False), (128, 64, True), (64, 36, True),
                                        (1, 1, False), (37, 5, True)])
def test_fuse_prep_kernel_matches_plain(cuda, w, h, mirror):
    """B3 bit for bit against its plain version on the card and on the CPU,
    with a rotated and shifted pose and a target camera of another size."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics

    rng = np.random.default_rng(w * h)
    depth = rng.integers(0, 4000, (h, w)).astype(np.int32)
    depth[rng.random((h, w)) < 0.05] = 0
    color = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    a = 0.12
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    t[:3, 3] = [0.2, -0.05, 0.1]
    src = Intrinsics.create(w, h, fx=0.74 * w, fy=0.75 * w, ppx=w / 2, ppy=h / 2, device="cpu")
    dst = Intrinsics.create(h + 3, w, fx=0.7 * w, fy=0.7 * w, ppx=(h + 3) // 2, ppy=w // 2,
                            device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        args = (torch.from_numpy(depth).to(dev), torch.from_numpy(color).to(dev),
                torch.tensor(0.001, device=dev), torch.tensor(0.5, device=dev),
                torch.tensor(3.0, device=dev), src.to(dev), torch.from_numpy(t).to(dev),
                dst.to(dev), mirror, torch.tensor(0.25, device=dev), torch.tensor(4.0, device=dev))
        out[str(dev)] = B3.fuse_prep(*args)
        if dev != "cpu":
            before = B3.launches["fuse_prep"]
            plain = B3.fuse_prep_plain(*args)
            out["plain"] = plain
    torch.cuda.synchronize()
    assert B3.launches["fuse_prep"] == before
    for got in (out["plain"], out["cpu"]):
        assert torch.equal(out["cuda"][0].cpu(), got[0].cpu())
        assert torch.equal(out["cuda"][1].cpu(), got[1].cpu())


def test_pipeline_on_card_matches_cpu(cuda):
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig, FusionPipeline
    from pointcloud_depthfusion_tpu_torch.io.synthetic import (
        SyntheticScene, right_to_left_transform, two_camera_rig,
    )

    w, h = 160, 120
    wl, wr = two_camera_rig()
    host = Intrinsics.create(w, h, fx=119.0, fy=119.0, ppx=80.0, ppy=60.0, device="cpu")
    frames = [SyntheticScene().render(host, pose, seed=i) for i, pose in enumerate((wl, wr))]
    for mode, align in (("tiled", False), ("tiled", True), ("exact", False),
                        ("indexed", False), ("packed", False), ("pallas", False)):
        out = {}
        for dev in ("cpu", cuda):
            intr = host.to(dev)
            cfg = FusionConfig.create(render_mode=mode, align_frames=align)
            pipe = FusionPipeline(intr, cfg, device=dev)
            pipe.set_right_transform(right_to_left_transform(wl, wr))
            fs = [Frameset.create(f.depth, f.color, intr, device=dev) for f in frames]
            out[str(dev)] = pipe.process(*fs)
        gpu, cpu = out["cuda"], out["cpu"]
        assert (gpu.image.cpu() != cpu.image).any(-1).float().mean() <= 1e-3, (mode, align)
        assert (gpu.zbuf.cpu() < 1e38).float().mean() > 0.5, (mode, align)


def test_registration_on_card_matches_cpu(cuda):
    """Six ticks of the converging-ticks settings on the 106×60 pair: the
    card's transforms within 5e-3 per entry of the CPU run's (the GICP
    bar, tpu_check.py:459-464), the same flags, and B5 launched 4 times
    per grid rebuild and 2 times per cached tick."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
    from pointcloud_depthfusion_tpu_torch.registration.pipeline import (
        RegistrationPipeline, RegistrationSettings,
    )

    w, h = 106, 60
    host = Intrinsics.create(w, h, fx=80.0, fy=80.0, ppx=w / 2, ppy=h / 2, device="cpu")
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    dl, dr = (SyntheticScene().render(host, pose, depth_noise_std=0.002, seed=s).depth
              for pose, s in ((wl, 3), (wr, 4)))
    settings = RegistrationSettings(
        resolution=0.02, voxelsize=0.01, initial_resolution=0.12, resolution_step=0.05,
        max_iterations=48, discard_transform=False, reset_initial_guess=False,
        neighbor_search="direct7")
    card = RegistrationPipeline(host, host, settings, device=cuda)
    cpu = RegistrationPipeline(host, host, settings, device="cpu")
    before = B5.launches["segsum_sorted"]
    for _ in range(6):
        np.testing.assert_allclose(card.tick(dl, dr), cpu.tick(dl, dr), rtol=0, atol=5e-3)
    flags = [(t.discarded, t.guess_reset, t.target_grid_rebuilt) for t in card.telemetry]
    assert flags == [(t.discarded, t.guess_reset, t.target_grid_rebuilt) for t in cpu.telemetry]
    rebuilt = sum(f[2] for f in flags)
    assert B5.launches["segsum_sorted"] - before == 4 * rebuilt + 2 * (6 - rebuilt)


@pytest.mark.parametrize("s,n,n_px", [(1, 1, 1), (3, 1000, 257), (8, 9_001, 3000)])
def test_sorted_streams_kernel_matches_plain(cuda, s, n, n_px):
    """B7: one launch over the (S, N) entries, bit for bit the plain
    version's (the flat resolve), with and without rgb."""
    pix, z, rgb = (t.reshape(s, n) for t in _entries(s * n, n_px, s + n, cuda))
    before = Z.launches["zresolve_sorted_streams"]
    for r in (rgb, None):
        got = Z.zresolve_sorted_streams(pix, z, r, n_px)
        want = Z.zresolve_sorted_streams_plain(pix, z, r, n_px)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        host = Z.zresolve_sorted_streams(pix.cpu(), z.cpu(), None if r is None else r.cpu(), n_px)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, host))
    torch.cuda.synchronize()
    assert Z.launches["zresolve_sorted_streams"] == before + 2


def test_rig_on_card_matches_cpu(cuda):
    """A 3-camera rig at 160×120 in every rig mode: the card's image within
    1e-3 of pixels of the CPU run's (1e-2 for packed), and on the card
    multi_stream equal to the default bit for bit."""
    import dataclasses

    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse

    w, h, n = 160, 120, 3
    host = Intrinsics.create(w, h, fx=119.0, fy=119.0, ppx=80.0, ppy=60.0, device="cpu")
    poses = rig_arc_poses(n, toe_in_deg_per_m=37.5)
    fs = [SyntheticScene().render(host, p, depth_noise_std=0.002, seed=i)
          for i, p in enumerate(poses)]
    arrays = (np.stack([f.depth for f in fs]).astype(np.int32), np.stack([f.color for f in fs]),
              np.full((n,), 0.001, np.float32), np.stack(poses).astype(np.float32))
    base = FusionConfig.create(vertical_image=False, mirror_image=False, device="cpu")
    for mode, kw, multi in (("tiled", dict(emit_zbuf=False), False), ("tiled", {}, False),
                            ("tiled", {}, True), ("packed", {}, False),
                            ("tiled", dict(use_median_filter=True), False)):
        cfg = dataclasses.replace(base, render_mode=mode, **kw)
        out = {}
        for dev in ("cpu", cuda):
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            out[str(dev)] = rig_fuse(host, host, cfg, multi_stream=multi, device=dev)(*args)
        torch.cuda.synchronize()
        gpu, cpu = out["cuda"].cpu(), out["cpu"]
        assert gpu.shape == (h, w, 3) and gpu.any(-1).float().mean() > 0.5
        bar = 1e-2 if mode == "packed" else 1e-3
        assert (gpu != cpu).any(-1).float().mean() <= bar, (mode, kw, multi)
        if multi:
            default = rig_fuse(host, host, cfg, device=cuda)(*[torch.from_numpy(a).to(cuda)
                                                               for a in arrays])
            assert torch.equal(default.cpu(), gpu)
