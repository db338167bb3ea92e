"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; without a device every test skips. This file
imports no jax, so on a machine without it run it as

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import re
import time

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6
from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as B5
from pointcloud_depthfusion_tpu_torch.ops.cuda import spatial_cuda as S
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_ops(fn, tries=5):
    """The names of the device operations of one ``fn()``, by
    torch.profiler. A trace now and then loses some or all of its kernels
    while the host's records of the launches come back whole (as in
    chip_smoke.py's ``traced``): the first trace holding one kernel for
    each host ``cudaLaunch*`` record gives its device events; without one
    in ``tries``, the last trace's host launches, copies and fills."""
    from torch.profiler import ProfilerActivity, profile

    for k in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = [e.name for e in events if str(e.device_type).endswith("CUDA")]
        host = [e.name for e in events if not str(e.device_type).endswith("CUDA")]
        launches = [n for n in host if re.match(r"cudaLaunch(Cooperative)?Kernel", n)]
        kernels = [n for n in device if not n.startswith(("Memcpy", "Memset"))]
        if launches and len(kernels) == len(launches):
            return device
        time.sleep(min(0.05 * 2 ** k, 1.0))
    return launches + [n for n in host if re.match(r"cudaMem(cpy|set)", n)]


def _entries(n, n_px, seed, device):
    rng = np.random.default_rng(seed)
    pix = rng.integers(-2, n_px + 3, n).astype(np.int32)
    pix[rng.random(n) < 0.1] = Z.INVALID_PIX
    z = rng.integers(-50, 50, n).astype(np.int32)
    rgb = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    return (torch.from_numpy(a).to(device) for a in (pix, z, rgb))


@pytest.mark.parametrize("n,n_px", [(0, 5), (1, 1), (1000, 257), (70_001, 3000), (100_000, 64)])
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


def _feed(n, n_px, seed, device, mask="random"):
    """A masked feed (idx, z f32, ok, rgb24): pixel ids inside and outside
    [0, n_px), z from a few values (ties), ``ok`` random, all off or all on."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, n_px + 3, n).astype(np.int32)
    z = (rng.integers(-3, 4, n).astype(np.int32) << 23).view(np.float32)
    rgb = rng.integers(0, 1 << 24, n).astype(np.int32)
    ok = {"random": rng.random(n) < 0.8, "all_off": np.zeros(n, bool),
          "all_on": np.ones(n, bool)}[mask]
    return tuple(torch.from_numpy(a).to(device) for a in (idx, z, ok, rgb))


def _resolve_all(pix, z, rgb, n_px):
    """Every JAX API resolve of the entries, flattened to a list."""
    return [*Z.zresolve_sorted_entries(pix, z, rgb, n_px),
            *Z.zresolve_sorted_entries(pix, z, None, n_px),
            Z.zresolve_winner_rgb(pix, z, rgb, n_px)]


def _plain_all(pix, z, rgb, n_px):
    return [*Z.zresolve_sorted_entries_plain(pix, z, rgb, n_px),
            *Z.zresolve_sorted_entries_plain(pix, z, None, n_px),
            Z.zresolve_winner_rgb_plain(pix, z, rgb, n_px)]


def _keys_clean():
    torch.cuda.synchronize()
    return all(bool((k == -1).all()) for k in Z._key_buffers.values())


def test_resolve_of_invalid_entries_is_empty(cuda):
    pix, z, rgb = _entries(5000, 700, 1, cuda)
    pix = torch.full_like(pix, Z.INVALID_PIX)
    got = _resolve_all(pix, z, rgb, 700)
    assert all(bool((g == Z.INT32_MAX).all()) for g in got)
    assert _keys_clean()


@pytest.mark.parametrize("mask", ["random", "all_off", "all_on"])
@pytest.mark.parametrize("n,n_px", [(0, 5), (1, 1), (1000, 257), (70_001, 3000), (100_000, 64)])
def test_masked_resolve_matches_plain(cuda, n, n_px, mask):
    """The masked feed: bit for bit its plain version and the JAX API's
    resolve of the masked entries, in the 16 B loads' layout and in an
    unaligned view (the scalar loop)."""
    idx, z, ok, rgb = _feed(n + 1, n_px, n + n_px, cuda, mask)
    for sl in (slice(0, n), slice(1, n + 1)):
        feed = tuple(t[sl] for t in (idx, z, ok, rgb))
        for need_zbuf in (True, False):
            got = Z.zresolve_masked(*feed, n_px, need_zbuf)
            want = Z.zresolve_masked_plain(*feed, n_px, need_zbuf)
            assert torch.equal(got[0], want[0]) and (got[1] is None) == (not need_zbuf)
            assert not need_zbuf or torch.equal(got[1], want[1])
            minz, mrgb = Z.zresolve_sorted_entries(*Z.masked_entries(*feed), n_px)
            assert torch.equal(got[0], mrgb) and (not need_zbuf or torch.equal(got[1], minz))
    assert _keys_clean()


def test_key_buffer_grows_shrinks_and_stays_clean(cuda):
    """One stream's key buffer through growing, shrinking and growing
    n_px, each call with other entries equal to its own plain result, and
    all-ones after every call."""
    for k, n_px in enumerate((100, 50_000, 7, 200_000, 1, 3000, 400_000)):
        pix, z, rgb = _entries(2 * n_px + 5, n_px, 40 + k, cuda)
        got, want = _resolve_all(pix, z, rgb, n_px), _plain_all(pix, z, rgb, n_px)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n_px
        feed = _feed(2 * n_px + 5, n_px, 80 + k, cuda)
        assert torch.equal(Z.zresolve_masked(*feed, n_px, True)[1],
                           Z.zresolve_masked_plain(*feed, n_px, True)[1])
        assert _keys_clean(), n_px
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert Z._key_buffers[(cuda.index if cuda.index is not None else torch.cuda.current_device(),
                           stream)].numel() >= 400_000


def test_two_side_streams_resolve_at_once(cuda):
    """Two side streams, each with its own key buffer, resolving in turns
    without waiting for each other: each result is its own plain one."""
    inputs = [tuple(_entries(300_000, 100_000, 60 + i, cuda)) for i in range(2)]
    wants = [_plain_all(*e, 100_000) for e in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    gots = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                gots[i].append(_resolve_all(*inputs[i], 100_000))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for g in got:
            assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert {(torch.cuda.current_device(), s.cuda_stream) for s in streams} <= set(Z._key_buffers)
    assert _keys_clean()


def test_failed_launch_drops_the_key_buffer(cuda, monkeypatch):
    """A launch that reports an error raises and drops its stream's key
    buffer, so the next call starts from a fresh one and is right: here the
    failed launch leaves the old buffer dirty (all zeros)."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

    pix, z, rgb = _entries(20_000, 5000, 7, cuda)
    Z.zresolve_winner_rgb(pix, z, rgb, 5000)
    slot = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    dirty = Z._key_buffers[slot]
    lib = _build.load()
    real = lib.zresolve_launch
    calls = []

    def fail_once(*args):
        calls.append(args)
        if len(calls) == 1:
            dirty.zero_()
            return 700  # cudaErrorIllegalAddress
        return real(*args)

    monkeypatch.setattr(lib, "zresolve_launch", fail_once)
    before = dict(Z.launches)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        Z.zresolve_winner_rgb(pix, z, rgb, 5000)
    assert slot not in Z._key_buffers and Z.launches == before
    got = Z.zresolve_sorted_entries(pix, z, rgb, 5000)
    assert all(torch.equal(a, b) for a, b in zip(got, Z.zresolve_sorted_entries_plain(
        pix, z, rgb, 5000)))
    assert Z._key_buffers[slot] is not dirty and len(calls) == 2
    assert _keys_clean()


def test_each_resolve_call_is_one_device_op(cuda):
    """Every resolve wrapper runs one kernel on the card a call (no fill, no
    scratch allocation), counted by torch.profiler, and counts one launch
    under its name."""
    pix, z, rgb = _entries(40_000, 10_000, 3, cuda)
    idx, zf, ok, rgb24 = _feed(40_000, 10_000, 4, cuda)
    s2 = tuple(t.reshape(4, -1) for t in (pix, z, rgb))
    f2 = tuple(t.reshape(4, -1) for t in (idx, zf, ok, rgb24))
    calls = {
        "zresolve_sorted_entries": lambda: Z.zresolve_sorted_entries(pix, z, rgb, 10_000),
        "zresolve_sorted_entries_legacy": lambda: Z.zresolve_sorted_entries(
            pix, z, rgb, 10_000, legacy_feed=True),
        "zresolve_winner_rgb": lambda: Z.zresolve_winner_rgb(pix, z, rgb, 10_000),
        "zresolve_sorted_streams": lambda: Z.zresolve_sorted_streams(*s2, 10_000),
    }
    masked = {
        "zresolve_sorted_entries": lambda: Z.zresolve_masked(idx, zf, ok, rgb24, 10_000, True),
        "zresolve_winner_rgb": lambda: Z.zresolve_masked(idx, zf, ok, rgb24, 10_000, False),
        "zresolve_sorted_streams": lambda: Z.zresolve_masked(*f2, 10_000, True),
    }
    depth_only = {"zresolve_sorted_entries": lambda: Z.zresolve_sorted_entries(
        pix, z, None, 10_000)}
    for group in (calls, masked, depth_only):
        for name, fn in group.items():
            fn()
            torch.cuda.synchronize()
            ops = _device_ops(fn)
            assert len(ops) == 1, (name, ops)
            before = dict(Z.launches)
            fn()
            assert Z.launches == {**before, name: before[name] + 1}, name


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


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (9, 1), (33, 31), (131, 300)])
def test_morph_passes_one_launch_match_plain(cuda, h, w):
    """One, two and four passes in one launch: bit-exact to the chain of
    single passes, on 0/1 and on any u8 values, and on bool masks (the mask
    format)."""
    g = torch.Generator(device=cuda).manual_seed(h * 7 + w)
    masks = [torch.randint(0, 2, (h, w), generator=g, device=cuda, dtype=torch.uint8),
             torch.randint(0, 256, (h, w), generator=g, device=cuda, dtype=torch.uint8)]
    passes = ((False,), (True,), (False, True), (True, False), (True, True, False, False),
              B6.OPEN_CLOSE)
    before = B6.launches["morph_plane"]
    for m in masks:
        for p in passes:
            assert torch.equal(B6.morph_passes(m, p), B6.morph_passes_plain(m, p)), p
    for p in passes:
        want = B6.morph_passes_plain(masks[0], p).view(torch.bool)
        assert torch.equal(B6.mask_passes(masks[0].bool(), p), want), p
    torch.cuda.synchronize()
    assert B6.launches["morph_plane"] == before + (len(masks) + 1) * len(passes)


FUSED_ROIS = (None, (10, 5, 100, 80), (0, 0, 160, 120), (0, 40, 30, 30), (50, 0, 40, 20),
              (140, 30, 40, 50), (20, 100, 50, 40), (77, 61, 1, 1))


def _fused_box(roi, h, w):
    """The fused call's (x0, y0, x1, y1) of ``roi``, as filter_depth clamps it."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    if roi is None:
        return None
    x0, y0, rw, rh = F._clamped_roi(h, w, roi)
    return x0, y0, x0 + rw, y0 + rh


def test_filter_depth_with_morphology_on_card_matches_cpu(cuda):
    """One B6 launch per call, in each depth dtype the kernel takes, with
    ROIs on each edge and of one pixel: bit-identical to the CPU's plain
    run and to the fused call's plain version on the card."""
    from pointcloud_depthfusion_tpu_torch.ops import filters as F

    rng = np.random.default_rng(5)
    depth = rng.integers(300, 3300, (120, 160)).astype(np.int32)
    depth[rng.random(depth.shape) < 0.02] = 0
    for dtype in B6.DEPTH_KINDS:
        # u8 depth on a 16× coarser scale, so that the window still cuts.
        d, s = (depth // 16, 0.016) if dtype == torch.uint8 else (depth, 0.001)
        host = torch.from_numpy(d).to(dtype)
        card = host.to(cuda)
        scale = torch.tensor(s, device=cuda)
        for roi in FUSED_ROIS:
            before = B6.launches["morph_plane"]
            got = F.filter_depth(card, scale, torch.tensor(0.5, device=cuda),
                                 torch.tensor(3.0, device=cuda), roi, use_morphology=True)
            torch.cuda.synchronize()
            assert B6.launches["morph_plane"] - before == 1
            cpu = F.filter_depth(host, torch.tensor(s), 0.5, 3.0, roi, use_morphology=True)
            plain = B6.filter_depth_open_close_plain(card, scale, 0.5, 3.0,
                                                     _fused_box(roi, 120, 160))
            for a, b, c in zip(got, cpu, plain):
                assert torch.equal(a.cpu(), b) and torch.equal(a, c), (roi, dtype)


# The spatial filter's row-scan kernel: bit-exact to its plain version,
# 2 launches an iteration.
@pytest.mark.parametrize("h,w", [(1, 1), (1, 37), (29, 1), (23, 41), (96, 160)])
def test_spatial_kernel_matches_plain(cuda, h, w):
    rng = np.random.default_rng(h * 1000 + w)
    d = rng.integers(1000, 1040, (h, w)) + 400 * (np.arange(w) >= w // 2)
    d[rng.random((h, w)) < 0.25] = 0
    d[h // 3, 1:max(w - 2, 1)] = 0
    for dtype in (torch.int32, torch.uint16, torch.int64):
        t = torch.from_numpy(d).to(dtype=dtype, device=cuda)
        for holes_fill in range(6):
            for magnitude in (0, 1, 2, 3):
                before = S.launches["spatial_filter"]
                got = S.spatial_filter(t, 0.55, 20.0, magnitude, holes_fill)
                torch.cuda.synchronize()
                assert S.launches["spatial_filter"] - before == max(2 * magnitude, 1)
                want = S.spatial_filter_plain(t, 0.55, 20.0, magnitude, holes_fill)
                assert got.dtype == dtype and torch.equal(got, want), (dtype, holes_fill, magnitude)
    disp = torch.from_numpy(d.astype(np.float32) / 37.0).to(cuda)
    for holes_fill in (0, 2):
        got = S.spatial_filter(disp, 0.5, 8.0, 2, holes_fill)
        assert got.dtype == torch.float32
        assert torch.equal(got, S.spatial_filter_plain(disp, 0.5, 8.0, 2, holes_fill))
    with pytest.raises(ValueError, match="contiguous"):
        S.spatial_filter(torch.zeros((8, 6), dtype=torch.int32, device=cuda).t())
    with pytest.raises(ValueError, match="expected one of"):
        S.spatial_filter(torch.zeros((8, 6), dtype=torch.float64, device=cuda))


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


def _prep_inputs(n, w, h, seed, distort, roi, offsets):
    """n cameras' frames and B3's cameras (on the CPU): 0.3-3.5 m of depth
    with holes, per-camera intrinsics (inverse Brown-Conrady with
    ``distort``), yaws and shifts, ROIs and pixel offsets."""
    from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics

    rng = np.random.default_rng(seed)
    scale = np.asarray([0.001, 0.00025, 0.0005, 0.001][:n], np.float32)
    depth = (rng.uniform(0.3, 3.5, (n, h, w)) / scale[:, None, None]).astype(np.int32)
    depth[rng.random((n, h, w)) < 0.05] = 0
    color = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = 0.08 * (i - 1)
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.05 * i, -0.02, 0.1]
    model = Distortion.INVERSE_BROWN_CONRADY if distort else Distortion.NONE
    intr = [Intrinsics.create(w, h, fx=0.8 * w + 3 * i, fy=0.8 * w + 2 * i, ppx=w / 2 + i,
                              ppy=h / 2 - i, model=model,
                              coeffs=(0.06, -0.02, 0.001, -0.0015, 0.004) if i == 1 else (0.0,) * 5,
                              device="cpu") for i in range(n)]
    fused = Intrinsics.create(h + 7, w, fx=0.7 * w, fy=0.7 * w, ppx=(h + 7) // 2, ppy=w // 2,
                              device="cpu")
    rois = [(6, 4, w // 2, h // 2), None, (-1, 3, w + 9, -1), None][:n] if roi else None
    cams = B3.prep_cameras(intr, fused, 0.5, 3.0, True, rois=rois,
                           pix_offsets=[i * offsets for i in range(n)], device="cpu")
    return [torch.from_numpy(a) for a in (depth, color, scale, poses)], cams


def _cams_on(cams, dev):
    return B3.prep_cameras([i.to(dev) for i in cams.intrinsics], cams.fused.to(dev),
                           cams.min_depth, cams.max_depth, cams.mirror, rois=cams.rois,
                           pix_offsets=cams.pix_offsets, z_near=cams.z_near, z_far=cams.z_far,
                           device=dev)


@pytest.mark.parametrize("n,w,h,distort,roi,offsets,per_stream", [
    (2, 128, 64, False, False, 0, False), (2, 160, 90, True, True, 0, False),
    (3, 64, 36, True, True, 5000, True), (4, 37, 5, False, True, 300, False),
    (1, 1, 1, False, False, 0, False)])
def test_prep_feed_kernel_matches_plain(cuda, n, w, h, distort, roi, offsets, per_stream):
    """B3's masked feed bit for bit against its plain version on the card
    and on the CPU: stacked frames, separate frames, rgb24 color; one launch
    a call."""
    host, cams = _prep_inputs(n, w, h, n + w, distort, roi, offsets)
    args = [t.to(cuda) for t in host]
    card = _cams_on(cams, cuda)
    before = B3.launches["fuse_prep"]
    got = B3.fuse_prep_feed(*args, card, per_stream)
    assert B3.launches["fuse_prep"] == before + 1
    want = B3.fuse_prep_feed_plain(*args, card, per_stream)
    cpu = B3.fuse_prep_feed(*host, cams, per_stream)
    split = B3.fuse_prep_feed(*([t[i].clone() for i in range(n)] for t in args), card,
                              per_stream)
    rgb24 = args[1].to(torch.int32)
    packed = B3.fuse_prep_feed(args[0], (rgb24[..., 0] << 16) | (rgb24[..., 1] << 8)
                               | rgb24[..., 2], *args[2:], card, per_stream)
    torch.cuda.synchronize()
    for other in (want, cpu, split, packed):
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, other))


def test_prep_keys_kernel_matches_plain(cuda):
    """B3's packed keys for two cameras in one launch, as the pallas mode
    runs it (two separate framesets): bit for bit its plain version."""
    host, cams = _prep_inputs(2, 128, 64, 5, False, False, 0)
    args = [[t[i].to(cuda) for i in range(2)] for t in host]
    card = _cams_on(cams, cuda)
    got = B3.fuse_prep_keys(*args, card)
    want = B3.fuse_prep_keys_plain(*args, card)
    cpu = B3.fuse_prep_keys(*host, cams)
    torch.cuda.synchronize()
    for other in (want, cpu):
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, other))


def test_prep_reads_poses_every_call_and_refuses_mixed_devices(cuda):
    """B3 reads each camera's pose and depth scale from their tensors on
    every launch (a tensor rewritten in place takes effect), and raises
    when the frames, the cameras, the poses or the scales lie on different
    devices."""
    host, cams = _prep_inputs(2, 128, 64, 9, False, False, 0)
    args = [t.to(cuda) for t in host]
    card = _cams_on(cams, cuda)
    first = B3.fuse_prep_feed(*args, card)
    args[3][1, 0, 3] += 0.05
    args[2][0] *= 2.0
    moved = B3.fuse_prep_feed(*args, card)
    want = B3.fuse_prep_feed_plain(*args, card)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(moved, want))
    assert not torch.equal(moved[0], first[0])
    with pytest.raises(ValueError, match="cameras"):
        B3.fuse_prep_feed(*host, card)
    with pytest.raises(ValueError, match="cameras"):
        B3.fuse_prep_feed(*args, cams)
    with pytest.raises(ValueError, match="cam_to_virtual"):
        B3.fuse_prep_feed(*args[:3], host[3], card)
    with pytest.raises(ValueError, match="depth_scale"):
        B3.fuse_prep_keys(args[0], args[1], host[2], args[3], card)


def _packed_feed(n, n_slots, seed, device, ok_frac=0.9):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, n_slots + 3, n).astype(np.int32)
    z = rng.uniform(0.05, 5.0, n).astype(np.float32)
    ok = rng.random(n) < ok_frac
    rgb24 = rng.integers(0, 1 << 24, n).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (idx, z, ok, rgb24)]


@pytest.mark.parametrize("ok_frac", [0.9, 0.0])
@pytest.mark.parametrize("n,n_slots", [(0, 5), (1, 1), (1001, 257), (70_001, 3000),
                                       (100_000, 64)])
def test_scatter_min_variants_match_plain(cuda, n, n_slots, ok_frac):
    """Every scatter-min variant (given keys or the feed, raw or decoded,
    with or without the z-buffer) bit for bit its plain version, aligned and
    unaligned; the key buffer all-ones after every call."""
    feed = _packed_feed(n + 1, n_slots, n + n_slots, cuda, ok_frac)
    for span in (None, 3.75):
        zparams = Z.packed_zparams(0.25, 4.0, cuda, span=span)
        for sl in (slice(0, n), slice(1, n + 1)):
            f = [t[sl] for t in feed]
            key = Z.packed_keys_plain(*f[1:], zparams)
            cases = [
                (lambda: Z.scatter_min_packed(*f, n_slots, zparams, planes=False),
                 lambda: Z.scatter_min_packed_plain(*f, n_slots, zparams, planes=False)),
                (lambda: Z.scatter_min_u32(f[0], key, n_slots),
                 lambda: Z.scatter_min_u32_plain(f[0], key, n_slots))]
            for need_zbuf in (True, False):
                cases += [
                    (lambda nz=need_zbuf: Z.scatter_min_packed(*f, n_slots, zparams, True, nz),
                     lambda nz=need_zbuf: Z.scatter_min_packed_plain(*f, n_slots, zparams, True,
                                                                     nz)),
                    (lambda nz=need_zbuf: Z.scatter_min_u32(f[0], key, n_slots, zparams, True, nz),
                     lambda nz=need_zbuf: Z.scatter_min_u32_plain(f[0], key, n_slots, zparams,
                                                                  True, nz))]
            for kernel, plain in cases:
                before = Z.launches["scatter_min_u32"]
                got, want = kernel(), plain()
                assert Z.launches["scatter_min_u32"] == before + 1
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for a, b in zip(got, want):
                    assert (a is None and b is None) or torch.equal(a, b)
                assert _keys_clean()


def test_scatter_min_failed_launch_drops_the_key_buffer(cuda, monkeypatch):
    """As the resolve's: a scatter-min launch that reports an error raises
    and drops its stream's key buffer; the next call is right."""
    from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

    idx, z, ok, rgb24 = _packed_feed(20_000, 5000, 9, cuda)
    zparams = Z.packed_zparams(0.25, 4.0, cuda)
    Z.scatter_min_packed(idx, z, ok, rgb24, 5000, zparams)
    slot = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    dirty = Z._key_buffers[slot]
    lib = _build.load()
    real = lib.scatter_min_u32_launch
    calls = []

    def fail_once(*args):
        calls.append(args)
        if len(calls) == 1:
            dirty.zero_()
            return 700  # cudaErrorIllegalAddress
        return real(*args)

    monkeypatch.setattr(lib, "scatter_min_u32_launch", fail_once)
    before = dict(Z.launches)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        Z.scatter_min_packed(idx, z, ok, rgb24, 5000, zparams)
    assert slot not in Z._key_buffers and Z.launches == before
    got = Z.scatter_min_packed(idx, z, ok, rgb24, 5000, zparams, need_zbuf=True)
    want = Z.scatter_min_packed_plain(idx, z, ok, rgb24, 5000, zparams, need_zbuf=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert Z._key_buffers[slot] is not dirty and len(calls) == 2
    assert _keys_clean()


def test_prep_and_scatter_min_are_one_device_op_each(cuda):
    """B3 for every camera, and each scatter-min variant, run one kernel on
    the card a call, counted by torch.profiler."""
    host, cams = _prep_inputs(3, 160, 90, 2, True, True, 0)
    args, card = [t.to(cuda) for t in host], _cams_on(cams, cuda)
    feed = _packed_feed(40_000, 10_000, 4, cuda)
    zparams = Z.packed_zparams(0.25, 4.0, cuda)
    key = Z.packed_keys_plain(*feed[1:], zparams)
    calls = {"fuse_prep_feed": lambda: B3.fuse_prep_feed(*args, card),
             "scatter_min_packed": lambda: Z.scatter_min_packed(*feed, 10_000, zparams,
                                                                need_zbuf=True),
             "scatter_min_u32 planes": lambda: Z.scatter_min_u32(feed[0], key, 10_000, zparams,
                                                                 planes=True),
             "scatter_min_u32": lambda: Z.scatter_min_u32(feed[0], key, 10_000)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        ops = _device_ops(fn)
        assert len(ops) == 1, (name, ops)
