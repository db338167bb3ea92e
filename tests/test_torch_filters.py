"""The port's plain 3×3 color filters (kernel B4) and depth filter against
the JAX package on the CPU. Bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu.ops.pallas import filters_pallas as FP
from pointcloud_depthfusion_tpu_torch.ops import filters as TF
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4


def _plane(kind, h, w):
    rng = np.random.default_rng(h * 1000 + w + len(kind))
    if kind == "random":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "zeros":
        return np.zeros((h, w), np.uint8)
    if kind == "full":
        return np.full((h, w), 255, np.uint8)
    # Values in {0, 1}: the 3×3 sum is 8 (an exact x.5 after /16) often.
    return rng.integers(0, 2, (h, w)).astype(np.uint8)


SHAPES = [(3, 3), (120, 160)]
KINDS = ["random", "zeros", "full", "ties"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_gauss_plain_bit_exact(kind, h, w):
    p = _plane(kind, h, w)
    got = B4.gauss3x3_plane(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(FP.gauss3x3_plane(jnp.asarray(p), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(JF.gauss_filter(jnp.asarray(p), 3)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_median_plain_bit_exact(kind, h, w):
    p = _plane(kind, h, w)
    got = B4.median3x3_plane(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(FP.median3x3_plane(jnp.asarray(p), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(JF.median_filter(jnp.asarray(p), 1)))


def test_tie_planes_hold_ties():
    p = _plane("ties", 120, 160).astype(np.int32)
    s = sum(w * p[dy:118 + dy, dx:158 + dx]
            for (dy, dx), w in zip([(a, b) for a in range(3) for b in range(3)],
                                   [1, 2, 1, 2, 4, 2, 1, 2, 1]))
    assert (s % 16 == 8).sum() > 100


@pytest.mark.parametrize("use_median", [False, True])
def test_filter_color_planar_and_hwc(use_median):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    planes = [img[..., c] for c in range(3)]
    want = np.asarray(JF.filter_color_planar(*map(jnp.asarray, planes), use_median))
    got = TF.filter_color_planar(*(torch.from_numpy(np.ascontiguousarray(p)) for p in planes),
                                 use_median)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TF.filter_color(torch.from_numpy(img), use_median).numpy(),
                                  np.asarray(JF.filter_color(jnp.asarray(img), use_median)))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 5), (5, 2)])
def test_degenerate_planes_pass_through(h, w):
    p = _plane("random", h, w)
    np.testing.assert_array_equal(TF.gauss_filter(torch.from_numpy(p)).numpy(),
                                  np.asarray(JF.gauss_filter(jnp.asarray(p), 3)))
    np.testing.assert_array_equal(TF.median_filter(torch.from_numpy(p)).numpy(),
                                  np.asarray(JF.median_filter(jnp.asarray(p), 1)))


@pytest.mark.parametrize("size", [3, 5])
def test_general_gauss_and_median_bit_exact(size):
    """The cases outside B4 (u16 depth, 5×5, radius 2, ``interior_roi=False``)
    run plain PyTorch: bit-exact to JAX. The Gauss is exact in f32 up to the
    5×5 u16 case, so half-up rounding is NPP's."""
    rng = np.random.default_rng(size)
    depth = rng.integers(0, 65536, (40, 56)).astype(np.uint16)
    depth[0, :8] = [65535, 65535, 0, 1, 2, 65535, 7, 8]
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    for a in (depth, img):
        t = torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16 else a)
        for interior in (True, False):
            got = TF.gauss_filter(t, size, interior_roi=interior)
            assert got.dtype == t.dtype
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(JF.gauss_filter(jnp.asarray(a), size, interior)))
            got = TF.median_filter(t, size // 2, interior_roi=interior)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(JF.median_filter(jnp.asarray(a), size // 2, interior)))


ROIS = [None, (10, 5, 50, 40), (100, 80, 200, 200), (-1, -1, -1, -1), (5, -3, -1, 20)]
WINDOWS = [(0.001, 0.5, 3.0), (0.00025, 0.3, 4.7), (0.001, 0.0, 65.535)]


@pytest.mark.parametrize("roi", ROIS)
@pytest.mark.parametrize("window", WINDOWS)
def test_filter_depth_bit_exact(roi, window):
    scale, lo, hi = window
    rng = np.random.default_rng(7)
    depth = rng.integers(0, 20000, (120, 160)).astype(np.uint16)
    # Values around the truncated thresholds (0.5/0.001 is 499.99997 in f32).
    depth.ravel()[:12] = [0, 498, 499, 500, 501, 2999, 3000, 3001, 1199, 1200, 18800, 65535]
    jd, jv = JF.filter_depth(jnp.asarray(depth), jnp.float32(scale),
                             jnp.float32(lo), jnp.float32(hi), roi)
    td, tv = TF.filter_depth(torch.from_numpy(depth.astype(np.int32)),
                             torch.tensor(scale, dtype=torch.float32),
                             torch.tensor(lo, dtype=torch.float32), hi, roi)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(TF.roi_mask(120, 160, roi).numpy(),
                                  np.asarray(JF.roi_mask(120, 160, roi)))


def test_minmax_threshold_truncates_to_499():
    d = torch.tensor([[498, 499, 500]], dtype=torch.int32)
    out = TF.filter_depth_minmax(d, torch.tensor(0.001), torch.tensor(0.5), torch.tensor(3.0))
    assert out.tolist() == [[0, 499, 500]]
