"""The rest of the port's depth filters (ROADMAP A10) against the JAX
package op by op and the scalar oracles of tests/oracles.py, on the CPU;
and the port's numpy host filters against the JAX package's.

Bit-exact everywhere but two places, each stated where it is tested: the
bilateral filter against x64 JAX, and the spatial filter on f32 disparity
against the f64-free oracle (the JAX test's own bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu.ops import host_filters as JHF
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.ops import filters as TF
from pointcloud_depthfusion_tpu_torch.ops import host_filters as THF


def _depth(h, w, seed, holes=0.15, lo=500, hi=3000):
    rng = np.random.default_rng(seed)
    d = rng.integers(lo, hi, (h, w)).astype(np.uint16)
    d[rng.random((h, w)) < holes] = 0
    return d


def _t(d):
    return torch.from_numpy(d.astype(np.int32))


def test_mask_count():
    m = np.random.default_rng(0).random((30, 40)) > 0.3
    got = TF.mask_count(torch.from_numpy(m))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(JF.mask_count(jnp.asarray(m))) == int(m.sum())


def test_temporal_filter_bit_exact():
    rng = np.random.default_rng(1)
    cur = rng.integers(0, 1000, (24, 32)).astype(np.uint16)
    prev = (cur.astype(np.int32) + rng.integers(-30, 30, cur.shape)).clip(0, 65535).astype(np.uint16)
    cur[0, :3] = 0
    prev[1, :3] = 0
    cur[2, :4] = [10, 11, 12, 13]  # x.5 blends: 0.4·c + 0.6·p, rounded half to even
    prev[2, :4] = [15, 16, 12, 18]
    for persistence in (True, False):
        got, hist = TF.temporal_filter(_t(cur), _t(prev), persistence=persistence)
        want, _ = JF.temporal_filter(jnp.asarray(cur), jnp.asarray(prev), persistence=persistence)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert hist is got
    got, _ = TF.temporal_filter(_t(cur), _t(prev))
    np.testing.assert_array_equal(got.numpy(), oracles.temporal_filter_oracle(cur, prev))


@pytest.mark.parametrize("mode", ["left", "farthest", "nearest"])
def test_hole_fill_bit_exact(mode):
    d = _depth(20, 24, 2, holes=0.3)
    d[:, 0] = 0  # rows whose first pixels have nothing to their left
    d[5, :] = 0  # an all-hole row
    got = TF.hole_fill(_t(d), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.hole_fill(jnp.asarray(d), mode)))
    np.testing.assert_array_equal(THF.hole_fill_np(d, mode), JHF.hole_fill_np(d, mode))
    with pytest.raises(ValueError, match="unknown"):
        TF.hole_fill(_t(d), "middle")


@pytest.mark.parametrize("m", [1, 2, 4])
def test_decimation_bit_exact(m):
    d = _depth(24, 32, 3, holes=0.4, lo=0)
    d[:4, :4] = 0  # all-hole blocks
    got = TF.decimation_filter(_t(d), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.decimation_filter(jnp.asarray(d), m)))
    if m > 1:
        np.testing.assert_array_equal(got.numpy(), oracles.decimation_filter_oracle(d, m))
        np.testing.assert_array_equal(THF.decimation_filter_np(d, m), JHF._decimation_filter_numpy(d, m))
    with pytest.raises(ValueError, match="divisible"):
        TF.decimation_filter(_t(d[:, :31]), 2)


def test_decimate_intrinsics():
    kw = dict(fx=631.0, fy=632.0, ppx=424.0, ppy=241.0, coeffs=(0.1, -0.02, 0.0, 0.001, 0.0))
    for m in (1, 2, 3):
        ti = TF.decimate_intrinsics(TIntr.create(848, 480, device="cpu", **kw), m)
        ji = JF.decimate_intrinsics(JIntr.create(848, 480, **kw), m)
        assert (ti.width, ti.height) == (ji.width, ji.height)
        for f in ("fx", "fy", "ppx", "ppy"):
            assert float(getattr(ti, f)) == float(getattr(ji, f)), (m, f)
        np.testing.assert_array_equal(ti.coeffs.numpy(), np.asarray(ji.coeffs))


@pytest.mark.parametrize("holes_fill", [0, 1, 3, 5])
def test_spatial_filter_bit_exact(holes_fill):
    """The scan becomes a loop over columns and rows; held bit for bit to
    the oracle (f32 blends, half-up rounding) and to JAX's scan."""
    d = _depth(12, 40, 4, holes=0.3)
    d[3, 5:30] = 0  # a hole run longer than the small radii
    got = TF.spatial_filter(_t(d), 0.55, 20.0, 2, holes_fill=holes_fill)
    assert got.dtype == torch.int32
    want = oracles.spatial_filter_oracle(d, 0.55, 20.0, 2, holes_fill=holes_fill)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JF.spatial_filter(jnp.asarray(d), 0.55, 20.0, 2, holes_fill=holes_fill)))
    np.testing.assert_array_equal(THF.spatial_filter_np(d, 0.55, 20.0, 2, holes_fill), want)


def test_spatial_filter_tie_rounding_and_float_domain():
    # Raw depths <= 20: exact x.5 blends in f32 (0.55·1 + 0.45·11 = 5.5 → 6).
    d = np.random.default_rng(5).integers(0, 25, (16, 20)).astype(np.uint16)
    d[0, :2] = [11, 1]
    np.testing.assert_array_equal(TF.spatial_filter(_t(d)).numpy(),
                                  oracles.spatial_filter_oracle(d).astype(np.int32))
    disp = (np.random.default_rng(6).random((10, 12)) * 50 + 10).astype(np.float32)
    disp[np.random.default_rng(7).random((10, 12)) < 0.2] = 0.0
    got = TF.spatial_filter(torch.from_numpy(disp), 0.5, 8.0, 1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(JF.spatial_filter(jnp.asarray(disp), 0.5, 8.0, 1)))
    # The oracle's bound from the JAX test (tests/test_filters.py:204).
    np.testing.assert_allclose(got, oracles.spatial_filter_oracle(disp, 0.5, 8.0, 1),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("holes_fill", [-1, 6])
def test_spatial_holes_fill_out_of_range_raises(holes_fill):
    d = _t(_depth(4, 6, 0))
    with pytest.raises(ValueError, match="0..5"):
        TF.spatial_filter(d, holes_fill=holes_fill)
    with pytest.raises(ValueError, match="0..5"):
        THF.spatial_filter_np(d.numpy().astype(np.uint16), holes_fill=holes_fill)
    assert [TF.spatial_holes_radius(k, 40) for k in range(6)] == [0, 2, 4, 8, 16, 40]


def test_disparity_transforms_bit_exact():
    d = _depth(20, 24, 8, holes=0.1, lo=300, hi=6000)
    for fx in (631.0, torch.tensor(315.5)):
        disp = TF.depth_to_disparity(_t(d), 0.001, fx, 0.095)
        jdisp = JF.depth_to_disparity(jnp.asarray(d), 0.001, float(fx), 0.095)
        assert disp.dtype == torch.float32
        np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
        back = TF.disparity_to_depth(disp, 0.001, fx, 0.095)
        np.testing.assert_array_equal(back.numpy(), np.asarray(JF.disparity_to_depth(
            jdisp, 0.001, float(fx), 0.095)))
        np.testing.assert_array_equal(back.numpy() == 0, d == 0)
        np.testing.assert_array_equal(disp.numpy(), THF.depth_to_disparity_np(d, 0.001, float(fx)))
        np.testing.assert_array_equal(back.numpy(),
                                      THF.disparity_to_depth_np(disp.numpy(), 0.001, float(fx)))


def _bilateral_f32_numpy(d, radius, val_sq=9_000_000.0, pos_sq=10_000.0):
    """A numpy f32 transcription of the JAX loop as production JAX (no x64)
    computes it: spatial weight rounded to f32, f32 sums."""
    h, w = d.shape
    x = d.astype(np.float32)
    p = np.pad(x, radius, mode="edge")
    num = np.zeros((h, w), np.float32)
    den = np.zeros((h, w), np.float32)
    k = 2 * radius + 1
    for dy in range(k):
        for dx in range(k):
            win = p[dy:dy + h, dx:dx + w]
            wg = np.float32(np.exp(-((dy - radius) ** 2 + (dx - radius) ** 2) / (2.0 * pos_sq)))
            wgt = wg * np.exp(-((win - x) ** 2) / np.float32(2.0 * val_sq))
            num = num + wgt * win
            den = den + wgt
    out = num / np.maximum(den, np.float32(1e-12))
    return np.clip(np.rint(out), 0, 65535).astype(np.int32)


def test_bilateral_f32_and_against_x64_jax():
    """f32 accumulation, as JAX computes without x64. The test session runs
    JAX with x64 on (tests/conftest.py), where the numpy f64 spatial weight
    makes JAX's sums f64: against that, ±1 raw unit on at most 1% of pixels
    (4.5e-4 measured at radius 10); against the f32 transcription, bit for
    bit."""
    d = _depth(40, 56, 5, holes=0.1)
    for radius in (2, 10):
        got = TF.bilateral_filter_depth(_t(d), radius=radius).numpy()
        np.testing.assert_array_equal(got, _bilateral_f32_numpy(d, radius))
        want = np.asarray(JF.bilateral_filter_depth(jnp.asarray(d), radius=radius)).astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (radius, diff.max(), (diff > 0).mean())


def test_host_threshold_filter_matches_jax():
    d = _depth(16, 20, 9, holes=0.1, lo=0, hi=4000)
    for lo, hi in ((0.0, 2.0), (0.6, 1.2)):
        np.testing.assert_array_equal(THF.threshold_filter_np(d, 0.001, lo, hi),
                                      JHF.threshold_filter_np(d, 0.001, lo, hi))
