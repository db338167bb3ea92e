"""The port's plain z-resolve (kernels B1/B2) against the JAX package's
Pallas kernels, run in the interpreter on the CPU. Bit-exact.

Inputs stay inside the contract: an entry on a real pixel never carries
zbits = INT32_MAX (the two JAX kernels disagree with each other there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops.pallas.zresolve_pallas import (
    zresolve_sorted_entries as jax_sorted_entries,
    zresolve_winner_rgb as jax_winner_rgb,
)
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

MAXI = 0x7FFFFFFF
JAX_KW = dict(tile_px=64, chunk=256, interpret=True)


def _entries(seed, n, n_px, z_range, negative_z=False):
    """Random entries with duplicate pixels, empty pixels, invalid and
    out-of-range pixel ids; invalid entries carry MAX like the render's."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, n_px - n_px // 5, n).astype(np.int32)  # top fifth stays empty
    lo = -z_range if negative_z else 1
    z = rng.integers(lo, z_range, n).astype(np.int32)
    rgb = rng.integers(0, 1 << 24, n).astype(np.int32)
    invalid = rng.random(n) < 0.15
    pix[invalid] = Z.INVALID_PIX
    z[invalid] = MAXI
    rgb[invalid] = MAXI
    pix[rng.random(n) < 0.02] = -1  # dropped, like ids past the last pixel
    return pix, z, rgb


CASES = {
    # name: (seed, n, n_px, z range, negative z)
    "ties": (0, 3001, 700, 40, False),
    "wide_z": (1, 4099, 1000, 1 << 30, False),
    "signed_z": (2, 2500, 640, 1 << 20, True),
    "dense_pixels": (3, 5000, 130, 8, False),
}


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_entries_plain_bit_exact(case):
    seed, n, n_px, zr, neg = CASES[case]
    pix, z, rgb = _entries(seed, n, n_px, zr, neg)
    assert n % JAX_KW["chunk"] != 0
    want_z, want_r = jax_sorted_entries(jnp.asarray(pix), jnp.asarray(z), jnp.asarray(rgb),
                                        n_px, **JAX_KW)
    got_z, got_r = Z.zresolve_sorted_entries(_t(pix), _t(z), _t(rgb), n_px)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert (got_z.numpy() == MAXI).any() and (got_z.numpy() != MAXI).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_entries_depth_only_bit_exact(case):
    seed, n, n_px, zr, neg = CASES[case]
    pix, z, _ = _entries(seed, n, n_px, zr, neg)
    want_z, want_2 = jax_sorted_entries(jnp.asarray(pix), jnp.asarray(z), None, n_px, **JAX_KW)
    got_z, got_2 = Z.zresolve_sorted_entries(_t(pix), _t(z), None, n_px)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_2.numpy(), np.asarray(want_2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_entries_legacy_feed_bit_exact(case):
    """B2-legacy: the JAX package's (4, N) feed through its first resolve
    kernel; the port routes the flag to the one B2 kernel."""
    seed, n, n_px, zr, neg = CASES[case]
    pix, z, rgb = _entries(seed, n, n_px, zr, neg)
    want_z, want_r = jax_sorted_entries(jnp.asarray(pix), jnp.asarray(z), jnp.asarray(rgb),
                                        n_px, legacy_feed=True, **JAX_KW)
    got_z, got_r = Z.zresolve_sorted_entries(_t(pix), _t(z), _t(rgb), n_px, legacy_feed=True)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    same = Z.zresolve_sorted_entries(_t(pix), _t(z), _t(rgb), n_px)
    assert all(torch.equal(a, b) for a, b in zip(same, (got_z, got_r)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_winner_rgb_plain_bit_exact(case):
    seed, n, n_px, zr, neg = CASES[case]
    pix, z, rgb = _entries(seed, n, n_px, zr, neg)
    want = jax_winner_rgb(jnp.asarray(pix), jnp.asarray(z), jnp.asarray(rgb), n_px, **JAX_KW)
    got = Z.zresolve_winner_rgb(_t(pix), _t(z), _t(rgb), n_px)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), Z.zresolve_winner_rgb_plain(
        _t(pix), _t(z), _t(rgb), n_px).numpy())


def test_tie_break_and_empty_by_hand():
    pix = np.array([2, 2, 2, 0, Z.INVALID_PIX, 5], np.int32)
    z = np.array([7, 7, 9, -3, MAXI, 1], np.int32)
    rgb = np.array([30, 20, 10, 5, MAXI, 8], np.int32)
    minz, mrgb = Z.zresolve_sorted_entries(_t(pix), _t(z), _t(rgb), 4)
    assert minz.tolist() == [-3, MAXI, 7, MAXI]
    assert mrgb.tolist() == [5, MAXI, 20, MAXI]


def test_cpu_wrappers_use_plain_and_count_no_launch():
    before = dict(Z.launches)
    pix, z, rgb = _entries(9, 600, 100, 50)
    Z.zresolve_winner_rgb(_t(pix), _t(z), _t(rgb), 100)
    Z.zresolve_sorted_entries(_t(pix), _t(z), None, 100)
    Z.zresolve_sorted_entries(_t(pix), _t(z), _t(rgb), 100, legacy_feed=True)
    assert Z.launches == before


def test_wrappers_reject_bad_inputs():
    pix = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        Z.zresolve_sorted_entries(pix, torch.zeros(4, dtype=torch.int64), None, 8)
    with pytest.raises(ValueError):
        Z.zresolve_winner_rgb(pix, pix, pix[:3], 8)
    with pytest.raises(ValueError):
        Z.zresolve_winner_rgb(pix, pix, None, 8)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        Z.zresolve_winner_rgb(meta, meta, meta, 8)
