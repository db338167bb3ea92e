"""The port's plain z-resolve (kernels B1/B2/B7) against the JAX package's
Pallas kernels, run in the interpreter on the CPU. Bit-exact.

Inputs stay inside the contract: an entry on a real pixel never carries
zbits = INT32_MAX (the two JAX kernels disagree with each other there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops.pallas.zresolve_pallas import (
    zresolve_sorted_entries as jax_sorted_entries,
    zresolve_sorted_streams as jax_sorted_streams,
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
    # The same entries as a masked feed: ok off on the invalid ones, which
    # carry pixel ids inside the image there.
    ok = pix != Z.INVALID_PIX
    idx = np.where(ok, pix, np.arange(n, dtype=np.int32) % n_px)
    feed = (_t(idx), _t(z.view(np.float32)), _t(ok), _t(rgb))
    m_r, m_z = Z.zresolve_masked(*feed, n_px, True)
    assert torch.equal(m_z, got_z) and torch.equal(m_r, got_r)


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


def _masked_feed(seed, n, n_px, z_range, negative_z, mask):
    """A masked feed (idx, z bits, ok, rgb24) and, beside it, the JAX API's
    entries it stands for (INVALID_PIX and MAX where ``ok`` is off). The
    entries that ``ok`` drops carry pixel ids inside the image, so a mask
    that went unread would show."""
    rng = np.random.default_rng(seed + 1000)
    idx = rng.integers(0, n_px - n_px // 5, n).astype(np.int32)
    idx[rng.random(n) < 0.02] = -1
    z = rng.integers(-z_range if negative_z else 1, z_range, n).astype(np.int32)
    rgb = rng.integers(0, 1 << 24, n).astype(np.int32)
    ok = np.full(n, mask == "all_on")
    entries = (np.where(ok, idx, Z.INVALID_PIX).astype(np.int32), np.where(ok, z, MAXI),
               np.where(ok, rgb, MAXI))
    return (idx, z, ok, rgb), entries


@pytest.mark.parametrize("mask", ["all_off", "all_on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_feed_plain_bit_exact(case, mask):
    """The masked feed (the render's own entries, masked in the kernel) on
    the CPU with every entry off and every entry on: bit for bit the JAX
    package's resolve of the masked entries, and the unmasked plain
    version's. (A mixed mask: test_sorted_entries_plain_bit_exact.)"""
    seed, n, n_px, zr, neg = CASES[case]
    (idx, z, ok, rgb), entries = _masked_feed(seed, n, n_px, zr, neg, mask)
    want_z, want_r = jax_sorted_entries(*(jnp.asarray(a) for a in entries), n_px, **JAX_KW)
    feed = (_t(idx), _t(z.view(np.float32)), _t(ok), _t(rgb))
    got_r, got_z = Z.zresolve_masked(*feed, n_px, True)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    image_only, none = Z.zresolve_masked(*feed, n_px, False)
    assert none is None and torch.equal(image_only, got_r)
    plain = Z.zresolve_sorted_entries_plain(*(_t(a) for a in entries), n_px)
    assert torch.equal(plain[0], got_z) and torch.equal(plain[1], got_r)
    assert all(torch.equal(a, _t(b)) for a, b in zip(Z.masked_entries(*feed), entries))
    assert (got_r.numpy() == MAXI).all() == (mask == "all_off")


STREAM_CASES = {
    # name: (seed, streams S, entries per stream N, n_px, z range)
    "one_stream": (4, 1, 900, 300, 30),
    "three_streams": (5, 3, 500, 400, 30),
}


@pytest.mark.parametrize("with_rgb", [True, False], ids=["rgb", "depth_only"])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_sorted_streams_plain_bit_exact(case, with_rgb):
    """B7: (S, N) streams, each with duplicate pixels, z ties broken by rgb,
    empty pixels, invalid entries and pixel ids past n_px, against the JAX
    multi-stream kernel."""
    seed, s, n, n_px, zr = STREAM_CASES[case]
    pix, z, rgb = _entries(seed, s * n, n_px, zr)
    rng = np.random.default_rng(seed + 100)
    past = rng.random(s * n) < 0.03
    pix[past] = n_px + rng.integers(0, 200, int(past.sum()))  # beyond n_px, inside and past the pad
    pix, z, rgb = (a.reshape(s, n) for a in (pix, z, rgb))
    r = rgb if with_rgb else None
    want_z, want_r = jax_sorted_streams(jnp.asarray(pix), jnp.asarray(z),
                                        None if r is None else jnp.asarray(r), n_px,
                                        tile_px=128, chunk=256, interpret=True)
    got_z, got_r = Z.zresolve_sorted_streams(_t(pix), _t(z), None if r is None else _t(r), n_px)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    flat = Z.zresolve_sorted_entries(_t(pix.reshape(-1)), _t(z.reshape(-1)),
                                     None if r is None else _t(r.reshape(-1)), n_px)
    assert all(torch.equal(a, b) for a, b in zip(flat, (got_z, got_r)))
    assert (got_z.numpy() == MAXI).any() and (got_z.numpy() != MAXI).any()


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
    Z.zresolve_sorted_streams(_t(pix).reshape(3, 200), _t(z).reshape(3, 200),
                              _t(rgb).reshape(3, 200), 100)
    feed = (_t(pix), _t(z).view(torch.float32), _t(pix) >= 0, _t(rgb))
    Z.zresolve_masked(*feed, 100, True)
    Z.zresolve_masked(*(t.reshape(3, 200) for t in feed), 100, False)
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
    streams = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(S, N\) int32"):
        Z.zresolve_sorted_streams(pix, pix, None, 8)
    with pytest.raises(ValueError, match=r"\(S, N\) int32"):
        Z.zresolve_sorted_streams(streams, streams, streams[:1], 8)
    with pytest.raises(ValueError, match="contiguous"):
        Z.zresolve_sorted_streams(streams, streams.t().contiguous().t(), None, 8)


def test_masked_feed_rejects_what_it_does_not_take():
    """The masked feed takes idx int32, z float32, ok bool and rgb24 int32
    of one shape, contiguous, on one device, and converts none of them."""
    idx, rgb = torch.zeros(6, dtype=torch.int32), torch.zeros(6, dtype=torch.int32)
    z, ok = torch.zeros(6), torch.ones(6, dtype=torch.bool)
    cases = [
        ((idx.long(), z, ok, rgb), r"idx: expected \(N,\) int32"),
        ((idx, z.view(torch.int32), ok, rgb), r"z: expected \(N,\) float32"),
        ((idx, z.double(), ok, rgb), r"z: expected \(N,\) float32"),
        ((idx, z, ok.to(torch.uint8), rgb), r"ok: expected \(N,\) bool"),
        ((idx, z, ok, rgb[:5]), r"rgb24: expected \(N,\) int32 of \(6,\)"),
        ((idx, z, ok, torch.zeros(12, dtype=torch.int32)[::2]), "contiguous"),
        ((idx.reshape(1, 2, 3), z.reshape(1, 2, 3), ok.reshape(1, 2, 3), rgb.reshape(1, 2, 3)),
         r"\(N,\)"),
        ((idx.reshape(2, 3), z, ok, rgb), r"z: expected \(S, N\) float32 of \(2, 3\)"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            Z.zresolve_masked(*args, 8, True)
    with pytest.raises(ValueError, match="needs rgb24"):
        Z.zresolve_masked(idx, z, ok, None, 8, True)
    meta = [t.to("meta") for t in (idx, z, ok, rgb)]
    with pytest.raises(ValueError, match="unsupported device"):
        Z.zresolve_masked(*meta, 8, False)
    with pytest.raises(ValueError, match="on meta"):
        Z.zresolve_masked(idx, z, ok, rgb.to("meta"), 8, False)
