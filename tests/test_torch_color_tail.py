"""The fused frame's color tail, kernel B4's image kernel (plain versions on
the CPU), against the JAX package: the packed winner decoded and filtered
in one call. Bit-exact. (test_torch_filters.py holds the u8 channel
forms against JAX.) Also the coverage sentinel the tail relies on, and
``run_deployment(cpu=True)``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu.ops import render as JR
from pointcloud_depthfusion_tpu.ops.pallas import filters_pallas as FP
from pointcloud_depthfusion_tpu_torch.nodes import launch as TL
from pointcloud_depthfusion_tpu_torch.ops.cuda import filters_cuda as B4
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

INT32_MAX = 0x7FFFFFFF
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _winners(h, w, seed):
    """Packed r<<16|g<<8|b winners with uncovered pixels (INT32_MAX) and
    channel values that tie the Gauss's rounding often."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h * w, 3))
    ties = rng.random(h * w) < 0.3
    rgb[ties] = rng.integers(0, 2, (int(ties.sum()), 3))
    mrgb = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]).astype(np.int32)
    mrgb[rng.random(h * w) < 0.2] = INT32_MAX
    return mrgb


def _jax_tail(mrgb, h, w, mode, pallas):
    covered = jnp.asarray(mrgb != INT32_MAX)
    planes = [p.reshape(h, w) for p in JR.decode_winner_planes(covered, jnp.asarray(mrgb))]
    if mode is None:
        return np.asarray(jnp.stack(planes, -1))
    if pallas:
        return np.asarray(FP.filter_color_pallas(jnp.stack(planes, -1), mode == "median",
                                                 interpret=True))
    return np.asarray(JF.filter_color_planar(*planes, mode == "median"))


# The Pallas kernel slices its taps and fails on a plane one pixel wide
# (5×1), so there the reference is XLA's filter_color_planar alone.
@pytest.mark.parametrize("mode", ["gauss", "median", None])
@pytest.mark.parametrize("h,w", [(8, 8), (7, 13), (2, 5), (5, 1)])
def test_winner_image_matches_jax(h, w, mode):
    mrgb = _winners(h, w, h * 100 + w)
    got = B4.winner_image(torch.from_numpy(mrgb), h, w, mode).numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax_tail(mrgb, h, w, mode, pallas=False))
    if mode is not None and w > 1:
        np.testing.assert_array_equal(got, _jax_tail(mrgb, h, w, mode, pallas=True))


def test_winner_image_batches_images_apart():
    """A (B, H·W) batch filters each image on its own: no bleed across the
    boundary between two stacked images."""
    h, w = 6, 9
    mrgb = np.stack([_winners(h, w, s) for s in (1, 2)])
    got = B4.winner_image(torch.from_numpy(mrgb), h, w, "gauss")
    assert got.shape == (2, h, w, 3)
    for b in range(2):
        assert torch.equal(got[b], B4.winner_image(torch.from_numpy(mrgb[b]), h, w, "gauss"))


def test_image_wrappers_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="int32"):
        B4.winner_image(torch.zeros(12, dtype=torch.int64), 3, 4)
    with pytest.raises(ValueError, match="int32"):
        B4.winner_image(torch.zeros(11, dtype=torch.int32), 3, 4)
    with pytest.raises(ValueError, match="mode"):
        B4.winner_image(torch.zeros(12, dtype=torch.int32), 3, 4, "box")
    plane = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one shape"):
        B4.planes_image([plane, plane, torch.zeros((4, 3), dtype=torch.uint8)])
    with pytest.raises(ValueError, match="expected 3"):
        B4.planes_image([plane] * 4)
    with pytest.raises(ValueError, match="uint8 image"):
        B4.interleaved_image(torch.zeros((3, 4, 5), dtype=torch.uint8))


def test_winner_alone_marks_coverage_with_the_zbuffer():
    """The z-buffer resolve (B2's plain version) leaves the winner's rgb at
    INT32_MAX exactly where the min z is: the tail decodes coverage from
    the winner alone on every tiled path."""
    rng = np.random.default_rng(5)
    n, n_px = 4000, 900
    pix = rng.integers(-3, n_px + 3, n).astype(np.int32)
    ok = rng.random(n) > 0.2
    z = rng.integers(1, 1 << 30, n).astype(np.int32)
    z[rng.random(n) < 0.3] = 7  # z ties
    rgb = rng.integers(0, 1 << 24, n).astype(np.int32)
    pix[~ok] = Z.INVALID_PIX
    z[~ok], rgb[~ok] = INT32_MAX, INT32_MAX
    minz, mrgb = Z.zresolve_sorted_entries(*(torch.from_numpy(a) for a in (pix, z, rgb)), n_px)
    assert bool(((minz == INT32_MAX) == (mrgb == INT32_MAX)).all())
    assert 0 < int((mrgb == INT32_MAX).sum()) < n_px


def test_run_deployment_accepts_cpu_flag():
    """The JAX package's ``run_deployment(manifest, cpu=True)``: the same
    run as ``device="cpu"``; with a card device it raises."""
    manifest = TL.load_manifest(os.path.join(REPO, "configs", "deployment_dual.yaml"))
    m = dict(manifest, width=48, height=32, registration={"every_n_frames": 0}, viewer={})
    by_flag = TL.run_deployment(m, cpu=True, frames=2)
    by_device = TL.run_deployment(m, device="cpu", frames=2)
    for s in (by_flag, by_device):
        s.pop("wall_s")
    assert by_flag == by_device
    assert by_flag["device"] == "cpu" and by_flag["frames"] == 2
    with pytest.raises(ValueError, match="cpu=True"):
        TL.run_deployment(m, cpu=True, device="cuda", frames=1)
    with pytest.raises(TypeError, match="bool"):
        TL.run_deployment(m, "cuda")  # a device where cpu goes
