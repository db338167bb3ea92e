"""Kernel B6's plain versions (21-point erosion/dilation, one to four
passes, and the whole of ``filter_depth(use_morphology=True)``) and the
port's morphology against the JAX package on the CPU: the Pallas
``morph_plane`` in interpret mode, jnp ``erode``/``dilate``/``morph_open``/
``morph_close``/``filter_depth`` and the scalar oracles of
tests/oracles.py. Bit-exact everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
from pointcloud_depthfusion_tpu.ops.pallas import filters_pallas as FP
from pointcloud_depthfusion_tpu_torch.ops import filters as TF
from pointcloud_depthfusion_tpu_torch.ops.cuda import morph_cuda as B6


def _mask(kind, h, w):
    rng = np.random.default_rng(h * 131 + w + len(kind))
    if kind == "zeros":
        return np.zeros((h, w), bool)
    if kind == "ones":
        return np.ones((h, w), bool)
    if kind == "sparse":  # isolated pixels: erased by erosion, grown by dilation
        return rng.random((h, w)) > 0.93
    if kind == "lines":  # single-pixel rows and columns
        m = np.zeros((h, w), bool)
        m[h // 2, :] = True
        m[:, w // 3] = True
        return m
    return rng.random((h, w)) > 0.4


KINDS = ["random", "zeros", "ones", "sparse", "lines"]
# H or W below the element's 5: the replicate border covers the whole plane.
SHAPES = [(2, 2), (3, 7), (4, 9), (24, 40), (120, 160)]


@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_morph_plain_matches_pallas_and_jnp(h, w, kind, dilate):
    m = _mask(kind, h, w)
    got = B6.morph_plane(torch.from_numpy(m.astype(np.uint8)), dilate)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w)
    pallas = FP.morph_plane(jnp.asarray(m.astype(np.uint8)), dilate=dilate, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    jnp_op = JF.dilate if dilate else JF.erode
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp_op(jnp.asarray(m))).astype(np.uint8))
    assert B6.launches["morph_plane"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("h,w", [(1, 1), (1, 6), (6, 1)])
def test_morph_single_row_or_column_matches_jnp(h, w):
    """Planes one pixel high or wide (the Pallas kernel's shifted copies
    cannot take them, so jnp and the oracle are the references)."""
    m = _mask("random", h, w)
    for dilate, jnp_op, oracle in ((False, JF.erode, oracles.erode_oracle),
                                   (True, JF.dilate, oracles.dilate_oracle)):
        got = B6.morph_plane(torch.from_numpy(m.astype(np.uint8)), dilate).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp_op(jnp.asarray(m))).astype(np.uint8))
        np.testing.assert_array_equal(got, oracle(m).astype(np.uint8))


def test_morph_plain_takes_any_u8_values():
    """The kernel's contract is integer min/max of u8 values, like the
    Pallas kernel's int32 min/max."""
    p = np.random.default_rng(3).integers(0, 256, (17, 23)).astype(np.uint8)
    for dilate in (False, True):
        np.testing.assert_array_equal(
            B6.morph_plane(torch.from_numpy(p), dilate).numpy(),
            np.asarray(FP.morph_plane(jnp.asarray(p), dilate=dilate, interpret=True)))


@pytest.mark.parametrize("kind", ["random", "sparse", "lines"])
def test_open_close_match_jnp_and_oracle(kind):
    m = _mask(kind, 24, 40)
    t = torch.from_numpy(m)
    for name in ("erode", "dilate", "morph_open", "morph_close"):
        got = getattr(TF, name)(t)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(JF, name)(jnp.asarray(m))))
        np.testing.assert_array_equal(got.numpy(), getattr(oracles, f"{name}_oracle")(m))


# The ROIs of the first test, then ROIs on the left, top, right and bottom
# edges of the 160x120 image (the last two clipped there).
ROIS = [None, (10, 5, 50, 40), (-1, -1, -1, -1), (0, 30, 40, 50), (40, 0, 60, 30),
        (120, 40, 50, 40), (30, 90, 60, 40)]


def _filter_depth_pair(depth, roi):
    """JAX and the port (the fused call's plain version, on the CPU) on the
    same u16 depth, morphology on."""
    jd, jv = JF.filter_depth(jnp.asarray(depth), jnp.float32(0.001), jnp.float32(0.5),
                             jnp.float32(3.0), roi, use_morphology=True)
    td, tv = TF.filter_depth(torch.from_numpy(depth.astype(np.int32)),
                             torch.tensor(0.001), torch.tensor(0.5), torch.tensor(3.0), roi,
                             use_morphology=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    return td.numpy(), tv.numpy()


@pytest.mark.parametrize("roi", ROIS)
def test_filter_depth_with_morphology_bit_exact(roi):
    """Open then close the validity mask after thresholding; pixels that the
    closing turns on keep depth 0 with ``valid`` True, as in JAX."""
    rng = np.random.default_rng(11)
    depth = rng.integers(400, 3100, (120, 160)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.005] = 0  # isolated holes, filled by the closing
    depth[rng.random(depth.shape) < 0.01] = 3500  # past the window
    td, tv = _filter_depth_pair(depth, roi)
    assert (tv & (td == 0)).any()  # the reproduced quirk occurs


@pytest.mark.parametrize("h,w,roi", [(1, 1, None), (1, 6, None), (6, 1, None), (33, 31, None),
                                     (33, 31, (12, 9, 1, 1)), (33, 31, (0, 0, 31, 9))])
def test_filter_depth_morphology_small_planes_and_rois(h, w, roi):
    """Planes under the element's size, an odd shape, a 1-pixel ROI and one
    along two edges: bit-exact to JAX, and equal to the chain of four
    single passes the fused call replaces."""
    rng = np.random.default_rng(h * 100 + w)
    depth = rng.integers(400, 3100, (h, w)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.2] = 0
    td, tv = _filter_depth_pair(depth, roi)
    d = TF.filter_depth_minmax(torch.from_numpy(depth.astype(np.int32)), 0.001, 0.5, 3.0)
    m = TF.depth_validity_mask(d, roi).view(torch.uint8)
    for dilate in B6.OPEN_CLOSE:
        m = B6.morph_plane_plain(m, dilate)
    np.testing.assert_array_equal(tv, m.view(torch.bool).numpy())
    np.testing.assert_array_equal(td, torch.where(m.view(torch.bool), d, 0).numpy())


@pytest.mark.parametrize("passes", [(False, True), (True, False), (True, True, False),
                                    B6.OPEN_CLOSE])
def test_morph_passes_match_jnp_chain(passes):
    """One call of up to four passes against the chain of JAX's single
    passes, on u8 values that are not 0/1 too (integer min/max)."""
    rng = np.random.default_rng(len(passes))
    for m in (rng.random((24, 40)) > 0.4, rng.integers(0, 256, (13, 9)).astype(np.uint8)):
        want = jnp.asarray(m.astype(np.uint8))
        for dilate in passes:
            want = FP.morph_plane(want, dilate=dilate, interpret=True)
        got = B6.morph_passes(torch.from_numpy(m.astype(np.uint8)), passes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    before = dict(B6.launches)
    mask = torch.from_numpy(np.random.default_rng(2).random((9, 11)) > 0.5)
    for passes in ((False,), (True, False), B6.OPEN_CLOSE):
        want = B6.morph_passes_plain(mask.view(torch.uint8), passes)
        assert torch.equal(B6.morph_passes(mask.view(torch.uint8), passes), want)
        assert torch.equal(B6.mask_passes(mask, passes), want.view(torch.bool))
    depth = torch.from_numpy(np.random.default_rng(3).integers(0, 3000, (9, 11)))
    for dtype in (torch.int32, torch.int64, torch.int16):
        got = B6.filter_depth_open_close(depth.to(dtype), 0.001, 0.5, 3.0, (1, 2, 8, 9))
        want = B6.filter_depth_open_close_plain(depth, 0.001, 0.5, 3.0, (1, 2, 8, 9))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert B6.launches == before


def test_morph_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        B6.morph_plane(torch.zeros((4, 4), dtype=torch.int32), True)
    with pytest.raises(ValueError, match="uint8"):
        B6.morph_plane(torch.zeros((2, 4, 4), dtype=torch.uint8), True)
    plane = torch.zeros((4, 4), dtype=torch.uint8)
    for passes in ((), (True,) * 5):
        with pytest.raises(ValueError, match="passes"):
            B6.morph_passes(plane, passes)
    with pytest.raises(ValueError, match="bool mask"):
        B6.mask_passes(plane, (True,))
    for bad in (torch.zeros((4, 4)), torch.zeros((4, 4), dtype=torch.bool),
                torch.zeros((1, 4, 4), dtype=torch.int32)):
        with pytest.raises(ValueError, match="integer depth plane"):
            B6.filter_depth_open_close(bad, 0.001, 0.5, 3.0, None)
