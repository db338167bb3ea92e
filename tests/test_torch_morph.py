"""Kernel B6's plain version (21-point erosion/dilation) and the port's
morphology against the JAX package on the CPU: the Pallas ``morph_plane``
in interpret mode, jnp ``erode``/``dilate``/``morph_open``/``morph_close``
and the scalar oracles of tests/oracles.py. Bit-exact everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_depthfusion_tpu.ops import filters as JF
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


ROIS = [None, (10, 5, 50, 40), (-1, -1, -1, -1)]


@pytest.mark.parametrize("roi", ROIS)
def test_filter_depth_with_morphology_bit_exact(roi):
    """Open then close the validity mask after thresholding; pixels that the
    closing turns on keep depth 0 with ``valid`` True, as in JAX."""
    rng = np.random.default_rng(11)
    depth = rng.integers(400, 3100, (120, 160)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.005] = 0  # isolated holes, filled by the closing
    jd, jv = JF.filter_depth(jnp.asarray(depth), jnp.float32(0.001), jnp.float32(0.5),
                             jnp.float32(3.0), roi, use_morphology=True)
    td, tv = TF.filter_depth(torch.from_numpy(depth.astype(np.int32)),
                             torch.tensor(0.001), torch.tensor(0.5), torch.tensor(3.0), roi,
                             use_morphology=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tv.numpy() & (td.numpy() == 0)).any()  # the reproduced quirk occurs


def test_morph_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        B6.morph_plane(torch.zeros((4, 4), dtype=torch.int32), True)
    with pytest.raises(ValueError, match="uint8"):
        B6.morph_plane(torch.zeros((2, 4, 4), dtype=torch.uint8), True)
