"""The spatial filter's plain version (ops/cuda/spatial_cuda.py, the eager
loop that the row-scan kernel csrc/spatial.cu replaces on the card) against
the JAX package's ``lax.scan`` on the CPU, bit for bit, and the wrapper's
validation and dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu_torch.ops import filters as TF
from pointcloud_depthfusion_tpu_torch.ops.cuda import _build
from pointcloud_depthfusion_tpu_torch.ops.cuda import spatial_cuda as S


def _depth(h, w, seed, holes=0.25):
    """u16 depth in narrow bands (so that neighbours blend) with holes and
    hole runs longer than the small radii."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(1000, 1040, (h, w)) + 400 * (np.arange(w) >= w // 2)).astype(np.uint16)
    d[rng.random((h, w)) < holes] = 0
    d[h // 3, 2:w - 3] = 0
    return d


@pytest.mark.parametrize("holes_fill,magnitude", [(0, 1), (3, 2), (5, 3)])
def test_spatial_plain_matches_jax(holes_fill, magnitude):
    d = _depth(24, 20, holes_fill)
    got = S.spatial_filter_plain(torch.from_numpy(d.astype(np.int32)), 0.55, 20.0, magnitude,
                                 holes_fill)
    assert got.dtype == torch.int32
    want = JF.spatial_filter(jnp.asarray(d), 0.55, 20.0, magnitude, holes_fill=holes_fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("h,w", [(17, 20), (1, 20)])
def test_spatial_plain_matches_jax_on_disparity(h, w):
    """f32 disparity, a single row too; the input stays as it was."""
    d = _depth(h, w, 9).astype(np.float32) / 100.0
    t = torch.from_numpy(d.copy())
    got = S.spatial_filter_plain(t, 0.5, 8.0, 2, 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JF.spatial_filter(jnp.asarray(d), 0.5, 8.0, 2, 2)))
    np.testing.assert_array_equal(t.numpy(), d)


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    before = dict(S.launches)
    d = torch.from_numpy(_depth(7, 9, 1).astype(np.int32))
    for magnitude in (0, 1, 2):
        assert torch.equal(TF.spatial_filter(d, 0.55, 20.0, magnitude, 1),
                           S.spatial_filter_plain(d, 0.55, 20.0, magnitude, 1))
    for shape in ((1, 9), (7, 1)):
        line = d[:shape[0], :shape[1]].contiguous()
        assert torch.equal(S.spatial_filter(line, holes_fill=5),
                           S.spatial_filter_plain(line, holes_fill=5))
    # magnitude 0 is the conversion alone; a 1x1 plane has no step.
    assert torch.equal(S.spatial_filter(d, magnitude=0), d)
    assert torch.equal(S.spatial_filter(d[:1, :1], holes_fill=5), d[:1, :1])
    assert S.launches == before


def test_spatial_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        S.spatial_filter(torch.zeros((2, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="0..5"):
        S.spatial_filter(torch.zeros((4, 4), dtype=torch.int32), holes_fill=6)
