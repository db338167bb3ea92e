"""The port's plain fused prep (kernel B3) against the JAX package's Pallas
kernel run in the interpreter, on the scene of tests/test_pallas_prep.py.

The bar is that test's own: indices equal; keys equal except on fewer than
1e-3 of pixels, where the color bits are equal and zq differs by one step
(the Pallas kernel may contract a multiply-add that the op-by-op order
rounds twice). The port's plain version and its kernel share one op order
and are held bit for bit against each other on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Distortion
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.ops.pallas.fuse_prep_pallas import (
    fuse_prep_pallas,
    largest_tile_rows as j_largest_tile_rows,
)
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3

F32 = jnp.float32
COEFFS = (0.11, -0.23, 0.0021, -0.0017, 0.045)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intr(w, h, fx, fy, model=Distortion.NONE, coeffs=(0.0,) * 5):
    kw = dict(fx=fx, fy=fy, ppx=w / 2, ppy=h / 2, model=model, coeffs=coeffs)
    return JIntr.create(w, h, **kw), TIntr.create(w, h, device="cpu", **kw)


def _pose():
    t = np.eye(4, dtype=np.float32)
    a = 0.12
    t[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    t[:3, 3] = [0.2, -0.05, 0.1]
    return t


def _frame(ti, noise=0.002):
    _, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    return SyntheticScene().render(ti, wr, depth_noise_std=noise)


def _both(fs, t, src, dst, mirror, tile_rows=None):
    """(JAX Pallas in the interpreter, port plain) (idx, key as uint32)."""
    (ji, ti), (jd, td) = src, dst
    j_idx, j_key = fuse_prep_pallas(
        jnp.asarray(fs.depth), jnp.asarray(fs.color), jnp.asarray(0.001, F32),
        jnp.asarray(0.5, F32), jnp.asarray(3.0, F32), ji, jnp.asarray(t), jd, mirror,
        jnp.asarray(0.25, F32), jnp.asarray(4.0, F32), tile_rows=tile_rows, interpret=True)
    t_idx, t_key = B3.fuse_prep(
        torch.from_numpy(fs.depth.astype(np.int32)), torch.from_numpy(fs.color),
        torch.tensor(0.001), torch.tensor(0.5), torch.tensor(3.0), ti, torch.from_numpy(t),
        td, mirror, torch.tensor(0.25), torch.tensor(4.0), tile_rows=tile_rows)
    return (np.asarray(j_idx), np.asarray(j_key)), (t_idx.numpy(), t_key.numpy().view(np.uint32))


def _assert_prep_bar(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    diff = got[1] != want[1]
    assert diff.mean() < 1e-3, diff.mean()
    a, b = got[1][diff].astype(np.int64), want[1][diff].astype(np.int64)
    assert ((a & 0x3FFFF) == (b & 0x3FFFF)).all()
    assert (np.abs((a >> 18) - (b >> 18)) <= 1).all()
    return int(diff.sum())


@pytest.fixture(scope="module")
def scene():
    src = _intr(128, 64, 95.0, 96.0)
    return src, _frame(src[1]), _pose()


@pytest.mark.parametrize("mirror", [False, True])
def test_prep_plain_matches_pallas_kernel(scene, mirror):
    src, fs, t = scene
    before = dict(B3.launches)
    want, got = _both(fs, t, src, src, mirror, tile_rows=32)
    flips = _assert_prep_bar(want, got)
    print(f"mirror={mirror}: keys off by one zq step on {flips} of {got[1].size} pixels")
    assert B3.launches == before
    assert got[0].dtype == np.int32 and got[0].shape == (64, 128)
    ok = got[1] != 0xFFFFFFFF
    assert 0.3 < ok.mean() < 1.0
    np.testing.assert_array_equal(got[0] == 128 * 64, ~ok)


def test_prep_plain_against_other_target_and_window(scene):
    """Another target camera (a vertical, narrower virtual view) and the
    wrapper's plain version called directly."""
    src, fs, t = scene
    dst = _intr(64, 128, 50.0, 48.0)
    want, got = _both(fs, t, src, dst, True)
    _assert_prep_bar(want, got)
    args = (torch.from_numpy(fs.depth.astype(np.int32)), torch.from_numpy(fs.color),
            torch.tensor(0.001), torch.tensor(0.5), torch.tensor(3.0), src[1],
            torch.from_numpy(t), dst[1], True, torch.tensor(0.25), torch.tensor(4.0))
    plain = B3.fuse_prep_plain(*args)
    assert np.array_equal(plain[0].numpy(), got[0])
    assert np.array_equal(plain[1].numpy().view(np.uint32), got[1])


def test_prep_is_pinhole_like_the_pallas_kernel():
    """Inverse Brown-Conrady intrinsics: both kernels deproject pinhole
    (a reference quirk the port keeps)."""
    src = _intr(128, 64, 95.0, 96.0, Distortion.INVERSE_BROWN_CONRADY, COEFFS)
    fs = _frame(_intr(128, 64, 95.0, 96.0)[1])
    want, got = _both(fs, _pose(), src, src, False)
    _assert_prep_bar(want, got)
    pinhole = _both(fs, _pose(), _intr(128, 64, 95.0, 96.0), src, False)[1]
    assert np.array_equal(pinhole[0], got[0]) and np.array_equal(pinhole[1], got[1])


def test_prep_whole_plane_fallback_height_and_tile_validation():
    """test_pallas_prep.py:98-127: a 36-row frame has no multiple-of-8
    divisor and runs as one tile; a tile that does not divide raises."""
    assert B3.largest_tile_rows(36) == j_largest_tile_rows(36) == 36
    for h in (480, 720, 64, 8, 7):
        assert B3.largest_tile_rows(h) == j_largest_tile_rows(h)
    src = _intr(64, 36, 50.0, 50.0)
    fs = SyntheticScene().render(src[1], two_camera_rig(baseline=0.4, toe_in_deg=6.0)[1])
    eye = np.eye(4, dtype=np.float32)
    want, got = _both(fs, eye, src, src, False)
    assert got[0].shape == got[1].shape == (36, 64)
    _assert_prep_bar(want, got)
    with pytest.raises(ValueError, match="divide"):
        _both(fs, eye, src, src, False, tile_rows=16)
    with pytest.raises(ValueError, match="divide"):
        B3.fuse_prep(torch.zeros((36, 64), dtype=torch.int32),
                     torch.zeros((36, 64, 3), dtype=torch.uint8), 0.001, 0.5, 3.0, src[1],
                     torch.eye(4), src[1], False, 0.25, 4.0, tile_rows=16)


def test_prep_rejects_what_it_does_not_take():
    _, ti = _intr(8, 6, 5.0, 5.0)
    depth = torch.zeros((6, 8), dtype=torch.int32)
    color = torch.zeros((6, 8, 3), dtype=torch.uint8)
    args = (0.001, 0.5, 3.0, ti, torch.eye(4), ti, False, 0.25, 4.0)
    with pytest.raises(ValueError, match="int32 depth"):
        B3.fuse_prep(depth.to(torch.int64), color, *args)
    with pytest.raises(ValueError, match="uint8 color"):
        B3.fuse_prep(depth, color[..., :2], *args)
    meta = torch.zeros((6, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        B3.fuse_prep(meta, color.to("meta"), *args)
