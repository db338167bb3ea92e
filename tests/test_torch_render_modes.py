"""The port's render modes (exact, packed, indexed; plain kernels on the
CPU) against the JAX package's, run op by op. Bit-exact: images, z-buffers,
winner indices, and uint32 keys (the port's int32 bit patterns viewed as
np.uint32). The edge cases are those of tests/test_render.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.ops import render as JR
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.ops import render as TR
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

ZMAX = np.float32(np.finfo(np.float32).max)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intr(w=40, h=30, fx=35.0, fy=36.0):
    kw = dict(fx=fx, fy=fy, ppx=w / 2, ppy=h / 2)
    return JIntr.create(w, h, **kw), TIntr.create(w, h, device="cpu", **kw)


def _cloud(seed, n, w=40, h=30, fx=35.0, fy=36.0):
    """Points that mostly land inside the image (tests/test_render.py)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 3.0, n)
    px = rng.uniform(-5, w + 5, n)
    py = rng.uniform(-5, h + 5, n)
    pts = np.stack([(px - w / 2) / fx * z, (py - h / 2) / fy * z, z], -1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return pts, cols, rng.random(n) > 0.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _planar(pts, cols, valid, j=True):
    f = jnp.asarray if j else _t
    return ([f(pts[:, i]) for i in range(3)], [f(cols[:, i]) for i in range(3)], f(valid))


@pytest.mark.parametrize("mirror", [False, True])
def test_compute_pixel_indices_bit_exact(mirror):
    ji, ti = _intr()
    pts, _, valid = _cloud(0, 5000)
    pts[:6, 2] = [0.0, -1.0, 1e-30, 3e7, 2.0, 2.0]
    pts[4:6, 0] = [-1e30, 1e30]  # past the i32 range: saturated or clamped, never inside
    want = JR.compute_pixel_indices(jnp.asarray(pts), jnp.asarray(valid), ji, mirror)
    got = TR.compute_pixel_indices(_t(pts), _t(valid), ti, mirror)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("mirror", [False, True])
def test_exact_renders_bit_exact(mirror):
    """project_zbuffer ((N, 3), division) and project_zbuffer_planar
    (reciprocal), with and without rgb24 and a background."""
    ji, ti = _intr()
    pts, cols, valid = _cloud(1, 5000)
    want = JR.project_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), ji,
                              mirror=mirror)
    got = TR.project_zbuffer(_t(pts), _t(cols), _t(valid), ti, mirror=mirror)
    for g, w in zip(got, want):
        _eq(g, w)
    bg = np.random.default_rng(2).integers(0, 256, (30, 40, 3)).astype(np.uint8)
    want = JR.project_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), ji,
                              mirror=mirror, background=jnp.asarray(bg))
    got = TR.project_zbuffer(_t(pts), _t(cols), _t(valid), ti, mirror=mirror,
                             background=_t(bg))
    _eq(got[0], want[0])
    (jx, jy, jz), jc, jv = _planar(pts, cols, valid)
    (tx, ty, tz), tc, tv = _planar(pts, cols, valid, j=False)
    want = JR.project_zbuffer_planar(jx, jy, jz, *jc, jv, ji, mirror=mirror)
    got = TR.project_zbuffer_planar(tx, ty, tz, *tc, tv, ti, mirror=mirror)
    for g, w in zip(got, want):
        _eq(g, w)
    rgb24 = TR.pack_rgb(_t(cols))
    again = TR.project_zbuffer_planar(tx, ty, tz, None, None, None, tv, ti, mirror=mirror,
                                      rgb24=rgb24)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_exact_equals_tiled_bitwise():
    """test_render.py:203: the exact render equals the tiled one bit for
    bit, here on duplicate positions with other colors as well."""
    _, ti = _intr(37, 23)
    pts, cols, valid = _cloud(3, 3000, 37, 23)
    pts[1000:2000] = pts[:1000]
    (tx, ty, tz), tc, tv = _planar(pts, cols, valid, j=False)
    for mirror in (False, True):
        exact = TR.project_zbuffer_planar(tx, ty, tz, *tc, tv, ti, mirror=mirror)
        tiled = TR.project_zbuffer_tiled_planar(tx, ty, tz, *tc, tv, ti, mirror=mirror)
        assert all(torch.equal(a, b) for a, b in zip(exact, tiled))


def test_exact_tie_break_and_empty():
    """test_render.py:61 and :84: equal depth at one pixel goes to the
    smaller packed color; no valid point leaves black and FLT_MAX."""
    ji, ti = _intr()
    pts = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    cols = np.array([[200, 0, 0], [100, 0, 0]], np.uint8)
    ok = np.array([True, True])
    img, _ = TR.project_zbuffer(_t(pts), _t(cols), _t(ok), ti)
    want, _ = JR.project_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(ok), ji)
    assert img[15, 20].tolist() == [100, 0, 0]
    _eq(img, want)
    img, zbuf = TR.project_zbuffer(torch.zeros((10, 3)), torch.zeros((10, 3), dtype=torch.uint8),
                                   torch.zeros(10, dtype=torch.bool), ti)
    assert int(img.sum()) == 0 and bool((zbuf == ZMAX).all())


@pytest.mark.parametrize("mirror", [False, True])
def test_packed_renders_bit_exact(mirror):
    ji, ti = _intr()
    pts, cols, valid = _cloud(4, 4000)
    pts[:3, 2] = [0.3, 4.4, 9.0]  # clipped at both ends of the window
    cols[:3] = 255
    near, far = 0.4, 3.5
    want = JR.project_zbuffer_packed(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), ji,
                                     mirror=mirror, z_near=near, z_far=far)
    got = TR.project_zbuffer_packed(_t(pts), _t(cols), _t(valid), ti, mirror=mirror,
                                    z_near=near, z_far=far)
    for g, w in zip(got, want):
        _eq(g, w)
    (jx, jy, jz), jc, jv = _planar(pts, cols, valid)
    (tx, ty, tz), tc, tv = _planar(pts, cols, valid, j=False)
    want = JR.project_zbuffer_packed_planar(jx, jy, jz, *jc, jv, ji, mirror=mirror,
                                            z_near=near, z_far=far)
    got = TR.project_zbuffer_packed_planar(tx, ty, tz, *tc, tv, ti, mirror=mirror,
                                           z_near=torch.tensor(near), z_far=torch.tensor(far))
    for g, w in zip(got, want):
        _eq(g, w)
    (rp, gp, bp), zb = TR.project_zbuffer_packed_planar(
        tx, ty, tz, None, None, None, tv, ti, mirror=mirror, z_near=near, z_far=far,
        return_planes=True, rgb24=TR.pack_rgb(_t(cols)))
    assert torch.equal(torch.stack([rp, gp, bp], -1), got[0]) and torch.equal(zb, got[1])


def test_packed_decode_bit_exact():
    """unpack_packed_buffer on every 6-bit channel value, zq at 0, mid and
    max, and the 0xFFFFFFFF sentinel."""
    ji, ti = _intr(16, 12)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, 192, dtype=np.uint64).astype(np.uint32)
    keys[:64] = (np.arange(64, dtype=np.uint32) * 0x1041) | (np.uint32(16383) << 18)
    keys[64:70] = [0, 0xFFFFFFFF, 0xFFFFFFFE, 1 << 18, 0x3FFFF, 0x7FFFFFFF]
    want = JR.unpack_packed_buffer(jnp.asarray(keys), ji, 0.25, 4.5)
    got = TR.unpack_packed_buffer(_t(keys.view(np.int32)), ti, 0.25, 4.5)
    for g, w in zip(got, want):
        _eq(g, w)


def test_packed_white_point_at_far_plane_not_dropped():
    """test_render.py:316: a near-white point beyond z_far keeps its pixel."""
    ji, ti = _intr(8, 8, 8.0, 8.0)
    pts = np.array([[0.0, 0.0, 6.0]], np.float32)
    cols = np.array([[255, 255, 255]], np.uint8)
    img, zbuf = TR.project_zbuffer_packed(_t(pts), _t(cols), torch.ones(1, dtype=torch.bool),
                                          ti, z_near=0.25, z_far=4.5)
    want = JR.project_zbuffer_packed(jnp.asarray(pts), jnp.asarray(cols), jnp.ones(1, bool), ji,
                                     z_near=0.25, z_far=4.5)
    assert img[4, 4].tolist() == [255, 255, 255] and float(zbuf[4, 4]) < 1e30
    _eq(img, want[0])
    _eq(zbuf, want[1])


@pytest.mark.parametrize("mirror", [False, True])
def test_indexed_renders_bit_exact(mirror):
    ji, ti = _intr()
    pts, cols, valid = _cloud(6, 5000)
    pts[:3, 2] = [0.3, 3.6, 40.0]
    near, far = 0.4, 3.5
    (jx, jy, jz), jc, jv = _planar(pts, cols, valid)
    (tx, ty, tz), tc, tv = _planar(pts, cols, valid, j=False)
    j_cov, j_widx = JR.indexed_winner_planar(jx, jy, jz, jv, ji, mirror, near, far)
    t_cov, t_widx = TR.indexed_winner_planar(tx, ty, tz, tv, ti, mirror, near, far)
    _eq(t_cov, j_cov)
    _eq(t_widx, j_widx)
    want = JR.indexed_winner_gather(j_cov, j_widx, jz, *jc)
    got = TR.indexed_winner_gather(t_cov, t_widx, tz, *tc)
    for g, w in zip(got, want):
        _eq(g, w)
    again = TR.indexed_winner_gather(t_cov, t_widx, tz, None, None, None,
                                     rgb24=TR.pack_rgb(_t(cols)))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    want = JR.project_zbuffer_indexed(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), ji,
                                      mirror=mirror, z_near=near, z_far=far)
    got = TR.project_zbuffer_indexed(_t(pts), _t(cols), _t(valid), ti, mirror=mirror,
                                     z_near=near, z_far=far)
    for g, w in zip(got, want):
        _eq(g, w)
    planar = TR.project_zbuffer_indexed_planar(tx, ty, tz, *tc, tv, ti, mirror, near, far)
    assert all(torch.equal(a, b) for a, b in zip(planar, got))


def test_indexed_tie_break_and_empty():
    """test_render.py:162 and :175: a depth-bin tie goes to the lowest
    point index, with its exact depth; no valid point leaves black and
    FLT_MAX."""
    _, ti = _intr()
    pts = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    cols = np.array([[200, 5, 0], [100, 0, 7]], np.uint8)
    img, zbuf = TR.project_zbuffer_indexed(_t(pts), _t(cols), torch.ones(2, dtype=torch.bool), ti)
    assert img[15, 20].tolist() == [200, 5, 0] and float(zbuf[15, 20]) == 1.0
    img, zbuf = TR.project_zbuffer_indexed(torch.zeros((10, 3)),
                                           torch.zeros((10, 3), dtype=torch.uint8),
                                           torch.zeros(10, dtype=torch.bool), ti)
    assert int(img.sum()) == 0 and bool((zbuf == ZMAX).all())


def test_indexed_tiny_cloud_far_clip_no_wrap():
    """test_render.py:292: with 31 depth bits f32(2^31 - 1) rounds up, and
    only the integer re-clamp keeps the far point from wrapping its key."""
    ji, ti = _intr(8, 8, 4.0, 4.0)
    x = np.zeros((1, 2), np.float32)
    z = np.array([[1.0, 40.0]], np.float32)
    ok = np.ones((1, 2), bool)
    cov, widx = TR.indexed_winner_planar(_t(x), _t(x), _t(z), _t(ok), ti, z_near=0.25, z_far=4.5)
    assert bool(cov[36]) and int(widx[36]) == 0
    j_cov, j_widx = JR.indexed_winner_planar(jnp.asarray(x), jnp.asarray(x), jnp.asarray(z),
                                             jnp.asarray(ok), ji, z_near=0.25, z_far=4.5)
    _eq(cov, j_cov)
    _eq(widx, j_widx)


def test_indexed_bits_and_too_many_points():
    for n in (1, 2, 5000, (1 << 19) + 7, 814_080, 1_843_200):
        assert TR._index_bits_for(n) == JR._index_bits_for(n)
    assert TR._index_bits_for(814_080) == 20 and TR._index_bits_for(1_843_200) == 21
    _, ti = _intr()
    big = torch.zeros(1).expand(1 << 24)  # 2^24 points leave 7 depth bits
    with pytest.raises(ValueError, match="depth bits"):
        TR.indexed_winner_planar(big, big, big, big > 0, ti)


def test_scatter_min_u32_matches_jax_scatter():
    """The packed/indexed/pallas scatter, on keys across the whole uint32
    range (the sign bit set on half), the all-ones key, and dropped slots."""
    rng = np.random.default_rng(7)
    n, n_slots = 6000, 500
    idx = rng.integers(0, 400, n).astype(np.int32)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    high = rng.random(n) < 0.1  # slots 400-449 see keys >= 2^31 only
    idx[high] = rng.integers(400, 450, high.sum())
    keys[high] |= np.uint32(0x80000000)
    keys[high & (rng.random(n) < 0.3)] = 0xFFFFFFFF
    idx[::37] = n_slots  # the dump slot; slots 450-499 stay empty
    buf = jnp.full((n_slots + 1,), jnp.uint32(0xFFFFFFFF), jnp.uint32)
    want = np.asarray(buf.at[jnp.asarray(idx)].min(jnp.asarray(keys), mode="drop"))[:n_slots]
    before = dict(Z.launches)
    got = Z.scatter_min_u32(_t(idx), _t(keys.view(np.int32)), n_slots)
    assert got.dtype == torch.int32 and Z.launches == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want == 0xFFFFFFFF).any() and (want >= 1 << 31).any()
    empty = Z.scatter_min_u32(torch.full((4,), -1, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), 3)
    assert empty.tolist() == [-1, -1, -1]
    with pytest.raises(ValueError, match="key"):
        Z.scatter_min_u32(_t(idx), _t(keys.astype(np.int64)), n_slots)


def test_u32_helpers_round_trip():
    v = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=torch.int64)
    bits = Z.u32_bits(v)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, (1 << 31) - 1, -(1 << 31), -1]
    assert torch.equal(Z.u32_value(bits), v)
