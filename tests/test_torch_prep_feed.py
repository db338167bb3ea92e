"""Kernel B3's masked feed and the packed scatter-min, plain versions on the
CPU, against the JAX package run op by op.

- B3's output (b) (``fuse_prep_feed``) for 2 and 3 cameras of 64×48, pinhole
  and inverse Brown-Conrady, with ROIs, mirror on and off, pixel offsets and
  the per-stream layout: bit for bit the JAX chain ``filter_depth`` →
  ``deproject_planar`` → ``transform_planar`` →
  ``compute_pixel_indices_planar`` per camera; output (a)
  (``fuse_prep_keys``) the JAX Pallas kernel's per camera, in the
  interpreter, to that kernel's own bar (tests/test_torch_fuse_prep.py).
- ``scatter_min_u32`` and ``scatter_min_packed`` in every variant (given
  keys or the feed, raw bits or the packed decode, the dual frame's and the
  rig's span): bit for bit JAX's ``.at[idx].min(key, mode="drop")`` and
  ``_decode_packed_planes`` (JAX ops/render.py:200-221), with entries all
  invalid and none at all.

The card holds each kernel bit for bit against these plain versions
(chip_smoke.py phase 10, tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core import geometry as JG
from pointcloud_depthfusion_tpu.core.camera import Distortion
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu.ops import render as JR
from pointcloud_depthfusion_tpu.ops.pallas.fuse_prep_pallas import fuse_prep_pallas
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.ops.cuda import fuse_prep_cuda as B3
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

W, H = 64, 48
FW, FH = 56, 70  # the virtual camera: another size and aspect
COEFFS = (0.06, -0.02, 0.001, -0.0015, 0.004)
ROIS = ((6, 4, 40, 30), None, (-1, 10, 70, 100))
SCALES = (0.001, 0.00025, 0.0005)
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intrinsics(n, distort):
    """n cameras of W×H: fx, fy and the principal point differ; with
    ``distort`` the inverse Brown-Conrady model, camera 1 with real
    coefficients."""
    out = []
    for i in range(n):
        kw = dict(fx=52.0 + 3.0 * i, fy=53.0 + 2.0 * i, ppx=W / 2 + 1.5 * (i - 1), ppy=H / 2 - i)
        if distort:
            kw.update(model=Distortion.INVERSE_BROWN_CONRADY,
                      coeffs=COEFFS if i == 1 else (0.0,) * 5)
        out.append((JIntr.create(W, H, **kw), TIntr.create(W, H, device="cpu", **kw)))
    return out


def _fused():
    kw = dict(fx=50.0, fy=49.0, ppx=FW / 2, ppy=FH / 2)
    return JIntr.create(FW, FH, **kw), TIntr.create(FW, FH, device="cpu", **kw)


def _frames(n, seed):
    """(depth (n, H, W) int32, color (n, H, W, 3) u8, depth_scale (n,) f32,
    cam_to_virtual (n, 4, 4) f32): 0.3-3.5 m in each camera's depth units
    with holes, small yaws and shifts."""
    rng = np.random.default_rng(seed)
    scale = np.asarray(SCALES[:n], np.float32)
    metres = rng.uniform(0.3, 3.5, (n, H, W))
    depth = (metres / scale[:, None, None]).astype(np.int32)
    depth[rng.random((n, H, W)) < 0.05] = 0
    color = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    poses = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        a = 0.08 * (i - 1)
        poses[i] = np.eye(4)
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.05 * i, -0.02, 0.1]
    return depth, color, scale, poses


def _jax_feed(depth, color, scale, poses, intr, fused, mirror, rois, offsets):
    """The JAX package's prep of each camera, op by op."""
    out = []
    with jax.disable_jit():
        for i, (ji, _) in enumerate(intr):
            d, valid = JF.filter_depth(jnp.asarray(depth[i]), F32(scale[i]), F32(0.5), F32(3.0),
                                       rois[i])
            x, y, z, valid = JG.deproject_planar(d.astype(F32) * F32(scale[i]), ji, valid)
            x, y, z = JG.transform_planar(x, y, z, jnp.asarray(poses[i]))
            idx, zc, ok = JR.compute_pixel_indices_planar(x, y, z, valid, fused, mirror)
            rgb = JR.pack_rgb(jnp.asarray(color[i]))
            out.append([np.asarray(a) for a in (idx + offsets[i], zc, ok, rgb, valid)])
    return [np.stack([o[k] for o in out]) for k in range(5)]


@pytest.mark.parametrize("n,distort,mirror,roi,per_stream", [
    (2, False, True, False, False),
    (2, True, False, True, False),
    (3, True, True, True, True),
    (3, False, False, False, True),
], ids=["2cam-pinhole-mirror", "2cam-bc-roi", "3cam-bc-roi-mirror-streams",
        "3cam-pinhole-streams"])
def test_feed_plain_matches_jax_chain(n, distort, mirror, roi, per_stream):
    depth, color, scale, poses = _frames(n, seed=10 * n + distort)
    intr = _intrinsics(n, distort)
    jfused, tfused = _fused()
    rois = ROIS[:n] if roi else (None,) * n
    offsets = [0] * n if n == 2 else [0, 5000, 10000]
    cams = B3.prep_cameras([t for _, t in intr], tfused, 0.5, 3.0, mirror, rois=rois,
                           pix_offsets=offsets, device="cpu")
    before = dict(B3.launches)
    got = B3.fuse_prep_feed(torch.from_numpy(depth), torch.from_numpy(color),
                            torch.from_numpy(scale), torch.from_numpy(poses), cams, per_stream)
    assert B3.launches == before
    want = _jax_feed(depth, color, scale, poses, intr, jfused, mirror, rois, offsets)
    shape = (n, H * W) if per_stream else (n * H * W,)
    for g, w_, dtype in zip(got[:4], want[:4], (torch.int32, torch.float32, torch.bool,
                                                 torch.int32)):
        assert g.dtype == dtype and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy().reshape(n, -1), w_.reshape(n, -1))
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    ok = want[2]
    assert 0.3 < ok.mean() < 0.95
    # The camera's frames as N separate tensors (the dual frame's framesets)
    # give the same feed.
    split = B3.fuse_prep_feed([torch.from_numpy(d) for d in depth],
                              [torch.from_numpy(c) for c in color],
                              [torch.tensor(s) for s in scale],
                              [torch.from_numpy(p) for p in poses], cams, per_stream)
    assert all(torch.equal(a, b) for a, b in zip(split, got))


def test_feed_takes_packed_color_and_keys_match_pallas_kernel():
    """rgb24 planes give the feed of the u8 images; output (a) per camera is
    the Pallas kernel's in the interpreter, and its valid planes
    filter_depth's."""
    n = 2
    depth, color, scale, poses = _frames(n, seed=3)
    intr = _intrinsics(n, False)
    jfused, tfused = _fused()
    cams = B3.prep_cameras([t for _, t in intr], tfused, 0.5, 3.0, True, z_near=0.25,
                           z_far=4.0, device="cpu")
    args = (torch.from_numpy(depth), torch.from_numpy(color), torch.from_numpy(scale),
            torch.from_numpy(poses))
    rgb24 = (args[1].to(torch.int32) * torch.tensor([1 << 16, 1 << 8, 1])).sum(-1,
                                                                             dtype=torch.int32)
    packed = B3.fuse_prep_feed(args[0], rgb24, args[2], args[3], cams)
    assert all(torch.equal(a, b) for a, b in zip(packed, B3.fuse_prep_feed(*args, cams)))
    idx, key, valid = B3.fuse_prep_keys(*args, cams)
    assert idx.shape == key.shape == (n * H * W,) and valid.shape == (n, H, W)
    for i, (ji, _) in enumerate(intr):
        j_idx, j_key = fuse_prep_pallas(
            jnp.asarray(depth[i]), jnp.asarray(color[i]), F32(scale[i]), F32(0.5), F32(3.0), ji,
            jnp.asarray(poses[i]), jfused, True, F32(0.25), F32(4.0), interpret=True)
        sl = slice(i * H * W, (i + 1) * H * W)
        np.testing.assert_array_equal(idx[sl].numpy(), np.asarray(j_idx).reshape(-1))
        # The Pallas kernel's own bar (tests/test_torch_fuse_prep.py): keys
        # equal but on under 1e-3 of pixels, and there the same color and
        # zq within one step.
        got_key = key[sl].numpy().view(np.uint32).astype(np.int64)
        want_key = np.asarray(j_key).reshape(-1).astype(np.int64)
        diff = got_key != want_key
        assert diff.mean() < 1e-3
        assert ((got_key[diff] & 0x3FFFF) == (want_key[diff] & 0x3FFFF)).all()
        assert (np.abs((got_key[diff] >> 18) - (want_key[diff] >> 18)) <= 1).all()
        with jax.disable_jit():
            j_valid = JF.filter_depth(jnp.asarray(depth[i]), F32(scale[i]), F32(0.5), F32(3.0))[1]
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(j_valid))
    with pytest.raises(ValueError, match="ROI"):
        B3.fuse_prep_keys(*args, B3.prep_cameras([t for _, t in intr], tfused, 0.5, 3.0,
                                                 rois=ROIS[:2], device="cpu"))


def _feed(n, n_slots, seed, ok_frac=0.9):
    """A masked feed: slots with duplicates, the dump slot and slots past
    it; z across and beyond the quantization range; rgb24 over 24 bits."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_slots + 3, n).astype(np.int32)
    idx[::29] = n_slots
    z = rng.uniform(0.05, 5.0, n).astype(np.float32)
    ok = rng.random(n) < ok_frac
    rgb24 = rng.integers(0, 1 << 24, n).astype(np.int32)
    return idx, z, ok, rgb24


def _jax_packed(idx, z, ok, rgb24, n_slots, z_near, z_far, span):
    """JAX ops/render.py:200-221 on a feed, ``span`` the key's divisor."""
    z_levels = F32((1 << 14) - 1)
    with jax.disable_jit():
        zq = jnp.clip((jnp.asarray(z) - F32(z_near)) / span * z_levels, 0.0, z_levels - 1.0
                      ).astype(jnp.uint32)
        p24 = jnp.asarray(rgb24).astype(jnp.uint32)
        rgb666 = (((p24 >> 18) & 0x3F) << 12) | (((p24 >> 10) & 0x3F) << 6) | ((p24 >> 2) & 0x3F)
        key = jnp.where(jnp.asarray(ok), (zq << 18) | rgb666, jnp.uint32(0xFFFFFFFF))
        buf = jnp.full((n_slots + 1,), jnp.uint32(0xFFFFFFFF), jnp.uint32)
        buf = buf.at[jnp.asarray(idx)].min(key, mode="drop")[:n_slots]
        planes = JR._decode_packed_planes(buf, z_near, z_far)
    return np.array(key), np.array(buf), [np.array(p) for p in planes]


@pytest.mark.parametrize("n,ok_frac", [(3000, 0.9), (500, 0.0), (0, 0.9)],
                         ids=["entries", "all-invalid", "none"])
@pytest.mark.parametrize("rig_span", [False, True], ids=["dual-span", "rig-span"])
def test_scatter_min_variants_match_jax(n, ok_frac, rig_span):
    n_slots, z_near, z_far = 400, 0.25, 4.0
    idx, z, ok, rgb24 = _feed(n, n_slots, seed=n + rig_span, ok_frac=ok_frac)
    # The dual frame divides by f32(far) - f32(near), the rig by the f32 of
    # the host's far - near.
    span = F32(z_far - z_near) if rig_span else F32(z_far) - F32(z_near)
    key, buf, planes = _jax_packed(idx, z, ok, rgb24, n_slots, z_near, z_far, span)
    zparams = Z.packed_zparams(z_near, z_far, "cpu", span=z_far - z_near if rig_span else None)
    t = [torch.from_numpy(a) for a in (idx, z, ok, rgb24)]
    before = dict(Z.launches)
    np.testing.assert_array_equal(Z.packed_keys_plain(*t[1:], zparams).numpy().view(np.uint32),
                                  key)
    raw = Z.scatter_min_packed(*t, n_slots, zparams, planes=False)
    np.testing.assert_array_equal(raw.numpy().view(np.uint32), buf)
    given = Z.scatter_min_u32(t[0], torch.from_numpy(key.view(np.int32)), n_slots)
    assert torch.equal(given, raw)
    for got in (Z.scatter_min_packed(*t, n_slots, zparams, planes=True, need_zbuf=True),
                Z.scatter_min_u32(t[0], torch.from_numpy(key.view(np.int32)), n_slots, zparams,
                                  planes=True, need_zbuf=True)):
        for g, w_ in zip(got, planes):
            np.testing.assert_array_equal(g.numpy(), w_)
    r, g, b, none = Z.scatter_min_packed(*t, n_slots, zparams, planes=True)
    assert none is None and all(torch.equal(p, torch.from_numpy(w_))
                                for p, w_ in zip((r, g, b), planes))
    assert Z.launches == before
    covered = buf != 0xFFFFFFFF
    assert covered.any() == (n > 0 and ok_frac > 0)


def test_scatter_min_and_prep_reject_what_they_do_not_take():
    idx, z, ok, rgb24 = (torch.from_numpy(a) for a in _feed(64, 16, seed=1))
    zparams = Z.packed_zparams(0.25, 4.0, "cpu")
    with pytest.raises(ValueError, match="zparams"):
        Z.scatter_min_packed(idx, z, ok, rgb24, 16, zparams.to(torch.float64))
    with pytest.raises(ValueError, match="zparams"):
        Z.scatter_min_u32(idx, rgb24, 16, None, planes=True, need_zbuf=True)
    with pytest.raises(ValueError, match="ok"):
        Z.scatter_min_packed(idx, z, ok.to(torch.uint8), rgb24, 16, zparams)
    intr = _intrinsics(2, False)
    cams = B3.prep_cameras([t for _, t in intr], _fused()[1], 0.5, 3.0, device="cpu")
    assert cams.static.shape == (2, 17) and cams.ints.dtype == torch.int32
    # The frames' device decides, and the cameras must share it.
    depth, color, scale, poses = (torch.from_numpy(a) for a in _frames(2, seed=1))
    away = B3.prep_cameras([t for _, t in intr], _fused()[1], 0.5, 3.0, device="meta")
    for fn in (B3.fuse_prep_feed, B3.fuse_prep_keys):
        with pytest.raises(ValueError, match="cameras on meta"):
            fn(depth, color, scale, poses, away)
    with pytest.raises(ValueError, match="unsupported device"):
        B3.fuse_prep_feed(depth.to("meta"), color.to("meta"), scale, poses, away)
    with pytest.raises(ValueError, match="pixel offsets"):
        B3.prep_cameras([t for _, t in intr], _fused()[1], 0.5, 3.0, pix_offsets=[0],
                        device="cpu")
    other = TIntr.create(W + 1, H, fx=50.0, fy=50.0, ppx=30.0, ppy=20.0, device="cpu")
    with pytest.raises(ValueError, match="width and height"):
        B3.prep_cameras([intr[0][1], other], _fused()[1], 0.5, 3.0, device="cpu")


def test_memo_rebuilds_only_when_an_input_changes():
    memo, built = B3.Memo(), []
    a, b = torch.zeros(2), torch.ones(2)

    def build():
        built.append(1)
        return len(built)

    assert memo.get((a, b, 3, None), build) == 1
    assert memo.get((a, b, 3, None), build) == 1
    assert memo.get((a, b.clone(), 3, None), build) == 2
    assert memo.get((a, b, 4, None), build) == 3
    assert memo.get((a, b, 4), build) == 4


def test_pipeline_keeps_cameras_and_reads_poses_every_frame():
    """FusionPipeline keeps B3's cameras while the calibration and config
    stay, across new transforms and new framesets; the poses and depth
    scales are read on every frame, so one rewritten in place takes
    effect."""
    from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import (
        FusionConfig, FusionPipeline, fuse_posed)

    n = 2
    depth, color, scale, _ = _frames(n, seed=5)
    intr = _intrinsics(n, False)[0][1]
    pairs = [[Frameset.create(depth[i], color[i], intr, depth_scale=float(scale[0]),
                              device="cpu") for i in range(n)] for _ in range(2)]
    cfg = FusionConfig.create(device="cpu")
    pipe = FusionPipeline(intr, cfg, device="cpu")
    first = pipe.process(*pairs[0])
    kept = pipe._prep_memo._value
    assert pipe.process(*pairs[0]).image.equal(first.image)
    pipe.set_right_transform(np.eye(4, dtype=np.float32))
    pipe.process(*pairs[1])
    assert pipe._prep_memo._value is kept
    # A pose and a depth scale rewritten in place: the frame takes both.
    cfg, poses = pipe.config, [p.clone() for p in pipe._poses]
    before = fuse_posed(*pairs[1], *poses, cfg, pipe.fused_intrinsics,
                        prep_memo=pipe._prep_memo)
    poses[1][0, 3] += 0.05
    pairs[1][0].depth_scale.mul_(1.25)
    after = fuse_posed(*pairs[1], *poses, cfg, pipe.fused_intrinsics, prep_memo=pipe._prep_memo)
    fresh = fuse_posed(*pairs[1], *(p.clone() for p in poses), cfg, pipe.fused_intrinsics)
    assert pipe._prep_memo._value is kept
    assert after.image.equal(fresh.image) and after.valid_left.equal(fresh.valid_left)
    assert not after.image.equal(before.image)
