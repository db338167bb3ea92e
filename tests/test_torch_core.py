"""The port's core (camera, geometry, frameset) and synthetic scene against
the JAX package on the CPU.

Coordinate planes must be bit-identical to JAX run op by op (XLA's jit on
the CPU contracts multiply-adds into FMAs, a documented backend
difference). Transcendental pose math agrees within atol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core import camera as JC
from pointcloud_depthfusion_tpu.core import frameset as JFS
from pointcloud_depthfusion_tpu.core import geometry as JG
from pointcloud_depthfusion_tpu.fusion import pipeline as JP
from pointcloud_depthfusion_tpu.io import synthetic as JS
from pointcloud_depthfusion_tpu_torch.core import camera as TC
from pointcloud_depthfusion_tpu_torch.core import frameset as TFS
from pointcloud_depthfusion_tpu_torch.core import geometry as TG
from pointcloud_depthfusion_tpu_torch.fusion import pipeline as TP
from pointcloud_depthfusion_tpu_torch.io import synthetic as TS
from pointcloud_depthfusion_tpu_torch.utils import convert

POSE_ATOL = 1e-6
COEFFS = (0.11, -0.23, 0.0021, -0.0017, 0.045)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_intrinsics(ji, ti):
    for f in ("ppx", "ppy", "fx", "fy", "coeffs"):
        a, b = np.asarray(getattr(ji, f), np.float32), _np(getattr(ti, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (ji.width, ji.height, int(ji.model)) == (ti.width, ti.height, int(ti.model))


def _both_intrinsics(w, h, model=JC.Distortion.NONE, coeffs=(0.0,) * 5):
    kw = dict(fx=631.0 * w / 848.0, fy=629.5 * w / 848.0, ppx=w / 2 + 0.3, ppy=h / 2 - 0.7,
              model=model, coeffs=coeffs)
    return (JC.Intrinsics.create(w, h, dtype=jnp.float32, **kw),
            TC.Intrinsics.create(w, h, device="cpu", **kw))


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r = np.eye(4)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    if axis == 1:
        r[i, j], r[j, i] = s, -s
    return r


# -- camera -----------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(160, 120), (161, 121)])
def test_intrinsics_create_transpose_center(w, h):
    ji, ti = _both_intrinsics(w, h, JC.Distortion.INVERSE_BROWN_CONRADY, COEFFS)
    _same_intrinsics(ji, ti)
    _same_intrinsics(ji.transposed(), ti.transposed())
    _same_intrinsics(ji.with_centered_pp(), ti.with_centered_pp())
    for vertical in (True, False):
        _same_intrinsics(JC.fused_virtual_intrinsics(ji, vertical),
                         TC.fused_virtual_intrinsics(ti, vertical))
    assert ti.pixel_count == ji.pixel_count


def test_extrinsics_column_major_and_matrix():
    rng = np.random.default_rng(3)
    r9, t3 = rng.normal(size=9), rng.normal(size=3)
    je = JC.Extrinsics.from_column_major_flat(r9, t3)
    te = TC.Extrinsics.from_column_major_flat(r9, t3, device="cpu")
    np.testing.assert_array_equal(_np(te.rotation), np.asarray(je.rotation))
    np.testing.assert_array_equal(_np(te.as_matrix()), np.asarray(je.as_matrix()))
    np.testing.assert_array_equal(_np(TC.Extrinsics.identity("cpu").as_matrix()),
                                  np.asarray(JC.Extrinsics.identity().as_matrix()))


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("n_d", [0, 5, 8])
def test_camera_info_to_intrinsics(legacy, n_d):
    k = np.array([631.7, 0, 423.9, 0, 630.2, 239.6, 0, 0, 1.0])
    d = np.linspace(0.01, 0.08, n_d)
    ji = JC.camera_info_to_intrinsics(JC.CameraInfo(848, 480, k, d),
                                      legacy_int_truncation=legacy)
    ti = TC.camera_info_to_intrinsics(TC.CameraInfo(848, 480, k, d),
                                      legacy_int_truncation=legacy, device="cpu")
    _same_intrinsics(ji, ti)
    info = TC.CameraInfo.from_intrinsics(ti)
    np.testing.assert_array_equal(info.k, JC.CameraInfo.from_intrinsics(ji).k)


def test_presets_and_d455_defaults():
    assert TC.CAMERA_MODEL_PRESETS == JC.CAMERA_MODEL_PRESETS
    for size in [(848, 480), (1280, 720)]:
        _same_intrinsics(JC.d455_default_intrinsics(*size), TC.d455_default_intrinsics(*size, device="cpu"))


# -- geometry: bit-exact planes ----------------------------------------------


@pytest.mark.parametrize("model", [JC.Distortion.NONE, JC.Distortion.INVERSE_BROWN_CONRADY])
@pytest.mark.parametrize("with_mask", [False, True])
def test_deproject_planar_bit_exact(model, with_mask):
    rng = np.random.default_rng(int(model) * 2 + with_mask)
    h, w = 120, 160
    ji, ti = _both_intrinsics(w, h, model, COEFFS)
    depth = (rng.integers(0, 4000, (h, w)) * rng.random((h, w))).astype(np.float32) * np.float32(0.001)
    depth[rng.random((h, w)) < 0.1] = 0
    mask = rng.random((h, w)) < 0.8
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    got = TG.deproject_planar(torch.from_numpy(depth), ti, tm)
    want = JG.deproject_planar(jnp.asarray(depth), ji, jm)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_transform_planar_bit_exact():
    rng = np.random.default_rng(5)
    x, y, z = (rng.normal(size=(120, 160)).astype(np.float32) for _ in range(3))
    t = rng.normal(size=(4, 4)).astype(np.float32)
    got = TG.transform_planar(*(torch.from_numpy(a) for a in (x, y, z, t)))
    want = JG.transform_planar(*(jnp.asarray(a) for a in (x, y, z, t)))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_pixel_grid():
    u, v = TG.pixel_grid(7, 9)
    ju, jv = JG.pixel_grid(7, 9, jnp.float32)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# -- geometry: pose math within atol ----------------------------------------

ROTATIONS = {
    "identity": np.eye(4),
    "z100_trace_pos_dominant_diag": _rot(2, 100.0),
    "x-160_w_negative": _rot(0, -160.0),
    "y170": _rot(1, 170.0),
    "z-179": _rot(2, -179.0),
    "mixed": _rot(0, 30.0) @ _rot(1, -50.0) @ _rot(2, 75.0),
}


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_quaternion_from_matrix(name):
    r = _f32(ROTATIONS[name][:3, :3])
    got = TG.quaternion_from_matrix(torch.from_numpy(r)).numpy()
    want = np.asarray(JG.quaternion_from_matrix(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(TG.matrix_from_quaternion(torch.from_numpy(got)).numpy(),
                               np.asarray(JG.matrix_from_quaternion(jnp.asarray(want))),
                               atol=POSE_ATOL, rtol=0)


@pytest.mark.parametrize("name,sign", [("z100_trace_pos_dominant_diag", 1.0),
                                       ("x-160_w_negative", -1.0)])
def test_quaternion_w_sign(name, sign):
    """Eigen's rule keeps w > 0 for a 100° rotation (trace > 0) although its
    diagonal is dominant; -160° about x takes the x-branch with w < 0, the
    case where interpolate_transform inverts its result."""
    q = TG.quaternion_from_matrix(torch.from_numpy(_f32(ROTATIONS[name][:3, :3])))
    assert float(q[0]) * sign > 0


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
def test_quaternion_slerp(t):
    rng = np.random.default_rng(11)
    for _ in range(4):
        q0, q1 = (_f32(v / np.linalg.norm(v)) for v in rng.normal(size=(2, 4)))
        got = TG.quaternion_slerp(torch.from_numpy(q0), torch.from_numpy(q1), t).numpy()
        want = np.asarray(JG.quaternion_slerp(jnp.asarray(q0), jnp.asarray(q1), t))
        np.testing.assert_allclose(got, want, atol=POSE_ATOL, rtol=0)
    q = _f32([0.5, 0.5, 0.5, 0.5])  # parallel: the lerp branch
    np.testing.assert_allclose(
        TG.quaternion_slerp(torch.from_numpy(q), torch.from_numpy(q), t).numpy(), q, atol=POSE_ATOL)


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_interpolate_transform_and_fused_pose(name):
    m = ROTATIONS[name].copy()
    m[:3, 3] = [0.31, -0.05, 0.12]
    m = _f32(m)
    left = np.eye(4, dtype=np.float32)
    got = TG.interpolate_transform(torch.from_numpy(left), torch.from_numpy(m)).numpy()
    want = np.asarray(JG.interpolate_transform(jnp.asarray(left), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=POSE_ATOL, rtol=0)
    for kw in (dict(), dict(vertical_image=False),
               dict(set_camera_pose=True, camera_translation=(0.1, -0.2, 0.05),
                    camera_rotation_deg=(5.0, -12.0, 30.0))):
        jc, tc = JP.FusionConfig.create(**kw), TP.FusionConfig.create(device="cpu", **kw)
        np.testing.assert_allclose(
            TP.fused_camera_transform(tc, torch.from_numpy(m)).numpy(),
            np.asarray(JP.fused_camera_transform(jc, jnp.asarray(m))),
            atol=POSE_ATOL, rtol=0)


def test_invert_euler_rotz_deg2rad():
    m = _f32(ROTATIONS["mixed"])
    m[:3, 3] = [1.0, 2.0, -0.5]
    np.testing.assert_allclose(TG.invert_rigid(torch.from_numpy(m)).numpy(),
                               np.asarray(JG.invert_rigid(jnp.asarray(m))), atol=POSE_ATOL)
    ang = _f32([0.3, -1.1, 2.4])
    np.testing.assert_allclose(TG.euler_to_matrix(torch.from_numpy(ang)).numpy(),
                               np.asarray(JG.euler_to_matrix(jnp.asarray(ang))), atol=POSE_ATOL)
    np.testing.assert_allclose(TG.rotz(TG.deg2rad(90.0)).numpy(),
                               np.asarray(JG.rotz(JG.deg2rad(90.0))), atol=POSE_ATOL)
    assert TG.deg2rad(90.0) == float(JG.deg2rad(90.0))


# -- frameset ---------------------------------------------------------------


def test_frameset_create_and_packed_color():
    rng = np.random.default_rng(2)
    depth = rng.integers(0, 65536, (12, 16)).astype(np.uint16)
    color = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    ji, ti = _both_intrinsics(16, 12)
    stamp = 1.7e9 + 123.456
    jf = JFS.Frameset.create(depth, color, ji, depth_scale=0.00025, timestamp=stamp, pack_color=True)
    tf = TFS.Frameset.create(depth, color, ti, depth_scale=0.00025, timestamp=stamp, pack_color=True,
                             device="cpu")
    np.testing.assert_array_equal(tf.depth.numpy(), np.asarray(jf.depth).astype(np.int32))
    np.testing.assert_array_equal(tf.color.numpy(), np.asarray(jf.color))
    np.testing.assert_array_equal(tf.color_packed.numpy(), np.asarray(jf.color_packed))
    for f in ("depth_scale", "timestamp", "timestamp_epoch"):
        assert float(getattr(tf, f)) == float(getattr(jf, f)), f
    on_device = TFS.Frameset.create(torch.from_numpy(depth.astype(np.int32)),
                                    torch.from_numpy(color), ti, pack_color=True, device="cpu")
    np.testing.assert_array_equal(on_device.color_packed.numpy(), np.asarray(jf.color_packed))
    assert (TFS.absolute_stamp(float(tf.timestamp), float(tf.timestamp_epoch))
            == jf.to_host().timestamp)
    assert (tf.height, tf.width) == (12, 16)
    np.testing.assert_array_equal(TFS.pack_rgb24_host(color), JFS.pack_rgb24_host(color))
    assert TFS.split_stamp(stamp) == JFS.split_stamp(stamp)
    assert TFS.absolute_stamp(3.5, 4096.0) == JFS.absolute_stamp(3.5, 4096.0)


# -- synthetic scene ---------------------------------------------------------


def test_synthetic_frames_byte_identical():
    ji, ti = _both_intrinsics(160, 120)
    wl, wr = TS.two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    for got, want in zip((wl, wr), JS.two_camera_rig(baseline=0.6, toe_in_deg=10.0)):
        np.testing.assert_array_equal(got, want)
    for pose, seed in ((wl, 0), (wr, 1)):
        kw = dict(depth_noise_std=0.002, hole_fraction=0.01, seed=seed, timestamp=3.0)
        a = TS.SyntheticScene().render(ti, pose, **kw)
        b = JS.SyntheticScene().render(ji, pose, **kw)
        assert a.depth.tobytes() == b.depth.tobytes()
        assert a.color.tobytes() == b.color.tobytes()
        assert (a.timestamp, a.depth_scale) == (b.timestamp, b.depth_scale)
    np.testing.assert_array_equal(TS.right_to_left_transform(wl, wr),
                                  JS.right_to_left_transform(wl, wr))
    for got, want in zip(TS.rig_arc_poses(4, 0.9, 12.0), JS.rig_arc_poses(4, 0.9, 12.0)):
        np.testing.assert_array_equal(got, want)


# -- state carried across ----------------------------------------------------


def test_convert_from_jax_leaves():
    ji, _ = _both_intrinsics(160, 120, JC.Distortion.INVERSE_BROWN_CONRADY, COEFFS)
    ti = convert.intrinsics_from_arrays(
        *(np.asarray(getattr(ji, f)) for f in ("ppx", "ppy", "fx", "fy", "coeffs")),
        ji.width, ji.height, ji.model, device="cpu")
    _same_intrinsics(ji, ti)
    je = JC.Extrinsics.create(_f32(ROTATIONS["mixed"][:3, :3]), [0.1, 0.2, 0.3])
    te = convert.extrinsics_from_arrays(np.asarray(je.rotation), np.asarray(je.translation),
                                        device="cpu")
    np.testing.assert_array_equal(te.as_matrix().numpy(), np.asarray(je.as_matrix()))
    jc = JP.FusionConfig.create(min_depth=0.4, max_depth=2.5, roi_left=(1, 2, 3, 4),
                                emit_zbuf=False)
    static = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.metadata.get("static")}
    tc = convert.fusion_config_from_arrays(
        np.asarray(jc.min_depth), np.asarray(jc.max_depth),
        np.asarray(jc.camera_translation), np.asarray(jc.camera_rotation_deg), device="cpu",
        **static)
    assert (tc.roi_left, tc.emit_zbuf, float(tc.min_depth)) == ((1, 2, 3, 4), False, float(jc.min_depth))
    rng = np.random.default_rng(0)
    jf = JFS.Frameset.create(rng.integers(0, 5000, (6, 8)).astype(np.uint16),
                             rng.integers(0, 256, (6, 8, 3)).astype(np.uint8),
                             JC.Intrinsics.create(8, 6, 5.0, 5.0, 4.0, 3.0),
                             timestamp=5000.25, pack_color=True)
    tf = convert.frameset_from_arrays(
        np.asarray(jf.depth), np.asarray(jf.color), ti, depth_scale=np.asarray(jf.depth_scale),
        timestamp=np.asarray(jf.timestamp), timestamp_epoch=np.asarray(jf.timestamp_epoch),
        color_packed=np.asarray(jf.color_packed), device="cpu")
    assert (TFS.absolute_stamp(float(tf.timestamp), float(tf.timestamp_epoch))
            == jf.to_host().timestamp)
    np.testing.assert_array_equal(tf.depth.numpy(), np.asarray(jf.depth).astype(np.int32))
    np.testing.assert_array_equal(tf.color_packed.numpy(), np.asarray(jf.color_packed))
    pose = convert.pose_from_array(np.eye(4), device="cpu")
    assert pose.dtype == torch.float32 and pose.shape == (4, 4)
