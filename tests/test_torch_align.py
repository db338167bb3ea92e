"""The port's depth→color alignment (plain B2 on the CPU) against the JAX
package's ``align_depth_to_color(method="scatter")`` run op by op and the
scalar oracle of tests/oracles.py. Bit-exact. The cases are those of
tests/test_align.py."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_depthfusion_tpu.core.camera import Extrinsics as JExt
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.ops import align as JA
from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.ops import align as TA
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda as Z

METHODS = ("binned", "sorted", "scatter", None)
ROT_A = 0.02
T = (0.015, -0.001, 0.002)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                    np.float32)


def _cams(model=Distortion.NONE, coeffs=(0.0,) * 5):
    """tests/test_align.py:12-22: a 32×24 depth camera, a 40×30 color
    camera, a small rotation and baseline. (JAX, port)."""
    d = dict(width=32, height=24, fx=28.0, fy=28.5, ppx=16.0, ppy=12.0)
    c = dict(width=40, height=30, fx=35.0, fy=35.5, ppx=20.0, ppy=15.0, model=model,
             coeffs=coeffs)
    rot = _rot(ROT_A)
    jax_side = (JIntr.create(**d), JIntr.create(**c), JExt.create(rot, T))
    port = (Intrinsics.create(**d, device="cpu"), Intrinsics.create(**c, device="cpu"),
            Extrinsics.create(rot, T, device="cpu"))
    return jax_side, port


def _depth(seed):
    rng = np.random.default_rng(seed)
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    depth[rng.random((24, 32)) < 0.2] = 0
    return depth


def _port(depth, cams, **kw):
    return TA.align_depth_to_color(torch.from_numpy(depth.astype(np.int32)), 0.001, *cams, **kw)


def _oracle(depth):
    return oracles.align_depth_to_color_oracle(
        depth, 0.001, 28.0, 28.5, 16.0, 12.0, 35.0, 35.5, 20.0, 15.0,
        _rot(ROT_A).astype(np.float64), np.array(T), 40, 30)


@pytest.mark.parametrize("footprint", [4, "auto", 8])
def test_align_matches_jax_and_oracle(footprint):
    (jd, jc, je), cams = _cams()
    depth = _depth(1234)
    want = JA.align_depth_to_color(jnp.asarray(depth), 0.001, jd, jc, je,
                                   max_footprint=footprint, method="scatter")
    before = dict(Z.launches)
    got = _port(depth, cams, max_footprint=footprint)
    assert got.dtype == torch.int32 and got.shape == (30, 40)
    assert Z.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), _oracle(depth).astype(np.int32))
    assert (got.numpy() > 0).mean() > 0.5


def test_every_method_name_is_identical():
    """The JAX package's methods are bit-identical; the port accepts each
    name and runs one formulation."""
    _, cams = _cams()
    depth = _depth(7)
    outs = [_port(depth, cams, method=m) for m in METHODS]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("model", [Distortion.MODIFIED_BROWN_CONRADY, Distortion.FTHETA])
def test_align_with_a_distorting_color_camera(model):
    """project_points' forward models (geometry.py:163-177)."""
    coeffs = (0.9, 0.0, 0.0, 0.0, 0.0) if model == Distortion.FTHETA else (
        0.11, -0.23, 0.0021, -0.0017, 0.045)
    (jd, jc, je), cams = _cams(model, coeffs)
    depth = _depth(11)
    want = JA.align_depth_to_color(jnp.asarray(depth), 0.001, jd, jc, je, method="scatter")
    np.testing.assert_array_equal(_port(depth, cams).numpy(), np.asarray(want).astype(np.int32))


def test_saturated_and_zero_depth_map_to_zero():
    """0xFFFF collides with the reference's buffer sentinel (kernels.cu:284)
    and comes out 0, as zero depth does."""
    _, cams = _cams()
    for value in (0xFFFF, 0):
        out = _port(np.full((24, 32), value, np.uint16), cams)
        assert int(out.sum()) == 0
    mixed = _depth(3)
    mixed[::3] = 0xFFFF
    (jd, jc, je), _ = _cams()
    want = JA.align_depth_to_color(jnp.asarray(mixed), 0.001, jd, jc, je, method="scatter")
    np.testing.assert_array_equal(_port(mixed, cams).numpy(), np.asarray(want).astype(np.int32))


def test_identity_extrinsics_same_intrinsics():
    """test_align.py:42: each interior pixel's own box covers it, so its
    aligned value never exceeds its input."""
    intr = Intrinsics.create(32, 24, fx=28.0, fy=28.0, ppx=16.0, ppy=12.0, device="cpu")
    depth = np.random.default_rng(1234).integers(400, 3000, (24, 32)).astype(np.uint16)
    got = _port(depth, (intr, intr, Extrinsics.identity("cpu"))).numpy()
    nonzero = got > 0
    assert nonzero.mean() > 0.9
    sel = nonzero.copy()
    sel[-1, :] = sel[:, -1] = False
    assert (got[sel] <= depth[sel]).all()


def test_auto_footprint_matches_jax_and_warns_outside_the_envelope():
    (jd, jc, je), (td, tc, te) = _cams()
    assert TA.auto_footprint(td, tc) == JA.auto_footprint(jd, jc) == 3
    assert TA.auto_footprint(td, tc, te) == JA.auto_footprint(jd, jc, je)
    d = dict(width=640, height=480, ppx=320.0, ppy=240.0)
    pairs = [(dict(fx=400.0, fy=400.0), dict(fx=560.0, fy=560.0))]
    for ext in ((np.eye(3), [0.015, 0.0, 0.0]), (np.eye(3), [0.0, 0.0, -0.08]),
                (np.eye(3), [0.0, 0.0, -0.3]), (_rot(0.5), [0.01, 0.0, 0.0])):
        for (fd, fc) in pairs:
            j = (JIntr.create(**d, **fd), JIntr.create(**d, **fc), JExt.create(*ext))
            t = (Intrinsics.create(**d, **fd, device="cpu"),
                 Intrinsics.create(**d, **fc, device="cpu"), Extrinsics.create(*ext, device="cpu"))
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                want = JA.auto_footprint(*j)
            with warnings.catch_warnings(record=True) as tw:
                warnings.simplefilter("always")
                got = TA.auto_footprint(*t)
            assert got == want
            assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    with pytest.warns(UserWarning, match="envelope"):
        assert TA.auto_footprint(t[0], t[1], Extrinsics.create(np.eye(3), [0, 0, -0.3],
                                                              device="cpu")) == 8


def test_auto_footprint_without_values_falls_back_to_four():
    """Calibration with no values to read (meta tensors, the analogue of
    the JAX package's traced intrinsics) takes the conservative cap 4."""
    _, (td, tc, te) = _cams()
    meta = Intrinsics.create(40, 30, 35.0, 35.5, 20.0, 15.0, device="meta")
    with pytest.warns(UserWarning, match="no values"):
        assert TA.auto_footprint(td, meta, te) == 4
