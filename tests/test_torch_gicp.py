"""The port's VGICP solver (registration/gicp.py) and its geometry helpers
against the JAX package on the CPU.

Tolerances and their reasons:
- transforms: 5e-3 per entry, the parity gate's GICP bar
  (tpu_check.py:459-464) for f32 Gauss-Newton paths that differ in
  summation order (the port sums the K neighbor probes and the points in
  one reduction, and solves the 6×6 step in f64);
- iteration and correspondence counts: equal, except at the end of the
  coarse-to-fine ladder, where one iteration and two correspondences apart
  are allowed (its exit test sits at the epsilon);
- pose helpers (se3_exp, Euler angles, point transforms): 1e-6, the pose
  bar of test_torch_core.py (sin/cos/atan2 differ by ulps across libraries);
- 3×3 / 6×6 solves: relative 1e-5 (f32 cofactors; f64 vs f32 Cholesky);
- regularized covariances of the prepared grids: 2e-3 per entry. JAX's
  jitted covariance cancellation rounds differently, and the plane normal
  of a voxel whose two smallest eigenvalues nearly tie swings on that
  difference (at the gate's inputs 1.8% of source voxels differ by more
  than 1e-4; the largest difference is 1.3e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core import geometry as JG
from pointcloud_depthfusion_tpu.core.camera import Distortion
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JI
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu.ops import filters as JF
from pointcloud_depthfusion_tpu.registration import gicp as JGI
from pointcloud_depthfusion_tpu_torch.core import geometry as TG
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TI
from pointcloud_depthfusion_tpu_torch.registration import gicp as TGI
from pointcloud_depthfusion_tpu_torch.utils import convert

TRANSFORM_ATOL = 5e-3
POSE_ATOL = 1e-6
# The gate's solve (tpu_check.py:302-313) on its inputs at half size.
GATE_KW = dict(resolution=0.1, voxel_size=0.05, kernel_width=0.05, kernel_max_dist=0.25,
               max_iterations=30, table_size=1 << 13)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: torch's OpenMP
    threads would otherwise spin between ops against the JAX thread pool
    and the test run's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def clouds():
    """tpu_check._build_gicp_inputs at 212×120: the converging rig's two
    depth frames, filtered and deprojected by the JAX package."""
    w, h = 212, 120
    intr = JI.create(w, h, fx=157.5, fy=157.5, ppx=w / 2, ppy=h / 2, dtype=jnp.float32)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    fl = scene.render(intr, wl, depth_noise_std=0.001)
    fr = scene.render(intr, wr, depth_noise_std=0.001, seed=1)

    def to_cloud(d):
        dd, vv = JF.filter_depth(jnp.asarray(d), 0.001, 0.5, 10.0, None)
        pts, vv = JG.deproject(dd.astype(jnp.float32) * 0.001, intr, vv)
        return np.asarray(pts.reshape(-1, 3), np.float32), np.asarray(vv.reshape(-1))

    tgt, tv = to_cloud(fl.depth)
    src, sv = to_cloud(fr.depth)
    return src, sv, tgt, tv


_SOLVES = {}


# Jitted like every production caller; shared, so every solve of one
# neighbor search on the gate's clouds reuses one compiled program.
_JAX_REGISTER = jax.jit(JGI.gicp_register)


def _solve(clouds, ns):
    """JAX and port solves, once per neighbor search."""
    if ns not in _SOLVES:
        src, sv, tgt, tv = clouds
        kw = dict(GATE_KW, neighbor_search=ns)
        jr = _JAX_REGISTER(
            jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt), jnp.asarray(tv),
            jnp.eye(4, dtype=jnp.float32), JGI.GICPConfig.create(**kw))
        tr = TGI.gicp_register(_t(src), _t(sv), _t(tgt), _t(tv), torch.eye(4),
                               TGI.GICPConfig.create(device="cpu", **kw))
        _SOLVES[ns] = jr, tr
    return _SOLVES[ns]


@pytest.mark.parametrize("ns", ["direct1", "direct7"])
def test_gicp_register_matches_jax(clouds, ns):
    jr, tr = _solve(clouds, ns)
    np.testing.assert_allclose(tr.transform.numpy(), np.asarray(jr.transform),
                               rtol=0, atol=TRANSFORM_ATOL)
    assert int(tr.iterations) == int(jr.iterations)
    assert int(tr.num_correspondences) == int(jr.num_correspondences) > 100
    assert bool(tr.converged) == bool(jr.converged)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-3)


@pytest.mark.parametrize("ns", ["direct1", "direct7"])
def test_multiscale_matches_jax(clouds, ns, monkeypatch):
    """A three-stage coarse-to-fine ladder on the gate's clouds. JAX's own
    gicp_register_multiscale runs, with each stage through the shared
    jitted solve (the ladder keeps the gate's static fields, so no stage
    compiles anew)."""
    src, sv, tgt, tv = clouds
    kw = dict(resolution=0.1, voxel_size=0.05, coarse_start=0.3, steps=3, max_iterations=30,
              coarse_iterations=8, kernel_width=0.05, table_size=1 << 13, neighbor_search=ns)
    jcfgs = JGI.default_multiscale_configs(**kw)
    tcfgs = TGI.default_multiscale_configs(device="cpu", **kw)
    assert [c.iteration_cap for c in tcfgs] == [int(c.iteration_cap) for c in jcfgs] == [8, 8, 30]
    for jc, tc in zip(jcfgs, tcfgs):
        for f in ("resolution", "rotation_eps", "translation_eps", "kernel_max_dist", "damping"):
            assert float(getattr(tc, f)) == float(getattr(jc, f)), f
    monkeypatch.setattr(JGI, "gicp_register", _JAX_REGISTER)
    jr = JGI.gicp_register_multiscale(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt),
                                      jnp.asarray(tv), jnp.eye(4, dtype=jnp.float32), jcfgs)
    tr = TGI.gicp_register_multiscale(_t(src), _t(sv), _t(tgt), _t(tv), torch.eye(4), tcfgs)
    np.testing.assert_allclose(tr.transform.numpy(), np.asarray(jr.transform),
                               rtol=0, atol=TRANSFORM_ATOL)
    # The last stage's step-norm exit sits at its epsilon here, so rounding
    # may move it by one iteration (direct1: 16 against JAX's 17, with 1498
    # against 1497 correspondences).
    assert abs(int(tr.iterations) - int(jr.iterations)) <= 1
    assert abs(int(tr.num_correspondences) - int(jr.num_correspondences)) <= 2
    with pytest.raises(ValueError, match="at least one stage"):
        TGI.gicp_register_multiscale(_t(src), _t(sv), _t(tgt), _t(tv), torch.eye(4), ())


def test_prepared_target_and_source_match_jax(clouds):
    src, sv, tgt, tv = clouds
    jc, tc = JGI.GICPConfig.create(**GATE_KW), TGI.GICPConfig.create(device="cpu", **GATE_KW)
    jt = jax.jit(JGI.prepare_target)(jnp.asarray(tgt), jnp.asarray(tv), jc)
    tt = TGI.prepare_target(_t(tgt), _t(tv), tc)
    np.testing.assert_array_equal(tt.count.numpy(), np.asarray(jt.count))
    np.testing.assert_array_equal(tt.coords.numpy(), np.asarray(jt.coords))
    np.testing.assert_allclose(tt.mean.numpy(), np.asarray(jt.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.cov.numpy(), np.asarray(jt.cov), rtol=0, atol=2e-3)
    js = jax.jit(JGI.prep_source)(jnp.asarray(src), jnp.asarray(sv), jc)
    ts = TGI.prep_source(_t(src), _t(sv), tc)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(js[2]), rtol=0, atol=2e-3)

    rows, coords = TGI.pack_target_table(tt)
    jtable = np.asarray(JGI.pack_target_table(jt))
    assert rows.shape == (tt.table_size, 10) and coords.dtype == torch.int32
    np.testing.assert_array_equal(coords.numpy(), jtable[:, 10:13].view(np.int32))
    np.testing.assert_array_equal(rows[:, :4].numpy(), jtable[:, :4])

    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.01, -0.02, 0.005]
    want = float(JGI.fitness_score(jnp.asarray(src), jnp.asarray(sv), jt, jnp.asarray(t)))
    got = float(TGI.fitness_score(_t(src), _t(sv), tt, _t(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_small_solves_match_jax():
    rng = np.random.default_rng(11)
    m = rng.normal(size=(200, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(TGI._inv3x3(_t(m)).numpy(), np.asarray(JGI._inv3x3(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-6)
    s = m @ m.transpose(0, 2, 1)
    comps = [s[:, 0, 0], s[:, 0, 1], s[:, 0, 2], s[:, 1, 1], s[:, 1, 2], s[:, 2, 2]]
    for got, want in zip(TGI._sym_inv6(*map(_t, comps)), JGI._sym_inv6(*map(jnp.asarray, comps))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    h = (a @ a.T + np.eye(6)).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32)
    got = TGI._solve_6x6(_t(h), _t(g), torch.tensor(0.01)).numpy()
    want = np.asarray(JGI._solve_6x6(jnp.asarray(h), jnp.asarray(g), jnp.float32(0.01)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got.dtype == np.float32
    # Not positive definite: a NaN step, which the solver zeroes.
    assert torch.isnan(TGI._solve_6x6(-_t(h), _t(g), torch.tensor(0.01))).all()


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(12)
    for xi in [np.zeros(6), np.full(6, 1e-10), *rng.normal(0, 0.3, (6, 6))]:
        xi = xi.astype(np.float32)
        np.testing.assert_allclose(TG.se3_exp(_t(xi)).numpy(), np.asarray(JG.se3_exp(jnp.asarray(xi))),
                                   rtol=0, atol=POSE_ATOL)
    assert torch.equal(TG.se3_exp(torch.zeros(6)), torch.eye(4))
    for angles in rng.uniform(-1.2, 1.2, (5, 3)).astype(np.float32):
        r = np.asarray(JG.euler_to_matrix(jnp.asarray(angles)))
        np.testing.assert_allclose(TG.extract_euler_angles(_t(r)).numpy(),
                                   np.asarray(JG.extract_euler_angles(jnp.asarray(r))),
                                   rtol=0, atol=POSE_ATOL)
    assert TG.rad2deg(np.pi) == pytest.approx(float(JG.rad2deg(np.pi)))
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    t = np.asarray(JG.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6).astype(np.float32))))
    np.testing.assert_allclose(TG.transform_points(_t(pts), _t(t)).numpy(),
                               np.asarray(JG.transform_points(jnp.asarray(pts), jnp.asarray(t))),
                               rtol=0, atol=POSE_ATOL * 4)


@pytest.mark.parametrize("model", [Distortion.NONE, Distortion.INVERSE_BROWN_CONRADY])
def test_deproject_matches_jax(model):
    rng = np.random.default_rng(int(model))
    h, w = 60, 80
    kw = dict(fx=61.5, fy=60.25, ppx=40.3, ppy=29.6, model=model,
              coeffs=(0.11, -0.23, 0.0021, -0.0017, 0.045))
    ji, ti = JI.create(w, h, dtype=jnp.float32, **kw), TI.create(w, h, device="cpu", **kw)
    depth = (rng.integers(0, 4000, (h, w)) * np.float32(0.001)).astype(np.float32)
    mask = rng.random((h, w)) < 0.9
    jp, jv = JG.deproject(jnp.asarray(depth), ji, jnp.asarray(mask))
    tp, tv = TG.deproject(_t(depth), ti, _t(mask))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # Bit-exact up to XLA's CPU division, which misrounds a few quotients.
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-7, atol=0)
    assert tp.shape == (h, w, 3)


def test_config_from_jax_arrays_and_unported_paths(clouds):
    jc = JGI.GICPConfig.create(fitness_rel_eps=5e-3, iteration_cap=7, **GATE_KW)
    static = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.metadata.get("static")}
    leaves = [np.asarray(getattr(jc, f)) for f in (
        "resolution", "voxel_size", "rotation_eps", "translation_eps", "fitness_eps",
        "fitness_rel_eps", "kernel_width", "kernel_max_dist", "damping", "iteration_cap")]
    tc = convert.gicp_config_from_arrays(*leaves, device="cpu", **static)
    assert tc == dataclasses.replace(tc) and tc.iteration_cap == 7
    assert tc.table_size == 1 << 13 and float(tc.fitness_rel_eps) == np.float32(5e-3)
    src, sv, tgt, tv = (_t(a) for a in clouds)
    matrix = TGI.gicp_register(src, sv, tgt, tv, torch.eye(4),
                               dataclasses.replace(tc, solver="matrix"))
    assert bool(torch.isfinite(matrix.transform).all()) and int(matrix.iterations) >= 1
    with pytest.raises(ValueError, match="planar"):
        TGI.gicp_register(src, sv, tgt, tv, torch.eye(4),
                          dataclasses.replace(tc, solver="matrix", neighbor_search="direct7"))
    with pytest.raises(ValueError, match="neighbor_search"):
        TGI.gicp_register(src, sv, tgt, tv, torch.eye(4),
                          dataclasses.replace(tc, neighbor_search="direct5"))


def test_no_correspondences_reports_unconverged(clouds):
    """The gate's source moved 100 m away (same shapes and settings, so the
    shared jitted solve is reused)."""
    src, sv, tgt, tv = clouds
    src = src + np.float32(100.0)
    jr = _JAX_REGISTER(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt), jnp.asarray(tv),
                       jnp.eye(4, dtype=jnp.float32), JGI.GICPConfig.create(**GATE_KW))
    tr = TGI.gicp_register(_t(src), _t(sv), _t(tgt), _t(tv), torch.eye(4),
                           TGI.GICPConfig.create(device="cpu", **GATE_KW))
    assert int(tr.num_correspondences) == 0 and not bool(tr.converged)
    assert float(tr.fitness) == float(jr.fitness) > 1e10
    assert int(tr.iterations) == int(jr.iterations) == 1
    np.testing.assert_array_equal(tr.transform.numpy(), np.eye(4, dtype=np.float32))
