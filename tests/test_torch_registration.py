"""The port's registration service (registration/pipeline.py) and its
config factory against the JAX package on the CPU.

Tolerances and their reasons:
- per-tick transforms: 5e-3 per entry, the parity gate's GICP bar
  (tpu_check.py:459-464); the two solvers differ only in f32 summation
  order and in the 6×6 solve (f64 Cholesky here);
- tick flags (discarded, guess reset, grid rebuilt) and iteration counts:
  equal;
- fitness: relative 1e-3 (a mean of f32 squared distances summed in
  another order);
- quality against the rig's truth: the bar of
  test_registration_pipeline.test_registration_converges_over_ticks
  (< 0.02 m, < 1.5°).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JI
from pointcloud_depthfusion_tpu.io.synthetic import (
    SyntheticScene, right_to_left_transform, two_camera_rig,
)
from pointcloud_depthfusion_tpu.registration import pipeline as JP
from pointcloud_depthfusion_tpu.utils import factory as JFAC
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TI
from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda
from pointcloud_depthfusion_tpu_torch.registration import pipeline as TP
from pointcloud_depthfusion_tpu_torch.utils import convert
from pointcloud_depthfusion_tpu_torch.utils import factory as TFAC

W, H = 106, 60
TICKS = 6
TRANSFORM_ATOL = 5e-3
# test_registration_converges_over_ticks's settings: annealing
# 0.12 → 0.07 → 0.02, then steady ticks on the cached target grid.
CONVERGE = dict(resolution=0.02, voxelsize=0.01, initial_resolution=0.12, resolution_step=0.05,
                max_iterations=48, discard_transform=False, reset_initial_guess=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: torch's OpenMP
    threads would otherwise spin between ops against the JAX thread pool
    and the test run's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """tests/test_registration_pipeline.make_depth_pair: the 106×60 rig."""
    ji = JI.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2)
    ti = TI.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2, device="cpu")
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    scene = SyntheticScene()
    fl = scene.render(ji, wl, depth_noise_std=0.002, seed=3)
    fr = scene.render(ji, wr, depth_noise_std=0.002, seed=4)
    return ji, ti, fl.depth, fr.depth, right_to_left_transform(wl, wr)


_RUNS = {}


def _run(pair, ns):
    """TICKS ticks of the JAX and the port pipeline, once per neighbor search."""
    if ns not in _RUNS:
        ji, ti, dl, dr, _ = pair
        jp = JP.RegistrationPipeline(ji, ji, JP.RegistrationSettings(**CONVERGE, neighbor_search=ns))
        tp = TP.RegistrationPipeline(ti, ti, TP.RegistrationSettings(**CONVERGE, neighbor_search=ns),
                                     device="cpu")
        out = [(jp.tick(dl, dr).copy(), tp.tick(dl, dr).copy()) for _ in range(TICKS)]
        _RUNS[ns] = jp, tp, out
    return _RUNS[ns]


def _flags(pipe):
    return [(t.discarded, t.guess_reset, t.target_grid_rebuilt) for t in pipe.telemetry]


def _error_vs_truth(t, t_true):
    err_t = np.linalg.norm(t[:3, 3] - t_true[:3, 3])
    dr_mat = t[:3, :3] @ t_true[:3, :3].T
    return err_t, np.rad2deg(np.arccos(np.clip((np.trace(dr_mat) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("ns", ["direct1", "direct7"])
def test_ticks_match_jax(pair, ns):
    jp, tp, out = _run(pair, ns)
    for k, (want, got) in enumerate(out):
        assert got.dtype == np.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_ATOL, err_msg=f"tick {k}")
    assert _flags(tp) == _flags(jp)
    # Ticks 0-2 anneal (a new grid each), ticks 3-5 reuse the cached grid.
    assert [f[2] for f in _flags(tp)] == [True, True, True, False, False, False]
    assert [t.iterations for t in tp.telemetry] == [t.iterations for t in jp.telemetry]
    for j, t in zip(jp.telemetry, tp.telemetry):
        assert (t.source_points, t.target_points) == (j.source_points, j.target_points)
        np.testing.assert_allclose(t.fitness, j.fitness, rtol=1e-3)
    assert tp.initial_phase == jp.initial_phase is False
    assert tp.current_resolution == jp.current_resolution


@pytest.mark.parametrize("ns", ["direct1", "direct7"])
def test_ticks_meet_the_quality_bar(pair, ns):
    _, tp, out = _run(pair, ns)
    err_t, ang = _error_vs_truth(out[-1][1], pair[4])
    assert err_t < 0.02 and ang < 1.5, (err_t, ang)
    assert tp.telemetry[-1].fitness < tp.telemetry[0].fitness


def test_gating_and_guess_reset_match_jax(pair):
    """A fitness gate that rejects everything, then an empty source frame
    (zero correspondences: the f32-max fitness resets the guess)."""
    ji, ti, dl, dr, _ = pair
    kw = dict(CONVERGE, discard_transform=True, reset_initial_guess=True, adjust_resolution=False)
    jp = JP.RegistrationPipeline(ji, ji, JP.RegistrationSettings(**kw))
    tp = TP.RegistrationPipeline(ti, ti, TP.RegistrationSettings(**kw), device="cpu")
    for p in (jp, tp):
        p.best_fitness = 1e-12
        p.initial_transform = np.eye(4, dtype=np.float32)
        p.initial_transform[0, 3] = 0.05
    for depth_right in (dr, np.zeros_like(dr)):
        np.testing.assert_allclose(tp.tick(dl, depth_right), jp.tick(dl, depth_right),
                                   rtol=0, atol=TRANSFORM_ATOL)
    assert _flags(tp) == _flags(jp) == [(True, False, True), (True, True, False)]
    np.testing.assert_array_equal(tp.last_transform, tp.start_transform)
    assert tp.best_fitness == pytest.approx(jp.best_fitness, rel=1e-3)


def test_profiling_csv_and_transform_persistence(pair, tmp_path):
    ji, ti, dl, dr, t_true = pair
    _, tp, out = _run(pair, "direct7")
    path = tmp_path / "prof.csv"
    tp.write_profiling_csv(str(path))
    lines = path.read_text().strip().split("\n")
    assert lines[0] == ("euclidean_fitness,icp_duration,points_target,points_source,"
                        "target_grid_rebuilt")
    assert [ln.rsplit(",", 1)[1] for ln in lines[1:]] == ["1", "1", "1", "0", "0", "0"]
    assert float(lines[-1].split(",")[0]) == tp.telemetry[-1].fitness

    saved = str(tmp_path / "calib" / "transform.txt")
    settings = dataclasses.replace(tp.settings, transform_path=saved, save_transform=True,
                                   load_transform=True)
    TP.RegistrationPipeline(ti, ti, settings, device="cpu").close()  # identity: nothing solved
    np.testing.assert_array_equal(TP.load_transform_file(saved), np.eye(4, dtype=np.float32))
    TP.save_transform_file(saved, out[-1][1])
    np.testing.assert_array_equal(JP.load_transform_file(saved), TP.load_transform_file(saved))
    loaded = TP.RegistrationPipeline(ti, ti, settings, device="cpu")
    np.testing.assert_allclose(loaded.initial_transform, out[-1][1], atol=1e-7)
    loaded.seed(t_true)
    assert not loaded.initial_phase and loaded.current_resolution == settings.resolution
    np.testing.assert_allclose(loaded.tick(dl, dr), t_true, atol=0.02)
    with open(saved, "w") as fh:
        fh.write("not a matrix")
    assert TP.load_transform_file(saved) is None is JP.load_transform_file(saved)


def test_angle_gate_matches_jax():
    rng = np.random.default_rng(5)
    for deg in rng.uniform(-8.0, 8.0, (12, 3)):
        a = np.deg2rad(deg)
        rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
        ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0], [-np.sin(a[1]), 0, np.cos(a[1])]])
        m = np.eye(4)
        m[:3, :3] = rz @ ry
        for upside in (False, True):
            assert TP.transform_angles_fit(m, upside) == JP.transform_angles_fit(m, upside)


def test_factory_builds_the_jax_settings():
    """configs/registration_default.yaml and configs/fusion_default.yaml
    through both factories."""
    want, jcfg = JFAC.registration_settings()
    got, tcfg = TFAC.registration_settings()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.neighbor_search == "direct7" and got.angle_gate is True
    assert tcfg.get("registration_node.spin_rate") == jcfg.get("registration_node.spin_rate")
    assert convert.registration_settings_from_dict(dataclasses.asdict(want)) == got
    with pytest.raises(ValueError, match="unknown registration settings"):
        convert.registration_settings_from_dict({"bogus": 1})

    jf, _ = JFAC.fusion_config()
    tf, _ = TFAC.fusion_config(device="cpu")
    for f in dataclasses.fields(tf):
        a, b = getattr(tf, f.name), getattr(jf, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def test_tick_rejects_mismatched_depth_and_counts_no_launch(pair):
    _, ti, dl, dr, _ = pair
    before = dict(segsum_cuda.launches)
    tp = TP.RegistrationPipeline(ti, ti, TP.RegistrationSettings(**CONVERGE), device="cpu")
    with pytest.raises(ValueError, match="does not match the registered intrinsics"):
        tp.tick(dl[::2, ::2], dr)
    tp.tick(torch.from_numpy(dl.astype(np.int32)), dr)
    assert segsum_cuda.launches == before
