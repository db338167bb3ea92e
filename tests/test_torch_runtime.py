"""The port's native host runtime (``runtime``, its own copy of the C++ and
its own ctypes binding) against the JAX package's on the same inputs: the
renderer and the native synthetic source bit for bit, the rs2 spatial and
decimation filters against the numpy versions and the JAX binding, the
pairer and the ring; and the build: a failing compiler raises with its
output and leaves no library."""

import pathlib

import numpy as np
import pytest

import pointcloud_depthfusion_tpu.runtime as jax_runtime
from pointcloud_depthfusion_tpu.core import camera as JCamera
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.io.feeder import NativeSyntheticSource as JNativeSource
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene as JScene
from pointcloud_depthfusion_tpu_torch import runtime
from pointcloud_depthfusion_tpu_torch.core import camera as TCamera
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import (
    ApproximateTimePairer,
    NativeSyntheticSource,
    SyntheticSource,
)
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu_torch.ops import host_filters as HF
from pointcloud_depthfusion_tpu_torch.runtime import bindings

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def built():
    """Build (or load) both libraries once per worker."""
    runtime.load_library()
    assert jax_runtime.is_available()


def _spheres(scene):
    return np.asarray([[s.center[0], s.center[1], s.center[2], s.radius, *s.base_color]
                       for s in scene.spheres])


def _grazing_pose():
    """Pitched 85°: part of the plane lies beyond max_depth (depth 0, its
    checker color kept)."""
    a = np.deg2rad(85.0)
    pose = np.eye(4)
    pose[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return pose


def test_host_source_is_a_byte_copy_of_the_jax_runtime():
    assert bindings.SOURCE.read_bytes() == (REPO / "runtime" / "pdf_runtime.cpp").read_bytes()
    assert bindings.BUILD_ROOT == REPO / "build" / "host_runtime"
    assert "-ffp-contract=off" in bindings.CXX_FLAGS and "-fopenmp" in bindings.CXX_FLAGS
    lib = pathlib.Path(runtime.load_library()._name)
    assert lib.parent.parent == bindings.BUILD_ROOT and lib.name == "libpdf_runtime.so"


@pytest.mark.parametrize("pose", ["left", "grazing"])
def test_native_render_matches_jax_and_numpy(pose):
    """Noise-free: equal to the port's numpy renderer; with noise and
    holes: equal to the JAX binding's render for the same seed."""
    scene = SyntheticScene()
    world = two_camera_rig()[0] if pose == "left" else _grazing_pose()
    args = (W, H, 50.0, 50.0, 32.0, 24.0, world, scene.plane_z, _spheres(scene),
            scene.checker_period, scene.max_depth, 0.001)
    intr = Intrinsics.create(W, H, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0, device="cpu")
    fs = scene.render(intr, world)
    depth, color = runtime.render_scene_native(*args)
    np.testing.assert_array_equal(depth, fs.depth)
    np.testing.assert_array_equal(color, fs.color)
    if pose == "grazing":
        assert ((depth == 0) & (color.sum(-1) > 0)).any()
    noisy = dict(noise_std=0.002, hole_fraction=0.05, seed=12345)
    for got, want in zip(runtime.render_scene_native(*args, **noisy),
                         jax_runtime.render_scene_native(*args, **noisy)):
        np.testing.assert_array_equal(got, want)


def test_native_source_matches_jax_native_source():
    """The same seed gives the same frames, noise and holes included."""
    wl, _ = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    kw = dict(depth_noise_std=0.002, hole_fraction=0.02, timestamp_jitter_s=0.001, seed=5)
    port = NativeSyntheticSource(SyntheticScene(), Intrinsics.create(
        W, H, fx=47.6, fy=47.6, ppx=32.0, ppy=24.0, device="cpu"), wl, **kw)
    ref = JNativeSource(JScene(), JIntr.create(W, H, fx=47.6, fy=47.6, ppx=32.0, ppy=24.0),
                        wl, **kw)
    for _ in range(3):
        a, b = port.next_frame(), ref.next_frame()
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.color, b.color)
        assert (a.timestamp, a.depth_scale) == (b.timestamp, b.depth_scale)
        assert (a.depth == 0).mean() > 0.01
    # Noise-free, it equals the numpy source.
    kw = dict(depth_noise_std=0.0, hole_fraction=0.0, seed=5)
    intr = port.intrinsics
    np.testing.assert_array_equal(
        NativeSyntheticSource(SyntheticScene(), intr, wl, **kw).next_frame().depth,
        SyntheticSource(SyntheticScene(), intr, wl, **kw).next_frame().depth)


def _depth(rng, h=H, w=W):
    d = rng.integers(300, 3000, (h, w)).astype(np.uint16)
    d[rng.random((h, w)) < 0.15] = 0
    return d


@pytest.mark.parametrize("holes_fill", range(6))
def test_native_spatial_filter_matches_numpy_and_jax(holes_fill):
    rng = np.random.default_rng(11 + holes_fill)
    d = _depth(rng)
    disp = rng.random((32, 40)).astype(np.float32) * 50 + 10
    disp[rng.random((32, 40)) < 0.2] = 0.0
    for x, args in ((d, (0.55, 20.0, 2)), (disp, (0.5, 8.0, 1))):
        got = runtime.spatial_filter_native(x, *args, holes_fill=holes_fill)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(
            got, HF._spatial_filter_numpy(x, *args, holes_fill=holes_fill))
        np.testing.assert_array_equal(
            got, jax_runtime.spatial_filter_native(x, *args, holes_fill=holes_fill))
        np.testing.assert_array_equal(HF.spatial_filter_np(x, *args, holes_fill=holes_fill), got)


@pytest.mark.parametrize("magnitude", [2, 3, 4])
def test_native_decimation_matches_numpy_and_jax(magnitude):
    d = _depth(np.random.default_rng(magnitude), 48, 72)
    got = runtime.decimation_filter_native(d, magnitude)
    np.testing.assert_array_equal(got, HF._decimation_filter_numpy(d, magnitude))
    np.testing.assert_array_equal(got, jax_runtime.decimation_filter_native(d, magnitude))
    np.testing.assert_array_equal(HF.decimation_filter_np(d, magnitude), got)
    with pytest.raises(ValueError, match="not divisible"):
        runtime.decimation_filter_native(d[:, :-1], magnitude)


def test_spatial_filter_dispatch_dtype_and_value_identical(monkeypatch):
    """Wide integers (values over 65535) stay on numpy; u16, u8 and f32 go
    native; either way the values and dtype are the numpy version's."""
    rng = np.random.default_rng(3)
    wide = rng.integers(0, 90_000, (32, 40)).astype(np.int32)
    calls = []

    def native(depth, *args, **kw):
        calls.append(depth.dtype)
        return bindings.spatial_filter_native(depth, *args, **kw)

    monkeypatch.setattr(runtime, "spatial_filter_native", native)
    got = HF.spatial_filter_np(wide, 0.55, 20.0, 1)
    assert got.dtype == np.int32 and not calls
    np.testing.assert_array_equal(got, HF._spatial_filter_numpy(wide, 0.55, 20.0, 1))
    for dtype in (np.uint16, np.uint8, np.float32):
        x = rng.integers(1, 250, (32, 40)).astype(dtype)
        got = HF.spatial_filter_np(x, 0.55, 20.0, 1)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, HF._spatial_filter_numpy(x, 0.55, 20.0, 1))
    assert calls == [np.uint16, np.uint16, np.float32]


@pytest.mark.parametrize("holes_fill", [-1, 6])
def test_native_spatial_filter_validates_holes_fill(holes_fill):
    """The port's binding raises where the C++ (and the JAX binding) clamps."""
    d = _depth(np.random.default_rng(0))
    with pytest.raises(ValueError, match="holes_fill"):
        runtime.spatial_filter_native(d, holes_fill=holes_fill)
    with pytest.raises(ValueError, match="holes_fill"):
        HF.spatial_filter_np(d, holes_fill=holes_fill)


def test_native_pairer_matches_python():
    rng = np.random.default_rng(7)
    native, python = runtime.NativePairer(0.017, 10), ApproximateTimePairer(0.017, 10)
    stamps = {0: 0.0, 1: 0.004}
    for fid in range(60):
        stream = int(rng.integers(0, 2))
        stamps[stream] += 1 / 30.0 + float(rng.normal(0, 0.002))
        ts = stamps[stream]
        got_n = native.push(stream, ts, fid)
        got_p = python.push(stream, HostFrameset(np.zeros((2, 2), np.uint16),
                                                 np.zeros((2, 2, 3), np.uint8), ts))
        assert len(got_n) == len(got_p), (fid, got_n, got_p)
    assert native.emitted == python.emitted > 10
    assert native.dropped == python.dropped


def test_native_ring_order_and_capacity():
    ring = runtime.NativeRing(8, 3)
    for i in range(3):
        assert ring.try_write(np.full(8 - i, i, np.uint8))
    assert len(ring) == 3 and not ring.try_write(np.zeros(8, np.uint8))  # full
    with pytest.raises(ValueError, match="exceeds"):
        ring.try_write(np.zeros(9, np.uint8))
    for i in range(3):
        got = ring.try_read()
        assert got.tolist() == [i] * (8 - i) + [0] * i
    assert ring.try_read() is None and len(ring) == 0


def test_camera_presets_match_jax():
    for name in ("D455", "d435", "Intel RealSense L515"):
        assert TCamera.model_preset(name) == JCamera.model_preset(name)
    with pytest.raises(KeyError, match="unknown camera model"):
        TCamera.model_preset("D999")
    kw = dict(fx=631.5, fy=630.25, ppx=640.125, ppy=359.875)
    assert TCamera.intrinsics_as_numpy(Intrinsics.create(1280, 720, device="cpu", **kw)) == \
        JCamera.intrinsics_as_numpy(JIntr.create(1280, 720, **kw))


def _fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_error", None)
    monkeypatch.setattr(bindings, "build_log", "")
    monkeypatch.setattr(bindings, "BUILD_ROOT", tmp_path / "build")


def test_failing_compiler_raises_with_its_output(monkeypatch, tmp_path):
    """A compiler that fails on the source: load_library raises with its
    output, again without rebuilding, no library is left, and
    is_available() is False."""
    fake = tmp_path / "g++"
    log = tmp_path / "calls"
    fake.write_text(f"#!/bin/sh\necho x >> {log}\ncase \"$*\" in *-print-file-name*) echo $0; "
                    "exit 0;; *-E*) exit 0;; esac\n"
                    "echo 'pdf_runtime.cpp:1: error: no such flag' >&2\nexit 1\n")
    fake.chmod(0o755)
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(bindings, "_cxx_candidates", lambda: [str(fake)])
    with pytest.raises(RuntimeError, match="no such flag"):
        runtime.load_library()
    calls = len(log.read_text().split())
    with pytest.raises(RuntimeError, match="no such flag"):
        runtime.load_library()
    assert len(log.read_text().split()) == calls  # latched, not rebuilt
    assert not runtime.is_available()
    assert not list((tmp_path / "build").rglob("*.so"))
    with pytest.raises(RuntimeError, match="no such flag"):
        runtime.render_scene_native(4, 4, 1.0, 1.0, 2.0, 2.0, np.eye(4), 2.5,
                                    np.zeros((0, 7)), 0.25, 20.0, 0.001)


def test_compiler_without_openmp_is_passed_over(monkeypatch, tmp_path):
    """A compiler that finds no libgomp.spec (installed without
    OpenMP) is skipped for the next candidate; with none left, it raises."""
    no_omp = tmp_path / "g++-no-omp"
    no_omp.write_text("#!/bin/sh\necho libgomp.spec\n")
    no_omp.chmod(0o755)
    real = bindings.find_cxx()
    monkeypatch.setattr(bindings, "_cxx_candidates", lambda: [str(no_omp), real])
    assert bindings.find_cxx() == real
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(bindings, "_cxx_candidates", lambda: [str(no_omp)])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler with OpenMP"):
        runtime.load_library()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(bindings, "_cxx_candidates", lambda: [str(tmp_path / "no-g++")])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        runtime.load_library()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        NativeSyntheticSource(SyntheticScene(), Intrinsics.create(
            8, 6, 5.0, 5.0, 4.0, 3.0, device="cpu"), np.eye(4)).next_frame()
    assert not (tmp_path / "build").exists()
