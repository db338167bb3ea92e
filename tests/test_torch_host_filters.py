"""The camera node's temporal step: the native one-pass step of the port's
host runtime (``csrc/host/temporal.cpp``) bit for bit against the numpy
step it replaces (``host_filters._temporal_filter_numpy``) over chained
streams, and ``CameraNode`` yielding the same frames on either path, with
its counter naming the path each step took."""

import numpy as np
import pytest

from pointcloud_depthfusion_tpu_torch import runtime
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu_torch.ops import host_filters as HF

# An odd width and height, so the vectorised loop's tail runs too.
H, W = 37, 61
N_FRAMES = 12


@pytest.fixture(scope="module", autouse=True)
def built():
    runtime.load_library()


def _u16_holes_and_extremes(rng):
    """Depth with 1% holes, values pinned at 0 and 65535 in fixed pixels,
    and a wide spread so that some neighbours blend and some do not."""
    base = rng.integers(200, 65000, (H, W))
    out = []
    for _ in range(N_FRAMES):
        d = np.clip(base + rng.integers(-40, 41, (H, W)), 0, 65535).astype(np.uint16)
        d[rng.random((H, W)) < 0.01] = 0
        d[0, :7] = 65535
        d[1, :7] = 0
        d[2, ::3] = rng.choice([0, 65535], W)[::3]
        out.append(d)
    return out


def _u16_at_delta(rng, delta):
    """Each frame differs from the one before by exactly delta, delta - 1 or
    delta + 1 in most pixels, so the gate's edge decides each pixel."""
    d = rng.integers(1000, 60000, (H, W)).astype(np.int64)
    out = [d.astype(np.uint16)]
    for _ in range(N_FRAMES - 1):
        step = rng.choice([-1, 1], (H, W)) * (int(delta) + rng.integers(-1, 2, (H, W)))
        d = np.clip(out[-1].astype(np.int64) + step, 1, 65535)
        out.append(d.astype(np.uint16))
    return out


def _f32_disparity(rng, delta):
    """Disparity from the u16 stream, plus, in every frame from the third on,
    three pixels whose change from the history is f32(delta) exactly and its
    f32 neighbours (each a hole until the frame before, which sets the
    history to 0.5, where f32(delta) and its neighbours add exactly),
    and a -0.0."""
    depth = _u16_holes_and_extremes(rng)
    out = [HF.depth_to_disparity_np(d, 0.001, 631.0) for d in depth]
    edge = np.float32(delta)
    steps = np.array([np.nextafter(edge, np.float32(0)), edge, np.nextafter(edge, np.float32(1e9))],
                     np.float32)
    for k in range(2, len(out)):
        row = 3 + k
        for frame in out[:k - 1]:
            frame[row, :3] = 0.0
        out[k - 1][row, :3] = 0.5
        out[k][row, :3] = np.float32(0.5) + steps
        out[k][H - 1, k] = -0.0
    return out


STREAMS = {
    "u16 holes and extremes": (lambda rng: _u16_holes_and_extremes(rng), 0.4, 20.0),
    "u16 at delta 20": (lambda rng: _u16_at_delta(rng, 20), 0.4, 20.0),
    "u16 non-integer alpha and delta": (lambda rng: _u16_at_delta(rng, 20), 0.37, 20.3),
    # alpha 0.5 blends to x.5 wherever c + p is odd: half to even decides.
    "u16 half-way ties": (lambda rng: _u16_at_delta(rng, 20), 0.5, 20.0),
    "f32 disparity": (lambda rng: _f32_disparity(rng, 20.0), 0.4, 20.0),
    "f32 disparity, non-integer alpha and delta": (lambda rng: _f32_disparity(rng, 20.3),
                                                   0.37, 20.3),
}


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("stream", list(STREAMS))
def test_native_temporal_step_matches_numpy(stream):
    make, alpha, delta = STREAMS[stream]
    frames = make(np.random.default_rng(len(stream)))
    assert HF.temporal_runs_native(frames[0].dtype)
    hist_np = hist_native = frames[0]
    for k, frame in enumerate(frames[1:], 1):
        want = HF._temporal_filter_numpy(frame, hist_np, alpha, delta)
        got = HF.temporal_filter_np(frame, hist_native, alpha, delta)
        assert got.dtype == want.dtype == frame.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"frame {k}")
        assert got is not frame and got is not hist_native
        hist_np, hist_native = want, got


def test_temporal_step_dispatches_by_dtype():
    """Depth held as int32 takes the numpy step (the native loop holds u16
    and f32 only), and the native step refuses what it does not hold."""
    rng = np.random.default_rng(3)
    cur, prev = (rng.integers(0, 3000, (H, W)).astype(np.int32) for _ in range(2))
    assert not HF.temporal_runs_native(cur.dtype)
    got = HF.temporal_filter_np(cur, prev, 0.4, 20.0)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, HF._temporal_filter_numpy(cur, prev, 0.4, 20.0))
    with pytest.raises(ValueError, match="uint16 or float32"):
        runtime.temporal_filter_native(cur, prev)
    with pytest.raises(ValueError, match="does not match"):
        runtime.temporal_filter_native(cur.astype(np.uint16), prev.astype(np.float32))


class _ListSource(FramesetSource):
    intrinsics = Intrinsics.create(W, H, fx=30.0, fy=31.0, ppx=30.0, ppy=18.0, device="cpu")

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def next_frame(self):
        if self.i == len(self.frames):
            return None
        d = self.frames[self.i]
        self.i += 1
        return HostFrameset(depth=d, color=np.zeros((H, W, 3), np.uint8), timestamp=self.i / 30.0)


def _run_node(frames, **kw):
    cam = CameraNode("cam", _ListSource(frames), temporal_alpha=0.37, temporal_delta=20.3, **kw)
    got = []
    cam.subscribe_frameset(got.append)
    cam.spin(realtime=False)
    return [fs.depth for fs in got], cam.temporal_steps


@pytest.mark.parametrize("domain", ["depth", "disparity"])
def test_camera_node_same_frames_with_and_without_native(domain, monkeypatch):
    """The node's frames do not depend on whether the runtime loads; every
    step after the first frame (which starts the history) counts under the
    path it took."""
    frames = _u16_holes_and_extremes(np.random.default_rng(7))
    kw = dict(disparity_domain=domain == "disparity")
    native, native_steps = _run_node(frames, **kw)
    monkeypatch.setattr(HF, "_native", lambda: None)
    plain, plain_steps = _run_node(frames, **kw)
    assert len(native) == len(plain) == len(frames)
    for a, b in zip(native, plain):
        assert a.dtype == b.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
    steps = len(frames) - 1
    assert native_steps == {"native": steps, "numpy": 0}
    assert plain_steps == {"native": 0, "numpy": steps}
