"""The port's camera-ingest stage on the CPU, through both of its faces:
``DeviceFeeder`` (the dual pair) and ``RigFeeder`` (the N-camera rig).
The behaviours the faces share are one test each over ``dual`` and
``rig``; the pair's Framesets are held field by field to
``Frameset.create`` of their host frames."""

import time

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset, HostFrameset, split_stamp
from pointcloud_depthfusion_tpu_torch.io.feeder import (
    DeviceFeeder,
    DevicePair,
    FramesetSource,
    RigFeeder,
    SyntheticSource,
)
from torch_rig_common import FiniteSource, arc_sources, small_intrinsics

FACES = ("dual", "rig")
CAMERAS = {"dual": 2, "rig": 3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feeder(face, sources, **kw):
    if face == "dual":
        return DeviceFeeder(*sources, device="cpu", **kw)
    return RigFeeder(sources, device="cpu", **kw)


def _sources(face, cls=SyntheticSource, **kw):
    return arc_sources(CAMERAS[face], small_intrinsics(), cls, **kw)


def _hosts(item):
    if isinstance(item, DevicePair):
        return (item.host_left, item.host_right)
    return item.host_frames


def _stacked(item):
    """(depth, color, depth_scale) of an uploaded item on a camera axis."""
    if isinstance(item, DevicePair):
        fs = (item.left, item.right)
        return tuple(torch.stack([getattr(f, k) for f in fs])
                     for k in ("depth", "color", "depth_scale"))
    return item.depth, item.color, item.depth_scale


class Replay(FramesetSource):
    """The given host frames, then the end of the stream."""

    def __init__(self, frames, intr):
        self.frames, self._intr = list(frames), intr

    @property
    def intrinsics(self):
        return self._intr

    def next_frame(self):
        return self.frames.pop(0) if self.frames else None


@pytest.mark.parametrize("face", FACES)
def test_feeder_finite_sources_deliver_all_sets(face):
    """Five jittered but matchable rounds (spread under the 17 ms gate):
    every set reaches the consumer, stacked bit for bit from its host
    frames, before the end of stream; a second end-of-stream get answers
    None again."""
    n = CAMERAS[face]
    with _feeder(face, _sources(face, FiniteSource, n_frames=5,
                                timestamp_jitter_s=0.003)) as feeder:
        items = list(feeder)
    assert len(items) == 5
    for item in items:
        hosts = _hosts(item)
        depth, color, scale = _stacked(item)
        assert depth.shape == (n, 24, 32) and depth.dtype == torch.int32
        assert color.shape == (n, 24, 32, 3) and color.dtype == torch.uint8
        np.testing.assert_array_equal(depth.numpy(), np.stack([f.depth for f in hosts]))
        np.testing.assert_array_equal(color.numpy(), np.stack([f.color for f in hosts]))
        assert scale.tolist() == pytest.approx([0.001] * n)
        stamps = [f.timestamp for f in hosts]
        assert max(stamps) - min(stamps) <= 0.017
        assert item.upload_ms >= 0.0
    assert feeder.get() is None
    assert feeder.get() is None


@pytest.mark.parametrize("face", FACES)
def test_feeder_rejects_decimated_depth(face):
    """A decimated (not colour-aligned) depth stream fails at the feeder
    with the explanation, not later as a shape error in the fusion step."""
    class DecimatedSource(SyntheticSource):
        def next_frame(self):
            f = super().next_frame()
            return HostFrameset(depth=f.depth[::2, ::2], color=f.color,
                                depth_scale=f.depth_scale, timestamp=f.timestamp)

    sources = _sources(face)[:-1] + _sources(face, DecimatedSource)[-1:]
    with pytest.raises(RuntimeError, match="producer failed") as ei:
        with _feeder(face, sources) as feeder:
            feeder.get(timeout=30.0)
    assert isinstance(ei.value.__cause__, ValueError)
    assert "size mismatch" in str(ei.value.__cause__)


@pytest.mark.parametrize("face", FACES)
def test_feeder_source_error_reaches_consumer(face):
    class Broken(SyntheticSource):
        def next_frame(self):
            if self.frame_idx == 2:
                raise OSError("camera unplugged")
            return super().next_frame()

    feeder = _feeder(face, _sources(face, Broken))
    with pytest.raises(RuntimeError, match="producer failed") as ei:
        with feeder:
            for _ in range(10):
                assert feeder.get(timeout=30.0) is not None
    assert isinstance(ei.value.__cause__, OSError)
    assert not feeder._thread.is_alive()


@pytest.mark.parametrize("face", FACES)
def test_feeder_upload_false_delivers_host_items(face):
    """upload=False: every set reaches the consumer with its host frames and
    stamps only (the machinery-isolation mode)."""
    with _feeder(face, _sources(face, FiniteSource, n_frames=3), upload=False) as feeder:
        items = list(feeder)
    assert len(items) == 3
    for item in items:
        if face == "dual":
            assert item.left is None and item.right is None
        else:
            assert item.depth is None and item.color is None and item.depth_scale is None
            assert item.timestamps == [f.timestamp for f in item.host_frames]
        assert item.upload_ms == 0.0 and len(_hosts(item)) == CAMERAS[face]


@pytest.mark.parametrize("face", FACES)
def test_feeder_lifespan_skips_stale_sets(face):
    """QoS lifespan (fusion_node.cpp:183-187): sets older than lifespan_s at
    dequeue are skipped, and a fresh one follows."""
    feeder = _feeder(face, _sources(face), lifespan_s=0.2)
    with feeder:
        assert feeder.get(timeout=10.0) is not None
        time.sleep(0.6)  # every set queued before this is now stale
        fresh = feeder.get(timeout=10.0)
        age = time.perf_counter() - fresh.enqueue_time
    assert feeder.dropped_stale >= 1
    assert age < 0.6  # queued after the sleep began


def test_device_feeder_framesets_equal_frameset_create():
    """Each delivered Frameset equals ``Frameset.create`` of its host frame
    field by field: int32 depth (values past 32767 too), colour, packed
    colour, depth scale, stamp and epoch, calibration. The right stream's
    second frame comes 0.5 s late and pairs with nothing."""
    intr = small_intrinsics()
    left, right = [[src.next_frame() for _ in range(3)] for src in _sources("dual")]
    for k in range(3):
        left[k].timestamp = right[k].timestamp = 5000.0 + k / 30  # epoch 4096 s
        right[k].depth_scale = 0.00025
    right[1].timestamp += 0.5
    for frames in (left, right):
        frames[0].depth[0, :3] = (32768, 40000, 65535)  # the int16 bits' sign
    with DeviceFeeder(Replay(left, intr), Replay(right, intr), device="cpu",
                      pack_color=True) as feeder:
        pairs = list(feeder)
    assert [p.host_left.timestamp for p in pairs] == [5000.0, 5000.0 + 2 / 30]
    for p in pairs:
        for fs, host in ((p.left, p.host_left), (p.right, p.host_right)):
            want = Frameset.create(host.depth, host.color, intr, depth_scale=host.depth_scale,
                                   timestamp=host.timestamp, pack_color=True, device="cpu")
            for name in ("depth", "color", "color_packed", "depth_scale", "timestamp",
                         "timestamp_epoch"):
                got, ref = getattr(fs, name), getattr(want, name)
                assert got.dtype == ref.dtype and torch.equal(got, ref), name
            assert float(fs.timestamp_epoch) == split_stamp(host.timestamp)[0] == 4096.0
            for name in ("depth_intrinsics", "color_intrinsics"):
                for leaf in ("fx", "fy", "ppx", "ppy", "coeffs"):
                    assert torch.equal(getattr(getattr(fs, name), leaf),
                                       getattr(getattr(want, name), leaf))
            assert torch.equal(fs.depth_to_color.as_matrix(), want.depth_to_color.as_matrix())


@pytest.mark.parametrize("face", FACES)
def test_feeder_end_of_stream_pushes_the_last_round(face):
    """The round in which the first camera yields a frame and the second
    ends: the frame is pushed before the sync's flush, so it still pairs
    with the second camera's unpaired frame 10 ms from it, and then the
    stream ends."""
    intr = small_intrinsics()
    frame = _sources(face)[0].next_frame()

    def at(t):
        return HostFrameset(frame.depth, frame.color, t)

    streams = [[at(0.0), at(0.1)], [at(0.09)]]
    with _feeder(face, [Replay(s, intr) for s in streams], upload=False) as feeder:
        items = list(feeder)
    assert [[f.timestamp for f in _hosts(item)] for item in items] == [[0.1, 0.09]]
    assert feeder.get() is None
