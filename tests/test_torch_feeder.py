"""The port's camera-ingest stage on the CPU, through both of its faces:
``DeviceFeeder`` (the dual pair) and ``RigFeeder`` (the N-camera rig).
The behaviours the faces share are one test each over ``dual`` and
``rig``; the pair's Framesets are held field by field to
``Frameset.create`` of their host frames."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset, HostFrameset, split_stamp
from pointcloud_depthfusion_tpu_torch.io.feeder import (
    ApproximateTimePairer,
    ApproximateTimeSyncN,
    DeviceFeeder,
    DevicePair,
    FramesetSource,
    RigFeeder,
    SyntheticSource,
    _Capture,
)
from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource, record_dataset
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


# -- the capture threads ------------------------------------------------------


def _serial(sync, sources):
    """The sets a serial capture loop emits: camera 0's next frame, then
    camera 1's, ..., round by round, until the first None, then the flush."""
    sets = []
    while True:
        for i, src in enumerate(sources):
            f = src.next_frame()
            if f is None:
                return sets + sync.flush()
            sets += sync.push(i, f)


def _sync(face, n):
    return ApproximateTimePairer() if face == "dual" else ApproximateTimeSyncN(n)


def _face_sync(feeder):
    return feeder.pairer if isinstance(feeder, DeviceFeeder) else feeder.sync


def _same_sets(items, sets):
    """The feeder's items carry the serial loop's sets, frame for frame."""
    assert len(items) == len(sets)
    for item, frames in zip(items, sets):
        hosts = _hosts(item)
        assert [f.timestamp for f in hosts] == [f.timestamp for f in frames]
        for got, want in zip(hosts, frames):
            np.testing.assert_array_equal(got.depth, want.depth)
            np.testing.assert_array_equal(got.color, want.color)
        depth, _, _ = _stacked(item)
        np.testing.assert_array_equal(depth.numpy(), np.stack([f.depth for f in frames]))


def _frame_lists(n, k, skip=None):
    """k frames of each of n arc cameras, frame j stamped j/30 s plus up to
    3 ms; ``skip=(i, j)``: camera i misses its frame j, so the other
    cameras' frame j matches nothing and the sync drops it."""
    rng = np.random.default_rng(n)
    out = []
    for i, src in enumerate(arc_sources(n, small_intrinsics())):
        frames = [src.next_frame() for _ in range(k)]
        for j, f in enumerate(frames):
            f.timestamp = j / 30 + float(rng.uniform(0.0, 0.003))
        out.append([f for j, f in enumerate(frames) if (i, j) != skip])
    return out


class Counted(Replay):
    """A Replay that counts its calls and the threads that made them."""

    def __init__(self, frames, intr):
        super().__init__(frames, intr)
        self.calls = 0
        self.threads = set()

    def next_frame(self):
        self.calls += 1
        self.threads.add(threading.get_ident())
        return super().next_frame()


FACE_N = [("dual", 2), ("rig", 2), ("rig", 3), ("rig", 4)]


@pytest.mark.parametrize("kind", ["synthetic", "replay", "recorded"])
@pytest.mark.parametrize("face,n", FACE_N)
def test_feeder_emits_the_serial_loops_sets(face, n, kind, tmp_path):
    """Captured a frame ahead on a thread per camera, the stage emits the
    sets a serial loop over the same sources emits, in its order: jittered
    synthetic streams, and streams (replayed and recorded) whose last
    camera misses a frame, so the sync drops the others' frame."""
    intr = small_intrinsics()

    def sources():
        if kind == "synthetic":
            return arc_sources(n, intr, FiniteSource, n_frames=6, timestamp_jitter_s=0.003)
        lists = _frame_lists(n, 6, skip=(n - 1, 2))
        if kind == "replay":
            return [Replay(f, intr) for f in lists]
        paths = [str(tmp_path / f"cam{i}.npz") for i in range(n)]
        for path, frames in zip(paths, lists):
            record_dataset(path, frames, intr)
        return [RecordedSource(p) for p in paths]

    sync = _sync(face, n)
    sets = _serial(sync, sources())
    assert sets and (kind == "synthetic" or sync.dropped > 0)
    with _feeder(face, sources()) as feeder:
        items = list(feeder)
    _same_sets(items, sets)
    assert (_face_sync(feeder).emitted, _face_sync(feeder).dropped) == (sync.emitted, sync.dropped)
    assert feeder.get() is None


@pytest.mark.parametrize("ends", ["first", "last"])
@pytest.mark.parametrize("face", FACES)
def test_feeder_end_of_stream_when_one_camera_ends_first(face, ends):
    """Camera 0 or camera N-1 ends two rounds before the others: the stage
    delivers the serial loop's sets, then the end of stream, and no camera
    was asked for more than two frames past the serial loop's (one left in
    its slot, one captured after it)."""
    n, intr = CAMERAS[face], small_intrinsics()
    short = 0 if ends == "first" else n - 1
    lists = _frame_lists(n, 4)
    lists[short] = lists[short][:2]
    serial = [Counted(f, intr) for f in lists]
    sets = _serial(_sync(face, n), serial)
    sources = [Counted(f, intr) for f in lists]
    with _feeder(face, sources) as feeder:
        items = list(feeder)
        assert feeder.get() is None
    _same_sets(items, sets)
    for got, want in zip(sources, serial):
        assert want.calls <= got.calls <= want.calls + 2


@pytest.mark.parametrize("face", FACES)
def test_feeder_end_of_stream_while_another_camera_blocks(face):
    """Camera 0 ends after three frames while the other cameras block in
    their fourth capture: the stage delivers the three sets and then the
    end of stream, as the serial loop (which never asks them for a fourth
    frame) would, without waiting for the blocked cameras."""
    release = threading.Event()

    class Stalls(FiniteSource):
        def next_frame(self):
            if self.frame_idx == 3:
                release.wait(30.0)
            return super().next_frame()

    sources = _sources(face, Stalls, n_frames=8)
    sources[0] = _sources(face, FiniteSource, n_frames=3)[0]
    feeder = _feeder(face, sources).start()
    try:
        items = [feeder.get(timeout=10.0) for _ in range(3)]
        assert all(item is not None for item in items)
        assert feeder.get(timeout=10.0) is None
    finally:
        release.set()
        feeder.stop()


@pytest.mark.parametrize("broken", ["first", "last"])
@pytest.mark.parametrize("face", FACES)
def test_feeder_error_in_one_camera_reaches_get(face, broken):
    """One camera's source raises on its third frame: the two sets before
    reach the consumer, then get() raises with the source's exception."""
    n = CAMERAS[face]
    which = 0 if broken == "first" else n - 1

    class Broken(FiniteSource):
        def next_frame(self):
            if self.frame_idx == 2:
                raise OSError("camera unplugged")
            return super().next_frame()

    sources = _sources(face, FiniteSource, n_frames=8)
    sources[which] = _sources(face, Broken, n_frames=8)[which]
    with _feeder(face, sources, depth=4) as feeder:
        got = [feeder.get(timeout=30.0) for _ in range(2)]
        with pytest.raises(RuntimeError, match="producer failed") as ei:
            feeder.get(timeout=30.0)
    assert all(item is not None for item in got)
    assert isinstance(ei.value.__cause__, OSError)


@pytest.mark.parametrize("blocked", ["first", "last"])
@pytest.mark.parametrize("face", FACES)
def test_feeder_stop_while_a_camera_blocks_in_its_source(face, blocked):
    """stop() while one camera's thread is blocked inside next_frame
    returns within the 2 s join deadline, the ingest thread has ended, and
    the camera's thread ends once its source returns."""
    n = CAMERAS[face]
    which = 0 if blocked == "first" else n - 1
    entered, release = threading.Event(), threading.Event()

    class Blocking(SyntheticSource):
        def next_frame(self):
            entered.set()
            release.wait(30.0)
            return super().next_frame()

    sources = _sources(face)
    sources[which] = _sources(face, Blocking)[which]
    feeder = _feeder(face, sources).start()
    try:
        assert entered.wait(30.0)
        t = time.perf_counter()
        feeder.stop()
        assert time.perf_counter() - t < 2.5
        assert not feeder._thread.is_alive()
        assert feeder.get() is None
    finally:
        release.set()
    thread = feeder._capture.threads[which]
    thread.join(timeout=10.0)
    assert not thread.is_alive()


@pytest.mark.parametrize("mode", ["slow_consumer", "blocking_source"])
@pytest.mark.parametrize("face", FACES)
def test_feeder_capture_threads_and_capture_ahead(face, mode):
    """Each source is called from one thread of its own, neither the
    ingest thread nor the consumer's. ``capture_ahead`` counts mostly
    ``ready`` for instant sources behind a consumer that takes 30 ms a set
    (once the one-set queue has filled),
    and mostly ``waited`` for sources that block until their frame is due,
    camera i's frame k at t0 + (k (N + 1) + i) 15 ms."""
    n = CAMERAS[face]

    class Source(FiniteSource):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.threads = set()
            self.due = None

        def next_frame(self):
            self.threads.add(threading.get_ident())
            if self.due is not None:
                time.sleep(max(0.0, self.due(self.frame_idx) - time.perf_counter()))
            return super().next_frame()

    sources = _sources(face, Source, n_frames=12)
    if mode == "blocking_source":
        t0, step = time.perf_counter() + 0.05, 0.015
        for i, src in enumerate(sources):
            src.due = lambda k, i=i: t0 + (k * (n + 1) + i) * step
    with _feeder(face, sources, depth=1) as feeder:
        items = []
        for item in feeder:
            items.append(item)
            if mode == "slow_consumer":
                time.sleep(0.03)
    assert len(items) == 12
    threads = [src.threads for src in sources]
    assert all(len(t) == 1 for t in threads)
    idents = {next(iter(t)) for t in threads}
    assert len(idents) == n
    assert not idents & {feeder._thread.ident, threading.get_ident()}
    ready, waited = feeder.capture_ahead["ready"], feeder.capture_ahead["waited"]
    assert ready + waited == 12 * n + 1  # twelve rounds, then camera 0's end of stream
    if mode == "slow_consumer":
        assert ready > 2 * waited
    else:
        assert waited > 2 * ready


def test_capture_threads_stress_short_switch_interval():
    """Twelve cameras, more capture threads than cores, with the switch
    interval shortened to interleave them often: the rig emits the serial
    loop's sets, and every frame taken is counted once."""
    n, intr = 12, small_intrinsics()
    lists = _frame_lists(n, 6, skip=(5, 3))
    sets = _serial(_sync("rig", n), [Replay(f, intr) for f in lists])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _feeder("rig", [Replay(f, intr) for f in lists], depth=1) as feeder:
            items = []
            while (item := feeder.get(timeout=30.0)) is not None:
                items.append(item)
    finally:
        sys.setswitchinterval(interval)
    _same_sets(items, sets)
    ahead = feeder.capture_ahead
    assert ahead["ready"] + ahead["waited"] == 5 * n + 6  # camera 5 ends its sixth round


@pytest.mark.parametrize("n", [2, 4])
def test_capture_holds_its_slot_and_one_frame_more(n):
    """After one round is taken, each camera puts its next frame in its
    slot and captures the one after it at once, without waiting for the
    slot to be taken, then waits: three calls to each source, no more.
    (A camera that waited for its slot to be taken before calling its
    source again would wake inside every set's staging copy.)"""
    intr = small_intrinsics()
    sources = [Counted(f, intr) for f in _frame_lists(n, 6)]
    capture = _Capture(sources)
    try:
        first = [frames[0].timestamp for frames in _frame_lists(n, 6)]
        assert [f.timestamp for f in capture.round()] == first
        deadline = time.perf_counter() + 10.0
        while any(src.calls < 3 for src in sources) and time.perf_counter() < deadline:
            time.sleep(0.005)
        time.sleep(0.05)
        assert [src.calls for src in sources] == [3] * n
        assert capture.round() and capture.ahead == {"ready": n, "waited": n}
    finally:
        capture.close()
    for t in capture.threads:
        t.join(timeout=10.0)
        assert not t.is_alive()


@pytest.mark.parametrize("jitter", [0.0, 0.006])
def test_registration_pairer_under_capture_threads(jitter):
    """The registration node's pairer, fed by both camera nodes'
    subscriptions on their capture threads in arrival order (the switch
    interval shortened to interleave them often), pairs the frames the
    feeder pairs; each camera's subscribers run on one thread, its own."""
    from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.nodes.registration_node import (  # noqa: PLC0415
        RegistrationNodeApp,
    )

    cams = [CameraNode(name, src, temporal_filter=False) for name, src in zip(
        ("camera_left", "camera_right"),
        _sources("dual", FiniteSource, n_frames=30, timestamp_jitter_s=jitter))]
    reg = RegistrationNodeApp(*cams, device="cpu")
    threads = [set(), set()]
    for cam, t in zip(cams, threads):
        cam.subscribe_frameset(lambda fs, t=t: t.add(threading.get_ident()))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with DeviceFeeder(*cams, device="cpu", upload=False) as feeder:
            items = list(feeder)
    finally:
        sys.setswitchinterval(interval)
    assert items and (reg.pairer.emitted, reg.pairer.dropped) == (
        feeder.pairer.emitted, feeder.pairer.dropped)
    assert reg._latest[0] is items[-1].host_left.depth
    assert reg._latest[1] is items[-1].host_right.depth
    assert all(len(t) == 1 for t in threads) and threads[0] != threads[1]
