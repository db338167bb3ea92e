"""The port's rig feeder on the CPU: RigFeeder's N-way sync and upload,
held to the bars of the JAX package's own tests
(tests/test_parallel.py:750-870, tests/test_io.py:400-480,
tests/test_nodes.py:415-432), and its ApproximateTimeSyncN against the JAX
package's on the same stamps.
"""

import time

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.io.feeder import ApproximateTimeSyncN as JSync
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset, pack_rgb24_host
from pointcloud_depthfusion_tpu_torch.io.feeder import ApproximateTimeSyncN as TSync
from pointcloud_depthfusion_tpu_torch.io.feeder import RigFeeder, SyntheticSource
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, rig_arc_poses
from torch_rig_common import FiniteSource, arc_sources, small_intrinsics


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rig_feeder_finite_sources_deliver_all_sets():
    """Five jittered but matchable rounds (spread under the 17 ms gate):
    every set reaches the consumer, stacked on the camera axis, before the
    end of stream."""
    intr = small_intrinsics()
    with RigFeeder(arc_sources(3, intr, FiniteSource, n_frames=5, timestamp_jitter_s=0.003),
                   device="cpu") as feeder:
        batches = list(feeder)
    assert len(batches) == 5
    for b in batches:
        assert b.depth.shape == (3, 24, 32) and b.depth.dtype == torch.int32
        assert b.color.shape == (3, 24, 32, 3) and b.color.dtype == torch.uint8
        assert b.depth_scale.tolist() == pytest.approx([0.001] * 3)
        assert max(b.timestamps) - min(b.timestamps) <= 0.017
        assert b.upload_ms >= 0.0
        np.testing.assert_array_equal(b.depth.numpy(),
                                      np.stack([f.depth for f in b.host_frames]))
    assert feeder.get() is None  # a second end-of-stream get answers None


def test_rig_feeder_pack_color():
    intr = small_intrinsics()
    with RigFeeder(arc_sources(2, intr), pack_color=True, device="cpu") as feeder:
        for _ in range(2):  # the staging buffers are reused set to set
            batch = feeder.get()
            assert batch.color.shape == (2, 24, 32) and batch.color.dtype == torch.int32
            np.testing.assert_array_equal(
                batch.color.numpy(), np.stack([pack_rgb24_host(f.color) for f in batch.host_frames]))


def test_rig_feeder_rejects_decimated_depth():
    class DecimatedSource(SyntheticSource):
        def next_frame(self):
            f = super().next_frame()
            return HostFrameset(depth=f.depth[::2, ::2], color=f.color,
                                depth_scale=f.depth_scale, timestamp=f.timestamp)

    intr = small_intrinsics()
    poses = rig_arc_poses(2)
    sources = [SyntheticSource(SyntheticScene(), intr, poses[0], seed=1),
               DecimatedSource(SyntheticScene(), intr, poses[1], seed=2)]
    with pytest.raises(RuntimeError, match="producer failed") as ei:
        with RigFeeder(sources, device="cpu") as feeder:
            feeder.get(timeout=30.0)
    assert isinstance(ei.value.__cause__, ValueError)
    assert "size mismatch" in str(ei.value.__cause__)


def test_rig_feeder_source_error_reaches_consumer():
    class Broken(SyntheticSource):
        def next_frame(self):
            if self.frame_idx == 2:
                raise OSError("camera unplugged")
            return super().next_frame()

    intr = small_intrinsics()
    feeder = RigFeeder(arc_sources(3, intr, Broken), device="cpu")
    with pytest.raises(RuntimeError, match="producer failed") as ei:
        with feeder:
            for _ in range(10):
                assert feeder.get(timeout=30.0) is not None
    assert isinstance(ei.value.__cause__, OSError)
    assert not feeder._thread.is_alive()


def test_rig_feeder_upload_false_delivers_host_batches():
    """upload=False: every set reaches the consumer with its host frames and
    stamps only (the machinery-isolation mode)."""
    intr = small_intrinsics()
    with RigFeeder(arc_sources(2, intr, FiniteSource, n_frames=3), upload=False,
                   device="cpu") as feeder:
        batches = list(feeder)
    assert len(batches) == 3
    for b in batches:
        assert b.depth is None and b.color is None and b.depth_scale is None
        assert b.upload_ms == 0.0 and len(b.host_frames) == 2
        assert b.timestamps == [f.timestamp for f in b.host_frames]


def test_rig_feeder_lifespan_skips_stale_sets():
    """QoS lifespan (fusion_node.cpp:183-187): sets older than lifespan_s at
    dequeue are skipped, and a fresh one follows."""
    intr = small_intrinsics()
    feeder = RigFeeder(arc_sources(2, intr), lifespan_s=0.2, device="cpu")
    with feeder:
        assert feeder.get(timeout=10.0) is not None
        time.sleep(0.6)  # every set queued before this is now stale
        fresh = feeder.get(timeout=10.0)
        age = time.perf_counter() - fresh.enqueue_time
    assert feeder.dropped_stale >= 1
    assert age < 0.6  # queued after the sleep began


class _Stamp:
    """A frame as the sync sees it: a capture stamp and where it came from."""

    def __init__(self, timestamp, key):
        self.timestamp = timestamp
        self.key = key


SYNC_CASES = {
    # name: (seed, streams, stamp jitter s, drop probability, silent frames of the last stream)
    "two_tight": (0, 2, 0.002, 0.0, None),
    "three_jittered": (1, 3, 0.006, 0.1, None),
    "four_dropping": (2, 4, 0.006, 0.1, None),
    "three_silent_stream": (3, 3, 0.004, 0.05, (4, 12)),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_matches_jax(case):
    """30 Hz streams pushed in a shuffled order, with jittered stamps,
    dropped frames and a stream that falls silent: after every push and at
    the flush, the port's sync emits the JAX sync's sets and keeps its
    counters (queue_size 4, so saturation drops too)."""
    seed, n, jitter, drop, silent = SYNC_CASES[case]
    rng = np.random.default_rng(seed)
    j, t = JSync(n, queue_size=4), TSync(n, queue_size=4)
    emitted = 0
    for k in range(24):
        for s in rng.permutation(n):
            if rng.random() < drop or (silent and s == n - 1 and silent[0] <= k < silent[1]):
                continue
            f = _Stamp(k / 30.0 + float(np.clip(rng.normal(0, jitter), -0.015, 0.015)), (s, k))
            want, got = j.push(int(s), f), t.push(int(s), f)
            assert [[x.key for x in fs] for fs in got] == [[x.key for x in fs] for fs in want]
            assert (t.dropped, t.emitted) == (j.dropped, j.emitted)
            emitted += len(got)
    want, got = j.flush(), t.flush()
    assert [[x.key for x in fs] for fs in got] == [[x.key for x in fs] for fs in want]
    assert (t.dropped, t.emitted) == (j.dropped, j.emitted)
    assert emitted >= 8
    if silent:
        assert t.dropped > 0
