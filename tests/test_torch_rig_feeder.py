"""The port's rig feeder on the CPU: RigFeeder's packed colour, and its
ApproximateTimeSyncN against the JAX package's on the same stamps. What
the rig shares with the dual pair (every set delivered, the size check,
errors, host-only items, the lifespan), held to the bars of the JAX
package's own tests (tests/test_parallel.py:750-870,
tests/test_io.py:400-480, tests/test_nodes.py:415-432), is in
tests/test_torch_feeder.py.
"""

import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.io.feeder import ApproximateTimeSyncN as JSync
from pointcloud_depthfusion_tpu_torch.core.frameset import pack_rgb24_host
from pointcloud_depthfusion_tpu_torch.io.feeder import ApproximateTimeSyncN as TSync
from pointcloud_depthfusion_tpu_torch.io.feeder import RigFeeder
from torch_rig_common import arc_sources, small_intrinsics


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rig_feeder_pack_color():
    intr = small_intrinsics()
    with RigFeeder(arc_sources(2, intr), pack_color=True, device="cpu") as feeder:
        for _ in range(2):  # the staging buffers are reused set to set
            batch = feeder.get()
            assert batch.color.shape == (2, 24, 32) and batch.color.dtype == torch.int32
            np.testing.assert_array_equal(
                batch.color.numpy(), np.stack([pack_rgb24_host(f.color) for f in batch.host_frames]))


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
