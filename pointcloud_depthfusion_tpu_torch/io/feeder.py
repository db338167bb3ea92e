"""Host-side streaming fabric: sources, ApproximateTime pairing and
synchronization, and the asynchronous device feeders.

A copy of pointcloud_depthfusion_tpu/io/feeder.py (whose module imports
jax): :class:`FramesetSource`, :class:`SyntheticSource` and
:class:`NativeSyntheticSource` (the C++ renderer), the two-stream
:class:`ApproximateTimePairer` and the N-way :class:`ApproximateTimeSyncN`,
the shared delivery machinery, :class:`DeviceFeeder` (two cameras, one
:class:`DevicePair` per synchronized pair) and :class:`RigFeeder` (N
cameras, one stacked batch per synchronized set).

Both feeders capture on a background thread and upload from pinned host
buffers with ``non_blocking`` copies on a side stream, fenced before the
item is handed over and recorded on the consumer's stream, so a consumer
never reads an item before its copy lands and the caching allocator never
reuses its memory under a consumer's kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset, HostFrameset
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.runtime import render_scene_native

# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class FramesetSource:
    """A stream of HostFramesets (the capture-device abstraction)."""

    def next_frame(self) -> Optional[HostFrameset]:
        raise NotImplementedError

    @property
    def intrinsics(self) -> Intrinsics:
        raise NotImplementedError


class SyntheticSource(FramesetSource):
    """Deterministic synthetic stream with optional per-frame camera motion
    and timestamp jitter (models real sensors' non-ideal cadence).
    ``motion(frame_index)`` returns the 4×4 world_from_camera of that frame
    in place of the fixed pose."""

    def __init__(
        self,
        scene: SyntheticScene,
        intr: Intrinsics,
        world_from_cam: np.ndarray,
        fps: float = 30.0,
        depth_noise_std: float = 0.002,
        hole_fraction: float = 0.01,
        timestamp_jitter_s: float = 0.0,
        motion: Optional[Callable[[int], np.ndarray]] = None,
        seed: int = 0,
        start_time: float = 0.0,
    ):
        self.scene = scene
        self._intr = intr
        self.pose = np.asarray(world_from_cam)
        self.fps = fps
        self.depth_noise_std = depth_noise_std
        self.hole_fraction = hole_fraction
        self.jitter = timestamp_jitter_s
        self.motion = motion
        self.rng = np.random.default_rng(seed)
        self.frame_idx = 0
        self.start_time = start_time

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def sensor_options(self) -> dict:
        """Source-level options that CameraNode.attach_config reflects into
        the parameter tree (the synthetic sensor's analogue of rs2 sensor
        options such as laser power)."""
        return {
            "depth": {
                "depth_noise_std": self.depth_noise_std,
                "hole_fraction": self.hole_fraction,
            },
            "color": {
                "jitter": self.jitter,  # timestamp jitter (s)
            },
        }

    def _pose(self) -> np.ndarray:
        return self.motion(self.frame_idx) if self.motion else self.pose

    def next_frame(self) -> HostFrameset:
        t = self.start_time + self.frame_idx / self.fps
        if self.jitter > 0:
            t += float(self.rng.normal(0, self.jitter))
        fs = self.scene.render(
            self._intr,
            self._pose(),
            timestamp=t,
            depth_noise_std=self.depth_noise_std,
            hole_fraction=self.hole_fraction,
            seed=int(self.rng.integers(0, 2**31)),
        )
        self.frame_idx += 1
        return fs


class NativeSyntheticSource(SyntheticSource):
    """SyntheticSource rendered by the native host runtime's OpenMP renderer
    (``runtime.render_scene_native``): bit-exact to the numpy renderer on
    noise-free frames; its noise and holes come from the C++ xorshift RNG,
    so they differ from the numpy source's but equal the JAX package's
    NativeSyntheticSource for the same ``seed``. Raises when the runtime
    cannot be built: choose the class with ``runtime.is_available()``."""

    def next_frame(self) -> HostFrameset:
        t = self.start_time + self.frame_idx / self.fps
        if self.jitter > 0:
            t += float(self.rng.normal(0, self.jitter))
        scene = self.scene
        spheres = np.asarray([[s.center[0], s.center[1], s.center[2], s.radius, *s.base_color]
                              for s in scene.spheres])
        intr = self._intr
        depth, color = render_scene_native(
            intr.width, intr.height, float(intr.fx), float(intr.fy), float(intr.ppx),
            float(intr.ppy), np.asarray(self._pose()), scene.plane_z, spheres,
            scene.checker_period, scene.max_depth, 0.001,
            noise_std=self.depth_noise_std,
            hole_fraction=self.hole_fraction,
            seed=int(self.rng.integers(0, 2**62)),
        )
        self.frame_idx += 1
        return HostFrameset(depth=depth, color=color, timestamp=t, depth_scale=0.001)


# ---------------------------------------------------------------------------
# ApproximateTime pairing
# ---------------------------------------------------------------------------


class ApproximateTimePairer:
    """Pair two timestamped streams, emitting the closest-stamp pairs.

    message_filters ApproximateTime as the reference configures it (queue
    10, max interval 17 ms, fusion_node.cpp:221-228): bounded per-stream
    queues drop their oldest entry; a pair is emitted when the globally
    closest match is within ``max_interval_s``, consuming both entries and
    everything older.
    """

    def __init__(self, max_interval_s: float = 0.017, queue_size: int = 10):
        self.max_interval_s = max_interval_s
        self.queue_size = queue_size
        self.queues: Tuple[Deque[HostFrameset], Deque[HostFrameset]] = (
            collections.deque(),
            collections.deque(),
        )
        self.dropped = 0
        self.emitted = 0

    def push(self, stream: int, frame: HostFrameset) -> List[Tuple[HostFrameset, HostFrameset]]:
        """Add a frame; returns zero or more matched pairs."""
        q = self.queues[stream]
        q.append(frame)
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        return self._drain()

    def _drain(self) -> List[Tuple[HostFrameset, HostFrameset]]:
        out = []
        qa, qb = self.queues
        while qa and qb:
            # The globally closest pair (an exhaustive scan: at most 100
            # stamp comparisons at the configured queue size).
            best, best_dt = None, None
            for i, fa in enumerate(qa):
                for j, fb in enumerate(qb):
                    dt = abs(fa.timestamp - fb.timestamp)
                    if best_dt is None or dt < best_dt:
                        best_dt, best = dt, (i, j)
            if best_dt > self.max_interval_s:
                # Queues saturated with unmatchable data: drop the oldest
                # overall to make progress.
                if len(qa) >= self.queue_size or len(qb) >= self.queue_size:
                    (qa if qa[0].timestamp <= qb[0].timestamp else qb).popleft()
                    self.dropped += 1
                    continue
                break
            i, j = best
            fa, fb = qa[i], qb[j]
            for _ in range(i + 1):
                qa.popleft()
            for _ in range(j + 1):
                qb.popleft()
            self.dropped += i + j
            self.emitted += 1
            out.append((fa, fb))
        return out


# ---------------------------------------------------------------------------
# N-way ApproximateTime sync
# ---------------------------------------------------------------------------


class ApproximateTimeSyncN:
    """N-way ApproximateTime synchronization (message_filters semantics
    generalized past two streams).

    A set is emitted when one frame per stream can be chosen with total
    stamp SPREAD (max−min) ≤ ``max_interval_s``; emission consumes the
    chosen frames and everything older in each queue. Selection: pivot on
    the latest queue head, pick each stream's closest frame to the pivot —
    the same greedy that message_filters' ApproximateTime policy uses.
    """

    def __init__(self, n_streams: int, max_interval_s: float = 0.017,
                 queue_size: int = 10):
        if n_streams < 2:
            raise ValueError(f"need >= 2 streams, got {n_streams}")
        self.n_streams = n_streams
        self.max_interval_s = max_interval_s
        self.queue_size = queue_size
        self.queues: List[Deque[HostFrameset]] = [
            collections.deque() for _ in range(n_streams)
        ]
        self.dropped = 0
        self.emitted = 0

    def push(self, stream: int, frame: HostFrameset) -> List[Tuple[HostFrameset, ...]]:
        q = self.queues[stream]
        q.append(frame)
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        return self._drain()

    def _picks(self):
        pivot = max(q[0].timestamp for q in self.queues)
        picks = [min(range(len(q)), key=lambda i, q=q: abs(q[i].timestamp - pivot))
                 for q in self.queues]
        stamps = [q[k].timestamp for q, k in zip(self.queues, picks)]
        return pivot, picks, stamps

    def _emit(self, picks) -> Tuple[HostFrameset, ...]:
        frames = tuple(q[k] for q, k in zip(self.queues, picks))
        for q, k in zip(self.queues, picks):
            for _ in range(k + 1):
                q.popleft()
            self.dropped += k
        self.emitted += 1
        return frames

    def _drop_oldest(self) -> None:
        min(self.queues, key=lambda q: q[0].timestamp).popleft()
        self.dropped += 1

    def _drain(self) -> List[Tuple[HostFrameset, ...]]:
        out = []
        while all(self.queues):
            pivot, picks, stamps = self._picks()
            saturated = any(len(q) >= self.queue_size for q in self.queues)
            # Only emit when every pick is FINAL: a pick that is its queue's
            # newest element AND earlier than the pivot could be beaten by
            # the stream's next (later) frame — wait for it instead.
            final = all(k < len(q) - 1 or q[k].timestamp >= pivot
                        for q, k in zip(self.queues, picks))
            if not final and not saturated:
                break
            if max(stamps) - min(stamps) <= self.max_interval_s:
                out.append(self._emit(picks))
                continue
            # Unmatchable at current fill: drop the globally oldest head to
            # make progress if any queue is saturated, else wait for data.
            if saturated:
                self._drop_oldest()
                continue
            break
        return out

    def flush(self) -> List[Tuple[HostFrameset, ...]]:
        """End-of-stream drain: emit the remaining within-interval sets with
        the final-pick gate relaxed (there is no next frame to wait for);
        unmatchable heads are discarded."""
        out = []
        while all(self.queues):
            _, picks, stamps = self._picks()
            if max(stamps) - min(stamps) <= self.max_interval_s:
                out.append(self._emit(picks))
                continue
            self._drop_oldest()
        return out


# ---------------------------------------------------------------------------
# Async delivery
# ---------------------------------------------------------------------------


def _tensors(obj):
    """The tensors in ``obj``: nested tuples and dataclasses (Framesets)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for o in obj:
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


class _AsyncFeederBase:
    """Shared delivery machinery for background feeders: bounded queue
    hand-off, end-of-stream sentinel, error propagation, QoS lifespan
    expiry, stop-safe blocking get. Subclasses implement ``_run`` (the
    producer thread) and call :meth:`_deliver` / :meth:`_deliver_sentinel`."""

    def _init_delivery(self, depth: int, lifespan_s: Optional[float]) -> None:
        self.lifespan_s = lifespan_s
        self.dropped_stale = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._ended = False
        self.error: Optional[BaseException] = None
        self._copy_stream = None

    def _run(self) -> None:  # pragma: no cover - subclass responsibility
        raise NotImplementedError

    def _device_copy(self, host: Sequence[torch.Tensor], finish):
        """``finish(*tensors)`` on ``self.device`` copies of the ``host``
        staging tensors. On the card the copies run ``non_blocking`` on a
        side stream and ``finish`` runs there too; the stream is fenced
        before this returns (the copies have landed and the staging buffers
        are free again), and every tensor of the result is recorded on the
        device's default stream, where the consumer runs."""
        if self.device.type != "cuda":
            return finish(*(t.clone().to(self.device) for t in host))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = finish(*(t.to(self.device, non_blocking=True) for t in host))
        self._copy_stream.synchronize()
        consumer = torch.cuda.default_stream(self.device)
        for t in _tensors(out):
            t.record_stream(consumer)
        return out

    def _deliver(self, item) -> bool:
        """Bounded put: returns False if stop() preempted the hand-off."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _deliver_sentinel(self, drop_pending: bool = False) -> None:
        """Enqueue the end-of-stream None. It must reach the consumer or a
        later get() with no timeout blocks forever; on the error path
        (``drop_pending``) a pending item is sacrificed to make room."""
        while not self._stop.is_set():
            try:
                self._q.put(None, timeout=0.5)
                return
            except queue.Full:
                if drop_pending:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def get(self, timeout: Optional[float] = None):
        """Next synchronized item (None = clean end of stream). A producer
        failure re-raises HERE, never as a silently empty stream."""
        if not self._started:
            self.start()
        if self._ended:
            # The producer enqueues ONE sentinel and exits; keep answering
            # None instead of blocking a second end-of-stream get() forever.
            if self.error is not None:
                raise RuntimeError("frameset producer failed") from self.error
            return None
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            # Poll in short slices so an out-of-band stop() unblocks a
            # waiting consumer (stop() drains the queue, so the sentinel can
            # be lost).
            if self._stop.is_set():
                self._ended = True
                return None
            slice_s = 0.2
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                slice_s = min(slice_s, remaining)
            try:
                item = self._q.get(timeout=slice_s)
            except queue.Empty:
                continue
            if item is None:
                self._ended = True
                if self.error is not None:
                    raise RuntimeError("frameset producer failed") from self.error
                return None
            if (self.lifespan_s is not None
                    and time.perf_counter() - item.enqueue_time > self.lifespan_s):
                # QoS lifespan expiry: skip the stale item; a fresh one follows.
                self.dropped_stale += 1
                continue
            return item

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # stop() may run on the producer thread itself (a subscriber raising
        # through capture); joining the current thread would raise.
        if self._started and self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __iter__(self):
        while True:
            item = self.get()
            if item is None:
                return
            yield item


# ---------------------------------------------------------------------------
# Two-camera device feeder
# ---------------------------------------------------------------------------


_SIZE_MISMATCH = (
    "size mismatch — the fusion path needs color-aligned depth. Disable the "
    "camera node's decimation filter for composed fusion (the reference also "
    "runs it disabled, realsense.cpp:393)."
)


@dataclasses.dataclass
class DevicePair:
    """One synchronized pair: device Framesets (None with ``upload=False``)
    and the host frames they came from."""

    left: Optional[Frameset]
    right: Optional[Frameset]
    host_left: HostFrameset
    host_right: HostFrameset
    upload_ms: float = 0.0  # H2D time of this pair (the copy_to_gpu stage)
    # Wall clock at enqueue: the QoS-lifespan reference point
    # (fusion_node.cpp:183-187).
    enqueue_time: float = 0.0


class DeviceFeeder(_AsyncFeederBase):
    """Background thread: capture both cameras → ApproximateTime pair →
    upload, one pair ahead of the consumer (the reference's
    double-buffered capture, camera_node.cpp:315-343). ``get()`` blocks
    for the next ready pair; ``device=None`` means the card.

    ``lifespan_s``: drop pairs that waited longer than this for the
    consumer (the reference's 1 s QoS lifespan); None keeps every pair.
    ``pack_color``: also deliver ``Frameset.color_packed``, packed on the
    device after the upload (bit-identical to ``pack_rgb24_host``).
    ``upload=False``: deliver host-only pairs (``left``/``right`` None),
    the machinery-isolation measurement mode.

    On the card each camera's frame is staged in pinned buffers and copied
    with ``non_blocking=True`` on a side stream; the producer waits for the
    copies before it stamps ``upload_ms`` and hands the pair over, and
    records the pair's tensors on the device's default stream, where the
    consumer runs.
    """

    def __init__(
        self,
        source_left: FramesetSource,
        source_right: FramesetSource,
        pairer: Optional[ApproximateTimePairer] = None,
        depth: int = 2,
        device=None,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
        upload: bool = True,
    ):
        self.source_left = source_left
        self.source_right = source_right
        self.pairer = pairer or ApproximateTimePairer()
        self.device = resolve_device(device)
        self.pack_color = pack_color
        self.upload = upload
        self._staging: dict = {}
        self._intrinsics: dict = {}
        self._identity: Optional[Extrinsics] = None
        self._init_delivery(depth, lifespan_s)

    def _host_buffers(self, side: int, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(depth as int16 bits, color) staging tensors of one camera, pinned
        when the pair goes to the card; reused pair to pair (each upload is
        fenced before the next fill)."""
        bufs = self._staging.get(side)
        if bufs is None or tuple(bufs[0].shape) != (h, w):
            pin = self.device.type == "cuda"
            bufs = (torch.empty((h, w), dtype=torch.int16, pin_memory=pin),
                    torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=pin))
            self._staging[side] = bufs
        return bufs

    def _calibration(self, side: int, intr: Intrinsics) -> Tuple[Intrinsics, Extrinsics]:
        """The source's intrinsics on the device (moved once per source) and
        the identity depth→color extrinsics, made outside the copy stream."""
        cached = self._intrinsics.get(side)
        if cached is None or cached[0] is not intr:
            cached = (intr, intr.to(self.device))
            self._intrinsics[side] = cached
        if self._identity is None:
            self._identity = Extrinsics.identity(self.device)
        return cached[1], self._identity

    def _stage(self, side: int, host: HostFrameset) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy one camera's frame into its staging buffers: u16 depth as its
        int16 bits (widened to int32 on the device)."""
        if host.depth.shape != host.color.shape[:2]:
            raise ValueError(f"depth {host.depth.shape} / color {host.color.shape[:2]} "
                             + _SIZE_MISMATCH)
        depth, color = self._host_buffers(side, *host.depth.shape)
        np.copyto(depth.numpy(), np.asarray(host.depth, np.uint16).view(np.int16))
        np.copyto(color.numpy(), host.color, casting="unsafe")
        return depth, color

    def _upload_pair(self, hl: HostFrameset, hr: HostFrameset) -> Tuple[Frameset, Frameset]:
        calib = [self._calibration(0, self.source_left.intrinsics),
                 self._calibration(1, self.source_right.intrinsics)]

        def finish(dl, cl, dr, cr):
            return tuple(
                Frameset.create(d.to(torch.int32) & 0xFFFF, c, intr, depth_to_color=identity,
                                depth_scale=h.depth_scale, timestamp=h.timestamp,
                                pack_color=self.pack_color, device=self.device)
                for d, c, h, (intr, identity) in ((dl, cl, hl, calib[0]), (dr, cr, hr, calib[1])))

        return self._device_copy((*self._stage(0, hl), *self._stage(1, hr)), finish)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                fl = self.source_left.next_frame()
                fr = self.source_right.next_frame()
                if fl is None or fr is None:
                    self._deliver_sentinel()
                    return
                pairs = self.pairer.push(0, fl) + self.pairer.push(1, fr)
                for hl, hr in pairs:
                    t_up = time.perf_counter()
                    if not self.upload:
                        pair = DevicePair(left=None, right=None, host_left=hl, host_right=hr)
                    else:
                        left, right = self._upload_pair(hl, hr)
                        pair = DevicePair(left=left, right=right, host_left=hl, host_right=hr,
                                          upload_ms=(time.perf_counter() - t_up) * 1e3)
                    pair.enqueue_time = time.perf_counter()
                    if not self._deliver(pair):
                        return
        except Exception as exc:  # noqa: BLE001 - handed to the consumer's get()
            self.error = exc
            self._deliver_sentinel(drop_pending=True)


# ---------------------------------------------------------------------------
# N-camera rig feeder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RigBatch:
    """One synchronized N-camera frame set, stacked on a leading camera
    axis: the input shape of parallel.mesh.rig_fuse."""

    depth: Optional[torch.Tensor]  # (N, H, W) int32
    color: Optional[torch.Tensor]  # (N, H, W, 3) uint8, or (N, H, W) int32 when packed
    depth_scale: Optional[torch.Tensor]  # (N,) float32
    timestamps: List[float]  # host f64 capture stamps, per camera
    host_frames: Tuple[HostFrameset, ...]
    upload_ms: float = 0.0
    enqueue_time: float = 0.0


class RigFeeder(_AsyncFeederBase):
    """Background thread feeding an N-camera rig: capture all cameras →
    N-way ApproximateTime sync → ONE stacked upload to ``device``
    (``None``: the card).

    ``pack_color=True`` delivers the color as pre-packed (N, H, W) int32
    rgb24 planes instead of (N, H, W, 3) uint8 (the rig accepts both,
    bit-identical); the planes are packed on the device after the upload.
    ``upload=False`` delivers host-only batches (the tensor fields are
    None): the machinery-isolation measurement mode.
    ``mesh=`` (the camera-sharded upload) is not ported yet.

    On the card the host side is staged in pinned buffers and copied with
    ``non_blocking=True`` on a side stream; the producer waits for the copy
    before it stamps ``upload_ms`` and hands the batch over, and records
    the batch's tensors on the device's default stream, where the consumer
    runs, so the caching allocator cannot reuse their memory under a
    consumer's kernel.
    """

    def __init__(
        self,
        sources: Sequence[FramesetSource],
        mesh=None,
        sync: Optional[ApproximateTimeSyncN] = None,
        depth: int = 2,
        device=None,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
        upload: bool = True,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "RigFeeder(mesh=...): the camera-sharded upload is not ported yet "
                "(ROADMAP A15)"
            )
        if len(sources) < 2:
            raise ValueError(f"rig needs >= 2 cameras, got {len(sources)}")
        self.sources = list(sources)
        self.sync = sync or ApproximateTimeSyncN(len(sources))
        self.device = resolve_device(device)
        self.pack_color = pack_color
        self.upload = upload
        self._staging = None
        self._init_delivery(depth, lifespan_s)

    def _host_buffers(self, frames) -> Tuple[torch.Tensor, ...]:
        """(depth as int16 bits, color, depth_scale) host staging tensors
        for this set's shape, pinned when the batch goes to the card; reused
        set to set (each upload is fenced before the next fill)."""
        n = len(frames)
        h, w = frames[0].depth.shape
        key = (n, h, w)
        if self._staging is None or self._staging[0] != key:
            pin = self.device.type == "cuda"
            self._staging = (
                key,
                torch.empty((n, h, w), dtype=torch.int16, pin_memory=pin),
                torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pin),
                torch.empty((n,), dtype=torch.float32, pin_memory=pin),
            )
        return self._staging[1:]

    def _upload(self, frames) -> Tuple[torch.Tensor, ...]:
        """Stage the set on the host and copy it to the device: u16 depth
        travels as its int16 bits and widens to int32 there, and
        ``pack_color`` packs the rgb24 planes there (bit-identical to
        ``pack_rgb24_host``)."""
        depth, color, scale = self._host_buffers(frames)
        dn, cn = depth.numpy(), color.numpy()
        for i, f in enumerate(frames):
            np.copyto(dn[i], np.asarray(f.depth, np.uint16).view(np.int16))
            np.copyto(cn[i], f.color, casting="unsafe")
        scale.numpy()[:] = [f.depth_scale for f in frames]

        def finish(d, c, s):
            d = d.to(torch.int32) & 0xFFFF
            return d, R.pack_rgb(c) if self.pack_color else c, s

        return self._device_copy((depth, color, scale), finish)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                sets = []
                ended = False
                for i, src in enumerate(self.sources):
                    f = src.next_frame()
                    if f is None:
                        ended = True
                        break
                    sets += self.sync.push(i, f)
                # At stream end the sync gate is relaxed (flush): a final
                # matchable set waiting on next frames that never come is
                # emitted, not dropped.
                if ended:
                    sets += self.sync.flush()
                for frames in sets:
                    for f in frames:
                        # A decimated (not color-aligned) depth stream fails
                        # HERE with the explanation, not later as a shape
                        # error inside the rig.
                        if f.depth.shape != f.color.shape[:2]:
                            raise ValueError(f"depth {f.depth.shape} / color "
                                             f"{f.color.shape[:2]} " + _SIZE_MISMATCH)
                    t_up = time.perf_counter()
                    if not self.upload:
                        batch = RigBatch(
                            depth=None, color=None, depth_scale=None,
                            timestamps=[f.timestamp for f in frames], host_frames=frames,
                        )
                    else:
                        depth, color, scale = self._upload(frames)
                        batch = RigBatch(
                            depth=depth, color=color, depth_scale=scale,
                            timestamps=[f.timestamp for f in frames], host_frames=frames,
                            upload_ms=(time.perf_counter() - t_up) * 1e3,
                        )
                    batch.enqueue_time = time.perf_counter()
                    if not self._deliver(batch):
                        return
                if ended:
                    self._deliver_sentinel()
                    return
        except Exception as exc:  # noqa: BLE001 - handed to the consumer's get()
            self.error = exc
            self._deliver_sentinel(drop_pending=True)
