"""Host-side streaming fabric: sources, ApproximateTime pairing and
synchronization, and the camera-ingest stage with its two faces.

A copy of pointcloud_depthfusion_tpu/io/feeder.py (whose module imports
jax): :class:`FramesetSource`, :class:`SyntheticSource` and
:class:`NativeSyntheticSource` (the C++ renderer), the two-stream
:class:`ApproximateTimePairer` and the N-way :class:`ApproximateTimeSyncN`,
and one camera-ingest stage for N >= 2 cameras (:class:`_AsyncFeederBase`)
with two faces: :class:`DeviceFeeder` delivers each synchronized pair as a
:class:`DevicePair` of Framesets, :class:`RigFeeder` each synchronized set
as a stacked :class:`RigBatch`.

The stage captures on a thread per camera, ahead of the ingest thread,
which takes each round of the cameras' frames in camera order and pushes
each frame into the face's synchronizer. Each emitted set is staged in one
stacked pinned buffer, copied to the device in one ``non_blocking`` copy
on a side stream and finished there (depth widened, colour packed), fenced
before the item is handed over and recorded on the consumer's stream, so a
consumer never reads an item before its copy lands and the caching
allocator never reuses its memory under a consumer's kernel.
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
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset, HostFrameset, split_stamp
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene
from pointcloud_depthfusion_tpu_torch.ops import render as R
from pointcloud_depthfusion_tpu_torch.parallel.mesh import ShardedCameras
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

    def flush(self) -> List[Tuple[HostFrameset, HostFrameset]]:
        """End-of-stream drain: empty. Every push drains each pair within
        the interval, so what the queues still hold never pairs."""
        return []


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
# The camera-ingest stage
# ---------------------------------------------------------------------------


_SIZE_MISMATCH = (
    "size mismatch — the fusion path needs color-aligned depth. Disable the "
    "camera node's decimation filter for composed fusion (the reference also "
    "runs it disabled, realsense.cpp:393)."
)


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


_EMPTY = object()  # an empty slot of _Capture


class _Capture:
    """The cameras of the ingest stage, each capturing on a daemon thread
    of its own that calls only its source's ``next_frame``. Each result (a
    frame, the end-of-stream None, or the exception the source raised)
    goes into the camera's one-frame slot, the thread waiting while the
    slot is full, and the thread then captures its next frame at once: a
    camera holds at most the frame in its slot and the one it captured
    after it. :meth:`round` hands the ingest thread each camera's next
    result in camera order and wakes it once a round, when the whole round
    is there. The threads start one after another at the first round, so
    that round is captured in camera order. :meth:`close` wakes every side
    for good; frames captured and never taken are dropped."""

    def __init__(self, sources: Sequence[FramesetSource]):
        self.sources = list(sources)
        self.threads = [threading.Thread(target=self._capture, args=(i,), daemon=True)
                        for i in range(len(self.sources))]
        self.ahead = {"ready": 0, "waited": 0}
        lock = threading.Lock()
        self._taken = [threading.Condition(lock) for _ in self.sources]
        self._filled = threading.Condition(lock)
        self._slots = [_EMPTY] * len(self.sources)
        self._closed = False

    def _capture(self, i: int) -> None:
        try:
            while True:
                frame = self.sources[i].next_frame()
                if not self._hand(i, frame) or frame is None:
                    return
        except Exception as exc:  # noqa: BLE001 - raised again by round(), on the ingest thread
            self._hand(i, exc)

    def _hand(self, i: int, item) -> bool:
        """Put ``item`` in slot i once the slot is empty, wake the ingest
        thread if that completes its round, and start the next camera's
        thread at this camera's first result; False once closed."""
        with self._filled:
            while self._slots[i] is not _EMPTY and not self._closed:
                self._taken[i].wait()
            if self._closed:
                return False
            self._slots[i] = item
            if self._ready():
                self._filled.notify()
            if i + 1 < len(self.threads) and self.threads[i + 1].ident is None:
                self.threads[i + 1].start()
            return True

    def _ready(self) -> bool:
        """Closed, or every slot of the round filled up to the first whose
        stream ended or failed."""
        for item in self._slots:
            if item is _EMPTY:
                return self._closed
            if item is None or isinstance(item, Exception):
                return True
        return True

    def round(self) -> List[HostFrameset]:
        """Each camera's next frame in camera order, cut at the first camera
        whose stream ended (so shorter than the cameras at end of stream,
        and once closed). Raises the exception a source raised."""
        with self._filled:
            if self.threads[0].ident is None and not self._closed:
                self.threads[0].start()
            ready = [item is not _EMPTY for item in self._slots]
            while not self._ready():
                self._filled.wait()
            frames = []
            for i, item in enumerate(self._slots):
                if item is _EMPTY:
                    break
                self.ahead["ready" if ready[i] else "waited"] += 1
                self._slots[i] = _EMPTY
                self._taken[i].notify()
                if isinstance(item, Exception):
                    raise item
                if item is None:
                    break
                frames.append(item)
            return frames

    def close(self) -> None:
        with self._filled:
            self._closed = True
            self._filled.notify_all()
            for c in self._taken:
                c.notify_all()


class _AsyncFeederBase:
    """The camera-ingest stage of N >= 2 cameras, of which both feeders are
    faces.

    Each camera captures on a thread of its own, ahead of the ingest thread
    (:class:`_Capture`); the ingest thread takes a round, camera 0's next
    frame, then camera 1's, ..., and pushes each into the face's
    synchronizer in that order, so the synchronizer sees the pushes of a
    serial capture loop and emits the same sets. ``capture_ahead`` counts,
    for each frame taken, whether it was already waiting when the ingest
    thread asked for its round (``ready``) or not (``waited``). At the
    first ``None`` the ingest thread flushes the synchronizer, delivers
    what the flush emits, then the end-of-stream sentinel. Each emitted
    set is checked for colour
    alignment, staged in stacked host buffers, copied to the device in one
    fenced side-stream copy and finished there (:meth:`_upload`), packaged
    by the face (``_on_device`` on the copy stream, then ``_item``) and
    handed over through a bounded queue, with error propagation (a
    camera's exception as the ingest thread's), QoS lifespan expiry and a
    stop-safe blocking get. At end of stream or :meth:`stop` each camera
    may have captured, and published to its subscribers, up to two frames
    that no set carries. A camera's subscribers run on its thread, so
    several cameras' run at once; ``stop()`` waits at most 2 s in all for
    the threads, and a camera blocked in its source ends once the source
    returns."""

    def _init_ingest(self, sources, sync, depth: int, device: torch.device,
                     lifespan_s: Optional[float], pack_color: bool, upload: bool) -> None:
        self.sources = list(sources)
        self._capture = _Capture(self.sources)
        self.capture_ahead = self._capture.ahead
        self._sync = sync
        self.device = device
        self.pack_color = pack_color
        self.upload = upload
        self._staging: Optional[Tuple[torch.Tensor, ...]] = None
        self.lifespan_s = lifespan_s
        self.dropped_stale = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._ended = False
        self.error: Optional[BaseException] = None
        self._copy_streams: dict = {}

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                sets = []
                got = self._capture.round()
                for i, f in enumerate(got):
                    sets += self._sync.push(i, f)
                ended = len(got) < len(self.sources)
                if ended:
                    if self._stop.is_set():
                        return  # stop() closed the cameras: no stream end
                    # At stream end the sync gate is relaxed (flush): a final
                    # matchable set waiting on next frames that never come is
                    # emitted, not dropped.
                    sets += self._sync.flush()
                for frames in sets:
                    if not self._deliver(self._ingest(frames)):
                        return
                if ended:
                    self._deliver_sentinel()
                    return
        except Exception as exc:  # noqa: BLE001 - handed to the consumer's get()
            self.error = exc
            self._deliver_sentinel(drop_pending=True)
        finally:
            self._capture.close()

    def _ingest(self, frames):
        """The face's item for one emitted set: uploaded unless ``upload``
        is off, ``upload_ms`` from the first staging copy until the fenced
        copy has landed, ``enqueue_time`` stamped last."""
        for f in frames:
            # A decimated (not color-aligned) depth stream fails HERE with
            # the explanation, not later as a shape error in the fusion step.
            if f.depth.shape != f.color.shape[:2]:
                raise ValueError(f"depth {f.depth.shape} / color {f.color.shape[:2]} "
                                 + _SIZE_MISMATCH)
        if not self.upload:
            item = self._item(frames, None)
        else:
            t_up = time.perf_counter()
            item = self._item(frames, self._upload(frames))
            item.upload_ms = (time.perf_counter() - t_up) * 1e3
        item.enqueue_time = time.perf_counter()
        return item

    def _stage(self, frames) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Copy the set into the stacked host staging tensors: (N, H, W) u16
        depth as its int16 bits, (N, H, W, 3) color and (N,) f32 depth
        scales. Pinned when the set goes to the card, and reused set to set
        (each upload is fenced before the next fill) until (N, H, W)
        changes."""
        n, (h, w) = len(frames), frames[0].depth.shape
        if self._staging is None or tuple(self._staging[0].shape) != (n, h, w):
            pin = self.device.type == "cuda"
            self._staging = (
                torch.empty((n, h, w), dtype=torch.int16, pin_memory=pin),
                torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pin),
                torch.empty((n,), dtype=torch.float32, pin_memory=pin),
            )
        depth, color, scale = self._staging
        dn, cn = depth.numpy(), color.numpy()
        for i, f in enumerate(frames):
            np.copyto(dn[i], np.asarray(f.depth, np.uint16).view(np.int16))
            np.copyto(cn[i], f.color, casting="unsafe")
        scale.numpy()[:] = [f.depth_scale for f in frames]
        return self._staging

    def _finish(self, frames, depth, color, scale):
        """The device-side finish of a copied stack, on the copy stream: the
        depth widened to int32 once, ``pack_color``'s rgb24 planes packed
        once (bit-identical to ``pack_rgb24_host``), then the face's
        ``_on_device``."""
        depth = depth.to(torch.int32) & 0xFFFF
        packed = R.pack_rgb(color) if self.pack_color else None
        return self._on_device(frames, depth, color, packed, scale)

    def _upload(self, frames):
        """Stage the set, copy the stack and finish it on the device."""
        return self._copy(self._stage(frames), lambda *t: self._finish(frames, *t))

    def _copy(self, staged, finish):
        return self._device_copy(staged, finish)

    def _device_copy(self, host: Sequence[torch.Tensor], finish, device=None):
        """``finish(*tensors)`` on ``device`` (default ``self.device``)
        copies of the ``host`` staging tensors. On the card the copies run
        ``non_blocking`` on a side stream of that device and ``finish`` runs
        there too; the stream is fenced
        before this returns (the copies have landed and the staging buffers
        are free again), and every tensor of the result is recorded on the
        device's default stream, where the consumer runs."""
        device = self.device if device is None else device
        if device.type != "cuda":
            return finish(*(t.clone().to(device) for t in host))
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            out = finish(*(t.to(device, non_blocking=True) for t in host))
        stream.synchronize()
        consumer = torch.cuda.default_stream(device)
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
        self._capture.close()
        # stop() may run on a thread of the stage itself (a subscriber
        # raising through capture); joining the current thread would raise.
        # A camera blocked inside its source is not waited for past the
        # deadline: its thread is a daemon and ends once the source returns.
        deadline = time.perf_counter() + 2.0
        for t in (self._thread, *self._capture.threads):
            if t.ident is not None and t is not threading.current_thread():
                t.join(timeout=max(0.0, deadline - time.perf_counter()))

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
# The two faces: the dual pair and the N-camera rig
# ---------------------------------------------------------------------------


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
    """The camera-ingest stage's face for two cameras: each camera captures
    on its own thread, ahead of the ingest thread, which takes left then
    right, pairs them ApproximateTime and uploads each pair, up to
    ``depth`` pairs ahead of the consumer (the reference's double-buffered
    capture, camera_node.cpp:315-343). ``get()`` blocks for the next ready
    pair; ``device=None`` means the card. At end of stream and at
    :meth:`stop` each camera may have captured up to two frames that no
    pair carries; ``stop()`` waits at most 2 s for a camera blocked in its
    source.

    ``lifespan_s``: drop pairs that waited longer than this for the
    consumer (the reference's 1 s QoS lifespan); None keeps every pair.
    ``pack_color``: also deliver ``Frameset.color_packed``, packed on the
    device after the upload (bit-identical to ``pack_rgb24_host``).
    ``upload=False``: deliver host-only pairs (``left``/``right`` None),
    the machinery-isolation measurement mode.

    The pair is the stage's stack of two: each Frameset's depth, colour,
    packed colour and depth scale are its camera's slices of the finished
    stack, with its source's intrinsics (moved to the device once) and the
    identity depth→color extrinsics.
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
        self._intrinsics: dict = {}
        self._identity: Optional[Extrinsics] = None
        self._init_ingest((source_left, source_right), self.pairer, depth,
                          resolve_device(device), lifespan_s, pack_color, upload)

    def _on_device(self, frames, depth, color, packed, scale) -> Tuple[Frameset, Frameset]:
        if self._identity is None:
            self._identity = Extrinsics.identity(self.device)
        out = []
        for i, (host, src) in enumerate(zip(frames, self.sources)):
            cached = self._intrinsics.get(i)
            if cached is None or cached[0] is not src.intrinsics:
                cached = self._intrinsics[i] = (src.intrinsics, src.intrinsics.to(self.device))
            epoch, offset = split_stamp(float(host.timestamp))
            out.append(Frameset(
                depth=depth[i], color=color[i], depth_intrinsics=cached[1],
                color_intrinsics=cached[1], depth_to_color=self._identity,
                depth_scale=scale[i],
                timestamp=torch.tensor(offset, dtype=torch.float32, device=self.device),
                timestamp_epoch=torch.tensor(epoch, dtype=torch.float32, device=self.device),
                color_packed=None if packed is None else packed[i]))
        return tuple(out)

    def _item(self, frames, framesets) -> DevicePair:
        left, right = framesets or (None, None)
        return DevicePair(left=left, right=right, host_left=frames[0], host_right=frames[1])


@dataclasses.dataclass
class RigBatch:
    """One synchronized N-camera frame set, stacked on a leading camera
    axis: the input shape of parallel.mesh.rig_fuse, or with a mesh each
    field a ``ShardedCameras`` (rig_fuse_sharded's)."""

    depth: Optional[torch.Tensor]  # (N, H, W) int32
    color: Optional[torch.Tensor]  # (N, H, W, 3) uint8, or (N, H, W) int32 when packed
    depth_scale: Optional[torch.Tensor]  # (N,) float32
    timestamps: List[float]  # host f64 capture stamps, per camera
    host_frames: Tuple[HostFrameset, ...]
    upload_ms: float = 0.0
    enqueue_time: float = 0.0


class RigFeeder(_AsyncFeederBase):
    """The camera-ingest stage's face for an N-camera rig: each camera
    captures on its own thread, ahead of the ingest thread, which takes
    each round in camera order into the N-way ApproximateTime sync and
    makes the stacked upload to ``device`` (``None``: the card), delivered
    as it is. At end of stream and at :meth:`stop` each camera may have
    captured up to two frames that no set carries; ``stop()`` waits at
    most 2 s for a camera blocked in its source.

    ``pack_color=True`` delivers the color as pre-packed (N, H, W) int32
    rgb24 planes instead of (N, H, W, 3) uint8 (the rig accepts both,
    bit-identical). ``upload=False`` delivers host-only batches (the tensor
    fields are None): the machinery-isolation measurement mode.

    Given ``mesh`` (parallel.mesh.make_camera_mesh), the sources are this
    process's cameras and each shard's cameras are uploaded to that shard's
    device: the batch's tensors are ``ShardedCameras``, which
    ``rig_fuse_sharded`` takes as they are. One copy per device carries
    the cameras of all its shards.
    """

    def __init__(
        self,
        sources: Sequence[FramesetSource],
        mesh=None,
        axis: str = "cam",
        sync: Optional[ApproximateTimeSyncN] = None,
        depth: int = 2,
        device=None,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
        upload: bool = True,
    ):
        if len(sources) < 2:
            raise ValueError(f"rig needs >= 2 cameras, got {len(sources)}")
        if mesh is not None and len(sources) % len(mesh.devices) != 0:
            raise ValueError(
                f"{len(sources)} cameras not divisible by the "
                f"{mesh.shape[axis]}-device '{axis}' mesh axis"
            )
        self.mesh = mesh
        self.axis = axis
        self.sync = sync or ApproximateTimeSyncN(len(sources))
        device = mesh.devices[0] if mesh is not None and device is None else (
            resolve_device(device))
        self._init_ingest(sources, self.sync, depth, device, lifespan_s, pack_color, upload)

    def _on_device(self, frames, depth, color, packed, scale):
        return depth, color if packed is None else packed, scale

    def _copy(self, staged, finish):
        if self.mesh is None:
            return self._device_copy(staged, finish)
        # One copy per device of the cameras of its (consecutive) shards.
        devs = self.mesh.devices
        per = len(self.sources) // len(devs)
        shards = []
        for dev in dict.fromkeys(devs):
            on = [i for i, d in enumerate(devs) if d == dev]
            lo, hi = on[0] * per, (on[-1] + 1) * per
            out = self._device_copy(tuple(t[lo:hi] for t in staged), finish, dev)
            shards += [tuple(t[(i - on[0]) * per:(i - on[0] + 1) * per] for t in out) for i in on]
        n = len(self.sources) * self.mesh.n_processes
        return tuple(ShardedCameras(tuple(sh[k] for sh in shards), n) for k in range(3))

    def _item(self, frames, tensors) -> RigBatch:
        depth, color, scale = tensors or (None, None, None)
        return RigBatch(depth=depth, color=color, depth_scale=scale,
                        timestamps=[f.timestamp for f in frames], host_frames=frames)
