"""Registration node: low-cadence extrinsic re-estimation.

Port of pointcloud_depthfusion_tpu/nodes/registration_node.py (the
reference registration_node main loop): subscribes both cameras'
framesets, keeps the latest synchronized pair, solves on a timer at
``spin_rate_hz`` (one solve per tick, registration_node.cpp:468-473) on
``device`` (``None``: the card) and publishes the right→left transform.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import ApproximateTimePairer
from pointcloud_depthfusion_tpu_torch.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu_torch.registration.pipeline import (
    RegistrationPipeline,
    RegistrationSettings,
)


class RegistrationNodeApp:
    def __init__(
        self,
        camera_left: CameraNode,
        camera_right: CameraNode,
        settings: Optional[RegistrationSettings] = None,
        spin_rate_hz: float = 0.5,
        max_sync_interval_s: float = 0.017,
        profiling_path: Optional[str] = None,
        device=None,
    ):
        """``profiling_path``: write the per-tick registration CSV there on
        :meth:`stop` (the reference's enable_profiling + filename)."""
        self.spin_rate_hz = spin_rate_hz
        self.profiling_path = profiling_path
        self.pipeline = RegistrationPipeline(camera_left.source.intrinsics,
                                             camera_right.source.intrinsics, settings,
                                             device=device)
        self.pairer = ApproximateTimePairer(max_interval_s=max_sync_interval_s)
        self._latest: Optional[tuple] = None
        self._lock = threading.Lock()
        self._transform_subs: List[Callable[[np.ndarray], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Frameset subscriptions, not depth images: the tick needs each
        # frame's depth scale.
        camera_left.subscribe_frameset(lambda fs: self._on_frameset(0, fs))
        camera_right.subscribe_frameset(lambda fs: self._on_frameset(1, fs))

    def _on_frameset(self, stream: int, fs: HostFrameset) -> None:
        # Under the lock: captures arrive on each camera's own thread (the
        # fusion feeder's capture threads), in the order they finish, while
        # tick() reads on another, and the pairer is not thread-safe. The
        # pairer takes the globally closest pair, so a camera's frame that
        # arrives before the other's frame of its moment still pairs with it.
        with self._lock:
            for fl, fr in self.pairer.push(stream, fs):
                self._latest = (fl.depth, fr.depth, fl.depth_scale, fr.depth_scale)

    def subscribe_transform(self, cb: Callable[[np.ndarray], None]) -> None:
        self._transform_subs.append(cb)

    def tick(self) -> Optional[np.ndarray]:
        """One registration solve on the latest synchronized pair."""
        with self._lock:
            latest = self._latest
        if latest is None:
            return None
        transform = self.pipeline.tick(latest[0], latest[1], depth_scale_left=latest[2],
                                       depth_scale_right=latest[3])
        for cb in self._transform_subs:
            cb(transform)
        return transform

    def spin(self, max_ticks: Optional[int] = None) -> None:
        period = 1.0 / self.spin_rate_hz
        ticks = 0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.tick()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return
            dt = time.perf_counter() - t0
            if dt < period:
                self._stop.wait(period - dt)

    def start(self, **kw) -> "RegistrationNodeApp":
        self._thread = threading.Thread(target=self.spin, kwargs=kw, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)
        if self.profiling_path:
            self.pipeline.write_profiling_csv(self.profiling_path)
        self.pipeline.close()
