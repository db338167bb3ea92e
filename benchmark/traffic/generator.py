"""The one traffic generator: camera sources driven by a mix's parameters.

A mix is a JSON file beside this one (``<mix>.json``):

- ``loop``: ``"open"`` or ``"closed"``.
- ``rate_hz`` (open): the rate at which frame k of every camera falls due,
  at ``t0 + k / rate_hz``.
- ``warmup_frames``: frames every camera hands out before the window, as
  fast as they are pulled; they warm every shape the window uses.
- ``tail_frames`` (open): frames due after the window, so the last pairs
  of the window see the same pipeline behind them as every other.
- ``pool_frames``: distinct frames rendered per camera; frame k shows pool
  frame ``k mod pool_frames``.

Closed loop: a camera hands out its next frame the moment it is asked, for
``seconds`` after the window opens. Open loop: a camera that is asked early
sleeps until its next frame is due; one asked late holds at most
``queue_size`` due frames (the sensor's ``frames_queue_size``), hands out
the oldest of them and counts the older ones as dropped.

Every frame k carries the stamp ``STAMP0 + k / camera_fps`` (the sensor's
clock), so two cameras' frame k pair and no other frames do.
"""

from __future__ import annotations

import json
import math
import pathlib
import threading
import time
from typing import List, Optional

import numpy as np

STAMP0 = 1000.0
MIX_DIR = pathlib.Path(__file__).resolve().parent


def load_mix(name: str, directory: pathlib.Path = MIX_DIR) -> dict:
    mix = json.loads((pathlib.Path(directory) / f"{name}.json").read_text())
    if mix["loop"] not in ("open", "closed"):
        raise ValueError(f"mix {name}: loop must be open or closed")
    return mix


class Clock:
    """The window shared by a cell's cameras. Before :meth:`open` the
    cameras hand out their warm-up frames and then wait; :meth:`open` sets
    the window's start ``t0`` and releases them."""

    def __init__(self, mix: dict, seconds: float, camera_fps: float):
        self.mix = mix
        self.seconds = float(seconds)
        self.camera_fps = float(camera_fps)
        self.warmup = int(mix["warmup_frames"])
        self.t0: Optional[float] = None
        self._go = threading.Event()
        self._stopped = threading.Event()
        if mix["loop"] == "open":
            self.rate = float(mix["rate_hz"])
            self.frames = int(math.ceil(self.seconds * self.rate))
            self.tail = int(mix.get("tail_frames", 0))

    @property
    def open_loop(self) -> bool:
        return self.mix["loop"] == "open"

    def open(self, lead_s: float = 0.02) -> None:
        self.t0 = time.perf_counter() + lead_s
        self._go.set()

    def stop(self) -> None:
        """End the stream early (a failed run): waiting cameras return."""
        self._stopped.set()
        self._go.set()

    def is_open(self) -> bool:
        return self._go.is_set() and not self._stopped.is_set()

    def wait_open(self) -> bool:
        """Block until the window opens; False when the stream was stopped."""
        self._go.wait()
        return not self._stopped.is_set()

    @property
    def t_end(self) -> float:
        return self.t0 + self.seconds

    def due(self, k: int) -> float:
        """When window frame k (k >= 0) falls due, open loop."""
        return self.t0 + k / self.rate

    def stamp(self, k: int) -> float:
        return STAMP0 + k / self.camera_fps

    def frame_of(self, stamp: float) -> int:
        return int(round((stamp - STAMP0) * self.camera_fps))


class CameraSource:
    """One camera's stream of the cell's frame pool (a FramesetSource: it
    has ``next_frame`` and ``intrinsics``). Records every frame number it
    hands out, in order, the frames it dropped, and how late it woke."""

    def __init__(self, clock: Clock, depth: np.ndarray, color: np.ndarray, intrinsics,
                 depth_scale: float, queue_size: int, frameset_cls):
        self.clock = clock
        self.depth, self.color = depth, color  # (P, H, W) uint16, (P, H, W, 3) uint8
        self._intr = intrinsics
        self.depth_scale = float(depth_scale)
        self.queue_size = max(1, int(queue_size))
        self._frameset = frameset_cls
        self.next_k = -clock.warmup
        self.handed: List[int] = []
        self.dropped = 0
        self.wake_late_s: List[float] = []
        self.last_wait_s = 0.0

    @property
    def intrinsics(self):
        return self._intr

    def _frame(self, k: int):
        p = k % self.depth.shape[0]
        self.handed.append(k)
        return self._frameset(depth=self.depth[p], color=self.color[p],
                              timestamp=self.clock.stamp(k), depth_scale=self.depth_scale)

    def next_frame(self):
        clock = self.clock
        self.last_wait_s = 0.0
        k = self.next_k
        if k < 0:
            self.next_k += 1
            return self._frame(k)
        if not clock.is_open():
            t = time.perf_counter()
            if not clock.wait_open():
                return None
            self.last_wait_s = time.perf_counter() - t
        now = time.perf_counter()
        if not clock.open_loop:
            if now >= clock.t_end:
                return None
            self.next_k += 1
            return self._frame(k)
        if k >= clock.frames + clock.tail:
            return None
        due = clock.due(k)
        if now < due:
            time.sleep(due - now)
            woke = time.perf_counter()
            self.wake_late_s.append(woke - due)
            self.last_wait_s += woke - now
        else:
            newest = min(int((now - clock.t0) * clock.rate), clock.frames + clock.tail - 1)
            first = max(k, newest - self.queue_size + 1)
            self.dropped += first - k
            k = first
        self.next_k = k + 1
        return self._frame(k)
