"""ctypes bindings for the native host runtime (``csrc/host/pdf_runtime.cpp``
and ``csrc/host/temporal.cpp``).

A copy of pointcloud_depthfusion_tpu/runtime/bindings.py over the port's own
copy of the C++ source, with the port's temporal step built into the same
library. The library is built by g++ at first use into
``build/host_runtime/<hash>/libpdf_runtime.so`` beside the package: the hash
covers the sources, the flags and what the compiler makes of
``-march=native`` on this host, so a changed source, compiler or CPU never
loads a stale library. The flags are those of ``runtime/Makefile``;
``-ffp-contract=off`` is load-bearing: without it the spatial and temporal
filters' f32 blends contract into FMAs and stop matching the numpy versions.

The compiler is the first of ``$CXX`` and g++ on ``$PATH`` that has
OpenMP. A missing compiler or a failed build raises from
:func:`load_library` with the compiler's output; no native function falls
back to numpy. Callers that may run without the library choose at
construction, with :func:`is_available`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "host" / "pdf_runtime.cpp"
#: Every source of the library: the byte copy of the JAX runtime, then the
#: port's own.
SOURCES = (SOURCE, PACKAGE_DIR / "csrc" / "host" / "temporal.cpp")
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "host_runtime"
CXX_FLAGS = ["-O3", "-march=native", "-Wall",
             "-ffp-contract=off", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[RuntimeError] = None  # a failed build is not retried per call
_lock = threading.Lock()
#: The compiler's output from the build this process ran; empty when the
#: library was already built.
build_log = ""


def _cxx_candidates() -> List[str]:
    """Where the C++ compiler may be: $CXX, then g++ on $PATH."""
    out = []
    if os.environ.get("CXX"):
        out.append(shutil.which(os.environ["CXX"]) or os.environ["CXX"])
    found = shutil.which("g++")
    if found:
        out.append(found)
    return out


def _has_openmp(cxx: str) -> bool:
    """Whether ``cxx`` can build with -fopenmp: g++ reads libgomp.spec for
    it, which a compiler installed without OpenMP lacks."""
    try:
        spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return False
    return os.path.isabs(spec) and os.path.isfile(spec)


def find_cxx() -> str:
    """The first candidate compiler that runs and has OpenMP."""
    found = [p for p in _cxx_candidates() if os.path.isfile(p) and os.access(p, os.X_OK)]
    for path in found:
        if _has_openmp(path):
            return path
    if found:
        raise RuntimeError(f"no C++ compiler with OpenMP (libgomp.spec) among {found}; the "
                           "native host runtime cannot be built")
    raise RuntimeError("no C++ compiler found ($CXX, g++ on $PATH); the native host "
                       "runtime cannot be built")


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


def _digest(cxx: str) -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    # The compiler's version and its -march=native expansion on this host.
    h.update(_run([cxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull,
                   "-o", os.devnull]).encode())
    return h.hexdigest()[:16]


def _compile(cxx: str, target: pathlib.Path) -> str:
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build privately, then rename into place: a process building at the
    # same time never loads a half-written library.
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        lib = os.path.join(tmp, target.name)
        log = _run([cxx, *CXX_FLAGS, "-o", lib, *map(str, SOURCES)])
        os.replace(lib, target)
    return log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    d, i, p = ctypes.c_double, ctypes.c_int, ctypes.c_void_p
    pd = ctypes.POINTER(ctypes.c_double)
    lib.pdf_render_scene.argtypes = [
        i, i, d, d, d, d, pd, d, i, pd, d, d, d, d, d, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pdf_render_scene.restype = None

    lib.pdf_pairer_create.argtypes = [d, i]
    lib.pdf_pairer_create.restype = p
    lib.pdf_pairer_destroy.argtypes = [p]
    lib.pdf_pairer_destroy.restype = None
    lib.pdf_pairer_push.argtypes = [p, i, d, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), i]
    lib.pdf_pairer_push.restype = i
    lib.pdf_pairer_dropped.argtypes = [p]
    lib.pdf_pairer_dropped.restype = ctypes.c_int64
    lib.pdf_pairer_emitted.argtypes = [p]
    lib.pdf_pairer_emitted.restype = ctypes.c_int64

    lib.pdf_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.pdf_ring_create.restype = p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, restype in (("pdf_ring_destroy", None), ("pdf_ring_acquire_write", u8p),
                          ("pdf_ring_commit_write", None), ("pdf_ring_acquire_read", u8p),
                          ("pdf_ring_commit_read", None), ("pdf_ring_size", ctypes.c_size_t)):
        getattr(lib, name).argtypes = [p]
        getattr(lib, name).restype = restype

    f = ctypes.c_float
    for name, elem in (("pdf_spatial_filter_u16", ctypes.c_uint16),
                       ("pdf_spatial_filter_f32", ctypes.c_float)):
        getattr(lib, name).argtypes = [ctypes.POINTER(elem), i, i, f, f, i, i]
        getattr(lib, name).restype = None
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.pdf_decimation_u16.argtypes = [u16p, u16p, i, i, i]
    lib.pdf_decimation_u16.restype = None

    for name in ("pdf_temporal_step_u16", "pdf_temporal_step_f32"):
        getattr(lib, name).argtypes = [p, p, p, ctypes.c_int64, f, f, f]
        getattr(lib, name).restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """The native runtime, built on first call in this checkout. Raises
    with the compiler's output when it cannot be built (and again on every
    later call, without rebuilding)."""
    global _lib, _error, build_log
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            cxx = find_cxx()
            target = BUILD_ROOT / _digest(cxx) / "libpdf_runtime.so"
            if not target.exists():
                build_log = _compile(cxx, target)
            _lib = _bind(ctypes.CDLL(str(target)))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as exc:
            _error = RuntimeError(f"native host runtime unavailable: {exc}")
            raise _error from exc
        return _lib


def is_available() -> bool:
    """Whether the native runtime loads (building it on first call)."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def has_native_filters() -> bool:
    """The port's library always carries the filters (the JAX binding
    probes for them in libraries built before they existed)."""
    return is_available()


def render_scene_native(
    width: int,
    height: int,
    fx: float,
    fy: float,
    ppx: float,
    ppy: float,
    world_from_cam: np.ndarray,
    plane_z: float,
    spheres: np.ndarray,  # (N, 7): cx cy cz r  cr cg cb
    checker_period: float,
    max_depth: float,
    depth_scale: float,
    noise_std: float = 0.0,
    hole_fraction: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """OpenMP-parallel scene render; returns (depth u16 (H,W), color u8 (H,W,3))."""
    lib = load_library()
    depth = np.empty((height, width), np.uint16)
    color = np.empty((height, width, 3), np.uint8)
    wfc = np.ascontiguousarray(world_from_cam, np.float64).reshape(16)
    sph = np.ascontiguousarray(spheres, np.float64).reshape(-1)
    lib.pdf_render_scene(
        width, height, fx, fy, ppx, ppy,
        wfc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        plane_z, len(sph) // 7,
        sph.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        checker_period, max_depth, depth_scale,
        noise_std, hole_fraction, seed,
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        color.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return depth, color


def spatial_filter_native(
    depth: np.ndarray, alpha: float = 0.55, delta: float = 20.0,
    magnitude: int = 2, holes_fill: int = 0,
) -> np.ndarray:
    """OpenMP rs2 spatial filter, value-identical to
    ``ops.host_filters.spatial_filter_np`` (no FMA contraction, so the f32
    blends round the same). Integer depth is clipped into u16 and handed
    back in its own dtype, as the numpy version does. ``holes_fill``
    outside 0..5 raises, as ``spatial_holes_radius`` does (the C++ and the
    JAX binding clamp it)."""
    if not 0 <= int(holes_fill) <= 5:
        raise ValueError(f"holes_fill must be 0..5, got {holes_fill}")
    lib = load_library()
    h, w = depth.shape
    if np.issubdtype(depth.dtype, np.integer):
        out = np.ascontiguousarray(np.clip(depth, 0, 65535), np.uint16)
        lib.pdf_spatial_filter_u16(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            h, w, alpha, delta, int(magnitude), int(holes_fill),
        )
        return out.astype(depth.dtype, copy=False)
    out = np.ascontiguousarray(depth, np.float32).copy()
    lib.pdf_spatial_filter_f32(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, alpha, delta, int(magnitude), int(holes_fill),
    )
    return out


def decimation_filter_native(depth_u16: np.ndarray, magnitude: int = 2) -> np.ndarray:
    """Native rs2 decimation (block upper-median of nonzero depths)."""
    h, w = depth_u16.shape
    m = int(magnitude)
    if h % m or w % m:
        raise ValueError(f"image {h}x{w} not divisible by magnitude {m}")
    lib = load_library()
    src = np.ascontiguousarray(depth_u16, np.uint16)
    out = np.empty((h // m, w // m), np.uint16)
    lib.pdf_decimation_u16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, m,
    )
    return out


def temporal_filter_native(data: np.ndarray, prev: np.ndarray, alpha: float = 0.4,
                           delta: float = 20.0) -> np.ndarray:
    """One pass of the temporal EMA step over ``data`` (u16 depth or f32
    disparity) against ``prev`` of the same shape and dtype, value-identical
    to ``ops.host_filters._temporal_filter_numpy``; a fresh array. The
    constants are numpy's: f32(alpha), f32(1 - alpha) subtracted in f64,
    f32(delta)."""
    if data.dtype not in (np.uint16, np.float32):
        raise ValueError(f"the native temporal step takes uint16 or float32, not {data.dtype}")
    if prev.dtype != data.dtype or prev.shape != data.shape:
        raise ValueError(f"history {prev.dtype}{prev.shape} does not match frame "
                         f"{data.dtype}{data.shape}")
    lib = load_library()
    cur = np.ascontiguousarray(data)
    old = np.ascontiguousarray(prev)
    out = np.empty(cur.shape, cur.dtype)
    step = lib.pdf_temporal_step_u16 if cur.dtype == np.uint16 else lib.pdf_temporal_step_f32
    step(cur.ctypes.data, old.ctypes.data, out.ctypes.data, cur.size,
         alpha, 1.0 - alpha, delta)
    return out


class NativePairer:
    """C++ ApproximateTime pairer (the semantics of io.feeder's
    ApproximateTimePairer, over frame ids)."""

    def __init__(self, max_interval_s: float = 0.017, queue_size: int = 10):
        self._lib = load_library()
        self._h = self._lib.pdf_pairer_create(max_interval_s, queue_size)
        self._out = (ctypes.c_int64 * 64)()

    def push(self, stream: int, timestamp: float, frame_id: int) -> List[Tuple[int, int]]:
        n = self._lib.pdf_pairer_push(self._h, stream, timestamp, frame_id, self._out, 32)
        return [(self._out[i * 2], self._out[i * 2 + 1]) for i in range(n)]

    @property
    def dropped(self) -> int:
        return self._lib.pdf_pairer_dropped(self._h)

    @property
    def emitted(self) -> int:
        return self._lib.pdf_pairer_emitted(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pdf_pairer_destroy(self._h)
            self._h = None


class NativeRing:
    """SPSC byte ring of fixed slots (the capture → upload hand-off)."""

    def __init__(self, slot_size: int, n_slots: int):
        self._lib = load_library()
        self.slot_size = slot_size
        self._h = self._lib.pdf_ring_create(slot_size, n_slots)

    def try_write(self, data: np.ndarray) -> bool:
        flat = np.asarray(data).reshape(-1).view(np.uint8)
        # Validate before acquiring: a slot acquired and never committed
        # would wedge the ring.
        if flat.size > self.slot_size:
            raise ValueError(f"payload {flat.size} B exceeds ring slot {self.slot_size} B")
        ptr = self._lib.pdf_ring_acquire_write(self._h)
        if not ptr:
            return False
        buf = np.ctypeslib.as_array(ptr, shape=(self.slot_size,))
        buf[: flat.size] = flat
        buf[flat.size:] = 0
        self._lib.pdf_ring_commit_write(self._h)
        return True

    def try_read(self) -> Optional[np.ndarray]:
        ptr = self._lib.pdf_ring_acquire_read(self._h)
        if not ptr:
            return None
        buf = np.ctypeslib.as_array(ptr, shape=(self.slot_size,)).copy()
        self._lib.pdf_ring_commit_read(self._h)
        return buf

    def __len__(self) -> int:
        return self._lib.pdf_ring_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pdf_ring_destroy(self._h)
            self._h = None
