"""Registration service: continuous right→left transform estimation.

Port of pointcloud_depthfusion_tpu/registration/pipeline.py (the
reference's RegistrationNode, registration_node.cpp): consumes depth-frame
pairs at a low cadence, runs the VGICP solver with warm starts, gates
implausible results, anneals the resolution during the initial phase, and
persists the calibration transform.

The per-tick device work (filter → decimated deprojection → voxel grids on
kernel B5 → Gauss-Newton) runs eagerly on the pipeline's device; the
gating/annealing state machine stays on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.ops import filters as F
from pointcloud_depthfusion_tpu_torch.ops import voxel as V
from pointcloud_depthfusion_tpu_torch.registration.gicp import (
    GICPConfig,
    GICPResult,
    gicp_register_prepared,
    prepare_target,
)


@dataclasses.dataclass
class RegistrationSettings:
    """registration_node/config/config_default.yaml equivalents (see the
    JAX RegistrationSettings for each field's meaning)."""

    min_depth: float = 0.5
    max_depth: float = 3.0
    depth_scale_left: float = 0.001
    depth_scale_right: float = 0.001
    roi_left: Optional[Tuple[int, int, int, int]] = None
    roi_right: Optional[Tuple[int, int, int, int]] = None

    # Solver (config_default.yaml:15-29)
    resolution: float = 0.01
    voxelsize: float = 0.01
    kernel_width: float = 0.005
    kernel_max_dist: float = 0.025
    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    translation_epsilon: float = 1e-4
    fitness_epsilon: float = 1e-12
    table_size: int = 1 << 15
    neighbor_search: str = "direct1"

    # Sparse-outlier pre-filter (off by default, like the reference).
    outlier_removal: bool = False
    outlier_resolution: float = 0.05
    outlier_stddev_mul: float = 1.0

    # Gating / annealing (registration_node.cpp:363-407, :485-530)
    discard_transform: bool = True
    angle_gate: bool = True
    reset_initial_guess: bool = True
    adjust_resolution: bool = True
    initial_resolution: float = 0.1
    resolution_step: float = 0.05
    voxel_resolution_factor: float = 0.1
    cam_upside_down: bool = False

    # Persistence (registration_node.cpp:96-105, :742-833)
    transform_path: Optional[str] = None
    load_transform: bool = False
    save_transform: bool = False

    # Debug cloud taps (registration_node.cpp:410-427)
    publish_clouds: bool = False

    # Rebuild the target grid every N ticks (and on any resolution change).
    target_grid_cache_ticks: int = 4
    # Stride-decimate the depth image before deprojection (1 = off).
    cloud_decimation: int = 2


@dataclasses.dataclass
class RegistrationTelemetry:
    """Per-tick profiling row (registration profiling CSV schema)."""

    fitness: float
    icp_ms: float
    target_points: int
    source_points: int
    discarded: bool
    guess_reset: bool
    target_grid_rebuilt: bool = True
    iterations: int = 0


def _depth_tensor(depth, device) -> torch.Tensor:
    """u16 depth (numpy or tensor) → (H, W) int32 on ``device``."""
    if isinstance(depth, torch.Tensor):
        return depth.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.asarray(depth).astype(np.uint16).astype(np.int32)).to(device)


class RegistrationPipeline:
    """Continuous right→left extrinsic calibration on one device
    (``device=None``: the card)."""

    def __init__(
        self,
        intrinsics_left: Intrinsics,
        intrinsics_right: Intrinsics,
        settings: Optional[RegistrationSettings] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.settings = settings or RegistrationSettings()
        self.intr_left = intrinsics_left.to(self.device)
        self.intr_right = intrinsics_right.to(self.device)

        s = self.settings
        # cam_upside_down → initial guess 180° about Z (registration_node.cpp:153-160).
        start = np.eye(4, dtype=np.float32)
        if s.cam_upside_down:
            start[:3, :3] = np.asarray(
                [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]], np.float32
            )
        self.start_transform = start
        self.initial_transform = start.copy()
        self.last_transform = start.copy()
        self.best_fitness = np.inf
        self.initial_phase = bool(s.adjust_resolution)
        self.current_resolution = s.initial_resolution if s.adjust_resolution else s.resolution
        self.current_voxelsize = (
            max(s.voxelsize, s.voxel_resolution_factor * self.current_resolution)
            if s.adjust_resolution
            else s.voxelsize
        )
        self.telemetry: list[RegistrationTelemetry] = []
        self.debug_clouds: Optional[dict] = None

        if s.load_transform and s.transform_path:
            loaded = load_transform_file(s.transform_path)
            if loaded is not None:
                self.initial_transform = loaded
                self.last_transform = loaded.copy()

        self._cloud_cache: dict = {}
        self._tgt_grid_key = None
        self._tgt_grid = None
        self._tgt_grid_age = 0
        self._warm_start = False
        self._left_count = 0

    def _f32(self, value) -> torch.Tensor:
        return torch.tensor(float(value), dtype=torch.float32, device=self.device)

    # -- device programs ---------------------------------------------------

    def _cloud_fn(self, which: str):
        """(depth, depth_scale) → (points (N, 3), valid (N,), valid count) for
        one side, cached per the settings it closes over."""
        intr = self.intr_left if which == "left" else self.intr_right
        roi = self.settings.roi_left if which == "left" else self.settings.roi_right
        s = self.settings
        k = max(1, int(s.cloud_decimation))
        key = (which, s.min_depth, s.max_depth, roi, k,
               s.outlier_removal, s.outlier_resolution, s.outlier_stddev_mul, s.table_size)
        cached = self._cloud_cache.get(key)
        if cached is not None:
            return cached

        # Strided pixel (r, c) is pixel (r·k, c·k): dividing fx/fy/ppx/ppy
        # by k (as f32 tensors, in the JAX order) deprojects it exactly.
        kt = self._f32(k)
        intr_k = dataclasses.replace(
            intr, fx=intr.fx / kt, fy=intr.fy / kt, ppx=intr.ppx / kt, ppy=intr.ppy / kt,
            width=-(-intr.width // k), height=-(-intr.height // k),
        )
        min_depth, max_depth = self._f32(s.min_depth), self._f32(s.max_depth)
        outlier_res = self._f32(s.outlier_resolution)

        def to_cloud(depth: torch.Tensor, depth_scale: torch.Tensor):
            d, valid = F.filter_depth(depth, depth_scale, min_depth, max_depth, roi)
            d = d[::k, ::k]
            valid = valid[::k, ::k]
            pts, valid = G.deproject(d.to(torch.float32) * depth_scale, intr_k, valid)
            pts = pts.reshape(-1, 3)
            valid = valid.reshape(-1)
            if s.outlier_removal:
                valid = V.statistical_outlier_removal(
                    pts, valid, outlier_res, s.outlier_stddev_mul, s.table_size
                )
            return pts, valid, valid.sum()

        self._cloud_cache[key] = to_cloud
        return to_cloud

    def _make_config(self) -> GICPConfig:
        """This tick's solver settings: kernel, damping and epsilons follow
        the active annealing resolution; warm ticks enable the relative
        fitness-plateau exit (see the JAX ``_make_config``)."""
        s = self.settings
        kernel_width = self.current_resolution / 2.0
        kernel_max_dist = 2.5 * self.current_resolution
        damping = float(np.clip(0.25 * self.current_resolution, 0.01, 0.1))
        warm = not self.initial_phase and self._warm_start
        fitness_rel_eps = 5e-3 if warm else 0.0
        annealing = self.initial_phase and (self.current_resolution > s.resolution)
        if annealing:
            rotation_eps = max(s.rotation_epsilon, 1e-2)
            translation_eps = max(s.translation_epsilon, self.current_resolution / 100.0)
            iteration_cap = min(s.max_iterations, 16)
        else:
            rotation_eps = s.rotation_epsilon
            translation_eps = s.translation_epsilon
            iteration_cap = s.max_iterations
        return GICPConfig.create(
            fitness_rel_eps=fitness_rel_eps,
            resolution=self.current_resolution,
            voxel_size=self.current_voxelsize,
            rotation_eps=rotation_eps,
            translation_eps=translation_eps,
            fitness_eps=s.fitness_epsilon,
            kernel_width=kernel_width,
            kernel_max_dist=kernel_max_dist,
            max_iterations=s.max_iterations,
            iteration_cap=iteration_cap,
            table_size=s.table_size,
            damping=damping,
            neighbor_search=s.neighbor_search,
            device=self.device,
        )

    # -- the per-tick entry point -----------------------------------------

    def tick(
        self,
        depth_left_u16,
        depth_right_u16,
        depth_scale_left: Optional[float] = None,
        depth_scale_right: Optional[float] = None,
    ) -> np.ndarray:
        """One registration tick: returns the current right→left 4×4 (f32).

        Left is the target, right the source. ``depth_scale_left/right``:
        the frames' m/LSB scales, overriding the settings."""
        s = self.settings
        t0 = time.perf_counter()
        scale_l = s.depth_scale_left if depth_scale_left is None else float(depth_scale_left)
        scale_r = s.depth_scale_right if depth_scale_right is None else float(depth_scale_right)
        for name, d, intr in (
            ("left", depth_left_u16, self.intr_left),
            ("right", depth_right_u16, self.intr_right),
        ):
            if tuple(d.shape) != (intr.height, intr.width):
                raise ValueError(
                    f"{name} depth {tuple(d.shape)} does not match the registered "
                    f"intrinsics ({intr.height}, {intr.width}) — decimated depth "
                    "streams cannot feed the registration service"
                )

        right_cloud, right_valid, right_count = self._cloud_fn("right")(
            _depth_tensor(depth_right_u16, self.device), self._f32(scale_r)
        )
        config = self._make_config()

        grid_key = (float(self.current_resolution), float(self.current_voxelsize),
                    s.table_size, float(scale_l))
        rebuild = (
            self._tgt_grid is None
            or self._tgt_grid_key != grid_key
            or self._tgt_grid_age >= max(1, s.target_grid_cache_ticks)
        )
        if rebuild or s.publish_clouds:
            left_cloud, left_valid, left_count = self._cloud_fn("left")(
                _depth_tensor(depth_left_u16, self.device), self._f32(scale_l)
            )
            self._left_count = int(left_count)
        else:
            left_cloud = left_valid = None
        left_count = self._left_count
        if rebuild:
            self._tgt_grid = prepare_target(left_cloud, left_valid, config)
            self._tgt_grid_key = grid_key
            self._tgt_grid_age = 0
        self._tgt_grid_age += 1

        init = torch.from_numpy(np.asarray(self.initial_transform, np.float32)).to(self.device)
        result: GICPResult = gicp_register_prepared(
            right_cloud, right_valid, self._tgt_grid, init, config
        )
        final = result.transform.cpu().numpy().astype(np.float64)
        fitness = float(result.fitness)
        iterations = int(result.iterations)
        right_count = int(right_count)
        icp_ms = (time.perf_counter() - t0) * 1e3

        discarded = False
        guess_reset = False
        # Transform gating (registration_node.cpp:363-393).
        if s.discard_transform:
            angles_fit = not s.angle_gate or transform_angles_fit(final, s.cam_upside_down)
            if fitness < self.best_fitness and angles_fit:
                self.best_fitness = fitness
            else:
                final = self.initial_transform.astype(np.float64)
                self.best_fitness *= 1.5  # decay escape hatch
                discarded = True
        # Guess reset (registration_node.cpp:396-407).
        if s.reset_initial_guess and fitness > self.current_resolution * 10.0:
            final = self.start_transform.astype(np.float64)
            guess_reset = True

        self.last_transform = final.astype(np.float32)
        self.initial_transform = final.astype(np.float32)  # warm start
        self._warm_start = not guess_reset

        if s.publish_clouds:
            tgt = left_cloud[left_valid].cpu().numpy()
            src = right_cloud[right_valid].cpu().numpy()
            aligned = src @ final[:3, :3].T.astype(src.dtype) + final[:3, 3].astype(src.dtype)
            self.debug_clouds = dict(target=tgt, aligned=aligned)

        # Resolution annealing (registration_node.cpp:485-530).
        if s.adjust_resolution and self.initial_phase:
            if self.current_resolution - s.resolution_step > s.resolution:
                self.current_resolution -= s.resolution_step
            else:
                self.current_resolution = s.resolution
            if self.current_resolution * s.voxel_resolution_factor > s.voxelsize:
                self.current_voxelsize = s.voxel_resolution_factor * self.current_resolution
            else:
                self.current_voxelsize = s.voxelsize
            if self.current_resolution <= s.resolution and self.current_voxelsize <= s.voxelsize:
                self.initial_phase = False

        self.telemetry.append(RegistrationTelemetry(
            fitness=fitness, icp_ms=icp_ms, target_points=int(left_count),
            source_points=right_count, discarded=discarded, guess_reset=guess_reset,
            target_grid_rebuilt=rebuild, iterations=iterations,
        ))
        return self.last_transform

    def seed(self, transform: np.ndarray) -> None:
        """Adopt a trusted external transform: the next tick warm-starts from
        it with the annealing phase skipped (the load_transform workflow)."""
        t = np.asarray(transform, np.float32).reshape(4, 4)
        self.initial_transform = t.copy()
        self.last_transform = t.copy()
        self._warm_start = True
        self.initial_phase = False
        self.current_resolution = self.settings.resolution
        self.current_voxelsize = self.settings.voxelsize

    def close(self) -> None:
        s = self.settings
        if s.save_transform and s.transform_path:
            save_transform_file(s.transform_path, self.last_transform)

    def write_profiling_csv(self, path: str) -> None:
        """CSV with the reference schema (registration_node.cpp:429-460)."""
        with open(path, "w") as fh:
            fh.write("euclidean_fitness,icp_duration,points_target,points_source,"
                     "target_grid_rebuilt\n")
            for row in self.telemetry:
                fh.write(f"{row.fitness},{row.icp_ms},{row.target_points},"
                         f"{row.source_points},{int(row.target_grid_rebuilt)}\n")


# Transform persistence (whitespace-separated 4×4 text,
# registration_node.cpp:742-833).


def transform_angles_fit(final: np.ndarray, cam_upside_down: bool) -> bool:
    """Gate a solved right→left 4×4 (numpy) by its Euler angles
    (registration_node.cpp:363-393): |x| < 30°, |y| < 2°, |z| < 2° (or within
    2° of 180° for an upside-down mount, the JAX package's documented
    reading of the reference's intent)."""
    x_lim, y_lim, z_lim = 30.0, 2.0, 2.0
    r_m = final[:3, :3]
    euler = np.rad2deg(np.asarray([
        np.arctan2(r_m[2, 1], r_m[2, 2]),
        -np.arcsin(np.clip(r_m[2, 0], -1.0, 1.0)),
        np.arctan2(r_m[1, 0], r_m[0, 0]),
    ]))
    z_dev = 180.0 - abs(euler[2]) if cam_upside_down else abs(euler[2])
    return abs(euler[0]) < x_lim and abs(euler[1]) < y_lim and z_dev < z_lim


def save_transform_file(path: str, transform: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, np.asarray(transform, np.float64).reshape(4, 4))


def load_transform_file(path: str) -> Optional[np.ndarray]:
    """Load a 4×4; None on failure (the caller keeps identity, like the
    reference)."""
    try:
        m = np.loadtxt(path).reshape(4, 4).astype(np.float32)
    except (OSError, ValueError):
        return None
    return m if np.all(np.isfinite(m)) else None
