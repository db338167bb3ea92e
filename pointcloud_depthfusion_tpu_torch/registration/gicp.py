"""Voxelized GICP: rigid registration of two clouds.

Port of pointcloud_depthfusion_tpu/registration/gicp.py (the JAX package's
replacement for FastVGICPCuda, registration.cpp:31-47):

  * both clouds are voxel-downsampled at ``voxel_size`` (ops/voxel.py);
  * the target is voxelized at ``resolution`` into per-voxel Gaussians with
    plane-regularized covariances pooled over the 3×3×3 neighborhood;
  * correspondences are direct voxel lookups of the transformed source
    (``direct1``) or of its 7 / 27 neighbor voxels, RBF-weighted;
  * damped Gauss-Newton on SE(3), with the rotation / translation /
    fitness epsilons as the exit test.

The JAX package runs the iteration under ``lax.while_loop``. Here the step
masks itself once converged (a zero step; the fitness, correspondence count
and iteration count of the converging iteration kept), so extra iterations
change nothing; the host reads the converged flag once
every :data:`DONE_CHECK_EVERY` iterations and stops at
``min(max_iterations, iteration_cap)``. No other host sync happens inside a
solve. All math is f32 with TF32 off; the 6×6 solve runs in f64.

``solver="matrix"`` (the JAX package's readability oracle) runs the
batched-tensor loop with ``direct1``; it shares the planar loop's update
and host loop. The point-sharded solve (registration/distributed.py) runs
the planar loop with a shard sum.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pointcloud_depthfusion_tpu_torch.core import geometry as G
from pointcloud_depthfusion_tpu_torch.device import resolve_device
from pointcloud_depthfusion_tpu_torch.ops import voxel as V

FLT_MAX = float(torch.finfo(torch.float32).max)

#: Iterations between two host reads of the converged flag. The loop is
#: bound by launches on the host, so a read costs about one launch; fewer
#: reads only add masked iterations after convergence.
DONE_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class GICPConfig:
    """Solver settings (registration_node/config/config_default.yaml:15-29).

    The JAX package's traced leaves are 0-d f32 tensors on one device;
    ``iteration_cap`` (the early-exit budget) is a host int, because the
    host drives the loop. See the JAX GICPConfig for each field's meaning.
    """

    resolution: torch.Tensor
    voxel_size: torch.Tensor
    rotation_eps: torch.Tensor
    translation_eps: torch.Tensor
    fitness_eps: torch.Tensor
    fitness_rel_eps: torch.Tensor
    kernel_width: torch.Tensor
    kernel_max_dist: torch.Tensor
    damping: torch.Tensor
    iteration_cap: int
    max_iterations: int = 64
    table_size: int = 1 << 15
    min_voxel_points: float = 1.0
    min_cov_points: float = 6.0
    cov_regularization: str = "plane"
    solver: str = "planar"
    neighbor_search: str = "direct1"

    @staticmethod
    def create(
        resolution: float = 0.01,
        voxel_size: float = 0.01,
        rotation_eps: float = 2e-3,
        translation_eps: float = 1e-4,
        fitness_eps: float = 1e-12,
        kernel_width: float = 0.005,
        kernel_max_dist: float = 0.025,
        fitness_rel_eps: float = 0.0,
        damping: float = 1e-2,
        iteration_cap=None,
        device=None,
        **static_fields,
    ) -> "GICPConfig":
        """A config on ``device`` (``None``: the card)."""
        device = resolve_device(device)
        if iteration_cap is None:
            iteration_cap = static_fields.get("max_iterations", 64)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return GICPConfig(
            resolution=f32(resolution),
            voxel_size=f32(voxel_size),
            rotation_eps=f32(rotation_eps),
            translation_eps=f32(translation_eps),
            fitness_eps=f32(fitness_eps),
            fitness_rel_eps=f32(fitness_rel_eps),
            kernel_width=f32(kernel_width),
            kernel_max_dist=f32(kernel_max_dist),
            damping=f32(damping),
            iteration_cap=int(iteration_cap),
            **static_fields,
        )

    @property
    def device(self) -> torch.device:
        return self.resolution.device


@dataclasses.dataclass(frozen=True)
class GICPResult:
    transform: torch.Tensor  # (4, 4) source→target
    fitness: torch.Tensor  # mean squared residual distance (m²)
    converged: torch.Tensor  # bool
    iterations: torch.Tensor  # int32 — iterations until convergence / cap
    num_correspondences: torch.Tensor  # int32 (final iteration)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3×3 inverse (adjugate / determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _cholesky_solve_6x6(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """SPD 6×6 solve in f64, without a host sync. A matrix that is not
    positive definite gives a NaN solution, which the solver treats as a
    non-finite step (the JAX package's unrolled f32 Cholesky clamps the
    pivot instead; both only meet that case on a degenerate Hessian)."""
    l, info = torch.linalg.cholesky_ex(h.to(torch.float64))
    x = torch.cholesky_solve(g.to(torch.float64)[:, None], l)[:, 0]
    return torch.where(info == 0, x, float("nan")).to(h.dtype)


def _solve_6x6(h: torch.Tensor, g: torch.Tensor, damping: torch.Tensor) -> torch.Tensor:
    """Damped Gauss-Newton step: (H + λ·diag(H))⁻¹ g."""
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    lm = damping * torch.diag(torch.diagonal(h)) + 1e-12 * eye
    return _cholesky_solve_6x6(h + lm, g)


def prepare_target(target_points, target_valid, config: GICPConfig) -> V.VoxelGrid:
    """The regularized target distribution grid, cacheable across ticks
    while the target scene is static: means from the voxel's own members,
    covariance orientation pooled over the 3×3×3 neighborhood."""
    f = torch.float32
    tgt = target_points.reshape(-1, 3).to(f)
    tval = target_valid.reshape(-1)
    tgt_ds, tgt_mask = V.voxel_downsample(tgt, tval, config.voxel_size, config.table_size)
    tgt_grid = V.build_voxel_grid(tgt_ds, tgt_mask, config.resolution, config.table_size)
    tn_count, _, tn_cov = V.neighborhood_moments(tgt_grid)
    eye3 = torch.eye(3, dtype=f, device=tgt.device)
    cov_reg = torch.where(
        (tn_count >= config.min_cov_points)[:, None, None],
        V.regularize_covariances(tn_cov, config.cov_regularization),
        eye3,
    )
    return dataclasses.replace(tgt_grid, cov=cov_reg)


def gicp_register(
    source_points, source_valid, target_points, target_valid, initial_transform,
    config: GICPConfig,
) -> GICPResult:
    """Estimate the rigid transform mapping source-frame points into the
    target frame (warm-started from ``initial_transform``)."""
    tgt_grid = prepare_target(target_points, target_valid, config)
    return gicp_register_prepared(source_points, source_valid, tgt_grid, initial_transform, config)


# Neighbor-voxel offsets of the correspondence search (fast_gicp
# NeighborSearchMethod DIRECT1 / DIRECT7 / DIRECT27), in the JAX order.
_NEIGHBOR_OFFSETS = {
    "direct1": ((0, 0, 0),),
    "direct7": (
        (0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1),
    ),
    "direct27": tuple(
        (ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
    ),
}

# H from the 27 normal-equation sums (w11..w33, p11..p33, q11..q33, v, m×v):
# H = [[W, -P], [-Pᵀ, Q]] with the symmetric blocks' 6 unique entries.
_H_INDEX = (
    (0, 1, 2, 6, 7, 8),
    (1, 3, 4, 9, 10, 11),
    (2, 4, 5, 12, 13, 14),
    (6, 9, 12, 15, 16, 17),
    (7, 10, 13, 16, 18, 19),
    (8, 11, 14, 17, 19, 20),
)
_H_SIGN = tuple(
    tuple(1.0 if (i < 3) == (j < 3) else -1.0 for j in range(6)) for i in range(6)
)


def _sym_inv6(a, b, c, d, e, f):
    """Inverse of symmetric [[a,b,c],[b,d,e],[c,e,f]] as its 6 unique
    components (adjugate over determinant)."""
    co11 = d * f - e * e
    co12 = c * e - b * f
    co13 = b * e - c * d
    co22 = a * f - c * c
    co23 = b * c - a * e
    co33 = a * d - b * b
    det = a * co11 + b * co12 + c * co13
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    return (co11 * inv_det, co12 * inv_det, co13 * inv_det,
            co22 * inv_det, co23 * inv_det, co33 * inv_det)


def _check_neighbor_search(name: str) -> None:
    if name not in _NEIGHBOR_OFFSETS:
        raise ValueError(
            f"unknown neighbor_search {name!r} (expected one of {sorted(_NEIGHBOR_OFFSETS)})"
        )


def _gn_update(h, g, n_corr, fit_num, transform, prev_fitness, done, it_count, prev_n_corr,
               config: GICPConfig):
    """One damped Gauss-Newton update and the exit tests, shared by both
    solvers: the step from (H, g), the fitness from the correspondence
    count and the fitness numerator. Past convergence the step is a no-op
    and the converging iteration's fitness and count are kept (the JAX
    loop has stopped)."""
    f = torch.float32
    delta_raw = -_solve_6x6(h, g, config.damping)
    # A non-finite step is zeroed and must not read as convergence.
    step_finite = torch.isfinite(delta_raw).all()
    delta = torch.where(done | ~step_finite, 0.0, delta_raw)
    new_transform = G.mm(G.se3_exp(delta), transform)

    fitness = torch.where(
        n_corr > 0, fit_num / torch.clamp_min(n_corr.to(f), 1.0), FLT_MAX
    )
    rot_step = torch.linalg.vector_norm(delta[3:])
    trans_step = torch.linalg.vector_norm(delta[:3])
    fitness_ok = fitness < 1e10
    change = torch.abs(prev_fitness - fitness)
    plateau = (config.fitness_rel_eps > 0) & fitness_ok & (change < config.fitness_rel_eps * fitness)
    newly_done = (
        ((rot_step < config.rotation_eps) & (trans_step < config.translation_eps)
         & step_finite & (n_corr > 0))
        | (fitness_ok & (change < config.fitness_eps))
        | plateau
    ) & ~done
    it_count = torch.where(done, it_count, it_count + 1)
    fitness_out = torch.where(done, prev_fitness, fitness)
    n_corr_out = torch.where(done, prev_n_corr, n_corr)
    # Zero correspondences exits too; the result reports it unconverged.
    done = done | newly_done | (n_corr == 0)
    return new_transform, fitness_out, done, it_count, n_corr_out


def _gn_loop(step, initial_transform, config: GICPConfig, dev) -> GICPResult:
    """The host loop of both solvers: ``step`` until ``min(max_iterations,
    iteration_cap)``, the converged flag read every DONE_CHECK_EVERY
    iterations."""
    f = torch.float32
    transform = initial_transform.to(device=dev, dtype=f)
    fitness = torch.tensor(float("inf"), dtype=f, device=dev)
    done = torch.tensor(False, device=dev)
    it_count = torch.tensor(0, dtype=torch.int32, device=dev)
    n_corr = torch.tensor(0, dtype=torch.int32, device=dev)
    limit = min(config.max_iterations, config.iteration_cap)
    for i in range(1, limit + 1):
        transform, fitness, done, it_count, n_corr = step(transform, fitness, done, it_count, n_corr)
        if i % DONE_CHECK_EVERY == 0 and i < limit and bool(done):
            break
    return GICPResult(
        transform=transform,
        fitness=fitness,
        converged=done & (n_corr > 0),  # a no-correspondence exit is a failure
        iterations=it_count,
        num_correspondences=n_corr,
    )


def _planar_sums(src_ds, src_mask, src_cov, tgt_rows, tgt_coords, resolution, table_size: int,
                 config: GICPConfig, max_dist):
    """``sums(transform)`` of one cloud (or shard): the 27 normal-equation
    sums (27,), the correspondence count and the fitness numerator, with
    every per-point quantity an (M,) plane; the K neighbor probes of
    ``direct7``/``direct27`` run as one batched (K, M) pass."""
    f = torch.float32
    dev = src_ds.device
    offs = torch.tensor(_NEIGHBOR_OFFSETS[config.neighbor_search], dtype=torch.int32, device=dev)
    ox, oy, oz = offs[:, 0:1], offs[:, 1:2], offs[:, 2:3]
    sx, sy, sz = src_ds[:, 0], src_ds[:, 1], src_ds[:, 2]
    cs11, cs12, cs13 = src_cov[:, 0, 0], src_cov[:, 0, 1], src_cov[:, 0, 2]
    cs22, cs23, cs33 = src_cov[:, 1, 1], src_cov[:, 1, 2], src_cov[:, 2, 2]
    resolution, max_dist = resolution.to(dev), max_dist.to(dev)
    kernel_width = config.kernel_width.to(dev)
    max_d2 = max_dist * max_dist
    rbf_den = torch.clamp_min(kernel_width ** 2, 1e-12)
    use_rbf = kernel_width > 0

    def sums(transform):
        transform = transform.to(dev)
        r00, r01, r02 = transform[0, 0], transform[0, 1], transform[0, 2]
        r10, r11, r12 = transform[1, 0], transform[1, 1], transform[1, 2]
        r20, r21, r22 = transform[2, 0], transform[2, 1], transform[2, 2]
        t0, t1, t2 = transform[0, 3], transform[1, 3], transform[2, 3]

        mx = r00 * sx + r01 * sy + r02 * sz + t0
        my = r10 * sx + r11 * sy + r12 * sz + t1
        mz = r20 * sx + r21 * sy + r22 * sz + t2
        cx = torch.floor(mx / resolution).to(torch.int32)
        cy = torch.floor(my / resolution).to(torch.int32)
        cz = torch.floor(mz / resolution).to(torch.int32)

        # B = R C_s Rᵀ (6 components via A = R C_s), per point.
        a11 = r00 * cs11 + r01 * cs12 + r02 * cs13
        a12 = r00 * cs12 + r01 * cs22 + r02 * cs23
        a13 = r00 * cs13 + r01 * cs23 + r02 * cs33
        a21 = r10 * cs11 + r11 * cs12 + r12 * cs13
        a22 = r10 * cs12 + r11 * cs22 + r12 * cs23
        a23 = r10 * cs13 + r11 * cs23 + r12 * cs33
        a31 = r20 * cs11 + r21 * cs12 + r22 * cs13
        a32 = r20 * cs12 + r21 * cs22 + r22 * cs23
        a33 = r20 * cs13 + r21 * cs23 + r22 * cs33
        b11 = a11 * r00 + a12 * r01 + a13 * r02
        b12 = a11 * r10 + a12 * r11 + a13 * r12
        b13 = a11 * r20 + a12 * r21 + a13 * r22
        b22 = a21 * r10 + a22 * r11 + a23 * r12
        b23 = a21 * r20 + a22 * r21 + a23 * r22
        b33 = a31 * r20 + a32 * r21 + a33 * r22

        # Every (neighbor, point) pair at once: (K, M) planes.
        ncx, ncy, ncz = cx + ox, cy + oy, cz + oz
        idx = V.hash_coords_planar(ncx, ncy, ncz, table_size).to(torch.int64)
        rows = tgt_rows[idx]
        rc = tgt_coords[idx]
        found = (
            (rows[..., 0] >= config.min_voxel_points)
            & (rc[..., 0] == ncx) & (rc[..., 1] == ncy) & (rc[..., 2] == ncz)
        )
        ex = rows[..., 1] - mx
        ey = rows[..., 2] - my
        ez = rows[..., 3] - mz
        dist2 = ex * ex + ey * ey + ez * ez
        corr = src_mask & found & (dist2 <= max_d2)

        w11, w12, w13, w22, w23, w33 = _sym_inv6(
            rows[..., 4] + b11 + 1e-6, rows[..., 5] + b12, rows[..., 6] + b13,
            rows[..., 7] + b22 + 1e-6, rows[..., 8] + b23, rows[..., 9] + b33 + 1e-6,
        )
        rbf = torch.where(use_rbf, torch.exp(-0.5 * dist2 / rbf_den), 1.0)
        w = corr.to(f) * rbf

        vx = w11 * ex + w12 * ey + w13 * ez
        vy = w12 * ex + w22 * ey + w23 * ez
        vz = w13 * ex + w23 * ey + w33 * ez
        p11 = w12 * mz - w13 * my
        p12 = w13 * mx - w11 * mz
        p13 = w11 * my - w12 * mx
        p21 = w22 * mz - w23 * my
        p22 = w23 * mx - w12 * mz
        p23 = w12 * my - w22 * mx
        p31 = w23 * mz - w33 * my
        p32 = w33 * mx - w13 * mz
        p33 = w13 * my - w23 * mx
        q11 = mz * p21 - my * p31
        q12 = mz * p22 - my * p32
        q13 = mz * p23 - my * p33
        q22 = mx * p32 - mz * p12
        q23 = mx * p33 - mz * p13
        q33 = my * p13 - mx * p23
        terms = torch.stack([
            w11, w12, w13, w22, w23, w33,
            p11, p12, p13, p21, p22, p23, p31, p32, p33,
            q11, q12, q13, q22, q23, q33,
            vx, vy, vz, my * vz - mz * vy, mz * vx - mx * vz, mx * vy - my * vx,
        ])
        return ((w * terms).sum(dim=(1, 2)), corr.sum(dtype=torch.int32),
                (dist2 * corr.to(f)).sum())

    return sums


def _solve_planar(
    src_ds, src_mask, src_cov, tgt_rows, tgt_coords, resolution, table_size: int,
    initial_transform, config: GICPConfig, max_dist, shard_sum=None,
) -> GICPResult:
    """Gauss-Newton VGICP loop in structure-of-arrays form (the JAX
    package's ``_solve_planar``): the 27 normal-equation terms of every
    point (:func:`_planar_sums`) reduce in one sum over neighbors and
    points.

    ``shard_sum`` is the point-sharded solve's reduction, the counterpart
    of the JAX package's ``axis_name`` (registration/distributed.py): the
    source planes and the target table are then sequences with one entry
    per shard, each on its shard's device, and ``shard_sum`` takes the
    shards' (sums, correspondence count, fitness numerator) and returns
    their totals on the first shard's device, where the step runs."""
    if shard_sum is None:
        src_ds, src_mask, src_cov, tgt_rows, tgt_coords = (
            (t,) for t in (src_ds, src_mask, src_cov, tgt_rows, tgt_coords))
    shard_sums = [
        _planar_sums(*shard, resolution, table_size, config, max_dist)
        for shard in zip(src_ds, src_mask, src_cov, tgt_rows, tgt_coords)
    ]
    dev = src_ds[0].device
    h_index = torch.tensor(_H_INDEX, dtype=torch.int64, device=dev)
    h_sign = torch.tensor(_H_SIGN, dtype=torch.float32, device=dev)

    def step(transform, prev_fitness, done, it_count, prev_n_corr):
        parts = [sums(transform) for sums in shard_sums]
        sums, n_corr, fit_num = parts[0] if shard_sum is None else shard_sum(parts)
        h = sums[h_index] * h_sign
        g = -sums[21:27]
        return _gn_update(h, g, n_corr, fit_num, transform, prev_fitness, done, it_count,
                          prev_n_corr, config)

    return _gn_loop(step, initial_transform, config, dev)


def _solve_matrix(
    src_ds, src_mask, src_cov, tgt_rows, tgt_coords, resolution, table_size: int,
    initial_transform, config: GICPConfig, max_dist,
) -> GICPResult:
    """The batched-tensor Gauss-Newton loop (``solver="matrix"``, the JAX
    package's direct1 readability oracle): per point a 3×3 combined
    covariance, its inverse and the 3×6 Jacobian, reduced to H and g by
    einsum. The same correspondences, step and exit tests as the planar
    loop, in another f32 association order."""
    f = torch.float32
    dev = src_ds.device
    eye3 = torch.eye(3, dtype=f, device=dev)
    max_d2 = max_dist * max_dist
    rbf_den = torch.clamp_min(config.kernel_width ** 2, 1e-12)
    use_rbf = config.kernel_width > 0

    def lookup(moved):
        coords = V.voxel_coords(moved, resolution)
        idx = V.hash_coords(coords, table_size).to(torch.int64)
        rows = tgt_rows[idx]
        found = (rows[:, 0] >= config.min_voxel_points) & (tgt_coords[idx] == coords).all(-1)
        c6 = rows[:, 4:10]
        cov = torch.stack([
            torch.stack([c6[:, 0], c6[:, 1], c6[:, 2]], -1),
            torch.stack([c6[:, 1], c6[:, 3], c6[:, 4]], -1),
            torch.stack([c6[:, 2], c6[:, 4], c6[:, 5]], -1),
        ], -2)
        return rows[:, 1:4], cov, found

    def step(transform, prev_fitness, done, it_count, prev_n_corr):
        r_mat = transform[:3, :3]
        moved = G.mm(src_ds, r_mat.T) + transform[:3, 3]  # (M, 3)
        mu, cov_t, found = lookup(moved)
        resid = mu - moved
        dist2 = (resid * resid).sum(-1)
        corr = src_mask & found & (dist2 <= max_d2)

        # Combined covariance C = C_t + R C_s Rᵀ and its weight W = C⁻¹.
        cov_c = cov_t + G.mm(G.mm(r_mat, src_cov), r_mat.T)
        w_mat = _inv3x3(cov_c + 1e-6 * eye3)
        rbf = torch.where(use_rbf, torch.exp(-0.5 * dist2 / rbf_den), 1.0)
        wgt = corr.to(f) * rbf

        # dr/dξ = [-I | [Rp+t]×] (3×6), left perturbation ξ = (ρ, φ).
        px, py, pz = moved[:, 0], moved[:, 1], moved[:, 2]
        zeros = torch.zeros_like(px)
        skew = torch.stack([
            torch.stack([zeros, -pz, py], -1),
            torch.stack([pz, zeros, -px], -1),
            torch.stack([-py, px, zeros], -1),
        ], -2)
        jac = torch.cat([-eye3.expand(skew.shape), skew], -1)  # (M, 3, 6)
        wj = G.mm(w_mat, jac)
        h = torch.einsum("nij,nik,n->jk", jac, wj, wgt)
        g = torch.einsum("nij,ni,n->j", wj, resid, wgt)
        n_corr = corr.sum(dtype=torch.int32)
        fit_num = (dist2 * corr.to(f)).sum()
        return _gn_update(h, g, n_corr, fit_num, transform, prev_fitness, done, it_count,
                          prev_n_corr, config)

    return _gn_loop(step, initial_transform, config, dev)


def prep_source(source_points, source_valid, config: GICPConfig):
    """Downsample the source and attach per-point regularized covariances
    from their voxel neighborhoods: (src_ds (M, 3), src_mask (M,),
    src_cov (M, 3, 3))."""
    f = torch.float32
    src = source_points.reshape(-1, 3).to(f)
    sval = source_valid.reshape(-1)
    eye3 = torch.eye(3, dtype=f, device=src.device)
    src_ds, src_mask = V.voxel_downsample(src, sval, config.voxel_size, config.table_size)
    src_grid = V.build_voxel_grid(src_ds, src_mask, config.resolution, config.table_size)
    sn_count, _, sn_cov = V.neighborhood_moments(src_grid)
    src_cov_table = torch.where(
        (sn_count >= config.min_cov_points)[:, None, None],
        V.regularize_covariances(sn_cov, config.cov_regularization),
        eye3,
    )
    s_coords = V.voxel_coords(src_ds, config.resolution)
    s_idx = V.hash_coords(s_coords, config.table_size).to(torch.int64)
    s_hit = (src_grid.coords[s_idx] == s_coords).all(-1)
    src_cov = torch.where(s_hit[:, None, None], src_cov_table[s_idx], eye3)
    return src_ds, src_mask, src_cov


def pack_target_table(tgt_grid: V.VoxelGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solver's per-voxel lookup table: (T, 10) f32 rows (count, mean,
    symmetric cov ×6) and the (T, 3) int32 representative coords, gathered
    side by side. The JAX package bitcasts the coords into three more f32
    columns; kept as int32 here, INT32_MAX never passes through a float."""
    c = tgt_grid.cov
    cov6 = torch.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1], c[:, 1, 2], c[:, 2, 2]], -1)
    rows = torch.cat([tgt_grid.count[:, None], tgt_grid.mean, cov6], dim=-1)
    return rows, tgt_grid.coords.contiguous()


def gicp_register_prepared(
    source_points, source_valid, tgt_grid: V.VoxelGrid, initial_transform, config: GICPConfig,
) -> GICPResult:
    """:func:`gicp_register` against a prebuilt target grid
    (:func:`prepare_target`)."""
    _check_neighbor_search(config.neighbor_search)
    if config.solver == "planar":
        solve = _solve_planar
    elif config.neighbor_search != "direct1":
        raise ValueError(
            "multi-voxel neighbor_search requires the planar solver "
            "(the matrix loop is the direct1 readability oracle)"
        )
    else:
        solve = _solve_matrix
    src_ds, src_mask, src_cov = prep_source(source_points, source_valid, config)
    max_dist = torch.where(
        config.kernel_max_dist > 0, config.kernel_max_dist, 3.0 * config.resolution
    )
    rows, coords = pack_target_table(tgt_grid)
    return solve(
        src_ds, src_mask, src_cov, rows, coords, tgt_grid.resolution, tgt_grid.table_size,
        initial_transform, config, max_dist,
    )


def gicp_register_multiscale(
    source_points, source_valid, target_points, target_valid, initial_transform, configs,
) -> GICPResult:
    """Chain solver stages from coarse to fine resolution, each warm-started
    from the previous one (the reference's adjust_resolution schedule)."""
    result = None
    transform = initial_transform
    for cfg in configs:
        result = gicp_register(source_points, source_valid, target_points, target_valid,
                               transform, cfg)
        transform = result.transform
    if result is None:
        raise ValueError("multiscale schedule needs at least one stage")
    return result


def default_multiscale_configs(
    resolution: float = 0.01,
    voxel_size: float = 0.01,
    coarse_start: float = 0.1,
    steps: int = 3,
    max_iterations: int = 64,
    coarse_iterations: int = 16,
    device=None,
    **kw,
) -> Tuple[GICPConfig, ...]:
    """Geometric coarse→fine ladder ending at ``resolution``: coarse stages
    scale their step epsilons to their own resolution, cap their budget at
    ``coarse_iterations`` and damp harder."""
    if steps <= 1 or coarse_start <= resolution:
        return (GICPConfig.create(resolution=resolution, voxel_size=voxel_size,
                                  max_iterations=max_iterations, device=device, **kw),)
    kw = dict(kw)
    ratio = (resolution / coarse_start) ** (1.0 / (steps - 1))
    final_rot = kw.pop("rotation_eps", 2e-3)
    final_trans = kw.pop("translation_eps", 1e-4)
    cfgs = []
    for i in range(steps):
        r = coarse_start * (ratio ** i)
        last = i == steps - 1
        cfgs.append(GICPConfig.create(
            resolution=r,
            voxel_size=voxel_size,
            max_iterations=max_iterations,
            iteration_cap=max_iterations if last else min(coarse_iterations, max_iterations),
            rotation_eps=final_rot if last else max(final_rot, 1e-2),
            translation_eps=final_trans if last else max(final_trans, r / 100.0),
            kernel_max_dist=3.0 * r,
            damping=max(0.01, 0.1 * (r / coarse_start)),
            device=device,
            **kw,
        ))
    return tuple(cfgs)


def fitness_score(
    source_points, source_valid, target_grid: V.VoxelGrid, transform,
    min_voxel_points: float = 1.0,
) -> torch.Tensor:
    """Mean squared distance of the transformed source points to their
    matched target voxel means (PCL getFitnessScore proxy)."""
    moved = G.transform_points(source_points.reshape(-1, 3), transform)
    mu, _, found = V.lookup_voxels(target_grid, moved, min_voxel_points)
    ok = source_valid.reshape(-1) & found
    d2 = ((mu - moved) ** 2).sum(-1)
    return (d2 * ok).sum() / torch.clamp_min(ok.sum(), 1)
