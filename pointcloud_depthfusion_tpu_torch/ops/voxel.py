"""Voxel hashing, downsampling, and per-voxel Gaussian statistics.

Port of pointcloud_depthfusion_tpu/ops/voxel.py (PCL's ApproximateVoxelGrid
and the voxel-distribution machinery of FastVGICPCuda). Dense and
fixed-shape, as in the JAX package:

  * a power-of-two hash table indexed by a spatial hash of integer voxel
    coordinates;
  * per-slot sums of count, first and second moment, accumulated by kernel
    B5 (ops/cuda/segsum_cuda.py) or, with ``method="scatter"``, by
    ``index_add_``;
  * "downsampled cloud" = the table of voxel means + occupancy mask.

Hash collisions merge distinct voxels' statistics, like PCL's
ApproximateVoxelGrid.

Scalars that divide point coordinates (``resolution``) are taken as 0-d f32
tensors on the points' device: a CPU scalar divisor makes CUDA division
multiply by a reciprocal, which moves ``floor(p / resolution)`` across a
cell edge when the quotient lands one ulp off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda

INT32_MAX = 0x7FFFFFFF
_M32 = 0xFFFFFFFF
# The spatial hash's odd constants (Teschner et al. style) and the murmur3
# finalizer's multipliers, as in the JAX package.
_H1 = 73856093
_H2 = 19349669
_H3 = 83492791
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35

#: The 27 neighborhood offsets, in the JAX package's (dx, dy, dz) loop order.
_OFFSETS27 = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def voxel_coords(points: torch.Tensor, resolution) -> torch.Tensor:
    """Integer voxel coordinates floor(p / resolution), int32 (..., 3)."""
    return torch.floor(points / _f32(resolution, points.device)).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32): split at 16 bits so
    no int64 product overflows."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _check_pow2(table_size: int) -> None:
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"table_size {table_size} must be a power of 2")


def hash_coords_planar(cx, cy, cz, table_size: int) -> torch.Tensor:
    """:func:`hash_coords` on separate int32 coordinate planes.

    The JAX package hashes in uint32 with wraparound; here each plane is
    reinterpreted as u32 in int64 and every product is reduced mod 2^32,
    which gives the same bits."""
    _check_pow2(table_size)
    h = (
        (cx.to(torch.int64) & _M32) * _H1
        + (cy.to(torch.int64) & _M32) * _H2
        + (cz.to(torch.int64) & _M32) * _H3
    ) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    h = h ^ (h >> 16)
    return (h & (table_size - 1)).to(torch.int32)


def hash_coords(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of int32 voxel coords (..., 3) into [0, table_size):
    additive combine + murmur3 finalizer. ``table_size`` must be a power
    of two (masked modulo)."""
    _check_pow2(table_size)
    return hash_coords_planar(coords[..., 0], coords[..., 1], coords[..., 2], table_size)


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Per-voxel Gaussian statistics in a fixed-size hash table."""

    count: torch.Tensor  # (M,) f32 — number of points
    mean: torch.Tensor  # (M, 3)
    cov: torch.Tensor  # (M, 3, 3) — population covariance
    # (M, 3) int32 — the voxel of the lowest-index point that hashed into
    # the slot (INT32_MAX where empty); lookups collision-check against it.
    coords: torch.Tensor
    resolution: torch.Tensor  # 0-d f32

    @property
    def table_size(self) -> int:
        return self.count.shape[0]

    def occupied(self, min_points: float = 1.0) -> torch.Tensor:
        return self.count >= min_points


def build_voxel_grid(
    points: torch.Tensor,
    valid: torch.Tensor,
    resolution,
    table_size: int = 1 << 15,
    method: Optional[str] = None,
) -> VoxelGrid:
    """Accumulate per-voxel count/mean/covariance statistics.

    ``method``: ``"sorted"`` (the default) accumulates all 10 channels in one
    call of kernel B5, which runs its plain version on a CPU tensor;
    ``"scatter"`` is the JAX package's reference formulation, 11 separate
    ``index_add_`` scatters. Both drop invalid points and give the same
    counts and coords; the sums differ only in f32 addition order.
    """
    if method is None:
        method = "sorted"
    if method not in ("sorted", "scatter"):
        raise ValueError(f"unknown method {method!r} (expected 'sorted' or 'scatter')")
    pts = points.reshape(-1, 3).to(torch.float32)
    val = valid.reshape(-1)
    res = _f32(resolution, pts.device)
    coords = voxel_coords(pts, res)
    if method == "sorted":
        return _build_voxel_grid_sorted(pts, val, coords, res, table_size)

    idx = torch.where(val, hash_coords(coords, table_size), table_size).to(torch.int64)
    w = val.to(torch.float32)

    def acc(values):
        out = torch.zeros(table_size + 1, dtype=torch.float32, device=pts.device)
        return out.index_add_(0, idx, values * w)[:table_size]

    count = torch.zeros(table_size + 1, dtype=torch.float32, device=pts.device)
    count = count.index_add_(0, idx, w)[:table_size]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    psum = torch.stack([acc(x), acc(y), acc(z)], dim=-1)
    p6 = torch.stack(
        [acc(x * x), acc(x * y), acc(x * z), acc(y * y), acc(y * z), acc(z * z)], dim=-1
    )
    # Representative: the lowest valid point index per slot, then a gather
    # of its coords (a componentwise coordinate min would mix voxels).
    sentinel = _M32
    order = torch.arange(pts.shape[0], dtype=torch.int64, device=pts.device)
    rep = torch.full((table_size + 1,), sentinel, dtype=torch.int64, device=pts.device)
    rep = rep.scatter_reduce_(0, idx, torch.where(val, order, sentinel), "amin")[:table_size]
    rep_idx = torch.where(rep != sentinel, rep, INT32_MAX).to(torch.int32)
    return _finalize_grid(count, psum, p6, rep_idx, coords, res)


def _finalize_grid(count, psum, p6, rep_idx, coords, resolution) -> VoxelGrid:
    """Shared finalization of both builds: expand the symmetric second
    moment, gather representative coords (INT32_MAX rep_idx = empty
    slot), divide out the counts."""
    row0 = torch.stack([p6[:, 0], p6[:, 1], p6[:, 2]], dim=-1)
    row1 = torch.stack([p6[:, 1], p6[:, 3], p6[:, 4]], dim=-1)
    row2 = torch.stack([p6[:, 2], p6[:, 4], p6[:, 5]], dim=-1)
    ppsum = torch.stack([row0, row1, row2], dim=-2)

    has_rep = rep_idx != INT32_MAX
    safe_idx = torch.where(has_rep, rep_idx, 0).to(torch.int64)
    rep = torch.where(has_rep[:, None], coords[safe_idx], INT32_MAX)

    safe = torch.clamp_min(count, 1.0)
    mean = psum / safe[:, None]
    cov = ppsum / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    return VoxelGrid(count=count, mean=mean, cov=cov, coords=rep,
                     resolution=_f32(resolution, count.device))


def grid_channels(
    pts: torch.Tensor, val: torch.Tensor, coords: torch.Tensor, table_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5's inputs for a grid build: the (N,) int32 slot of each
    point (``padded_slots(table_size)`` where invalid) and its (N, 10) f32
    channels (weight, first moment, symmetric second moment)."""
    idx = torch.where(
        val, hash_coords(coords, table_size), segsum_cuda.padded_slots(table_size)
    ).to(torch.int32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    chans = torch.stack(
        [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], dim=-1
    )
    return idx.contiguous(), chans


def _build_voxel_grid_sorted(pts, val, coords, resolution, table_size: int) -> VoxelGrid:
    """All 10 statistic channels and the representative index in one call
    of kernel B5."""
    sums, rep_idx = segsum_cuda.segsum_sorted(*grid_channels(pts, val, coords, table_size),
                                              table_size)
    return _finalize_grid(sums[:, 0], sums[:, 1:4], sums[:, 4:10], rep_idx, coords, resolution)


def voxel_downsample(
    points: torch.Tensor, valid: torch.Tensor, leaf_size, table_size: int = 1 << 15
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ApproximateVoxelGrid: one mean point per occupied voxel. Returns the
    fixed-shape downsampled cloud (points (M, 3), valid (M,))."""
    grid = build_voxel_grid(points, valid, leaf_size, table_size)
    return grid.mean, grid.occupied()


def smallest_eigenvector_3x3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    trigonometric eigenvalue + cross product of rows, in component planes.
    The sign is arbitrary; compare ``n nᵀ``."""
    a11, a22, a33 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a12 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
    a13 = 0.5 * (a[..., 0, 2] + a[..., 2, 0])
    a23 = 0.5 * (a[..., 1, 2] + a[..., 2, 1])

    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = (b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * (a12 * a12 + a13 * a13 + a23 * a23)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    inv_p = 1.0 / p
    d11, d22, d33 = b11 * inv_p, b22 * inv_p, b33 * inv_p
    d12, d13, d23 = a12 * inv_p, a13 * inv_p, a23 * inv_p
    det_bn = (
        d11 * (d22 * d33 - d23 * d23)
        - d12 * (d12 * d33 - d23 * d13)
        + d13 * (d12 * d23 - d22 * d13)
    )
    r = torch.clamp(det_bn / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)

    m11, m22, m33 = a11 - lam, a22 - lam, a33 - lam
    m12, m13, m23 = a12, a13, a23
    c01 = (m12 * m23 - m13 * m22, m13 * m12 - m11 * m23, m11 * m22 - m12 * m12)
    c02 = (m12 * m33 - m13 * m23, m13 * m13 - m11 * m33, m11 * m23 - m12 * m13)
    c12 = (m22 * m33 - m23 * m23, m23 * m13 - m12 * m33, m12 * m23 - m22 * m13)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    pick01 = (n01 >= n02) & (n01 >= n12)
    pick02 = n02 >= n12
    bx, by, bz = (
        torch.where(pick01, c01[i], torch.where(pick02, c02[i], c12[i])) for i in range(3)
    )
    norm = torch.sqrt(bx * bx + by * by + bz * bz)
    inv_n = 1.0 / torch.clamp_min(norm, 1e-30)
    ok = norm > 1e-12  # isotropic / zero covariance: any direction works
    return torch.stack(
        [torch.where(ok, bx * inv_n, 0.0), torch.where(ok, by * inv_n, 0.0),
         torch.where(ok, bz * inv_n, 1.0)],
        dim=-1,
    )


def regularize_covariances(cov: torch.Tensor, mode: str = "plane", eps: float = 1e-3) -> torch.Tensor:
    """GICP covariance regularization. ``plane``: eigenvalues → (eps, 1, 1),
    as ``I - (1-eps)·n nᵀ``; ``norm``: adds eps·trace/3·I."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    if mode == "norm":
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        return cov + eps * (tr / 3.0 + 1e-9) * eye
    n = smallest_eigenvector_3x3(cov)
    return eye - (1.0 - eps) * n[..., :, None] * n[..., None, :]


def _neighborhood_rows(grid: VoxelGrid, table: torch.Tensor):
    """Gather ``table`` rows of the 27 neighbor voxels of every slot:
    (27, M, C) rows and the (27, M) hit mask (occupied slot, occupied
    neighbor, representative coords equal to the probed voxel)."""
    off = torch.tensor(_OFFSETS27, dtype=torch.int32, device=grid.coords.device)[:, None, :]
    ncoords = grid.coords[None] + off  # INT32_MAX slots wrap; masked by own_occ
    idx = hash_coords(ncoords, grid.table_size).to(torch.int64)
    rows = table[idx]
    hit = (grid.count > 0)[None] & (rows[..., 0] > 0) & (grid.coords[idx] == ncoords).all(-1)
    return rows, hit


def neighborhood_moments(
    grid: VoxelGrid, include_cov: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Each occupied voxel's moments pooled over its 3×3×3 neighborhood:
    (count (M,), mean (M, 3), cov (M, 3, 3) or None).

    The 27 neighbor lookups run as one batched gather of (27, M) rows;
    coords are gathered as their own int32 tensor (the JAX package bitcasts
    them into f32 columns, where INT32_MAX is a NaN pattern). The rows are
    added one neighbor at a time in the JAX loop order, so the sums, and the
    covariances that cancel from them, do not depend on a device's
    reduction order."""
    psum = grid.mean * grid.count[:, None]
    ppsum = (grid.cov + grid.mean[:, :, None] * grid.mean[:, None, :]) * grid.count[:, None, None]
    pp6 = torch.stack(
        [ppsum[:, 0, 0], ppsum[:, 0, 1], ppsum[:, 0, 2],
         ppsum[:, 1, 1], ppsum[:, 1, 2], ppsum[:, 2, 2]], dim=-1
    )
    parts = [grid.count[:, None], psum] + ([pp6] if include_cov else [])
    rows, hit = _neighborhood_rows(grid, torch.cat(parts, dim=-1))
    w = hit.to(torch.float32)[..., None]
    pooled = torch.zeros_like(rows[0])
    for k in range(len(_OFFSETS27)):
        pooled = pooled + w[k] * rows[k]
    count_n, psum_n = pooled[:, 0], pooled[:, 1:4]

    safe = torch.clamp_min(count_n, 1.0)
    mean_n = psum_n / safe[:, None]
    if not include_cov:
        return count_n, mean_n, None
    pp6_n = pooled[:, 4:10]
    r0 = torch.stack([pp6_n[:, 0], pp6_n[:, 1], pp6_n[:, 2]], -1)
    r1 = torch.stack([pp6_n[:, 1], pp6_n[:, 3], pp6_n[:, 4]], -1)
    r2 = torch.stack([pp6_n[:, 2], pp6_n[:, 4], pp6_n[:, 5]], -1)
    ppsum_n = torch.stack([r0, r1, r2], dim=-2)
    cov_n = ppsum_n / safe[:, None, None] - mean_n[:, :, None] * mean_n[:, None, :]
    return count_n, mean_n, cov_n


def lookup_voxels(
    grid: VoxelGrid, points: torch.Tensor, min_points: float = 6.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query point's voxel statistics (VGICP DIRECT1): (mean (N, 3),
    cov (N, 3, 3), found (N,)), ``found`` checked against the stored
    representative coords."""
    coords = voxel_coords(points, grid.resolution)
    idx = hash_coords(coords, grid.table_size).to(torch.int64)
    same_voxel = (grid.coords[idx] == coords).all(-1)
    found = (grid.count[idx] >= min_points) & same_voxel
    return grid.mean[idx], grid.cov[idx], found


def statistical_outlier_removal(
    points: torch.Tensor,
    valid: torch.Tensor,
    resolution,
    stddev_mul_thresh: float = 1.0,
    table_size: int = 1 << 15,
) -> torch.Tensor:
    """Sparse-outlier rejection, the JAX package's voxel-neighborhood
    stand-in for PCL's StatisticalOutlierRemoval: d_i = distance from p_i to
    the centroid of the other points of its 3×3×3 voxel neighborhood
    (4·resolution when it has none); keep d_i ≤ mean + mult·std over the
    scored points. Points whose voxel lost its hash slot are kept iff a
    voxel of their neighborhood verifies. Returns the filtered mask."""
    f = torch.float32
    pts = points.reshape(-1, 3).to(f)
    val = valid.reshape(-1)
    res = _f32(resolution, pts.device)
    grid = build_voxel_grid(pts, val, res, table_size)
    n_count, n_mean, _ = neighborhood_moments(grid, include_cov=False)

    coords = voxel_coords(pts, res)
    idx = hash_coords(coords, table_size).to(torch.int64)
    hit = (grid.coords[idx] == coords).all(-1) & (grid.count[idx] > 0)
    nc = n_count[idx]
    mu = n_mean[idx]
    lone = nc <= 1.0
    denom = torch.clamp_min(nc - 1.0, 1.0)
    mu_excl = (mu * nc[:, None] - pts) / denom[:, None]
    e = pts - mu_excl
    d = torch.sqrt(e[:, 0] ** 2 + e[:, 1] ** 2 + e[:, 2] ** 2)
    d = torch.where(lone, 4.0 * res, d)

    off = torch.tensor(_OFFSETS27, dtype=torch.int32, device=pts.device)[:, None, :]
    nb = coords[None] + off
    ni = hash_coords(nb, table_size).to(torch.int64)
    occupied_nb = ((grid.coords[ni] == nb).all(-1) & (grid.count[ni] > 0)).any(0)

    scored = val & hit
    n_scored = torch.clamp_min(scored.sum(dtype=f), 1.0)
    mean_d = torch.where(scored, d, 0.0).sum() / n_scored
    var_d = torch.where(scored, (d - mean_d) ** 2, 0.0).sum() / n_scored
    thresh = mean_d + stddev_mul_thresh * torch.sqrt(torch.clamp_min(var_d, 0.0))
    return val & torch.where(hit, d <= thresh, occupied_nb)
