"""Sharded GICP: port of pointcloud_depthfusion_tpu/registration/distributed.py.

Two ways to spread registration over a camera mesh
(parallel.mesh.make_camera_mesh):

* :func:`gicp_register_sharded`: ONE solve whose source cloud is
  point-sharded over the mesh. The prep (voxel downsample, covariances,
  target grid on kernel B5) runs once, replicated; each shard then
  evaluates correspondences and partial normal equations for its points,
  and the 29 scalars (27 normal-equation sums, the correspondence count,
  the fitness numerator) are summed once an iteration: over this process's
  shards in shard order, then ``torch.distributed.all_reduce(SUM)`` over
  the mesh's process group. The step runs on the first shard's device
  from identical sums in every process.

* :func:`gicp_register_batched`: B INDEPENDENT pair solves split over the
  shards; each shard runs the whole single-device
  :func:`~pointcloud_depthfusion_tpu_torch.registration.gicp.gicp_register`
  for its pairs on its device, so every result is bit-identical to a
  sequential call. :func:`register_rig_pairs` is the N-camera rig's
  adjacent-pair sweep on top of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pointcloud_depthfusion_tpu_torch.ops import voxel as V
from pointcloud_depthfusion_tpu_torch.parallel.mesh import CameraMesh
from pointcloud_depthfusion_tpu_torch.registration.gicp import (
    GICPConfig,
    GICPResult,
    _solve_planar,
    gicp_register,
    pack_target_table,
    prep_source,
    prepare_target,
)


def _pad_points(arr: torch.Tensor, mask: torch.Tensor, cov: torch.Tensor, n_shards: int):
    """Pad the point axis to a multiple of the shard count (pad entries are
    masked out, so they contribute nothing to any reduction)."""
    m = arr.shape[0]
    pad = -(-m // n_shards) * n_shards - m
    if not pad:
        return arr, mask, cov
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(pad, 3, 3)
    return (torch.cat([arr, arr.new_zeros((pad, 3))]),
            torch.cat([mask, mask.new_zeros((pad,))]),
            torch.cat([cov, eye]))


def _shard_sum(mesh: CameraMesh):
    """The 29-scalar reduction of the sharded solve: the shards' (sums,
    n_corr, fit_num) added in shard order on the first shard's device,
    then summed over the mesh's processes in one all_reduce."""
    dev = mesh.devices[0]

    def shard_sum(parts):
        sums, n_corr, fit_num = (p.to(dev) for p in parts[0])
        for s, n, f in parts[1:]:
            sums, n_corr, fit_num = sums + s.to(dev), n_corr + n.to(dev), fit_num + f.to(dev)
        if mesh.group is None:
            return sums, n_corr, fit_num
        import torch.distributed as dist  # noqa: PLC0415

        # The count rides as f32: exact below 2**24 points.
        packed = torch.cat([sums, fit_num.reshape(1), n_corr.to(torch.float32).reshape(1)])
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=mesh.group)
        return packed[:27], packed[28].to(torch.int32), packed[27]

    return shard_sum


def gicp_register_sharded(
    mesh: CameraMesh,
    source_points,
    source_valid,
    target_points,
    target_valid,
    initial_transform,
    config: GICPConfig,
    axis: str = "pt",
    tgt_grid: Optional[V.VoxelGrid] = None,
) -> GICPResult:
    """One GICP solve with the SOURCE CLOUD point-sharded over ``mesh``.

    The inputs and ``config`` lie on the mesh's first device. The prep
    (voxel downsample, covariances, target grid) runs replicated, the
    downsampled source is padded to a multiple of the shard count and shard
    s of the axis takes points ``[s·m, (s+1)·m)`` on its device, with a
    copy of the packed target table. Every shard steps from the same summed
    normal equations, so the result is the same in every process.

    Numerics: the correspondences and step math of the single-device planar
    solver; the 27 f32 sums associate per shard first, so the result can
    differ from ``gicp_register`` in the last float bits.

    ``tgt_grid``: optional prebuilt target (``prepare_target``).
    """
    if config.solver != "planar":
        raise ValueError("gicp_register_sharded requires the planar solver")
    n_shards = mesh.shape[axis]
    if tgt_grid is None:
        tgt_grid = prepare_target(target_points, target_valid, config)
    rows, coords = pack_target_table(tgt_grid)
    src_ds, src_mask, src_cov = _pad_points(*prep_source(source_points, source_valid, config),
                                            n_shards)
    max_dist = torch.where(config.kernel_max_dist > 0, config.kernel_max_dist,
                           3.0 * config.resolution)
    m = src_ds.shape[0] // n_shards
    shards = [(mesh.first_shard + s, dev) for s, dev in enumerate(mesh.devices)]
    planes = [tuple(t[g * m:(g + 1) * m].to(dev) for t in (src_ds, src_mask, src_cov))
              for g, dev in shards]
    tables = {dev: (rows.to(dev), coords.to(dev)) for dev in dict.fromkeys(mesh.devices)}
    return _solve_planar(
        [p[0] for p in planes], [p[1] for p in planes], [p[2] for p in planes],
        [tables[dev][0] for _, dev in shards], [tables[dev][1] for _, dev in shards],
        tgt_grid.resolution, tgt_grid.table_size, initial_transform, config, max_dist,
        shard_sum=_shard_sum(mesh),
    )


def _gather_results(mesh: CameraMesh, results, first: int, b: int) -> GICPResult:
    """The pairs' results stacked on the mesh's first device; across
    processes each contributes its rows to one all_reduce(SUM) over zeros
    (exact: every other row is 0), so every process holds all B."""
    dev = mesh.devices[0]
    fields = [f.name for f in dataclasses.fields(GICPResult)]
    stacked = {f: torch.stack([getattr(r, f).to(dev) for r in results]) for f in fields}
    if mesh.group is None:
        return GICPResult(**stacked)
    import torch.distributed as dist  # noqa: PLC0415

    out = {}
    for f, t in stacked.items():
        full = torch.zeros((b, *t.shape[1:]), dtype=torch.int32 if t.dtype == torch.bool
                           else t.dtype, device=dev)
        full[first:first + len(results)] = t
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
        out[f] = full.to(torch.bool) if t.dtype == torch.bool else full
    return GICPResult(**out)


def gicp_register_batched(
    mesh: CameraMesh,
    source_points,
    source_valid,
    target_points,
    target_valid,
    initial_transforms,
    config: GICPConfig,
    axis: str = "pair",
) -> GICPResult:
    """B independent pair solves, batch-split over ``mesh``.

    Args are batched on a leading pair axis: points (B, N, 3), valids
    (B, N), initial_transforms (B, 4, 4); B must be a multiple of the shard
    count. Shard s of the axis runs the full single-device solve (prep,
    target build, Gauss-Newton loop) of pairs ``[s·b, (s+1)·b)`` on its
    device with no reduction, so every result is bit-identical to the
    corresponding sequential ``gicp_register`` call. Returns a GICPResult
    with leading dim B on the mesh's first device, in every process.
    """
    b = source_points.shape[0]
    n_shards = mesh.shape[axis]
    if b % n_shards:
        raise ValueError(f"{b} pairs not divisible by {n_shards} devices")
    per = b // n_shards
    configs = {}
    results = []
    for s, dev in enumerate(mesh.devices):
        if dev not in configs:
            configs[dev] = dataclasses.replace(
                config, **{f.name: getattr(config, f.name).to(dev)
                           for f in dataclasses.fields(config)
                           if isinstance(getattr(config, f.name), torch.Tensor)})
        g = mesh.first_shard + s
        for i in range(g * per, (g + 1) * per):
            results.append(gicp_register(
                *(t[i].to(dev) for t in (source_points, source_valid, target_points,
                                         target_valid, initial_transforms)),
                configs[dev]))
    return _gather_results(mesh, results, mesh.first_shard * per, b)


def register_rig_pairs(
    mesh: CameraMesh,
    clouds,
    valids,
    config: GICPConfig,
    initial_transforms=None,
    cyclic: bool = True,
) -> GICPResult:
    """Register an N-camera rig's adjacent pairs in one batched step.

    ``clouds`` (N, M, 3) / ``valids`` (N, M): camera i's deprojected cloud.
    Pair i solves source camera (i+1) mod N → target camera i (the
    N-camera generalization of the reference's right→left solve,
    registration_node.cpp:272-461). With ``cyclic=False`` the wrap-around
    pair is still solved (N stays divisible) but reported unconverged.
    ``transform[i]`` maps camera i+1 coordinates into camera i's frame.
    """
    n = clouds.shape[0]
    src = torch.roll(clouds, -1, dims=0)
    sval = torch.roll(valids, -1, dims=0)
    if initial_transforms is None:
        initial_transforms = torch.eye(4, dtype=torch.float32,
                                       device=clouds.device).expand(n, 4, 4)
    res = gicp_register_batched(mesh, src, sval, clouds, valids, initial_transforms, config)
    if not cyclic:
        converged = res.converged.clone()
        converged[n - 1] = False
        res = dataclasses.replace(res, converged=converged)
    return res
