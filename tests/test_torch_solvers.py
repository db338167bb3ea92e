"""The port's sharded and batched GICP (registration/distributed.py) and its
``solver="matrix"`` on the CPU.

- ``gicp_register_sharded`` over 4 CPU shards is held to the JAX package's
  single-device ``gicp_register`` (the result JAX's own sharded test holds
  its sharded solve to, tests/test_gicp_distributed.py:44) and to the
  port's, within 5e-3 per entry (tpu_check.py:459-464); each shard holds
  ceil(M/4) points. JAX's distributed functions are never called here.
- ``gicp_register_batched`` and ``register_rig_pairs`` are bit-identical to
  the port's sequential ``gicp_register`` calls.
- ``solver="matrix"`` against JAX's matrix solver within 5e-3 per entry,
  and against the port's planar solver as tests/test_gicp.py:131 holds
  JAX's (2e-4, iterations within one); its errors as tests/test_gicp.py:248.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_depthfusion_tpu.registration import gicp as JGI
from pointcloud_depthfusion_tpu_torch.parallel.mesh import make_camera_mesh
from pointcloud_depthfusion_tpu_torch.registration import distributed as D
from pointcloud_depthfusion_tpu_torch.registration import gicp as TGI

TRANSFORM_ATOL = 5e-3
# tests/test_gicp_distributed.py:49-51.
SOLVE_KW = dict(resolution=0.05, voxel_size=0.02, kernel_width=0.0, kernel_max_dist=-1.0,
                max_iterations=64, table_size=1 << 13)
# tests/test_gicp_distributed.py:132-136, at a smaller cloud.
PAIR_KW = dict(resolution=0.05, voxel_size=0.02, kernel_width=0.0, kernel_max_dist=-1.0,
               max_iterations=24, table_size=1 << 13, neighbor_search="direct7")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def apply(t, pts):
    return pts @ t[:3, :3].T + t[:3, 3]


def small_transform(angle_y_deg=4.0, tx=0.05):
    a = np.deg2rad(angle_y_deg)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    t[0, 3] = tx
    return t


@pytest.fixture(scope="module")
def bunny_pair():
    target = oracles.make_bunny_like_cloud(3000)
    return apply(small_transform(), target).astype(np.float32), target.astype(np.float32)


def jax_solve(src, tgt, **kw):
    cfg = JGI.GICPConfig.create(**kw)
    ones = jnp.ones(len(src), bool)
    return JGI.gicp_register(jnp.asarray(src), ones, jnp.asarray(tgt), ones,
                             jnp.eye(4, dtype=jnp.float32), cfg)


def torch_args(src, tgt):
    ones = torch.ones(len(src), dtype=torch.bool)
    return torch.from_numpy(src), ones, torch.from_numpy(tgt), ones, torch.eye(4)


def test_point_sharded_solve_matches_single_device(bunny_pair, monkeypatch):
    """4 shards of ceil(M/4) points each, the 29 sums added once an
    iteration: within 5e-3 of JAX's single-device solve and of the port's,
    converged alike."""
    src, tgt = bunny_pair
    cfg = TGI.GICPConfig.create(device="cpu", **SOLVE_KW)
    seen = []

    def spy(src_ds, *a, **kw):
        seen.append([tuple(s.shape) for s in src_ds])
        return TGI._solve_planar(src_ds, *a, **kw)

    monkeypatch.setattr(D, "_solve_planar", spy)
    sharded = D.gicp_register_sharded(make_camera_mesh(4, axis="pt", device="cpu"),
                                      *torch_args(src, tgt), cfg)
    m = TGI.prep_source(*torch_args(src, tgt)[:2], cfg)[0].shape[0]
    assert seen == [[(-(-m // 4), 3)] * 4]
    single = TGI.gicp_register(*torch_args(src, tgt), cfg)
    want = jax_solve(src, tgt, **SOLVE_KW)
    np.testing.assert_allclose(sharded.transform.numpy(), np.asarray(want.transform),
                               atol=TRANSFORM_ATOL)
    np.testing.assert_allclose(sharded.transform.numpy(), single.transform.numpy(),
                               atol=TRANSFORM_ATOL)
    assert bool(sharded.converged) == bool(want.converged) == bool(single.converged)
    with pytest.raises(ValueError, match="planar"):
        D.gicp_register_sharded(make_camera_mesh(4, axis="pt", device="cpu"),
                                *torch_args(src, tgt), dataclasses.replace(cfg, solver="matrix"))


def test_matrix_solver_matches_jax_and_planar(bunny_pair):
    """solver="matrix" (direct1): within 5e-3 of JAX's matrix solver with
    the same iterations, and within 2e-4 of the port's planar solver;
    multi-voxel search with the matrix solver and unknown searches raise."""
    src, tgt = bunny_pair
    cfg_p = TGI.GICPConfig.create(device="cpu", **SOLVE_KW)
    cfg_m = dataclasses.replace(cfg_p, solver="matrix")
    rm = TGI.gicp_register(*torch_args(src, tgt), cfg_m)
    rp = TGI.gicp_register(*torch_args(src, tgt), cfg_p)
    want = jax_solve(src, tgt, solver="matrix", **SOLVE_KW)
    np.testing.assert_allclose(rm.transform.numpy(), np.asarray(want.transform),
                               atol=TRANSFORM_ATOL)
    assert int(rm.iterations) == int(want.iterations)
    assert bool(rm.converged) == bool(want.converged)
    np.testing.assert_allclose(rm.transform.numpy(), rp.transform.numpy(), atol=2e-4)
    assert abs(int(rp.iterations) - int(rm.iterations)) <= 1
    assert abs(float(rp.fitness) - float(rm.fitness)) <= 1e-6 + 0.05 * float(rm.fitness)
    ones = torch.ones(500, dtype=torch.bool)
    pts = torch.from_numpy(oracles.make_bunny_like_cloud(500).astype(np.float32))
    for kw, match in ((dict(neighbor_search="direct5"), "neighbor_search"),
                      (dict(neighbor_search="direct27", solver="matrix"), "planar")):
        bad = TGI.GICPConfig.create(table_size=1 << 10, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            TGI.gicp_register(pts, ones, pts, ones, torch.eye(4), bad)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(TGI.GICPResult))


def test_batched_and_rig_pairs_bit_identical_to_sequential():
    """4 pairs over 4 shards: each result equals the port's sequential
    gicp_register bit for bit; register_rig_pairs solves the rolled pairs
    and reports the wrap pair unconverged with cyclic=False; a pair count
    the shards do not divide raises."""
    cfg = TGI.GICPConfig.create(device="cpu", iteration_cap=8, **PAIR_KW)
    base = oracles.make_bunny_like_cloud(400)
    poses = [small_transform(2.0 * i, 0.02 * i) for i in range(4)]
    clouds = torch.from_numpy(np.stack([apply(np.linalg.inv(p), base) for p in poses])
                              .astype(np.float32))
    valids = torch.ones(clouds.shape[:2], dtype=torch.bool)
    eye = torch.eye(4).expand(4, 4, 4)
    mesh = make_camera_mesh(4, axis="pair", device="cpu")
    src = torch.roll(clouds, -1, 0)
    res = D.gicp_register_batched(mesh, src, valids, clouds, valids, eye, cfg)
    rig = D.register_rig_pairs(mesh, clouds, valids, cfg, cyclic=False)
    assert res.transform.shape == (4, 4, 4)
    for i in range(4):
        one = TGI.gicp_register(src[i], valids[i], clouds[i], valids[i], torch.eye(4), cfg)
        row = TGI.GICPResult(*(getattr(res, f.name)[i] for f in dataclasses.fields(res)))
        assert _same(row, one), i
        assert torch.equal(rig.transform[i], one.transform)
        assert bool(rig.converged[i]) == (bool(one.converged) and i < 3)
    assert int(res.num_correspondences.min()) > 0
    with pytest.raises(ValueError, match="not divisible"):
        D.gicp_register_batched(make_camera_mesh(3, axis="pair", device="cpu"), src, valids,
                                clouds, valids, eye, cfg)
