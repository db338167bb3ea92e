"""The port's voxel grids (ops/voxel.py) and the plain version of kernel B5
against the JAX package on the CPU.

Tolerances and their reasons:
- hash, grid counts and representative coords: bit-exact (integer math);
- voxel coords: bit-exact against a correctly rounded ``floor(p / r)``;
  against JAX they differ only where XLA's CPU division misrounds the
  quotient across a cell edge (at most 2e-3 of edge-case points);
- grid means: ``rtol=1e-5, atol=1e-6``, the parity gate's bar for two
  summation orders (``voxel_sorted_vs_scatter_tpu``, tpu_check.py:389-397):
  the JAX kernel sums sorted tiles, the plain version sums in entry order;
- segment sums of signed values: within 1e-5 of the slot's sum of
  magnitudes, the size of an f32 sum's rounding in another order (a plain
  relative bar fails where positive and negative terms cancel);
- covariances: ``atol=8e-6``, 32 ulps of E[ppᵀ] ≈ 2.3 m² at z ≈ 1.5 m:
  E[ppᵀ] − μμᵀ cancels, and two summation orders of E[ppᵀ] differ by
  ~10 ulps (2.5e-6 measured);
- eigenvectors through ``n nᵀ`` (the sign is arbitrary) within 1e-4:
  arccos/cos differ by ulps between libraries and the eigenvector of
  eigenvalues a few percent apart amplifies them;
- the outlier mask: equal on all but 1e-3 of points (its threshold is a
  mean + std over all points, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.ops import voxel as JV
from pointcloud_depthfusion_tpu.ops.pallas import segsum_pallas as JS
from pointcloud_depthfusion_tpu_torch.ops import voxel as TV
from pointcloud_depthfusion_tpu_torch.ops.cuda import segsum_cuda as S
from pointcloud_depthfusion_tpu_torch.utils import convert

MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
COV_TOL = dict(rtol=0, atol=8e-6)
MAXI = np.iinfo(np.int32).max


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: torch's OpenMP
    threads would otherwise spin between ops against the JAX thread pool
    and the test run's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(seed, n, scale=1.0, invalid=0.1):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(0.0, scale, (n, 3)) + [0.1, -0.2, 1.5]).astype(np.float32)
    valid = rng.random(n) >= invalid
    return pts, valid


# -- hash and coords ---------------------------------------------------------


@pytest.mark.parametrize("table_size", [1 << 10, 1 << 15])
def test_hash_bit_exact(table_size):
    rng = np.random.default_rng(table_size)
    edge = np.array([-(1 << 31), -(1 << 31) + 1, -1, 0, 1, (1 << 31) - 2, MAXI], np.int64)
    coords = np.concatenate([
        rng.integers(-3000, 3000, (2000, 3)),
        rng.integers(-(1 << 31), 1 << 31, (2000, 3)),
        np.stack(np.meshgrid(edge, edge, edge), -1).reshape(-1, 3),
    ]).astype(np.int32)
    want = np.asarray(JV.hash_coords(jnp.asarray(coords), table_size))
    got = TV.hash_coords(_t(coords), table_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    planar = TV.hash_coords_planar(*(_t(coords[:, i]) for i in range(3)), table_size)
    np.testing.assert_array_equal(planar.numpy(), want)
    with pytest.raises(ValueError, match="power of 2"):
        TV.hash_coords(_t(coords), 1000)


@pytest.mark.parametrize("res", [0.01, 0.05, 0.1])
def test_voxel_coords_bit_exact_at_cell_edges(res):
    rng = np.random.default_rng(7)
    r32 = np.float32(res)
    k = rng.integers(-300, 300, (3000, 3)).astype(np.float32)
    on_edge = k * r32
    pts = np.concatenate([
        on_edge, np.nextafter(on_edge, np.float32(np.inf)), np.nextafter(on_edge, np.float32(-np.inf)),
        rng.uniform(-3, 3, (3000, 3)).astype(np.float32),
    ]).astype(np.float32)
    ieee = np.floor(pts / r32).astype(np.int32)  # numpy divides correctly rounded
    got = TV.voxel_coords(_t(pts), torch.tensor(res, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, ieee)
    np.testing.assert_array_equal(TV.voxel_coords(_t(pts), res).numpy(), ieee)
    # XLA on the CPU does not round every f32 quotient correctly, so JAX's
    # coords differ exactly where its quotient differs from the IEEE one
    # and lands across a cell edge (a backend divergence, ROADMAP queue C).
    want = np.asarray(JV.voxel_coords(jnp.asarray(pts), jnp.float32(res)))
    xla_q = np.asarray(jnp.asarray(pts) / jnp.float32(res))
    differs = (got != want).any(-1)
    assert not (differs & (xla_q == pts / r32).all(-1)).any()
    assert differs.mean() <= 2e-3


# -- kernel B5's plain version ------------------------------------------------


SEGSUM_CASES = {
    # name: (n, channels, n_slots, slot spread, invalid fraction)
    "c1_one_slot_table": (1500, 1, 1, 1, 0.2),
    "c10_256": (4096, 10, 256, 256, 0.1),
    "c10_1000_skewed": (3001, 10, 1000, 12, 0.1),
    "c16_1000": (2500, 16, 1000, 1000, 0.1),
    "c16_256_one_slot_hit": (777, 16, 256, 1, 0.0),
    "c10_all_invalid": (1000, 10, 256, 256, 1.0),
}


@pytest.mark.parametrize("case", sorted(SEGSUM_CASES))
def test_segsum_plain_matches_pallas_interpreter(case):
    n, c, n_slots, spread, invalid = SEGSUM_CASES[case]
    rng = np.random.default_rng(n + c)
    slot = rng.integers(0, spread, n).astype(np.int32)
    slot[rng.random(n) < invalid] = JS.padded_slots(n_slots)
    vals = rng.normal(0, 2.0, (n, c)).astype(np.float32)
    vals[:, 0] = 1.0  # a count channel: exact in any order
    ws, wr = JS.segsum_sorted(jnp.asarray(slot), jnp.asarray(vals), n_slots, interpret=True)
    gs, gr = S.segsum_sorted(_t(slot), _t(vals), n_slots)
    assert S.padded_slots(n_slots) == JS.padded_slots(n_slots)
    assert gs.shape == (n_slots, c) and gr.dtype == torch.int32
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gs[:, 0].numpy(), np.asarray(ws)[:, 0])
    magnitude, _ = S.segsum_sorted(_t(slot), _t(np.abs(vals)), n_slots)
    assert (np.abs(gs.numpy() - np.asarray(ws)) <= 1e-5 * magnitude.numpy()).all()
    if invalid == 1.0:
        assert (gr.numpy() == MAXI).all() and not gs.numpy().any()


def test_segsum_drops_out_of_range_and_checks_inputs():
    slot = _t(np.array([3, 0, 3, 7, 0, 8, -1, 256], np.int32))
    vals = _t(np.arange(16, dtype=np.float32).reshape(8, 2))
    before = dict(S.launches)
    sums, rep = S.segsum_sorted(slot, vals, 8)
    assert S.launches == before  # CPU tensors run the plain version
    assert rep.tolist() == [1, MAXI, MAXI, 0, MAXI, MAXI, MAXI, 3]
    assert sums[0].tolist() == [10.0, 12.0] and sums[3].tolist() == [4.0, 6.0]
    for bad in (slot.to(torch.int64), slot[::2]):
        with pytest.raises(ValueError):
            S.segsum_sorted(bad, vals[: bad.shape[0]], 8)
    with pytest.raises(ValueError, match="channels"):
        S.segsum_sorted(slot, torch.zeros(8, 17), 8)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        S.segsum_sorted(meta, torch.zeros(8, 2, device="meta"), 8)


# -- grids -------------------------------------------------------------------


def _jax_grid(pts, valid, res, table_size, method):
    return jax.jit(lambda p, v: JV.build_voxel_grid(p, v, res, table_size, method=method))(
        jnp.asarray(pts), jnp.asarray(valid))


@pytest.mark.parametrize("jax_method", ["scatter", "sorted"])
@pytest.mark.parametrize("res,table_size", [(0.05, 1 << 12), (0.2, 1 << 10)])
def test_build_voxel_grid_matches_jax(jax_method, res, table_size):
    pts, valid = _cloud(3, 4000)
    want = _jax_grid(pts, valid, res, table_size, jax_method)
    for method in (None, "sorted", "scatter"):
        got = TV.build_voxel_grid(_t(pts), _t(valid), res, table_size, method=method)
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), **MEAN_TOL)
        np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), **COV_TOL)
        assert got.table_size == table_size and float(got.resolution) == np.float32(res)
    assert (got.count.numpy() > 1).any() and (got.coords.numpy() == MAXI).any()
    with pytest.raises(ValueError, match="unknown method"):
        TV.build_voxel_grid(_t(pts), _t(valid), res, table_size, method="bogus")


def test_voxel_downsample_matches_jax():
    pts, valid = _cloud(4, 3000, scale=0.5)
    jm, jv = JV.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 0.05, 1 << 12)
    tm, tv = TV.voxel_downsample(_t(pts), _t(valid), 0.05, 1 << 12)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MEAN_TOL)


# -- covariances ---------------------------------------------------------------


def _spd(seed, n):
    """Symmetric PSD matrices with eigenvalues at least 5% apart, as plane
    and line-like voxel covariances have."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.sort(rng.uniform(1e-4, 1.0, (n, 3)), -1) * [[1.0, 1.2, 1.5]]
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def test_eigenvector_and_regularization_match_jax():
    cov = _spd(5, 2000)
    jn = np.asarray(JV.smallest_eigenvector_3x3(jnp.asarray(cov)))
    tn = TV.smallest_eigenvector_3x3(_t(cov)).numpy()
    np.testing.assert_allclose(np.einsum("ni,nj->nij", tn, tn),
                               np.einsum("ni,nj->nij", jn, jn), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(tn, axis=-1), 1.0, atol=1e-5)
    for mode in ("plane", "norm"):
        want = np.asarray(JV.regularize_covariances(jnp.asarray(cov), mode))
        got = TV.regularize_covariances(_t(cov), mode).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if mode == "plane" else 1e-6)
    # Degenerate (zero, isotropic) covariances take the fixed direction z.
    flat = np.stack([np.zeros((3, 3)), np.eye(3)]).astype(np.float32)
    np.testing.assert_array_equal(TV.smallest_eigenvector_3x3(_t(flat)).numpy(),
                                  np.asarray(JV.smallest_eigenvector_3x3(jnp.asarray(flat))))


@pytest.fixture(scope="module")
def shared_grid():
    """One JAX grid (x64 off for its own arrays), carried into the port so
    both sides start from identical statistics."""
    pts, valid = _cloud(6, 4000, scale=0.3)
    jg = _jax_grid(pts, valid, 0.05, 1 << 12, "scatter")
    tg = convert.voxel_grid_from_arrays(
        np.asarray(jg.count), np.asarray(jg.mean), np.asarray(jg.cov),
        np.asarray(jg.coords), np.asarray(jg.resolution), device="cpu")
    return pts, valid, jg, tg


@pytest.mark.parametrize("include_cov", [True, False])
def test_neighborhood_moments_match_jax(shared_grid, include_cov):
    _, _, jg, tg = shared_grid
    jc, jm, jcov = JV.neighborhood_moments(jg, include_cov=include_cov)
    tc, tm, tcov = TV.neighborhood_moments(tg, include_cov=include_cov)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MEAN_TOL)
    if include_cov:
        np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), **COV_TOL)
    else:
        assert tcov is None and jcov is None
    assert (tc.numpy() > np.asarray(jg.count)).any()  # neighbors were pooled


def test_lookup_voxels_match_jax(shared_grid):
    pts, _, jg, tg = shared_grid
    q = np.concatenate([pts[:500], pts[:500] + 0.5]).astype(np.float32)
    for min_points in (1.0, 6.0):
        jm, jc, jf = JV.lookup_voxels(jg, jnp.asarray(q), min_points)
        tm, tc, tf = TV.lookup_voxels(tg, _t(q), min_points)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tf.numpy().any() and not tf.numpy().all()


def test_statistical_outlier_removal_matches_jax():
    rng = np.random.default_rng(8)
    dense = (rng.normal(0, 0.05, (3000, 3)) + [0, 0, 1.5]).astype(np.float32)
    sparse = rng.uniform(-2, 2, (100, 3)).astype(np.float32) + np.float32([0, 0, 1.5])
    pts = np.concatenate([dense, sparse])
    valid = rng.random(len(pts)) > 0.05
    for table_size in (1 << 12, 1 << 6):  # the small table evicts voxels
        want = np.asarray(jax.jit(
            lambda p, v, ts=table_size: JV.statistical_outlier_removal(p, v, 0.05, 1.0, ts)
        )(jnp.asarray(pts), jnp.asarray(valid)))
        got = TV.statistical_outlier_removal(_t(pts), _t(valid), 0.05, 1.0, table_size).numpy()
        assert (got != want).mean() <= 1e-3, (got != want).sum()
        assert not got[~valid].any()
    assert got[:3000].mean() > 0.5 and got[3000:].mean() < 0.5
