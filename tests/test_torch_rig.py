"""The port's single-device rig fusion (plain kernels, CPU) against the JAX
package's parallel/mesh.py.

The JAX side runs jitted, with the tiled rigs' resolve kernels on the
Pallas interpreter, as tests/test_parallel.py runs it. Jitted on the CPU,
XLA contracts the projection's multiply-adds into FMAs, so a winner may flip
at a near-tie: the exact images are held to the parity gate's budget
(CROSS_BACKEND_PIXEL_BUDGET = 1e-3 of pixels). The packed mode quantizes
depth, so a last-ulp change can move a key across a bin edge: it is held to
the gate's envelopes (coverage within 1e-3, color within 1e-2 of pixels,
tpu_check.py:417-451). Run op by op, JAX does not contract, and the rig
entries and packed keys are held bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import fused_virtual_intrinsics as j_fvi
from pointcloud_depthfusion_tpu.parallel import mesh as JM
from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics as t_fvi
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda
from pointcloud_depthfusion_tpu_torch.parallel import mesh as TM
from torch_rig_common import (
    N, ROIS, arc_frames, both_configs, jax_intrinsics, run_jax, run_torch, torch_intrinsics,
)

PIXEL_BUDGET = 1e-3
COLOR_BUDGET = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return arc_frames()


def _rot_z90(c2v):
    r = np.eye(4, dtype=np.float32)
    r[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    return (r @ c2v).astype(np.float32)


def _tilt(c2v, deg=(3.0, -2.0)):
    """cam_to_virtual seen from a virtual camera rolled about x and z, so
    every entry of each transform's rotation is nonzero and the order of
    its sums shows in the bits."""
    ax, az = np.deg2rad(deg)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    r = np.eye(4)
    r[:3, :3] = rx @ rz
    return (r @ c2v).astype(np.float32)


CASES = {
    # name: (FusionConfig fields, rig_fuse keywords, per-camera intrinsics + ROIs)
    "tiled_image_only": (dict(emit_zbuf=False), {}, False),
    "tiled_zbuf": ({}, {}, False),
    "multi_stream": ({}, dict(multi_stream=True), False),
    "packed": (dict(render_mode="packed"), {}, False),
    "per_camera_bc_rois": ({}, {}, True),
    "gauss_vertical_mirror": (dict(filter_fused_color=True, vertical_image=True,
                                   mirror_image=True), {}, False),
    "median": (dict(filter_fused_color=True, use_median_filter=True, emit_zbuf=False), {},
               False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rig_fuse_matches_jax(case, frames):
    cfg_kw, rig_kw, per_camera = CASES[case]
    depth, color, c2v = frames
    jc, tc = both_configs(**cfg_kw)
    ji = jax_intrinsics(per_camera)
    ti = torch_intrinsics(ji)
    ref_j, ref_t = (ji[0], ti[0]) if per_camera else (ji, ti)
    jf, tf = j_fvi(ref_j, jc.vertical_image), t_fvi(ref_t, tc.vertical_image)
    if jc.vertical_image:
        c2v = _rot_z90(c2v)
    rois = ROIS if per_camera else None
    want = run_jax(JM.rig_fuse(ji, jf, jc, rois=rois, **rig_kw), depth, color, c2v)
    got = run_torch(TM.rig_fuse(ti, tf, tc, rois=rois, device="cpu", **rig_kw),
                    depth, color, c2v).numpy()
    assert got.shape == want.shape == (tf.height, tf.width, 3) and got.dtype == np.uint8, case
    covered = want.any(-1)
    assert covered.mean() > 0.5, (case, covered.mean())
    differ = (got != want).any(-1).mean()
    if cfg_kw.get("render_mode") == "packed":
        assert (got.any(-1) != covered).mean() <= PIXEL_BUDGET, case
        assert differ <= COLOR_BUDGET, (case, differ)
    else:
        assert differ <= PIXEL_BUDGET, (case, differ)


@pytest.mark.parametrize("per_camera", [False, True], ids=["shared", "per_camera_bc_rois"])
def test_entries_and_packed_keys_bit_exact(per_camera, frames):
    """entries_all (flat, per-stream, with pixel offsets), entries_one per
    camera and the packed body's per-camera keys equal op-by-op JAX bit for
    bit, given the same cam_to_virtual."""
    depth, color, c2v = frames
    c2v = _tilt(c2v)
    jc, tc = both_configs(mirror_image=True)
    ji = jax_intrinsics(per_camera)
    ti = torch_intrinsics(ji)
    rois = ROIS if per_camera else None
    jcal, tcal = JM._RigCalibration(ji, rois), TM._RigCalibration(ti, rois, "cpu")
    jf, tf = j_fvi(jcal.ref, False), t_fvi(tcal.ref, False)
    scale = np.full((N,), 0.001, np.float32)
    offsets = np.arange(N, dtype=np.int32) * 1000
    t_args = (torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(color),
              torch.from_numpy(scale), torch.from_numpy(c2v))
    t_one, t_entries = TM._tiled_rig_body(tcal, tf, tc)[:2]
    t_project = TM._packed_rig_body(tcal, tf, tc, 0.25, 4.5)[0]
    with jax.disable_jit():
        j_args = (jnp.asarray(depth), jnp.asarray(color), jnp.asarray(scale), jnp.asarray(c2v))
        j_one, j_entries = JM._tiled_rig_body(jcal, jf, jc)[:2]
        j_project = JM._packed_rig_body(jcal, jf, jc, 0.25, 4.5)[0]
        for kw in ({}, dict(per_stream=True), dict(pix_offsets=offsets)):
            want = j_entries(*j_args, **kw)
            t_kw = dict(kw, pix_offsets=torch.from_numpy(offsets)) if "pix_offsets" in kw else kw
            got = t_entries(*t_args, **t_kw)
            for g, w_ in zip(got, want):
                assert g.dtype == torch.int32 and tuple(g.shape) == w_.shape
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert (got[0].numpy() != zresolve_cuda.INVALID_PIX).mean() > 0.5
        per_stream = t_entries(*t_args, per_stream=True)
        invalid = zresolve_cuda.INVALID_PIX
        for i in range(N):
            j_got = j_one(*(a[i] for a in j_args), pix_offset=int(offsets[i]),
                          intr1=jcal.at(i), roi1=jcal.roi_at(i))
            t_got = t_one(*(a[i] for a in t_args), pix_offset=int(offsets[i]),
                          intr1=tcal.at(i), roi1=tcal.roi_at(i))
            for g, w_ in zip(t_got, j_got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
            # entries_one is entries_all's camera i, shifted by its offset.
            pix_i = per_stream[0][i].numpy()
            np.testing.assert_array_equal(
                t_got[0].numpy(), np.where(pix_i == invalid, invalid, pix_i + offsets[i]))
            assert all(torch.equal(g, flat[i]) for g, flat in zip(t_got[1:], per_stream[1:]))
            j_idx, j_key = j_project(*(a[i] for a in j_args), intr1=jcal.at(i),
                                     roi1=jcal.roi_at(i))
            t_idx, t_key = t_project(*(a[i] for a in t_args), intr1=tcal.at(i),
                                     roi1=tcal.roi_at(i))
            np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key).view(np.int32))
