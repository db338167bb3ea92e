"""The port's rig paths against each other (plain kernels, CPU): the image
is the same whichever resolve, color layout or batching computes it, and
the rig raises the JAX package's ValueErrors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig as JConfig
from pointcloud_depthfusion_tpu.parallel import mesh as JM
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.frameset import pack_rgb24_host
from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig as TConfig
from pointcloud_depthfusion_tpu_torch.ops.cuda import zresolve_cuda
from pointcloud_depthfusion_tpu_torch.parallel import mesh as TM
from torch_rig_common import (
    ROIS, H, W, arc_frames, both_configs, jax_intrinsics, run_torch, torch_intrinsics,
)


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


VARIANTS = {
    # name: (FusionConfig changes, rig_fuse keywords)
    "multi_stream": ({}, dict(multi_stream=True)),
    "image_only": (dict(emit_zbuf=False), {}),
    "image_only_multi_stream": (dict(emit_zbuf=False), dict(multi_stream=True)),
    "exact": (dict(render_mode="exact"), {}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multi_stream_and_image_only_equal_default(variant, frames):
    """On one device B7 (multi_stream) and B1 (image only) give the image
    of the default B2 resolve, bit for bit; so does the exact alias."""
    depth, color, c2v = frames
    ti = torch_intrinsics(jax_intrinsics(False))
    _, tc = both_configs()
    changes, kw = VARIANTS[variant]
    base = run_torch(TM.rig_fuse(ti, ti, tc, device="cpu"), depth, color, c2v)
    got = run_torch(TM.rig_fuse(ti, ti, dataclasses.replace(tc, **changes), device="cpu", **kw),
                    depth, color, c2v)
    assert torch.equal(got, base)


@pytest.mark.parametrize("emit_zbuf", [True, False], ids=["zbuf", "image_only"])
@pytest.mark.parametrize("mode", ["tiled", "packed"])
def test_prepacked_color_equals_hwc(mode, emit_zbuf, frames):
    """Pre-packed (N, H, W) int32 rgb24 planes give the HWC image, single
    and batched."""
    depth, color, c2v = frames
    ti = torch_intrinsics(jax_intrinsics(False))
    packed = pack_rgb24_host(color)
    _, tc = both_configs(render_mode=mode, emit_zbuf=emit_zbuf)
    fn = TM.rig_fuse(ti, ti, tc, device="cpu")
    assert torch.equal(run_torch(fn, depth, color, c2v), run_torch(fn, depth, packed, c2v))
    fb = TM.batched_rig_fuse(ti, ti, tc, batch=2, cameras=2, device="cpu")
    args = (torch.from_numpy(depth.astype(np.int32)).reshape(2, 2, H, W),
            torch.full((2, 2), 0.001), torch.from_numpy(c2v).reshape(2, 2, 4, 4))
    hwc = fb(args[0], torch.from_numpy(color).reshape(2, 2, H, W, 3), *args[1:])
    pre = fb(args[0], torch.from_numpy(packed).reshape(2, 2, H, W), *args[1:])
    assert torch.equal(hwc, pre)


@pytest.mark.parametrize("mode", ["tiled", "packed"])
def test_batched_rig_matches_per_stream(mode):
    """B=2 rigs of C=3 cameras, per-camera intrinsics and ROIs, with the
    fused color filter: each stream's image equals rig_fuse on that stream
    alone (the filter runs per stream)."""
    b, c = 2, 3
    depth, color, c2v = arc_frames(b * c, seed=10, span=1.2)
    ti = torch_intrinsics(jax_intrinsics(True))[:c]
    _, tc = both_configs(render_mode=mode, filter_fused_color=True)
    fn = TM.batched_rig_fuse(ti, ti[0], tc, batch=b, cameras=c, rois=ROIS[:c], device="cpu")
    out = fn(torch.from_numpy(depth.astype(np.int32)).reshape(b, c, H, W),
             torch.from_numpy(color).reshape(b, c, H, W, 3), torch.full((b, c), 0.001),
             torch.from_numpy(c2v).reshape(b, c, 4, 4))
    one = TM.rig_fuse(ti, ti[0], tc, rois=ROIS[:c], device="cpu")
    assert out.shape == (b, H, W, 3)
    for k in range(b):
        sl = slice(k * c, (k + 1) * c)
        want = run_torch(one, depth[sl], color[sl], c2v[sl])
        assert want.any(-1).float().mean() > 0.3, k
        assert torch.equal(out[k], want), k


def _errors(m, intr_mod, cfg_mod, dev):
    """{name: (callable, match)}: the rig's ValueErrors, built with one
    package's modules."""
    kw = {} if dev is None else dict(device=dev)
    a = intr_mod.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2, **kw)
    b = intr_mod.create(W, H, fx=70.0, fy=71.0, ppx=W / 2, ppy=H / 2, **kw)
    short = intr_mod.create(W, H - 8, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2, **kw)
    cfg = cfg_mod.create(vertical_image=False, mirror_image=False, filter_fused_color=False, **kw)
    if dev is None:
        z = (jnp.zeros((4, H, W), jnp.uint16), jnp.zeros((4, H, W, 3), jnp.uint8),
             jnp.full((4,), 0.001, jnp.float32), jnp.tile(jnp.eye(4, dtype=jnp.float32), (4, 1, 1)))
    else:
        z = (torch.zeros((4, H, W), dtype=torch.int32), torch.zeros((4, H, W, 3), dtype=torch.uint8),
             torch.full((4,), 0.001), torch.eye(4).repeat(4, 1, 1))
    return {
        "unknown_mode": (lambda: m.rig_fuse(a, a, dataclasses.replace(cfg, render_mode="indexed"),
                                            **kw), "render_mode"),
        "unknown_mode_batched": (lambda: m.batched_rig_fuse(
            a, a, dataclasses.replace(cfg, render_mode="pallas"), batch=2, cameras=2, **kw),
            "render_mode"),
        "static_intrinsics_differ": (lambda: m.rig_fuse([a, short], a, cfg, **kw), "static"),
        "count_tiled": (lambda: m.rig_fuse([a, b], a, cfg, **kw)(*z), "must match"),
        "count_packed": (lambda: m.rig_fuse(
            [a, b], a, dataclasses.replace(cfg, render_mode="packed"), **kw)(*z), "must match"),
        "count_rois": (lambda: m.rig_fuse(a, a, cfg, rois=[None, None], **kw)(*z), "must match"),
        "count_batched": (lambda: m.batched_rig_fuse([a, b], a, cfg, batch=2, cameras=4, **kw),
                          "calibration"),
        "rois_against_intrinsics": (lambda: m.rig_fuse([a, b], a, cfg, rois=[None] * 3, **kw),
                                    "per-camera axes"),
    }


ERRORS = ("unknown_mode", "unknown_mode_batched", "static_intrinsics_differ", "count_tiled",
          "count_packed", "count_rois", "count_batched", "rois_against_intrinsics")


@pytest.mark.parametrize("name", ERRORS)
def test_rig_errors_match_jax(name):
    j_call, match = _errors(JM, JIntr, JConfig, None)[name]
    t_call, _ = _errors(TM, TIntr, TConfig, "cpu")[name]
    with pytest.raises(ValueError, match=match):
        j_call()
    with pytest.raises(ValueError, match=match):
        t_call()


def test_batched_rig_pixel_ids_stay_below_invalid():
    """The port's own bound: every stream's pixel ids stay below
    INVALID_PIX."""
    intr = TIntr.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2, device="cpu")
    cfg = TConfig.create(device="cpu")
    too_many = zresolve_cuda.INVALID_PIX // (W * H) + 1
    with pytest.raises(ValueError, match="invalid pixel id"):
        TM.batched_rig_fuse(intr, intr, cfg, batch=too_many, cameras=1, device="cpu")
    assert TM.batched_rig_fuse(intr, intr, cfg, batch=too_many - 1, cameras=1,
                               device="cpu").device == torch.device("cpu")
