"""The port's fused frame (plain kernels, CPU) against the JAX package.

The JAX side runs ``render_mode="exact"``, its plain reference, which is
bit-identical to "tiled". Jitted on the CPU, XLA contracts the projection's
multiply-adds into FMAs, so its z-buffer differs in the last ulp and a
winner may flip at a near-tie: those comparisons use the parity gate's
budget (CROSS_BACKEND_PIXEL_BUDGET = 1e-3 of pixels, z within the gate's
ulp envelope). Run op by op, JAX does not contract, and the render given
JAX's pose is held bit-exact.

The packed, indexed and pallas modes quantize depth, so a last-ulp change
can move a key across a bin edge: against jitted JAX they are held to the
parity gate's envelopes (tpu_check.py:417-451), and given JAX's pose, run
op by op, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_depthfusion_tpu.core import geometry as JG
from pointcloud_depthfusion_tpu.core.camera import Extrinsics as JExt
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.camera import fused_virtual_intrinsics as j_fvi
from pointcloud_depthfusion_tpu.core.frameset import Frameset as JFrameset
from pointcloud_depthfusion_tpu.fusion import pipeline as JP
from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics as TExt
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.camera import fused_virtual_intrinsics as t_fvi
from pointcloud_depthfusion_tpu_torch.core.frameset import Frameset as TFrameset
from pointcloud_depthfusion_tpu_torch.fusion import pipeline as TP
from pointcloud_depthfusion_tpu_torch.io.synthetic import (
    SyntheticScene,
    right_to_left_transform,
    two_camera_rig,
)

PIXEL_BUDGET = 1e-3
COLOR_BUDGET = 1e-2  # the gate's color bar for the quantizing modes
ZMAX = np.float32(np.finfo(np.float32).max)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_voxel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(w, h, toe_in=10.0, seeds=(0, 1)):
    """The bench scene of __graft_entry__._build_fusion at w×h."""
    fx = 631.0 * w / 848.0
    kw = dict(fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
    ji, ti = JIntr.create(w, h, **kw), TIntr.create(w, h, device="cpu", **kw)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=toe_in)
    fl = scene.render(ti, wl, depth_noise_std=0.002, hole_fraction=0.01, seed=seeds[0])
    fr = scene.render(ti, wr, depth_noise_std=0.002, hole_fraction=0.01, seed=seeds[1])
    t_rl = right_to_left_transform(wl, wr).astype(np.float32)
    return ji, ti, fl, fr, t_rl


def _pair(ji, ti, fl, fr, pack=False):
    jl = JFrameset.create(fl.depth, fl.color, ji, pack_color=pack)
    jr = JFrameset.create(fr.depth, fr.color, ji, pack_color=pack)
    tl = TFrameset.create(fl.depth, fl.color, ti, pack_color=pack, device="cpu")
    tr = TFrameset.create(fr.depth, fr.color, ti, pack_color=pack, device="cpu")
    return jl, jr, tl, tr


def _mismatch(j_img, j_zbuf, t_img, t_zbuf):
    """(image, coverage, z-outside-ulp-envelope) mismatch fractions, as
    the parity gate measures them (tpu_check.py:400-415)."""
    j_img, t_img = np.asarray(j_img), t_img.numpy()
    img = float((j_img != t_img).any(-1).mean())
    if j_zbuf is None:
        return img, 0.0, 0.0
    zj, zt = np.asarray(j_zbuf), t_zbuf.numpy()
    cov = float(((zj == ZMAX) != (zt == ZMAX)).mean())
    z_bad = float((~np.isclose(zj, zt, rtol=2e-6, atol=1e-6)).mean())
    return img, cov, z_bad


@pytest.fixture(scope="module")
def scene160():
    return _scene(160, 120)


def _jax_fuse_jit(ji, cfg):
    fi = j_fvi(ji, cfg.vertical_image)
    return jax.jit(lambda l, r, t, c: JP.fuse(l, r, t, c, fi))


def test_fuse_matches_jax_within_parity_budget(scene160):
    ji, ti, fl, fr, t_rl = scene160
    jl, jr, tl, tr = _pair(ji, ti, fl, fr)
    jc = JP.FusionConfig.create(vertical_image=True, mirror_image=True, render_mode="exact")
    tc = TP.FusionConfig.create(device="cpu", vertical_image=True, mirror_image=True)
    want = _jax_fuse_jit(ji, jc)(jl, jr, jnp.asarray(t_rl), jc)
    got = TP.fuse(tl, tr, torch.from_numpy(t_rl), tc, t_fvi(ti, True))
    assert got.image.shape == (160, 120, 3) and got.image.dtype == torch.uint8
    fr_img, fr_cov, fr_z = _mismatch(want.image, want.zbuf, got.image, got.zbuf)
    print(f"fuse vs jitted JAX exact, 160x120: image {fr_img:.6f}, coverage {fr_cov:.6f}, "
          f"z outside ulp envelope {fr_z:.6f}")
    assert max(fr_img, fr_cov, fr_z) <= PIXEL_BUDGET
    np.testing.assert_array_equal(got.valid_left.numpy(), np.asarray(want.valid_left))
    np.testing.assert_array_equal(got.valid_right.numpy(), np.asarray(want.valid_right))
    assert (got.zbuf.numpy() < ZMAX).mean() > 0.5


def test_render_given_jax_pose_is_bit_exact(scene160):
    """Op-by-op JAX does not contract multiply-adds, so with JAX's own
    virtual pose the port's render must match it bit for bit."""
    ji, ti, fl, fr, t_rl = scene160
    jl, jr, tl, tr = _pair(ji, ti, fl, fr)
    jc = JP.FusionConfig.create(vertical_image=True, mirror_image=True, render_mode="exact")
    tc = TP.FusionConfig.create(device="cpu", vertical_image=True, mirror_image=True)
    want = JP.fuse(jl, jr, jnp.asarray(t_rl), jc, j_fvi(ji, True))
    fused_t = JP.fused_camera_transform(jc, jnp.asarray(t_rl))
    right_total = JG.mm(fused_t, jnp.asarray(t_rl))
    got = TP.fuse_posed(tl, tr, torch.tensor(np.asarray(fused_t)),
                        torch.tensor(np.asarray(right_total)), tc, t_fvi(ti, True))
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    np.testing.assert_array_equal(got.zbuf.numpy(), np.asarray(want.zbuf))


def test_fuse_matches_jax_tiled_pallas_interpreter():
    ji, ti, fl, fr, t_rl = _scene(64, 48)
    jl, jr, tl, tr = _pair(ji, ti, fl, fr)
    jc = JP.FusionConfig.create(vertical_image=True, mirror_image=True, render_mode="tiled")
    tc = TP.FusionConfig.create(device="cpu", vertical_image=True, mirror_image=True)
    want = _jax_fuse_jit(ji, jc)(jl, jr, jnp.asarray(t_rl), jc)
    got = TP.fuse(tl, tr, torch.from_numpy(t_rl), tc, t_fvi(ti, True))
    fracs = _mismatch(want.image, want.zbuf, got.image, got.zbuf)
    print("fuse vs jitted JAX tiled (Pallas interpreter), 64x48: image %.6f, coverage %.6f, "
          "z outside ulp envelope %.6f" % fracs)
    assert max(fracs) <= PIXEL_BUDGET


def test_pipeline_process_two_frames_and_transform_update(scene160):
    """FusionPipeline over two frames with a registration update between
    them, against the JAX pipeline; emit_zbuf False gives the same image;
    median filter and pre-packed color work."""
    ji, ti, fl, fr, t_rl = scene160
    _, _, fl2, fr2, _ = _scene(160, 120, seeds=(5, 6))
    frames = [_pair(ji, ti, fl, fr), _pair(ji, ti, fl2, fr2, pack=True)]
    t_rl2 = t_rl.copy()
    t_rl2[0, 3] += 0.01
    for median in (False, True):
        jc = JP.FusionConfig.create(render_mode="exact", use_median_filter=median)
        tc = TP.FusionConfig.create(device="cpu", use_median_filter=median)
        jpipe = JP.FusionPipeline(ji, jc)
        tpipe = TP.FusionPipeline(ti, tc, device="cpu")
        tfast = TP.FusionPipeline(ti, dataclasses.replace(tc, emit_zbuf=False), device="cpu")
        for (jl, jr, tl, tr), t in zip(frames, (t_rl, t_rl2)):
            for p in (jpipe, tpipe, tfast):
                p.set_right_transform(t)
            want = jpipe.process(jl, jr)
            got = tpipe.process(tl, tr)
            fracs = _mismatch(want.image, want.zbuf, got.image, got.zbuf)
            print(f"pipeline median={median} packed={tl.color_packed is not None}: "
                  "image %.6f, coverage %.6f, z outside ulp envelope %.6f" % fracs)
            assert max(fracs) <= PIXEL_BUDGET
            fast = tfast.process(tl, tr)
            assert fast.zbuf is None
            assert torch.equal(fast.image, got.image)
            assert float(got.timestamp) == float(want.timestamp)


def _qstep(mode, n_pts, z_near=0.25, z_far=4.0):
    """One depth quantization step of a mode at the default window
    (z_near = min_depth / 2, z_far = max_depth + 1)."""
    bits = 14 if mode != "indexed" else 32 - max(1, n_pts.bit_length())
    return (z_far - z_near) / ((1 << bits) - 1)


def _envelope(j_img, j_zbuf, t_img, t_zbuf, qstep):
    """(coverage, z beyond two steps, color) mismatch fractions, as the gate
    measures the quantizing modes (tpu_check.py:417-451)."""
    zj, zt = np.asarray(j_zbuf), t_zbuf.numpy()
    cj, ct = zj != ZMAX, zt != ZMAX
    both = cj & ct
    z_bad = float((np.abs(zj[both] - zt[both]) > 2 * qstep).mean()) if both.any() else 0.0
    color = float((np.asarray(j_img) != t_img.numpy()).any(-1).mean())
    return float((cj != ct).mean()), z_bad, color


@pytest.mark.parametrize("mode", ["exact", "indexed", "packed", "pallas"])
def test_fuse_each_mode_matches_jitted_jax(scene160, mode):
    ji, ti, fl, fr, t_rl = scene160
    jl, jr, tl, tr = _pair(ji, ti, fl, fr)
    jc = JP.FusionConfig.create(vertical_image=True, mirror_image=True, render_mode=mode)
    tc = TP.FusionConfig.create(device="cpu", vertical_image=True, mirror_image=True,
                                render_mode=mode)
    want = _jax_fuse_jit(ji, jc)(jl, jr, jnp.asarray(t_rl), jc)
    got = TP.fuse(tl, tr, torch.from_numpy(t_rl), tc, t_fvi(ti, True))
    assert got.image.shape == (160, 120, 3) and got.zbuf.shape == (160, 120)
    np.testing.assert_array_equal(got.valid_left.numpy(), np.asarray(want.valid_left))
    np.testing.assert_array_equal(got.valid_right.numpy(), np.asarray(want.valid_right))
    assert (got.zbuf.numpy() < ZMAX).mean() > 0.5
    if mode == "exact":
        fracs = _mismatch(want.image, want.zbuf, got.image, got.zbuf)
        print("exact vs jitted JAX: image %.6f, coverage %.6f, z outside ulp envelope %.6f" % fracs)
        assert max(fracs) <= PIXEL_BUDGET
        return
    cov, z_bad, color = _envelope(want.image, want.zbuf, got.image, got.zbuf,
                                  _qstep(mode, 2 * 160 * 120))
    print(f"{mode} vs jitted JAX: coverage {cov:.6f}, z beyond 2 steps {z_bad:.6f}, "
          f"color {color:.6f}")
    assert cov <= PIXEL_BUDGET and z_bad <= PIXEL_BUDGET and color <= COLOR_BUDGET


@pytest.mark.parametrize("mode", ["indexed", "packed"])
def test_quantizing_render_given_jax_pose_is_bit_exact(scene160, mode):
    """Op by op and with JAX's pose, the packed and indexed renders match
    JAX bit for bit, like the exact one."""
    ji, ti, fl, fr, t_rl = scene160
    jl, jr, tl, tr = _pair(ji, ti, fl, fr, pack=mode == "packed")
    jc = JP.FusionConfig.create(vertical_image=True, mirror_image=True, render_mode=mode)
    tc = TP.FusionConfig.create(device="cpu", vertical_image=True, mirror_image=True,
                                render_mode=mode)
    want = JP.fuse(jl, jr, jnp.asarray(t_rl), jc, j_fvi(ji, True))
    fused_t = JP.fused_camera_transform(jc, jnp.asarray(t_rl))
    right_total = JG.mm(fused_t, jnp.asarray(t_rl))
    got = TP.fuse_posed(tl, tr, torch.tensor(np.asarray(fused_t)),
                        torch.tensor(np.asarray(right_total)), tc, t_fvi(ti, True))
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    np.testing.assert_array_equal(got.zbuf.numpy(), np.asarray(want.zbuf))


def test_pallas_mode_matches_packed_mode(scene160):
    """test_pallas_prep.py:71: the pallas mode against the packed mode,
    image mismatch <= 2e-3. The port's two follow one op order: 0."""
    ji, ti, fl, fr, t_rl = scene160
    _, _, tl, tr = _pair(ji, ti, fl, fr)
    out = {}
    for mode in ("packed", "pallas"):
        cfg = TP.FusionConfig.create(device="cpu", vertical_image=False, mirror_image=True,
                                     filter_fused_color=False, render_mode=mode)
        out[mode] = TP.fuse(tl, tr, torch.from_numpy(t_rl), cfg, t_fvi(ti, False))
    mismatch = float((out["packed"].image != out["pallas"].image).any(-1).float().mean())
    print(f"pallas vs packed image mismatch {mismatch}")
    assert mismatch <= 2e-3
    assert torch.equal(out["packed"].image, out["pallas"].image)
    assert torch.equal(out["packed"].zbuf, out["pallas"].zbuf)


def _aligned_pair(ji, ti, fl, fr):
    """The scene's frames as raw depth of a depth camera with its own
    intrinsics and a 1.5 cm depth→color baseline."""
    w, h = ti.width, ti.height
    dk = dict(fx=0.8 * float(ti.fx), fy=0.8 * float(ti.fy), ppx=w / 2 + 1.5, ppy=h / 2 - 1.0)
    rot = np.eye(3, dtype=np.float32)
    t = (0.015, 0.0, 0.001)
    jd, td = JIntr.create(w, h, **dk), TIntr.create(w, h, device="cpu", **dk)
    je, te = JExt.create(rot, t), TExt.create(rot, t, device="cpu")
    return ([JFrameset.create(f.depth, f.color, ji, jd, je) for f in (fl, fr)],
            [TFrameset.create(f.depth, f.color, ti, td, te, device="cpu") for f in (fl, fr)])


def test_fuse_align_frames_matches_jax(scene160):
    """align_frames=True against eager JAX fuse (whose auto footprint sees
    concrete intrinsics), tiled and packed."""
    ji, ti, fl, fr, t_rl = scene160
    (jl, jr), (tl, tr) = _aligned_pair(ji, ti, fl, fr)
    for mode in ("tiled", "packed"):
        jc = JP.FusionConfig.create(render_mode="exact" if mode == "tiled" else mode,
                                    align_frames=True)
        tc = TP.FusionConfig.create(device="cpu", render_mode=mode, align_frames=True)
        want = JP.fuse(jl, jr, jnp.asarray(t_rl), jc, j_fvi(ji, True))
        got = TP.fuse(tl, tr, torch.from_numpy(t_rl), tc, t_fvi(ti, True))
        np.testing.assert_array_equal(got.valid_left.numpy(), np.asarray(want.valid_left))
        np.testing.assert_array_equal(got.valid_right.numpy(), np.asarray(want.valid_right))
        fracs = _mismatch(want.image, want.zbuf, got.image, got.zbuf)
        print(f"align_frames {mode} vs eager JAX: image %.6f, coverage %.6f, "
              "z outside ulp envelope %.6f" % fracs)
        assert max(fracs) <= PIXEL_BUDGET
    plain = TP.fuse(tl, tr, torch.from_numpy(t_rl), TP.FusionConfig.create(device="cpu"),
                    t_fvi(ti, True))
    assert not torch.equal(plain.valid_left, got.valid_left)


def test_pipeline_resolves_align_footprint_once_per_calibration(scene160, monkeypatch):
    ji, ti, fl, fr, t_rl = scene160
    _, (tl, tr) = _aligned_pair(ji, ti, fl, fr)
    calls = []
    orig = TP.auto_footprint

    def counted(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(TP, "auto_footprint", counted)
    cfg = TP.FusionConfig.create(device="cpu", align_frames=True)
    pipe = TP.FusionPipeline(ti, cfg, device="cpu")
    pipe.set_right_transform(t_rl)
    first = pipe.process(tl, tr)
    again = pipe.process(tl, tr)
    assert len(calls) == 2  # one per camera
    assert torch.equal(first.image, again.image)
    k = orig(tl.depth_intrinsics, tl.color_intrinsics, tl.depth_to_color)
    pinned = TP.fuse(tl, tr, torch.from_numpy(t_rl),
                     dataclasses.replace(cfg, align_footprint=k), t_fvi(ti, True))
    assert torch.equal(pinned.image, first.image) and torch.equal(pinned.zbuf, first.zbuf)
    moved = dataclasses.replace(tl, depth_to_color=TExt.create(np.eye(3), (0.02, 0, 0),
                                                               device="cpu"))
    pipe.process(moved, tr)
    assert len(calls) == 2  # frames do not re-read the calibration
    pipe.calibrate(moved, tr)
    assert len(calls) == 4
    assert pipe._footprints == tuple(orig(fs.depth_intrinsics, fs.color_intrinsics,
                                          fs.depth_to_color) for fs in (moved, tr))


def test_unported_modes_raise():
    """Every mode and align_frames run; what raises is what JAX raises: an
    unknown mode, and the pallas mode with alignment or ROIs."""
    ji, ti, fl, fr, t_rl = _scene(16, 12)
    _, _, tl, tr = _pair(ji, ti, fl, fr)
    fi = t_fvi(ti, True)
    t = torch.from_numpy(t_rl)
    with pytest.raises(ValueError, match="unknown render_mode"):
        TP.fuse(tl, tr, t, TP.FusionConfig.create(device="cpu", render_mode="bogus"), fi)
    for mode in TP.RENDER_MODES:
        for align in (False, True):
            cfg = TP.FusionConfig.create(device="cpu", render_mode=mode, align_frames=align)
            if mode == "pallas" and align:
                with pytest.raises(ValueError, match="pre-aligned"):
                    TP.fuse(tl, tr, t, cfg, fi)
            else:
                assert TP.fuse(tl, tr, t, cfg, fi).image.shape == (16, 12, 3)
    roi = TP.FusionConfig.create(device="cpu", render_mode="pallas", roi_left=(0, 0, 8, 8))
    with pytest.raises(ValueError, match="ROI"):
        TP.fuse(tl, tr, t, roi, fi)
