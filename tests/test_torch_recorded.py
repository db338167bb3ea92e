"""The port's recorded and encoded sources and ``CameraNode.main`` against
the JAX package's: recordings replay across the two packages, encoded
framesets are the same bytes, the two CLIs write the same files for the
same arguments, and a dual manifest of two recordings runs through the
port's ``run_deployment``."""

import sys

import numpy as np
import pytest

from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset as JHost
from pointcloud_depthfusion_tpu.io import encoded as JEnc
from pointcloud_depthfusion_tpu.io import recorded as JRec
from pointcloud_depthfusion_tpu.nodes import camera_node as JCamNode
from pointcloud_depthfusion_tpu_torch.core.camera import Distortion, Intrinsics
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io import encoded as TEnc
from pointcloud_depthfusion_tpu_torch.io import recorded as TRec
from pointcloud_depthfusion_tpu_torch.nodes import camera_node as TCamNode
from pointcloud_depthfusion_tpu_torch.nodes import launch as TL

W, H = 40, 30
KEYS = ("depth", "color", "timestamps", "depth_scale", "intrinsics", "coeffs", "model")
INTR = dict(fx=35.5, fy=36.25, ppx=20.125, ppy=14.875, model=2,
            coeffs=(0.06, -0.02, 0.001, -0.0015, 0.004))


def _frames(host_cls, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [host_cls(depth=rng.integers(0, 4000, (H, W)).astype(np.uint16),
                     color=rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
                     timestamp=100.0 + k / 30.0, depth_scale=0.001 * (1 + k % 2))
            for k in range(n)]


def _assert_npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files) == sorted(KEYS)
        for k in KEYS:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_recordings_replay_across_packages(tmp_path, direction):
    writers = {"port": (TRec, Intrinsics.create(W, H, device="cpu", **INTR), HostFrameset),
               "jax": (JRec, JIntr.create(W, H, **INTR), JHost)}
    src, dst = direction.split("_to_")
    paths = {}
    for who in ("port", "jax"):
        mod, intr, host = writers[who]
        paths[who] = str(tmp_path / f"{who}.npz")
        mod.record_dataset(paths[who], _frames(host), intr)
    _assert_npz_equal(paths["port"], paths["jax"])
    reader = {"port": TRec, "jax": JRec}[dst].RecordedSource(paths[src], loop=True)
    assert len(reader) == 3 and reader.fps == pytest.approx(30.0)
    ri = reader.intrinsics
    assert (ri.width, ri.height, int(ri.model)) == (W, H, int(Distortion.INVERSE_BROWN_CONRADY))
    assert [float(v) for v in (ri.fx, ri.fy, ri.ppx, ri.ppy)] == \
        [INTR[k] for k in ("fx", "fy", "ppx", "ppy")]
    np.testing.assert_array_equal(np.asarray(ri.coeffs, np.float32),
                                  np.asarray(INTR["coeffs"], np.float32))
    want = _frames(HostFrameset)
    for k in range(4):  # the fourth frame is the first again, one period later
        got = reader.next_frame()
        np.testing.assert_array_equal(got.depth, want[k % 3].depth)
        np.testing.assert_array_equal(got.color, want[k % 3].color)
        assert got.depth_scale == want[k % 3].depth_scale
        assert got.timestamp == pytest.approx(100.0 + k / 30.0, abs=1e-9)
    once = TRec.RecordedSource(paths[src])
    assert [once.next_frame() is None for _ in range(4)] == [False] * 3 + [True]
    with pytest.raises(ValueError, match="empty recording"):
        TRec.record_dataset(str(tmp_path / "none.npz"), [], writers["port"][1])


def test_recorded_source_broadcasts_a_legacy_scalar_scale(tmp_path):
    path = str(tmp_path / "legacy.npz")
    TRec.record_dataset(path, _frames(HostFrameset), Intrinsics.create(W, H, device="cpu",
                                                                        **INTR))
    with np.load(path) as data:
        arrays = dict(data)
    arrays["depth_scale"] = np.asarray(0.00025)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    src = TRec.RecordedSource(path)
    assert src.depth_scale == 0.00025 and src.intrinsics.device.type == "cpu"
    assert [src.next_frame().depth_scale for _ in range(3)] == [0.00025] * 3


def test_encoded_frameset_bytes_match_jax(tmp_path):
    port, ref = _frames(HostFrameset, 2), _frames(JHost, 2)
    blobs = [TEnc.EncodedFrameset.encode(f).to_bytes() for f in port]
    assert blobs == [JEnc.EncodedFrameset.encode(f).to_bytes() for f in ref]
    TEnc.write_encoded_stream(str(tmp_path / "port.pdfe"), port)
    JEnc.write_encoded_stream(str(tmp_path / "jax.pdfe"), ref)
    assert (tmp_path / "port.pdfe").read_bytes() == (tmp_path / "jax.pdfe").read_bytes()
    for path in ("port.pdfe", "jax.pdfe"):
        back = TEnc.read_encoded_stream(str(tmp_path / path))
        assert len(back) == 2
        for got, want in zip(back, port):
            assert got.depth.dtype == np.uint16
            np.testing.assert_array_equal(got.depth, want.depth)
            np.testing.assert_array_equal(got.color, want.color)
            assert (got.timestamp, got.depth_scale) == (want.timestamp, want.depth_scale)
    with pytest.raises(ValueError, match="truncated"):
        TEnc.EncodedFrameset.from_bytes(blobs[0][:10])
    with pytest.raises(ValueError, match="truncated"):
        TEnc.EncodedFrameset.from_bytes(blobs[0][:-1])
    with pytest.raises(ValueError, match="bad encoded frameset"):
        TEnc.EncodedFrameset.from_bytes(b"XXXX" + blobs[0][4:])


def _main(mod, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["camera_node", *args])
    mod.main()


@pytest.mark.parametrize("ext", ["npz", "pdfe"])
def test_camera_node_main_matches_jax(tmp_path, monkeypatch, ext):
    """The same argv writes the same recording: both render natively with
    the same seed and run the same temporal filter."""
    outs = {}
    for key, mod in (("jax", JCamNode), ("port", TCamNode)):
        outs[key] = str(tmp_path / f"{key}.{ext}")
        _main(mod, monkeypatch, "--name", "camera_right", "--width", "106", "--height", "60",
              "--frames", "3", "--out", outs[key])
    if ext == "npz":
        _assert_npz_equal(outs["port"], outs["jax"])
        with np.load(outs["port"]) as data:
            assert data["depth"].shape == (3, 60, 106) and (data["depth"] > 0).mean() > 0.5
    else:
        with open(outs["port"], "rb") as a, open(outs["jax"], "rb") as b:
            assert a.read() == b.read()
        assert len(TEnc.read_encoded_stream(outs["port"])) == 3


def test_camera_node_main_replays_a_recording(tmp_path, monkeypatch, capsys):
    """--source replays a recording unfiltered, looping past its end; the
    same recording served by a camera host records again through
    --source tcp://, unfiltered too."""
    rec, again = str(tmp_path / "rec.npz"), str(tmp_path / "again.npz")
    _main(TCamNode, monkeypatch, "--width", "40", "--height", "30", "--frames", "2",
          "--out", rec)
    _main(TCamNode, monkeypatch, "--source", rec, "--frames", "3", "--out", again)
    assert "captured 3 frames @ 40x30" in capsys.readouterr().out
    with np.load(rec) as a, np.load(again) as b:
        np.testing.assert_array_equal(b["depth"], a["depth"][[0, 1, 0]])
        np.testing.assert_array_equal(b["intrinsics"], a["intrinsics"])
        assert b["timestamps"][2] == pytest.approx(a["timestamps"][1] + 1 / 30.0)
    from pointcloud_depthfusion_tpu_torch.io.network import FramesetStreamServer

    remote = str(tmp_path / "remote.npz")
    with FramesetStreamServer(TRec.RecordedSource(rec, loop=True), fps=0.0, queue_size=8,
                              max_frames=3) as server:
        _main(TCamNode, monkeypatch, "--source", f"tcp://127.0.0.1:{server.port}",
              "--frames", "3", "--out", remote)
    assert "captured 3 frames @ 40x30" in capsys.readouterr().out
    with np.load(again) as a, np.load(remote) as b:
        for k in ("depth", "color", "timestamps", "depth_scale"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_recorded_dual_deployment(tmp_path, monkeypatch):
    """Two recordings made with the port's CameraNode.main replay through
    run_deployment on the CPU: every frame fused, the temporal filter off
    on both cameras, no launch pose."""
    paths = []
    for name in ("camera_left", "camera_right"):
        paths.append(str(tmp_path / f"{name}.npz"))
        _main(TCamNode, monkeypatch, "--name", name, "--width", "80", "--height", "48",
              "--frames", "4", "--out", paths[-1])
    m = {"width": 8, "height": 6,  # synthetic sizes; recordings bring their own
         "cameras": [{"name": n, "source": p} for n, p in zip(("camera_left", "camera_right"),
                                                             paths)],
         "registration": {"every_n_frames": 3},
         "viewer": {"out_dir": str(tmp_path / "view"), "every_n": 2}}
    for i, spec in enumerate(m["cameras"]):
        cam = TL._build_camera(spec, i, 2, 8, 6)
        assert cam.temporal_filter is False and cam.launch_pose is None
        assert (cam.intrinsics.width, cam.intrinsics.height) == (80, 48)
    s = TL.run_deployment(m, device="cpu", frames=6)
    assert (s["tier"], s["frames"], s["fused_shape"]) == ("dual", 6, [80, 48, 3])
    assert s["fused_coverage"] > 0.3 and s["saved_pngs"] == 3
    assert s["registration_ticks"] == 2 and np.isfinite(s["registration_fitness"])
