"""The port's TCP frameset transport (``io.network``) and RealSense bridge
(``io.realsense_host``) against the JAX package's: frames cross between
the two packages bit for bit in both directions with both codecs, the two
send the same bytes, every error contract holds in both, and the port's
server keeps the QoS contracts (drop-oldest, stop() against a stalled
sender, re-accept, the frame cap, loud source crashes, a clean end that
keeps its tail and is bounded for a client that stopped reading).

Every server binds port 0 and every wait polls with a deadline."""

import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

import mock_pyrealsense2 as mockrs
from pointcloud_depthfusion_tpu.core.camera import Distortion as JDist
from pointcloud_depthfusion_tpu.core.camera import Extrinsics as JExt
from pointcloud_depthfusion_tpu.core.camera import Intrinsics as JIntr
from pointcloud_depthfusion_tpu.io import encoded as JEnc
from pointcloud_depthfusion_tpu.io import network as JN
from pointcloud_depthfusion_tpu.io import realsense_host as JRS
from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource as JSyn
from pointcloud_depthfusion_tpu_torch.core.camera import Distortion as TDist
from pointcloud_depthfusion_tpu_torch.core.camera import Extrinsics as TExt
from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics as TIntr
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io import network as TN
from pointcloud_depthfusion_tpu_torch.io import realsense_host as TRS
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource
from pointcloud_depthfusion_tpu_torch.io.feeder import SyntheticSource as TSyn
from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 36
CALIB = dict(fx=40.5, fy=41.25, ppx=23.75, ppy=18.125,
             coeffs=(0.061, -0.023, 0.0011, -0.0014, 0.0042))
ROT = np.array([[1.0, 1e-3, 0.0], [-1e-3, 1.0, 2e-4], [0.0, -2e-4, 1.0]])
TRANS = [0.015, 0.0, -0.001]
PACKAGES = {"jax": (JN, JIntr, JExt, JDist, JSyn), "port": (TN, TIntr, TExt, TDist, TSyn)}


def _source(pkg, seed=7):
    """A synthetic camera with Brown-Conrady intrinsics, numpy renderer."""
    _, intr_cls, _, dist, syn = PACKAGES[pkg]
    extra = {} if pkg == "jax" else {"device": "cpu"}
    intr = intr_cls.create(W, H, model=dist.BROWN_CONRADY, **CALIB, **extra)
    return syn(SyntheticScene(), intr, two_camera_rig()[0], seed=seed, depth_noise_std=0.001)


def _extrinsics(pkg):
    ext_cls = PACKAGES[pkg][2]
    return ext_cls.create(ROT, TRANS) if pkg == "jax" else ext_cls.create(ROT, TRANS, "cpu")


def _read_all(client):
    got = []
    while (fs := client.next_frame()) is not None:
        got.append(fs)
    return got


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


@pytest.mark.parametrize("codec", ["png", "raw"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_cross_packages_bit_for_bit(direction, codec):
    """A server of one package into a NetworkSource of the other: the
    handshake's name, fps, codec, intrinsics (Brown-Conrady coefficients
    included) and extrinsics, and every frame, stamp and depth scale equal
    bit for bit, and the clean end reads as None and stays so."""
    server_pkg, client_pkg = direction.split("_to_")
    srv_mod, cli_mod = PACKAGES[server_pkg][0], PACKAGES[client_pkg][0]
    with srv_mod.FramesetStreamServer(_source(server_pkg), fps=0.0, name="camera_left",
                                      depth_to_color=_extrinsics(server_pkg), max_frames=3,
                                      codec=codec) as server:
        client = cli_mod.NetworkSource("127.0.0.1", server.port)
        got = _read_all(client)
    assert client.next_frame() is None
    assert (client.name, client.fps, client.codec) == ("camera_left", 0.0, codec)
    intr = client.intrinsics
    assert (intr.width, intr.height, int(intr.model)) == (W, H, int(TDist.BROWN_CONRADY))
    for key in ("fx", "fy", "ppx", "ppy"):
        assert np.float32(np.asarray(getattr(intr, key))) == np.float32(CALIB[key]), key
    np.testing.assert_array_equal(np.asarray(intr.coeffs), np.float32(CALIB["coeffs"]))
    ext = client.depth_to_color
    np.testing.assert_array_equal(np.asarray(ext.rotation), np.float32(ROT))
    np.testing.assert_array_equal(np.asarray(ext.translation), np.float32(TRANS))
    twin = _source("port")
    assert len(got) == 3
    for fs in got:
        want = twin.next_frame()
        np.testing.assert_array_equal(fs.depth, want.depth)
        np.testing.assert_array_equal(fs.color, want.color)
        assert fs.depth.dtype == np.uint16 and fs.color.dtype == np.uint8
        assert fs.timestamp == want.timestamp
        assert fs.depth_scale == (np.float32(want.depth_scale) if codec == "raw"
                                  else want.depth_scale)


@pytest.mark.parametrize("codec", ["png", "raw"])
def test_handshake_and_frame_bytes_equal(codec):
    """The two packages put the same bytes on the wire for the same camera
    and frameset."""
    servers = [PACKAGES[p][0].FramesetStreamServer(_source(p), fps=15.0, name="camera_right",
                                                   depth_to_color=_extrinsics(p), codec=codec)
               for p in ("jax", "port")]
    try:
        assert servers[0]._handshake == servers[1]._handshake
        fs = _source("port").next_frame()
        jax_blob = (JN._encode_raw(fs) if codec == "raw"
                    else JEnc.EncodedFrameset.encode(fs).to_bytes())
        assert servers[1]._encode(fs) == jax_blob
    finally:
        for s in servers:
            s.stop()


def _handshake() -> bytes:
    srv = TN.FramesetStreamServer(_source("port"), fps=30.0, name="x", codec="raw")
    srv.stop()
    return srv._handshake


def _frame_bytes(blob: bytes) -> bytes:
    return struct.pack("<I", len(blob)) + blob


class _RawPeer:
    """A one-shot TCP peer: sends ``payload`` to the first client, then
    closes the connection (``hold=False``) or holds it open until
    :meth:`close`."""

    def __init__(self, payload: bytes, hold: bool):
        self._lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lst.bind(("127.0.0.1", 0))
        self._lst.listen(1)
        self.port = self._lst.getsockname()[1]
        self._release = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(payload, hold), daemon=True)
        self._thread.start()

    def _run(self, payload, hold):
        conn, _ = self._lst.accept()
        conn.sendall(payload)
        if hold:
            self._release.wait(10.0)
        conn.close()

    def close(self):
        self._release.set()
        self._thread.join(timeout=5.0)
        self._lst.close()


def _error_case(case):
    """(wire bytes, peer closes after sending, NetworkSource kwargs,
    frames that read fine, exception, message)."""
    hs = _handshake()
    good = _frame_bytes(TN._encode_raw(_source("port").next_frame()))
    return {
        "abrupt_close": (hs + good, True, {}, 1, ConnectionError, "aborted mid-stream"),
        "truncated_frame": (hs + good[:40], True, {}, 0, ConnectionError, "aborted mid-stream"),
        "undecodable_frame": (hs + _frame_bytes(b"\x01\x02\x03\x04" * 8), False, {}, 0,
                              ConnectionError, "undecodable"),
        "oversized_frame": (hs + struct.pack("<I", (64 << 20) + 1), False, {}, 0,
                            ConnectionError, "byte cap"),
        "timeout": (hs, False, {"timeout_s": 0.2}, 0, TimeoutError, "socket timeout"),
        "bad_magic": (b"XXXX" + hs[4:], False, {}, None, ConnectionError, "not a PDFN"),
        "bad_version": (hs[:4] + b"\x02" + hs[5:], False, {}, None, ConnectionError,
                        "unsupported stream version"),
        "oversized_handshake": (hs[:5] + struct.pack("<I", (1 << 20) + 1), False, {}, None,
                                ConnectionError, "handshake length"),
    }[case]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case", ["abrupt_close", "truncated_frame", "undecodable_frame",
                                  "oversized_frame", "timeout", "bad_magic", "bad_version",
                                  "oversized_handshake"])
def test_network_source_error_contracts(case, pkg):
    """Each transport fault raises (never a silent end of stream), in both
    packages alike; a fault after the handshake latches: every later call
    raises ConnectionError."""
    payload, close, kw, n_good, exc, msg = _error_case(case)
    peer = _RawPeer(payload, hold=not close)
    try:
        if n_good is None:  # the handshake itself fails
            with pytest.raises(exc, match=msg):
                PACKAGES[pkg][0].NetworkSource("127.0.0.1", peer.port, **kw)
            return
        client = PACKAGES[pkg][0].NetworkSource("127.0.0.1", peer.port, **kw)
        for _ in range(n_good):
            assert client.next_frame() is not None
        with pytest.raises(exc, match=msg):
            client.next_frame()
        with pytest.raises(ConnectionError):
            client.next_frame()
    finally:
        peer.close()


class _BigSource(FramesetSource):
    """Large frames at no render cost (480×640 raw is 1.5 MB, more than the
    loopback socket buffers hold in a few frames), optionally failing after
    ``crash_after`` frames; counts the frames pulled."""

    def __init__(self, h=480, w=640, crash_after=None):
        rng = np.random.default_rng(0)
        self._depth = rng.integers(0, 4000, (h, w)).astype(np.uint16)
        self._color = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        self._intr = TIntr.create(w, h, fx=500.0, fy=500.0, ppx=w / 2, ppy=h / 2, device="cpu")
        self.crash_after = crash_after
        self.pulled = 0

    @property
    def intrinsics(self):
        return self._intr

    def next_frame(self):
        if self.crash_after is not None and self.pulled >= self.crash_after:
            raise RuntimeError("sensor stalled")
        self.pulled += 1
        return HostFrameset(self._depth, self._color, self.pulled / 30.0)


def _server(source, **kw):
    return TN.FramesetStreamServer(source, fps=0.0, codec="raw", **kw).start()


def test_server_drops_oldest_for_a_stalled_client():
    """Keep-last QoS: a client that does not read loses old frames, not
    liveness; every frame is either sent or dropped."""
    server = _server(_BigSource(), queue_size=2, max_frames=24)
    try:
        client = TN.NetworkSource("127.0.0.1", server.port)
        _wait(lambda: server.frames_dropped > 0)
        got = len(_read_all(client))
        assert got >= 1 and got == server.frames_sent
        assert got + server.frames_dropped == 24
    finally:
        server.stop()


def test_server_stop_unblocks_a_stalled_sender():
    """stop() closes the active client: a sender blocked in sendall never
    sees the stop flag, and would outlive stop() without the close."""
    server = _server(_BigSource(), queue_size=2, sndbuf=16384)
    client = TN.NetworkSource("127.0.0.1", server.port)
    _wait(lambda: server.frames_dropped > 0)  # the sender is blocked
    t0 = time.perf_counter()
    server.stop()
    assert time.perf_counter() - t0 < 4.0
    assert not server._thread.is_alive()
    client.close()


def test_server_reaccepts_after_a_disconnect():
    server = _server(_source("port"), max_frames=3)
    try:
        c1 = TN.NetworkSource("127.0.0.1", server.port)
        assert c1.next_frame() is not None
        c1.close()  # gone mid-stream
        deadline = time.monotonic() + 10.0
        while True:
            try:
                c2 = TN.NetworkSource("127.0.0.1", server.port, timeout_s=2.0)
                break
            except (ConnectionError, OSError):
                assert time.monotonic() < deadline
                time.sleep(0.05)
        assert len(_read_all(c2)) == 3
    finally:
        server.stop()


def test_server_max_frames_takes_no_extra_frame():
    source = _BigSource(h=8, w=8)
    with TN.FramesetStreamServer(source, fps=0.0, max_frames=3) as server:
        got = _read_all(TN.NetworkSource("127.0.0.1", server.port))
    assert len(got) == 3 and source.pulled == 3


def test_source_crash_aborts_the_stream_loudly():
    """A source failure on the camera host reaches the fusion host as a
    ConnectionError, not as the clean end, and stays an error."""
    with _server(_BigSource(h=8, w=8, crash_after=2)) as server:
        client = TN.NetworkSource("127.0.0.1", server.port)
        assert client.next_frame() is not None and client.next_frame() is not None
        with pytest.raises(ConnectionError, match="aborted mid-stream"):
            client.next_frame()
        with pytest.raises(ConnectionError):
            client.next_frame()
        client.close()


def test_clean_end_keeps_its_tail():
    """A slow client at the end of a bounded stream still gets every frame:
    the end marker waits for the sender to drain."""
    server = _server(_source("port"), queue_size=2, max_frames=7)
    try:
        client = TN.NetworkSource("127.0.0.1", server.port)
        time.sleep(0.2)  # the producer reaches the end while the client waits
        got = 0
        while client.next_frame() is not None:
            got += 1
            time.sleep(0.02)
        assert got == 7 and server.frames_dropped == 0
    finally:
        server.stop()


def test_clean_end_drain_is_bounded_for_a_wedged_client(monkeypatch):
    """A client that stopped reading holds the end marker back; after
    DRAIN_TIMEOUT_S without progress the server closes it without the
    marker (the JAX server would wait until stop()), and serves the next
    client."""
    monkeypatch.setattr(TN, "DRAIN_TIMEOUT_S", 0.3)
    source = _BigSource()
    server = _server(source, queue_size=2, max_frames=6, sndbuf=16384)
    wedged = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    wedged.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    try:
        wedged.connect(("127.0.0.1", server.port))
        t0 = time.monotonic()
        _wait(lambda: source.pulled == 6)  # the producer reached the end
        _wait(lambda: server._conn is None, timeout=5.0)  # the client was closed
        assert time.monotonic() - t0 < 4.0 and server.frames_sent == 0
        wedged.settimeout(5.0)
        received = 0
        try:
            while chunk := wedged.recv(1 << 16):
                received += len(chunk)
        except ConnectionResetError:
            pass
        # Not one whole frame, so no end marker after it.
        assert received < len(server._handshake) + 4 + 480 * 640 * 5
        client = TN.NetworkSource("127.0.0.1", server.port)
        assert client.next_frame() is not None
        client.close()
    finally:
        wedged.close()
        server.stop()


@pytest.fixture
def mock_rs(monkeypatch):
    mockrs._reset()
    monkeypatch.setitem(sys.modules, "pyrealsense2", mockrs)
    yield mockrs
    mockrs._reset()


def _realsense(mod, **device):
    mockrs._reset()
    mockrs.add_device(**device)
    return mod.RealsenseSource(model="D455", width=160, height=120, warmup_frames=4)


def test_realsense_source_matches_jax(mock_rs):
    """On the same scripted device, the port's RealsenseSource yields the
    JAX one's frames (aligned, temporally filtered), intrinsics and depth
    scale; its calibration lies on the CPU."""
    device = dict(seed=7, depth_scale=0.00025, distortion_model=mockrs.distortion.brown_conrady,
                  coeffs=(-0.05, 0.06, 0.001, -0.002, -0.01))
    srcs = {"jax": _realsense(JRS, **device)}
    jframes = [srcs["jax"].next_frame() for _ in range(3)]
    srcs["port"] = _realsense(TRS, **device)
    tframes = [srcs["port"].next_frame() for _ in range(3)]
    for j, t in zip(jframes, tframes):
        np.testing.assert_array_equal(t.depth, j.depth)
        np.testing.assert_array_equal(t.color, j.color)
        assert t.depth_scale == j.depth_scale == 0.00025
    assert np.diff([f.timestamp for f in tframes]) == pytest.approx(
        np.diff([f.timestamp for f in jframes]), abs=1e-9)
    ti, ji = srcs["port"].intrinsics, srcs["jax"].intrinsics
    assert ti.fx.device.type == "cpu" and srcs["port"].depth_to_color.rotation.device.type == "cpu"
    assert (ti.width, ti.height, int(ti.model)) == (ji.width, ji.height, int(ji.model)) == (
        160, 120, int(TDist.BROWN_CONRADY))
    for key in ("fx", "fy", "ppx", "ppy", "coeffs"):
        np.testing.assert_array_equal(getattr(ti, key).numpy(), np.asarray(getattr(ji, key)))
    assert set(TRS._RS_DISTORTION) == set(JRS._RS_DISTORTION) == set(range(6))


def test_realsense_bridge_serves_the_jax_fusion_host(mock_rs):
    """The bridge as a camera host: RealsenseSource → the port's server →
    the JAX package's NetworkSource, bit-exact, with the source's depth
    scale and identity extrinsics."""
    src = _realsense(TRS, n_frames=16, seed=3)
    server = TN.FramesetStreamServer(src, name="camera_left", fps=src.fps,
                                     depth_to_color=src.depth_to_color, max_frames=3).start()
    try:
        net = JN.NetworkSource("127.0.0.1", server.port)
        got = _read_all(net)
        np.testing.assert_array_equal(np.asarray(net.depth_to_color.rotation), np.eye(3))
    finally:
        server.stop()
        src.stop()
    want = _realsense(TRS, n_frames=16, seed=3)
    assert len(got) == 3
    for fs in got:
        w = want.next_frame()
        np.testing.assert_array_equal(fs.depth, w.depth)
        np.testing.assert_array_equal(fs.color, w.color)
        assert fs.depth_scale == src.depth_scale


def test_realsense_without_pyrealsense2_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)  # the import fails
    with pytest.raises(RuntimeError, match="pyrealsense2 is not installed"):
        TRS.RealsenseSource()


def test_console_scripts_resolve_to_callables():
    """Every pdf-torch-* entry point in pyproject.toml names a callable in a
    port module; tests/test_torch_port_hygiene.py imports them all in a
    fresh interpreter and finds no jax there."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if k.startswith("pdf-torch-")}
    assert sorted(ours) == ["pdf-torch-camera", "pdf-torch-demo", "pdf-torch-launch",
                            "pdf-torch-realsense", "pdf-torch-rig", "pdf-torch-serve"]
    for target in ours.values():
        mod, _, fn = target.partition(":")
        assert mod.startswith("pointcloud_depthfusion_tpu_torch."), target
        assert callable(getattr(importlib.import_module(mod), fn)), target
