"""TCP frameset streaming: the cross-machine capture transport.

A copy of pointcloud_depthfusion_tpu/io/network.py, byte for byte the same
wire protocol, so a camera host of either package feeds a fusion host of
the other. The reference's two-host deployment moves framesets between
machines over DDS (camera_node on each Jetson → fusion_node,
README.md:14-34). Here a **camera host** (any machine that produces
framesets: a RealSense box, a recording, the synthetic renderer) runs
:class:`FramesetStreamServer`, and the fusion host reads it through
:class:`NetworkSource`, a plain FramesetSource that plugs into CameraNode,
DeviceFeeder and FusionNodeApp like any local source.

Wire protocol (version 1, little-endian):

  handshake:  b"PDFN" | u8 version | u32 json_len | json
              json = {name, fps, codec, intrinsics, extrinsic_rotation
              (row-major 9), extrinsic_translation (3)}
              (the GetCameraParameters service, camera_node.cpp:377-386,
              folded into connection setup; the depth scale rides in
              every frame)
  per frame:  u32 blob_len | frame blob
  end:        u32 0  (clean end of stream)

Two frame codecs, named by the handshake's ``codec``:

  "png"  (default): an EncodedFrameset blob (io/encoded.py: PNG depth and
         color), ~10× smaller, one PNG encode per frame on the camera host.
  "raw"  the uncompressed pair the reference's DDS DepthFrameset carries:
         u32 h | u32 w | f64 timestamp | f32 depth_scale | h·w u16 depth |
         h·w·3 u8 color. No encode cost; ~4.6 MB a frame at 1280×720.

QoS follows the reference's sensor-data profile: a bounded queue per
client that drops the OLDEST frame when the consumer falls behind
(keep-last, camera_node.cpp:104-114), so a slow link lowers the frame rate
and never grows the latency.

Everything here is host work: calibration is read and sent as numpy and
Python floats, and every tensor this module builds lies on the CPU, so a
camera-host process never initialises CUDA.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import sys
import threading
import time
import traceback
from typing import Optional, Sequence

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.camera import (
    Distortion,
    Extrinsics,
    Intrinsics,
    intrinsics_as_numpy,
)
from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu_torch.io.encoded import EncodedFrameset
from pointcloud_depthfusion_tpu_torch.io.feeder import FramesetSource

_MAGIC = b"PDFN"
_VERSION = 1
# Producer→sender marker for a source failure: the sender closes the
# connection without the clean u32(0) end, so the fusion host raises
# ConnectionError instead of reading the crash as the end of the stream.
_ABORT = object()
# Caps on the peer's u32 length fields: a desynced, corrupt or hostile
# sender must not drive a multi-GB allocation on the fusion host.
_MAX_HANDSHAKE_BYTES = 1 << 20  # 1 MB of calibration JSON
_MAX_FRAME_BYTES = 64 << 20  # 64 MB a frame (a 4K raw pair is ~41 MB)
# How long a clean end waits for the sender to make progress on a client
# that stopped reading, before it closes the client without the end marker.
DRAIN_TIMEOUT_S = 5.0


def _intrinsics_to_json(intr: Intrinsics) -> dict:
    fx, fy, ppx, ppy = intrinsics_as_numpy(intr)
    return {
        "width": int(intr.width),
        "height": int(intr.height),
        "fx": fx,
        "fy": fy,
        "ppx": ppx,
        "ppy": ppy,
        "model": int(intr.model),
        "coeffs": [float(c) for c in intr.coeffs.cpu().numpy().reshape(-1)],
    }


def _intrinsics_from_json(d: dict) -> Intrinsics:
    return Intrinsics.create(
        d["width"], d["height"], fx=d["fx"], fy=d["fy"], ppx=d["ppx"], ppy=d["ppy"],
        model=Distortion(d.get("model", int(Distortion.NONE))),
        coeffs=d.get("coeffs", [0.0] * 5), device="cpu",
    )


def _encode_raw(fs: HostFrameset) -> bytes:
    depth = np.ascontiguousarray(fs.depth, dtype="<u2")
    color = np.ascontiguousarray(fs.color, dtype=np.uint8)
    h, w = depth.shape
    header = struct.pack("<IIdf", h, w, fs.timestamp, fs.depth_scale)
    return header + depth.tobytes() + color.tobytes()


def _decode_raw(blob: bytes) -> HostFrameset:
    hdr = struct.calcsize("<IIdf")
    if len(blob) < hdr:
        raise ConnectionError(f"raw frame truncated ({len(blob)} bytes)")
    h, w, ts, scale = struct.unpack("<IIdf", blob[:hdr])
    n_d = h * w * 2
    # h and w come from the wire: check them against the blob before
    # frombuffer reads it.
    if h == 0 or w == 0 or h > 16384 or w > 16384:
        raise ConnectionError(f"implausible raw frame geometry {h}x{w}")
    if len(blob) != hdr + n_d + h * w * 3:
        raise ConnectionError(f"raw frame size mismatch: {len(blob)} bytes for {h}x{w}")
    depth = np.frombuffer(blob, dtype="<u2", count=h * w, offset=hdr).reshape(h, w)
    color = np.frombuffer(blob, dtype=np.uint8, count=h * w * 3,
                          offset=hdr + n_d).reshape(h, w, 3)
    return HostFrameset(depth=depth.copy(), color=color.copy(), timestamp=ts, depth_scale=scale)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # One preallocated buffer filled by recv_into: appending to bytes would
    # copy the whole message again for every chunk the kernel hands over.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("stream closed mid-message")
        got += k
    return bytes(buf)


def _close_socket(conn: socket.socket) -> None:
    """Shut a connection down both ways and close it; a sender blocked in
    ``sendall`` on it then fails with OSError."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


class FramesetStreamServer:
    """Stream a FramesetSource's frames to one TCP client at a time.

    The capture side of the two-host deployment. ``queue_size`` bounds the
    per-client backlog (drop-oldest, like SensorDataQoS keep-last). The
    server accepts the next client after one disconnects, until
    :meth:`stop`. ``frames_sent`` and ``frames_dropped`` count frames;
    ``capture_s`` and ``encode_s`` the seconds spent in the source and in
    the codec.
    """

    def __init__(
        self,
        source: FramesetSource,
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "camera",
        fps: float = 30.0,
        depth_to_color: Optional[Extrinsics] = None,
        queue_size: int = 4,
        max_frames: Optional[int] = None,
        sndbuf: Optional[int] = None,
        codec: str = "png",
    ):
        """``fps``: the send pacing (0: unpaced). ``max_frames``: frames
        served to each client before the clean end. ``sndbuf``: SO_SNDBUF
        of client connections; a small one bounds the kernel's backlog so
        the drop-oldest QoS engages promptly (loopback TCP autotunes to
        many MB). ``codec``: "png" (compressed, thin links) or "raw" (no
        encode cost, the reference's uncompressed DDS; wired LAN)."""
        if codec not in ("png", "raw"):
            raise ValueError(f"codec must be 'png' or 'raw', not {codec!r}")
        self.codec = codec
        self.source = source
        self.name = name
        self.fps = fps
        # Calibration stays on the host as numpy.
        if depth_to_color is not None:
            self._ext_rot = depth_to_color.rotation.cpu().numpy().astype(np.float64)
            self._ext_t = depth_to_color.translation.cpu().numpy().astype(np.float64)
        else:
            self._ext_rot = np.eye(3)
            self._ext_t = np.zeros(3)
        self.queue_size = queue_size
        self.max_frames = max_frames
        self.sndbuf = sndbuf
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self._sock.settimeout(0.5)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn: Optional[socket.socket] = None  # the active client, for stop()
        # Updated from the producer and the sender threads.
        self._stats_lock = threading.Lock()
        self.frames_sent = 0
        self.frames_dropped = 0
        self.capture_s = 0.0
        self.encode_s = 0.0
        # Built once, here, and sent to every client.
        self._handshake = self._handshake_blob()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FramesetStreamServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Close the active client too: a sender blocked in sendall (a
        # stalled client with the kernel's buffer full) never sees _stop;
        # closing its socket fails the send, and the serve loop ends.
        conn = self._conn
        if conn is not None:
            _close_socket(conn)
        try:
            # Wakes a serve loop waiting in accept() at once.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=5.0)
        self._sock.close()

    def __enter__(self) -> "FramesetStreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals ---------------------------------------------------------

    def _handshake_blob(self) -> bytes:
        payload = json.dumps(
            {
                "name": self.name,
                "fps": self.fps,
                "codec": self.codec,
                "intrinsics": _intrinsics_to_json(self.source.intrinsics),
                "extrinsic_rotation": self._ext_rot.reshape(-1).tolist(),
                "extrinsic_translation": self._ext_t.reshape(-1).tolist(),
            }
        ).encode()
        return _MAGIC + struct.pack("<BI", _VERSION, len(payload)) + payload

    def _encode(self, fs: HostFrameset) -> bytes:
        return _encode_raw(fs) if self.codec == "raw" else EncodedFrameset.encode(fs).to_bytes()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conn = conn
            try:
                self._stream_to(conn)
            except (ConnectionError, OSError):
                pass  # the client went away: accept the next one
            finally:
                self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass

    def _sent(self) -> int:
        with self._stats_lock:
            return self.frames_sent

    def _stream_to(self, conn: socket.socket) -> None:
        if self.sndbuf:
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, self.sndbuf)
        conn.sendall(self._handshake)
        # Encode on a producer thread, so a stalled socket cannot stall
        # capture; the bounded drop-oldest queue is the best-effort QoS.
        q: "queue.Queue" = queue.Queue(self.queue_size)
        done = threading.Event()

        def drop_oldest() -> None:
            try:
                q.get_nowait()
                with self._stats_lock:
                    self.frames_dropped += 1
            except queue.Empty:
                pass

        def end(marker) -> None:
            """Hand the end (None) or abort marker to the sender, even
            through a full queue. A clean end waits for the sender to
            drain, so a bounded stream keeps its tail; when the sender makes
            no progress for DRAIN_TIMEOUT_S (a client that stopped reading),
            the client is closed without the end marker. An abort drops
            queued frames to get through at once."""
            sent, deadline = self._sent(), time.monotonic() + DRAIN_TIMEOUT_S
            while not (self._stop.is_set() or done.is_set()):
                try:
                    q.put(marker, timeout=0.1)
                    return
                except queue.Full:
                    if marker is not None:
                        drop_oldest()
                        continue
                now_sent = self._sent()
                if now_sent != sent:
                    sent, deadline = now_sent, time.monotonic() + DRAIN_TIMEOUT_S
                elif time.monotonic() > deadline:
                    print(f"{self.name}: client read nothing for {DRAIN_TIMEOUT_S} s at the "
                          "end of the stream; closing it", file=sys.stderr, flush=True)
                    _close_socket(conn)
                    return

        def produce() -> None:
            period = 1.0 / self.fps if self.fps > 0 else 0.0
            sent = 0
            while not (self._stop.is_set() or done.is_set()):
                t0 = time.perf_counter()
                # The cap is checked before the fetch: fetching frame N+1 to
                # discard it would consume a frame of a non-looping source.
                if self.max_frames is not None and sent >= self.max_frames:
                    fs = None
                else:
                    try:
                        fs = self.source.next_frame()
                    except Exception:  # noqa: BLE001 - ends the stream loudly
                        traceback.print_exc(file=sys.stderr)
                        fs = _ABORT
                if fs is None or fs is _ABORT:
                    end(fs)
                    return
                t1 = time.perf_counter()
                blob = self._encode(fs)
                with self._stats_lock:
                    self.capture_s += t1 - t0
                    self.encode_s += time.perf_counter() - t1
                sent += 1
                while True:
                    try:
                        q.put(blob, timeout=0.1)
                        break
                    except queue.Full:
                        drop_oldest()  # keep-last QoS
                    if self._stop.is_set() or done.is_set():
                        return
                if period:
                    dt = time.perf_counter() - t0
                    if dt < period:
                        time.sleep(period - dt)

        prod = threading.Thread(target=produce, daemon=True)
        prod.start()
        try:
            while not self._stop.is_set():
                try:
                    blob = q.get(timeout=0.5)
                except queue.Empty:
                    if not prod.is_alive():
                        # The producer ended without a marker the sender
                        # could reach: abort, never a clean end.
                        print(f"{self.name}: producer died, aborting client", file=sys.stderr,
                              flush=True)
                        return
                    continue
                if blob is None:
                    conn.sendall(struct.pack("<I", 0))  # clean end
                    return
                if blob is _ABORT:
                    return  # a source failure: close without the end marker
                conn.sendall(struct.pack("<I", len(blob)) + blob)
                with self._stats_lock:
                    self.frames_sent += 1
        finally:
            done.set()
            prod.join(timeout=2.0)


class NetworkSource(FramesetSource):
    """FramesetSource over a TCP frameset stream (the fusion-host side).

    The constructor blocks until the handshake arrives; ``intrinsics`` and
    ``depth_to_color`` then carry the remote camera's calibration, on the
    CPU. ``frames_received``, ``recv_s`` and ``decode_s`` count the frames
    read and the seconds spent receiving and decoding them.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        try:
            self._sock.settimeout(timeout_s)
            magic = _recv_exact(self._sock, 4)
            if magic != _MAGIC:
                raise ConnectionError(f"not a PDFN stream (got {magic!r})")
            version, jlen = struct.unpack("<BI", _recv_exact(self._sock, 5))
            if version != _VERSION:
                raise ConnectionError(f"unsupported stream version {version}")
            if jlen > _MAX_HANDSHAKE_BYTES:
                raise ConnectionError(
                    f"handshake length {jlen} exceeds the {_MAX_HANDSHAKE_BYTES} byte cap "
                    "(desynced or hostile peer)")
            meta = json.loads(_recv_exact(self._sock, jlen).decode())
            self.name = meta.get("name", "camera")
            self.fps = float(meta.get("fps", 30.0))
            self.codec = meta.get("codec", "png")
            self._intr = _intrinsics_from_json(meta["intrinsics"])
            self.depth_to_color = Extrinsics.create(
                np.asarray(meta["extrinsic_rotation"], np.float64).reshape(3, 3),
                meta["extrinsic_translation"], device="cpu")
        except BaseException:
            # A failed handshake must not leak the connected socket.
            self._sock.close()
            raise
        self._ended = False
        self._failed: Optional[str] = None
        self.frames_received = 0
        self.recv_s = 0.0
        self.decode_s = 0.0

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def next_frame(self) -> Optional[HostFrameset]:
        if self._failed is not None:
            # The stream died on an error: keep raising, so a caller that
            # retries never reads the dead stream as a clean end.
            raise ConnectionError(self._failed)
        if self._ended:
            return None
        t0 = time.perf_counter()
        try:
            (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            if n == 0:  # clean end of stream
                self._ended = True
                self._sock.close()
                return None
            if n > _MAX_FRAME_BYTES:
                self.close()
                raise ConnectionError(
                    f"frame length {n} exceeds the {_MAX_FRAME_BYTES} byte cap (desynced or "
                    "hostile peer)")
            blob = _recv_exact(self._sock, n)
        except socket.timeout:
            # A gap beyond timeout_s is an error, not a clean end.
            self.close()
            self._failed = (f"no frame from {self.name} within the socket timeout — raise "
                            "NetworkSource(timeout_s=...) for slow senders")
            raise TimeoutError(self._failed)
        except (ConnectionError, OSError) as exc:
            # The server always ends with the 0-length marker: a close
            # without it means the peer died or the framing desynced.
            self.close()
            self._failed = f"frameset stream from {self.name} aborted mid-stream: {exc}"
            raise ConnectionError(self._failed) from exc
        t1 = time.perf_counter()
        # A payload that does not decode is a transport error too, and
        # latches like one.
        try:
            fs = _decode_raw(blob) if self.codec == "raw" else EncodedFrameset.from_bytes(
                blob).decode()
        except Exception as exc:  # noqa: BLE001 - reported as the transport's error
            self.close()
            self._failed = f"frameset stream from {self.name} delivered an undecodable frame: {exc}"
            raise ConnectionError(self._failed) from exc
        self.frames_received += 1
        self.recv_s += t1 - t0
        self.decode_s += time.perf_counter() - t1
        return fs

    def close(self) -> None:
        self._ended = True
        try:
            self._sock.close()
        except OSError:
            pass


def parse_tcp_source(spec: str):
    """``tcp://host:port`` → (host, port); the port defaults to 7447."""
    host, _, port = spec[len("tcp://"):].partition(":")
    return host, int(port or 7447)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Serve a camera over TCP (the camera-host process).

    ``python -m pointcloud_depthfusion_tpu_torch.io.network --name
    camera_left --port 7447`` streams the synthetic camera (the native
    renderer when the host runtime builds); ``--dataset rec.npz`` replays a
    recording instead. It prints the address it serves on, a status line
    every 5 s, and at exit (Ctrl-C or SIGINT) one JSON line: frames sent
    and dropped, the seconds spent capturing and encoding them, and
    whether CUDA was initialised (it never is: a camera host does no card
    work). ``argv``: the arguments (``None``: the command
    line).
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--name", default="camera_left", choices=["camera_left", "camera_right"])
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7447, help="0: any free port")
    parser.add_argument("--width", type=int, default=848)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--frames", type=int, default=0,
                        help="stop after N frames per client (0 = endless)")
    parser.add_argument("--codec", default="png", choices=["png", "raw"],
                        help="frame codec: png (compressed) or raw (reference DDS parity, "
                        "wired LAN)")
    parser.add_argument("--queue-size", type=int, default=4,
                        help="frames queued per client before the oldest is dropped")
    parser.add_argument("--dataset", default="",
                        help="replay a recorded .npz dataset (carries its own intrinsics) "
                        "instead of the synthetic camera")
    args = parser.parse_args(argv)

    import torch

    if args.dataset:
        from pointcloud_depthfusion_tpu_torch.io.recorded import RecordedSource

        source: FramesetSource = RecordedSource(args.dataset, loop=True)
    else:
        from pointcloud_depthfusion_tpu_torch.io.feeder import (
            NativeSyntheticSource,
            SyntheticSource,
        )
        from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene, two_camera_rig
        from pointcloud_depthfusion_tpu_torch.runtime import is_available

        w, h = args.width, args.height
        fx = 631.0 * w / 848.0
        intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2, device="cpu")
        wl, wr = two_camera_rig()
        pose = wl if args.name == "camera_left" else wr
        cls = NativeSyntheticSource if is_available() else SyntheticSource
        # The source always needs a timestamp cadence; --fps 0 only turns
        # the server's send pacing off.
        source = cls(SyntheticScene(), intr, pose, fps=args.fps or 30.0,
                     depth_noise_std=0.002, hole_fraction=0.01)

    server = FramesetStreamServer(
        source, host=args.host, port=args.port, name=args.name, fps=args.fps,
        max_frames=args.frames or None, codec=args.codec, queue_size=args.queue_size,
    )
    server.start()
    print(f"{args.name}: serving framesets on {server.host}:{server.port} ({args.fps} FPS, "
          f"{args.codec})", flush=True)
    try:
        while True:
            time.sleep(5)
            print(f"sent {server.frames_sent} dropped {server.frames_dropped}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print(json.dumps({"name": args.name, "codec": args.codec,
                          "frames_sent": server.frames_sent,
                          "frames_dropped": server.frames_dropped,
                          "capture_s": server.capture_s, "encode_s": server.encode_s,
                          "cuda_initialized": torch.cuda.is_initialized()}), flush=True)


if __name__ == "__main__":
    main()
