"""Encoded (compressed) frameset containers.

A copy of pointcloud_depthfusion_tpu/io/encoded.py, byte for byte the same
format: one depth+color pair as 16-bit PNG depth, PNG color (rgb8) and the
timestamp and depth scale (the reference's EncodedFrameset message,
camera_interfaces/msg/Encoded*.msg), and ``.pdfe`` streams of them.
"""

from __future__ import annotations

import dataclasses
import io as _io
import struct
from typing import List

import numpy as np

from pointcloud_depthfusion_tpu_torch.core.frameset import HostFrameset

_MAGIC = b"PDFE"
_VERSION = 1
_HEADER = "<4sBddII"


@dataclasses.dataclass
class EncodedFrameset:
    """One compressed depth+color pair."""

    depth_png: bytes
    color_png: bytes
    timestamp: float
    depth_scale: float

    @staticmethod
    def encode(fs: HostFrameset) -> "EncodedFrameset":
        from PIL import Image  # noqa: PLC0415

        cbuf = _io.BytesIO()
        Image.fromarray(fs.color).save(cbuf, format="PNG", optimize=False)
        dbuf = _io.BytesIO()
        # Pillow infers I;16 from the uint16 dtype.
        Image.fromarray(fs.depth).save(dbuf, format="PNG")
        return EncodedFrameset(depth_png=dbuf.getvalue(), color_png=cbuf.getvalue(),
                               timestamp=fs.timestamp, depth_scale=fs.depth_scale)

    def decode(self) -> HostFrameset:
        from PIL import Image  # noqa: PLC0415

        color = np.asarray(Image.open(_io.BytesIO(self.color_png)))
        depth = np.asarray(Image.open(_io.BytesIO(self.depth_png)))
        if depth.dtype == np.int32:
            depth = depth.astype(np.uint16)
        return HostFrameset(depth=depth, color=color, timestamp=self.timestamp,
                            depth_scale=self.depth_scale)

    def to_bytes(self) -> bytes:
        header = struct.pack(_HEADER, _MAGIC, _VERSION, self.timestamp, self.depth_scale,
                             len(self.depth_png), len(self.color_png))
        return header + self.depth_png + self.color_png

    @staticmethod
    def from_bytes(data: bytes) -> "EncodedFrameset":
        # Bounds-checked, so a truncated blob fails here with a framing
        # message, not as a PIL error on a short PNG slice.
        hdr_size = struct.calcsize(_HEADER)
        if len(data) < hdr_size:
            raise ValueError(
                f"encoded frameset truncated: {len(data)} bytes < {hdr_size}-byte header")
        magic, version, ts, scale, dlen, clen = struct.unpack(_HEADER, data[:hdr_size])
        if magic != _MAGIC or version != _VERSION:
            raise ValueError(f"bad encoded frameset (magic {magic!r}, version {version})")
        if hdr_size + dlen + clen > len(data):
            raise ValueError(f"encoded frameset truncated: header claims {dlen}+{clen} "
                             f"payload bytes, got {len(data) - hdr_size}")
        return EncodedFrameset(
            depth_png=data[hdr_size:hdr_size + dlen],
            color_png=data[hdr_size + dlen:hdr_size + dlen + clen],
            timestamp=ts, depth_scale=scale,
        )


def write_encoded_stream(path: str, frames: List[HostFrameset]) -> None:
    """Append-framed container: [u32 length][EncodedFrameset bytes]..."""
    with open(path, "wb") as fh:
        for fs in frames:
            blob = EncodedFrameset.encode(fs).to_bytes()
            fh.write(struct.pack("<I", len(blob)))
            fh.write(blob)


def read_encoded_stream(path: str) -> List[HostFrameset]:
    out: List[HostFrameset] = []
    with open(path, "rb") as fh:
        while True:
            len_bytes = fh.read(4)
            if len(len_bytes) < 4:
                break
            (n,) = struct.unpack("<I", len_bytes)
            out.append(EncodedFrameset.from_bytes(fh.read(n)).decode())
    return out
