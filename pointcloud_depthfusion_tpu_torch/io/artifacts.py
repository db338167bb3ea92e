"""Debug artifact dumps: PNG images and PLY point clouds. A copy of
pointcloud_depthfusion_tpu/io/artifacts.py (numpy and PIL only; the
reference's save_data PNG path, depth_frame.cpp:201-228, and its PLY
dumps, registration_node.cpp:344-350): ``save_ply`` writes the same bytes
as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_png(path: str, image: np.ndarray) -> None:
    """Save uint8 RGB/L or uint16 L images (PNG 16-bit for depth)."""
    from PIL import Image  # noqa: PLC0415

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(image)
    # Pillow infers "I;16" for uint16 arrays (passing mode= is deprecated).
    Image.fromarray(arr).save(path)


def load_png(path: str) -> np.ndarray:
    from PIL import Image  # noqa: PLC0415

    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype == np.int32:  # PIL loads 16-bit as I (int32)
        arr = arr.astype(np.uint16)
    return arr


def save_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write an (N, 3) float cloud (+optional uint8 colors) as PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    has_color = colors is not None
    if has_color:
        cols = np.asarray(colors, np.uint8).reshape(-1, 3)
        if cols.shape[0] != n:
            raise ValueError(
                f"{cols.shape[0]} colors for {n} points in save_ply"
            )

    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply",
        f"format {fmt} 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if has_color:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header.append("end_header")

    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                # Explicit little-endian floats: the header declares
                # binary_little_endian, and np.float32 is NATIVE order —
                # on a big-endian host the colorless branch ('<f4') would
                # be correct while this one wrote garbage coordinates.
                rec = np.zeros(
                    n,
                    dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                )
                rec["xyz"] = pts
                rec["rgb"] = cols
                fh.write(rec.tobytes())
            else:
                fh.write(pts.astype("<f4").tobytes())
        else:
            for i in range(n):
                line = f"{pts[i,0]} {pts[i,1]} {pts[i,2]}"
                if has_color:
                    line += f" {cols[i,0]} {cols[i,1]} {cols[i,2]}"
                fh.write((line + "\n").encode())


def load_ply(path: str, return_colors: bool = False):
    """Minimal PLY reader for x/y/z (float32) vertices, ascii or binary.

    ``return_colors=True`` additionally returns the (N, 3) uint8 RGB
    properties when present (zeros otherwise).
    """
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        fmt = "ascii"
        props = []
        # Track the CURRENT element while scanning: property lines belong
        # to the most recent element declaration, so a `element face ...`
        # section's properties must not inflate the vertex record size.
        current_element = None
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                current_element = line.split()[1]
                if current_element == "vertex":
                    n = int(line.split()[-1])
            elif line.startswith("property") and current_element == "vertex":
                props.append(line.split())
        prop_names = [p[2] for p in props if len(p) == 3]
        has_color = {"red", "green", "blue"} <= set(prop_names)
        if fmt == "ascii":
            # Index properties by NAME (like the binary path's offsets):
            # a vertex element with e.g. nx/ny/nz between xyz and the color
            # triple would break positional vals[3:6] parsing, and float-
            # typed color properties would raise under int().
            if {"x", "y", "z"} <= set(prop_names):
                xi, yi, zi = (prop_names.index(k) for k in ("x", "y", "z"))
            else:  # header without property lines: assume x y z leading
                xi, yi, zi = 0, 1, 2
            if has_color:
                ci = [prop_names.index(k) for k in ("red", "green", "blue")]
            pts = []
            cols = []
            for _ in range(n):
                vals = fh.readline().split()
                pts.append([float(vals[xi]), float(vals[yi]), float(vals[zi])])
                if has_color:
                    cols.append([int(float(vals[j])) for j in ci])
            xyz = np.asarray(pts, np.float32).reshape(n, 3)
            if return_colors:
                rgb = (
                    np.asarray(cols, np.uint8).reshape(n, 3)
                    if has_color else np.zeros((n, 3), np.uint8)
                )
                return xyz, rgb
            return xyz
        # Binary: build a numpy structured dtype from the property list so
        # every field is read at its declared offset, dtype, AND byte
        # order — x/y/z preceded by normals (or double-typed) and
        # big-endian files all parse correctly, byte-identically to the
        # name-indexed ascii path.
        if fmt == "binary_little_endian":
            endian = "<"
        elif fmt == "binary_big_endian":
            endian = ">"
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")
        np_types = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "ushort": "u2", "int": "i4", "uint": "u4",
        }
        fields = [
            (p[2], endian + np_types[p[1]]) for p in props if len(p) == 3
        ]
        if not fields:  # header without property lines: assume x y z f32
            fields = [(k, endian + "f4") for k in ("x", "y", "z")]
        rec = np.dtype(fields)
        names = [f[0] for f in fields]
        kx, ky, kz = (
            ("x", "y", "z") if {"x", "y", "z"} <= set(names) else names[:3]
        )
        raw = fh.read(n * rec.itemsize)
        arr = np.frombuffer(raw, dtype=rec, count=n)
        out = np.stack(
            [arr[kx], arr[ky], arr[kz]], axis=-1
        ).astype(np.float32)
        if return_colors:
            rgb = (
                np.stack(
                    [arr["red"], arr["green"], arr["blue"]], axis=-1
                ).astype(np.uint8)
                if has_color else np.zeros((n, 3), np.uint8)
            )
            return out, rgb
        return out
