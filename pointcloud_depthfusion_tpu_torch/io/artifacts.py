"""Debug artifact dumps: ``save_png``, a copy of the function of
pointcloud_depthfusion_tpu/io/artifacts.py (the reference's save_data PNG
path, depth_frame.cpp:201-228). PLY and the loaders are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np


def save_png(path: str, image: np.ndarray) -> None:
    """Save uint8 RGB/L or uint16 L images (PNG 16-bit for depth)."""
    from PIL import Image  # noqa: PLC0415

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(image)
    # Pillow infers "I;16" for uint16 arrays (passing mode= is deprecated).
    Image.fromarray(arr).save(path)
