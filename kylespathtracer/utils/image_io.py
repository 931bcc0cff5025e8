"""Image export.

The reference displays frames via GL swap (render.cpp:231-278) and never
writes files; a headless renderer needs real exporters. PNG encoding
uses the native C++ encoder (native/, loaded via ctypes) when built, with a
pure-Python zlib fallback; PPM needs nothing.

Renderer images are float [0,1] RGB with row 0 at the *bottom* (GL fragCoord
convention, see render/camera.py); exporters flip to top-down file order.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _to_u8(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # bottom-up render rows → top-down file rows


def save_ppm(path, image) -> None:
    img = _to_u8(image)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def save_png(path, image) -> None:
    """PNG via the native encoder when available, else Python zlib."""
    from kylespathtracer.utils import native as native_mod

    img = _to_u8(image)
    if native_mod.available():
        native_mod.write_png(str(path), img)
        return

    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    Path(path).write_bytes(out)


def save_image(path, image) -> None:
    path = str(path)
    if path.endswith(".ppm"):
        save_ppm(path, image)
    else:
        save_png(path, image)
