"""Image output.

The reference presents frames to a GLFW window (`main.cpp:301-335`);
this build is headless, so the display path becomes PNG/NPZ output. PNG
encoding prefers the native C++ encoder (sphereflake.runtime.native)
when built, with a pure-Python zlib fallback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """[H, W, 3] float image -> uint8 with the GL-style clamp to [0,1]."""
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    chunk = tag + payload
    return struct.pack(">I", len(payload)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def encode_png_python(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0, zlib)."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _png_chunk(b"IHDR", ihdr),
            _png_chunk(b"IDAT", zlib.compress(raw, 6)),
            _png_chunk(b"IEND", b""),
        ]
    )


def write_png(path: str, img) -> None:
    """Write a float [H, W, 3] image (or uint8) as PNG."""
    rgb = img if getattr(img, "dtype", None) == np.uint8 else to_uint8(img)
    try:
        from sphereflake.runtime.native import encode_png_native

        data = encode_png_native(rgb)
    except Exception:
        data = encode_png_python(rgb)
    with open(path, "wb") as f:
        f.write(data)


def write_gbuffer_npz(path: str, position, normal, min_t, image=None) -> None:
    """Save raw G-buffer planes (the reference's RGBA32F textures);
    `image` optionally adds the composited frame (float RGB) — the
    target surface for image-loss fitting (`fit.image_loss`)."""
    planes = dict(
        position=np.asarray(position),
        normal=np.asarray(normal),
        min_t=np.asarray(min_t),
    )
    if image is not None:
        planes["image"] = np.asarray(image)
    np.savez_compressed(path, **planes)


def shade_normals(normal, hit=None, background=0.12) -> np.ndarray:
    """Debug shading: normals remapped to RGB (G-buffer visualization)."""
    n = np.asarray(normal)
    img = n * 0.5 + 0.5
    if hit is not None:
        img = np.where(np.asarray(hit)[..., None], img, background)
    return img
