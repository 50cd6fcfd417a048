"""Native library (C++) vs Python implementations: Sobol, mt19937, PNG."""

import io
import struct
import zlib

import numpy as np
import pytest

from sphereflake.ops.noise import MT19937
from sphereflake.ops.sobol import (
    NUM_DIMENSIONS,
    direction_numbers,
    sobol_sample_np,
)
from sphereflake.runtime import native
from sphereflake.utils.image import encode_png_python

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@needs_native
def test_native_direction_numbers_match_python():
    ours = direction_numbers()
    theirs = native.sobol_direction_numbers(NUM_DIMENSIONS)
    np.testing.assert_array_equal(ours, theirs)


@needs_native
def test_native_sobol_batch_matches_python():
    for base in (0, 1, 7, 1000, 2**33 - 5):
        got = native.sobol_sample_batch(base, 64, 1)
        idx = np.arange(base, base + 64, dtype=np.uint64)
        want = sobol_sample_np(idx, 1)
        np.testing.assert_allclose(got, want, atol=0)


@needs_native
def test_native_sobol_scrambled():
    scr = np.arange(32, dtype=np.uint32) * 2654435761
    got = native.sobol_sample_batch(5, 32, 0, scr)
    idx = np.arange(5, 37, dtype=np.uint64)
    want = np.array([sobol_sample_np(np.array([i]), 0, s)[0]
                     for i, s in zip(idx, scr)])
    np.testing.assert_allclose(got, want, atol=0)


@needs_native
def test_native_mt19937_matches_python():
    a = native.mt19937_draw(12512, 2000)
    b = MT19937(12512).draw(2000)
    np.testing.assert_array_equal(a, b)
    # skip path
    c = native.mt19937_draw(12512, 10, skip=1990)
    np.testing.assert_array_equal(c, b[1990:])


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        cur = np.zeros(stride, np.int32)
        for x in range(stride):
            a = cur[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)


@needs_native
def test_native_png_roundtrip():
    rng = np.random.default_rng(0)
    img = (rng.random((13, 17, 3)) * 255).astype(np.uint8)
    # smooth region to exercise Paeth prediction
    img[4:9, 3:12] = np.linspace(0, 200, 9, dtype=np.uint8)[None, :, None]
    data = native.encode_png_native(img)
    decoded = _decode_png(data)
    np.testing.assert_array_equal(decoded, img)


def test_python_png_roundtrip():
    rng = np.random.default_rng(1)
    img = (rng.random((9, 11, 3)) * 255).astype(np.uint8)
    decoded = _decode_png(encode_png_python(img))
    np.testing.assert_array_equal(decoded, img)
