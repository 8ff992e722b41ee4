"""Minimal PNG writer (grayscale 8-bit), zlib + struct only.

The label service returns image bytes over REST like the reference's
QrCodeGenerator (QRCode.to(ImageType.PNG).stream()); no imaging dependency
is needed for lossless grayscale output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png_gray(img: np.ndarray) -> bytes:
    """uint8 [H, W] grayscale -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("expected uint8 [H, W] grayscale image")
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit gray
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def read_png_gray(data: bytes) -> np.ndarray:
    """Inverse of write_png_gray for round-trip tests (only the subset this
    module writes: 8-bit grayscale, filter 0)."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG")
    pos = len(_SIG)
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", body)
            if depth != 8 or ctype != 0:
                raise ValueError("unsupported PNG subset")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    out = np.zeros((h, w), np.uint8)
    stride = w + 1
    for r in range(h):
        line = raw[r * stride:(r + 1) * stride]
        if line[0] != 0:
            raise ValueError("unsupported PNG filter")
        out[r] = np.frombuffer(line[1:], np.uint8)
    return out
