"""A small PNG codec in NumPy and zlib, for machines without Pillow.

:func:`read_png` decodes non-interlaced 8-bit PNGs (grayscale, RGB,
palette, grayscale + alpha, RGBA; every row filter) into what Pillow's
``Image.open(path).convert(mode)`` gives for mode "RGB" or "L";
:func:`write_png` writes 8-bit grayscale or RGB; :func:`png_hw` reads the
size from the header.  The input pipeline uses
Pillow where it is installed and this codec where it is not
(data/pipeline.py ``_decode``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:     # Sub: a running sum of each channel along the row
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0) & 255
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:     # Up
            cur = line + prev
        elif kind in (3, 4):   # Average, Paeth: each byte depends on its left
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def png_hw(path) -> tuple:
    """(height, width) of a PNG from its IHDR chunk, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read_png(path, mode: str = "RGB") -> np.ndarray:
    """u8 [H, W, 3] (mode "RGB") or [H, W] (mode "L", ITU-R 601-2 luma as
    Pillow computes it) of an 8-bit non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    idat, palette, head = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or interlace or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are read here "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w, ch)
    if color == 3:
        rgb = palette[px[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if mode == "L":
        if color in (0, 4):
            return np.ascontiguousarray(px[..., 0])
        r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
        return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"mode {mode!r}: expected RGB or L")


def write_png(path, image: np.ndarray) -> None:
    """Write u8 [H, W] (grayscale) or [H, W, 3] (RGB) as a PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
