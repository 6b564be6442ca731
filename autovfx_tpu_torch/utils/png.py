"""PNG files with the standard library only (``zlib``, ``struct``).

The machine that runs the port on the card has no image library, so the
edit layer writes its frames and reads its instance masks here:
8-bit greyscale, greyscale + alpha, RGB, RGBA and palette images, not
interlaced; every scanline filter.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples/pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) image;
    every scanline unfiltered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = np.ascontiguousarray(img).reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = buf[y, 0], buf[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:  # a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind in (3, 4):  # depend on the pixel to the left
            cur = np.zeros(stride, np.int32)
            up = prev
            for x0 in range(0, stride, bpp):
                x = slice(x0, x0 + bpp)
                left = cur[x0 - bpp:x0] if x0 else np.zeros(bpp, np.int32)
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    ul = prev[x0 - bpp:x0] if x0 else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up[x], ul)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG as uint8 (H, W) (greyscale) or (H, W, C); a palette image
    comes back as RGB."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, palette = len(_SIGNATURE), [], None
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace or color_type not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {color_type}, interlace {interlace})")
    channels = _CHANNELS[color_type]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                    channels).reshape(h, w, channels)
    if color_type == 3:
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img


def read_mask(path: str) -> np.ndarray:
    """(H, W) bool: the image's luminance (ITU-R 601-2, in integers as
    image libraries convert to greyscale) above 127."""
    img = read_png(path)
    if img.ndim == 3 and img.shape[2] == 2:  # greyscale + alpha
        img = img[..., 0]
    elif img.ndim == 3:
        rgb = img[..., :3].astype(np.int64)
        img = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470
               + rgb[..., 2] * 7471 + 0x8000) >> 16
    return img > 127
