"""A small PNG reader and writer on ``zlib``, for the command-line drivers.

Reads non-interlaced 8-bit PNGs of colour types grey (0), RGB (2), grey +
alpha (4) and RGBA (6), with all five row filters (None, Sub, Up, Average,
Paeth); anything else (palettes, 16-bit samples, Adam7 interlacing) raises
``ValueError``.  ``to_luma`` is Pillow's ``convert("L")`` in its exact
integer form, so a frame reads the same here as through Pillow.  Writes
8-bit grey, RGB or RGBA with one row filter for every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed image data."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum of each sample along the row
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256)
            cur = cur.astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for grey, (H, W, C) uint8 for grey + alpha, RGB and RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey, grey+alpha, RGB and RGBA PNGs are "
                         f"read (bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)


def to_luma(img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("L")`` of an image from ``read_png``: grey as it
    is, grey + alpha drops the alpha, RGB(A) -> (19595 R + 38470 G + 7471 B
    + 0x8000) >> 16 (ITU-R 601-2 luma in 16-bit fixed point)."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return luma.astype(np.uint8)


def _filter_rows(img: np.ndarray, ftype: int, bpp: int) -> bytes:
    """Rows of (H, stride) uint8 under one filter type, each led by its type
    byte."""
    x = img.astype(np.int64)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    body = ((x - pred) % 256).astype(np.uint8)
    lead = np.full((img.shape[0], 1), ftype, np.uint8)
    return np.concatenate([lead, body], axis=1).tobytes()


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) grey or (H, W, C) grey + alpha / RGB / RGBA uint8 as an
    8-bit PNG, every row under ``filter_type`` (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or c not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4) images, got {img.shape}")
    h, w = img.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    data = zlib.compress(_filter_rows(img.reshape(h, w * c), filter_type, c))
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", data) + chunk(b"IEND", b""))
