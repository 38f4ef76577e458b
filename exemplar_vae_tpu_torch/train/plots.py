"""Image-grid artifacts (counterpart of exemplar_vae_tpu/train/plots.py).

Grids are assembled in numpy and written as 8-bit gray or RGB PNGs by the
standard library (zlib and struct): the port needs no imaging package.
``read_png`` reads back the files that ``save_grid`` writes.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}           # channels -> PNG color type (gray, RGB)


def make_grid(images: np.ndarray, ncol: int = None) -> np.ndarray:
    """(N, H, W, C) floats [0,1] -> (GH, GW, C) grid with 2px separators."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    if n == 0:
        # empty batch -> 1-cell blank grid (artifact writing must never
        # crash a finished run on a zero-sample config)
        return np.ones((h + 4, w + 4, c), np.float32)
    if ncol is not None and ncol < 1:
        raise ValueError(f"ncol must be >= 1, got {ncol}")
    ncol = ncol or int(math.ceil(math.sqrt(n)))
    nrow = int(math.ceil(n / ncol))
    pad = 2
    grid = np.ones((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = np.clip(images[i], 0, 1)
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def png_bytes(arr: np.ndarray) -> bytes:
    """(H, W, C) uint8 with C = 1 (gray) or 3 (RGB) -> a PNG file's bytes:
    8 bits per sample, no interlace, filter type 0 on every row."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG grids have 1 or 3 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_grid(images: np.ndarray, path: str, ncol: int = None):
    """Write make_grid(images, ncol) as a PNG, each value v stored as
    uint8(v * 255)."""
    grid = make_grid(images, ncol)
    with open(path, "wb") as f:
        f.write(png_bytes((grid * 255).astype(np.uint8)))


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 of a PNG written by save_grid (8-bit gray or RGB,
    filter type 0); raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: not an 8-bit gray or RGB PNG: {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read")
    return rows[:, 1:].reshape(h, w, channels).copy()
