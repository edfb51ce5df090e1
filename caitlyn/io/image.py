"""PNG output and input (host side), written with zlib and struct only so
that rendering needs no imaging package.

Writes 8-bit RGB; reads 8-bit greyscale, RGB and RGBA, non-interlaced, with
any of the five PNG row filters (what common encoders produce)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type → samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def save_png(path: str, img) -> None:
    """Save an (H, W, 3) float [0,1] image as an 8-bit RGB PNG."""
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) % 256).reshape(-1)
        elif ftype == 2:  # Up
            cur = (line + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) // 2
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) % 256
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """Load a PNG as (H, W, 3) float32 in [0, 1] (alpha dropped, grey
    broadcast to RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced grey/RGB/RGBA PNGs are "
            f"supported (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    pix = pix.reshape(h, w, ch)
    rgb = np.repeat(pix, 3, axis=2) if ch == 1 else pix[:, :, :3]
    return rgb.astype(np.float32) / 255.0
