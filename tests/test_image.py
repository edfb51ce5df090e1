"""PNG writing and reading without an imaging package (io/image.py)."""

import os
import struct
import zlib

import numpy as np
import pytest

from caitlyn.io.image import load_png, save_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 3), (48, 64, 3)])
def test_png_round_trip(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.random(shape).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    back = load_png(path)
    assert back.shape == shape and back.dtype == np.float32
    np.testing.assert_array_equal(back, np.round(img * 255.0) / 255.0)


def _encode(pix: np.ndarray, ftype: int) -> bytes:
    """A minimal encoder applying one PNG row filter to every row."""
    h, w, ch = pix.shape
    rows = pix.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for r in rows:
        left = np.concatenate([np.zeros(ch, np.int64), r[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(r)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((r - pred) % 256).astype(np.uint8).tobytes()
        prev = r

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_row_filters(tmp_path, ftype):
    """Every row filter decodes, for grey, RGB and RGBA."""
    rng = np.random.default_rng(ftype)
    for ch in (1, 3, 4):
        pix = rng.integers(0, 256, (6, 9, ch), dtype=np.uint8)
        path = tmp_path / f"f{ftype}_{ch}.png"
        path.write_bytes(_encode(pix, ftype))
        got = load_png(str(path))
        want = np.repeat(pix, 3, axis=2) if ch == 1 else pix[:, :, :3]
        np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)


def test_png_reader_reads_committed_golden():
    """The committed golden PNG (written by another encoder) decodes to its
    float golden, quantized."""
    png = load_png(os.path.join(REPO, "scenes", "golden", "cornell_64_cpu.png"))
    ref = np.load(os.path.join(REPO, "scenes", "golden", "cornell_64_cpu.npz"))["img"]
    np.testing.assert_array_equal(png, np.clip(np.floor(ref * 255.0 + 0.5), 0, 255) / 255.0)
