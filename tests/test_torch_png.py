"""The port's PNG codec (numpy and zlib only) against imageio.

Every format the pipeline writes or reads (8-bit gray, RGB, RGBA; 16-bit
gray) at odd sizes, bit-equal both ways: the port's files read by
imageio, imageio's files read by the port.  Files whose rows use each of
the five PNG row filters, read by both.  No tolerance: the arrays must be
equal.
"""

import io
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from text2nerf_tpu_torch.data import io as pio
from text2nerf_tpu_torch.utils import png

FORMATS = [
    ((1, 1), np.uint8), ((3, 5), np.uint8), ((5, 3, 3), np.uint8), ((1, 1, 3), np.uint8),
    ((3, 5, 4), np.uint8), ((17, 9, 3), np.uint8), ((1, 1), np.uint16),
    ((3, 5), np.uint16), ((33, 17), np.uint16),
]


def _arrays(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max + 1
    noise = rng.integers(0, hi, shape).astype(dtype)
    # smooth ramps: imageio's encoder picks other row filters for them
    ramp = np.cumsum(np.cumsum(rng.integers(0, 3, shape), 0), 1).astype(dtype)
    return noise, ramp


@pytest.mark.parametrize("shape,dtype", FORMATS)
def test_png_round_trips_through_imageio_both_ways(shape, dtype):
    for a in _arrays(shape, dtype, seed=sum(shape)):
        buf = io.BytesIO()
        imageio.imwrite(buf, a, format="png")
        ours = png.decode_png(buf.getvalue())
        assert ours.dtype == a.dtype and ours.shape == a.shape
        np.testing.assert_array_equal(ours, a)
        theirs = np.asarray(imageio.imread(png.encode_png(a)))
        assert theirs.dtype == a.dtype and theirs.shape == a.shape
        np.testing.assert_array_equal(theirs, a)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, bpp, depth, ctype):
    """A PNG whose row y uses filter y % 5, filtered by the PNG spec's
    rules written out byte by byte."""
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).reshape(h, -1)
    raw = rows.view(np.uint8).astype(int)
    out = bytearray()
    for y in range(h):
        kind = y % 5
        out.append(kind)
        for x in range(raw.shape[1]):
            a = raw[y, x - bpp] if x >= bpp else 0
            b = raw[y - 1, x] if y > 0 else 0
            c = raw[y - 1, x - bpp] if (y > 0 and x >= bpp) else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((raw[y, x] - pred) % 256)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,dtype,ctype", [
    ((11, 7, 3), np.uint8, 2), ((10, 6, 4), np.uint8, 6), ((12, 5), np.uint8, 0),
    ((10, 9), np.uint16, 0),
])
def test_png_reads_all_five_row_filters(shape, dtype, ctype):
    a = _arrays(shape, dtype, seed=7)[1]
    depth = 16 if dtype == np.uint16 else 8
    bpp = (shape[2] if len(shape) == 3 else 1) * depth // 8
    blob = _filtered_png(a, bpp, depth, ctype)
    np.testing.assert_array_equal(np.asarray(imageio.imread(blob)), a)  # the file is valid
    got = png.decode_png(blob)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


def test_scene_io_reads_what_the_jax_package_writes(tmp_path):
    from text2nerf_tpu.data import io as jio

    rng = np.random.default_rng(3)
    rgb = rng.random((7, 9, 3)).astype(np.float32)
    counts = rng.uniform(0, 70000, (7, 9))
    jio.write_rgb(str(tmp_path / "j" / "rgb.png"), rgb)
    jio.write_depth_png(str(tmp_path / "j" / "d.png"), counts)
    pio.write_rgb(str(tmp_path / "p" / "rgb.png"), rgb)
    pio.write_depth_png(str(tmp_path / "p" / "d.png"), counts)
    for side in ("j", "p"):
        for reader in (jio, pio):
            np.testing.assert_array_equal(reader.read_rgb(str(tmp_path / side / "rgb.png")),
                                          jio.read_rgb(str(tmp_path / "j" / "rgb.png")))
            np.testing.assert_array_equal(reader.read_depth_raw(str(tmp_path / side / "d.png")),
                                          jio.read_depth_raw(str(tmp_path / "j" / "d.png")))
    np.testing.assert_array_equal(pio.depth_process(counts, 0), jio.depth_process(counts, 0))
    np.testing.assert_array_equal(pio.depth_process(counts, 2), jio.depth_process(counts, 2))


def test_png_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2, 3), np.uint16))
    with pytest.raises(ValueError):
        png.decode_png(b"not a png")
