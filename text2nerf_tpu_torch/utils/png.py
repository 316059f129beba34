"""PNG reading and writing with numpy and zlib only.

The port's image files go through here, so a machine with no imageio,
PIL or OpenCV can write and read every image the pipeline makes.

- :func:`write_png`: 8-bit gray ``(H, W)``, RGB ``(H, W, 3)`` or RGBA
  ``(H, W, 4)`` from ``uint8``; 16-bit gray ``(H, W)`` from ``uint16``
  (the depth counts of ``data/io.py``).  Rows are stored unfiltered.
- :func:`read_png`: the same formats and gray + alpha, at bit depth 8 or
  16, with any of the five row filters; non-interlaced files only.  Gray
  and RGB come back ``(H, W)`` and ``(H, W, 3)``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of ``image`` as bytes (see the module docstring)."""
    a = np.asarray(image)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.dtype == np.uint16:
        if a.ndim != 2:
            raise ValueError(f"16-bit PNGs are gray only, got shape {a.shape}")
        depth, ctype = 16, 0
    elif a.dtype == np.uint8:
        depth = 8
        if a.ndim == 2:
            ctype = 0
        elif a.ndim == 3 and a.shape[-1] in (3, 4):
            ctype = 2 if a.shape[-1] == 3 else 6
        else:
            raise ValueError(f"cannot write a PNG of shape {a.shape}")
    else:
        raise ValueError(f"PNG samples must be uint8 or uint16, got {a.dtype}")
    h, w = a.shape[:2]
    if h < 1 or w < 1:
        raise ValueError(f"empty image {a.shape}")
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 of raw sample bytes."""
    if len(data) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, 0, dtype=np.uint64) % 256).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = bytearray(stride)
            up = prior.tolist()
            src = line.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """The image of a PNG file's bytes (see the module docstring)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        payload = blob[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"PNG colour type {ctype} at bit depth {depth}")
    if interlace:
        raise NotImplementedError("interlaced PNGs are not supported")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = raw.view(">u2").astype(np.uint16)
    else:
        img = raw
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
