"""AVI video writers and their reader (the port's copy of the JAX
package's ``utils/mjpeg_avi.py``, plus an uncompressed stream).

AVI 1.0 needs only a RIFF container around per-frame payloads:
- :func:`write_mjpeg_avi`: an 'MJPG' stream of JPEGs, which PIL encodes;
- :func:`write_rgb_avi`: an uncompressed 'DIB ' stream (BI_RGB, 24-bit
  bottom-up BGR rows padded to 4 bytes), numpy only: a video with a real
  frame rate where no image library is installed;
- :func:`read_mjpeg_avi`: the frames of either back (JPEGs decoded by
  PIL, bitmaps by numpy).

Layout (all little-endian):
  RIFF('AVI ' LIST('hdrl' avih LIST('strl' strh strf)) LIST('movi'
  00dc|00db ...) idx1)
"""

from __future__ import annotations

import io
import struct

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_BI_RGB = 0


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def _encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _frames_u8(frames):
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    return frames


def _write_avi(path, payloads, w, h, fps, handler, compression, chunk_id, image_size):
    """The RIFF container around ``payloads`` (one bytes object a frame):
    one video stream of ``handler`` frames stored as ``chunk_id`` chunks,
    with a keyframe index."""
    n = len(payloads)
    max_size = max(len(p) for p in payloads)
    avih = struct.pack(
        "<14I",
        int(1e6 / max(fps, 1)),            # dwMicroSecPerFrame
        max_size * fps,                    # dwMaxBytesPerSec
        0,                                 # dwPaddingGranularity
        _AVIF_HASINDEX,                    # dwFlags
        n, 0, 1,                           # frames, initial, streams
        max_size,                          # dwSuggestedBufferSize
        w, h,
        0, 0, 0, 0,                        # dwReserved
    )
    strh = (
        b"vids" + handler
        + struct.pack(
            "<IHHIIIIIIII",
            0, 0, 0,                       # flags, priority, language
            0,                             # initial frames
            1, max(fps, 1),                # scale, rate → fps
            0, n,                          # start, length
            max_size,                      # suggested buffer
            0xFFFFFFFF,                    # quality (-1: default)
            0,                             # sample size
        )
        + struct.pack("<4h", 0, 0, w, h)   # rcFrame
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, compression, image_size, 0, 0, 0, 0,
    )
    hdrl = _list(
        b"hdrl",
        _chunk(b"avih", avih)
        + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)),
    )

    # list + join (not bytes +=): quadratic concatenation costs GBs of
    # memcpy on a 600-frame render video
    movi_parts, index_parts = [], []
    offset = 4  # idx1 offsets count from the 'movi' fourcc
    for p in payloads:
        index_parts.append(
            chunk_id + struct.pack("<III", _AVIIF_KEYFRAME, offset, len(p))
        )
        chunk = _chunk(chunk_id, p)
        movi_parts.append(chunk)
        offset += len(chunk)
    movi = _list(b"movi", b"".join(movi_parts))
    idx1 = _chunk(b"idx1", b"".join(index_parts))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return path


def write_mjpeg_avi(path: str, frames, fps: int = 30, quality: int = 9):
    """Write ``frames`` (iterable of (H, W, 3) uint8) as an MJPEG AVI.

    ``quality`` follows imageio's 0-10 scale (the evaluations pass 9)
    and maps to JPEG quality ``min(95, quality * 10)``.
    """
    frames = _frames_u8(frames)
    h, w = frames[0].shape[:2]
    jq = max(1, min(95, int(round(quality * 10))))
    jpegs = [_encode_jpeg(f, jq) for f in frames]
    return _write_avi(path, jpegs, w, h, fps, b"MJPG", b"MJPG", b"00dc", w * h * 3)


def _dib_rows(frame: np.ndarray) -> bytes:
    """One (H, W, 3) uint8 RGB frame as a BI_RGB bitmap: rows bottom-up,
    BGR, each padded with zeros to a multiple of 4 bytes."""
    h, w = frame.shape[:2]
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 3 * w] = frame[::-1, :, ::-1].reshape(h, 3 * w)
    return rows.tobytes()


def write_rgb_avi(path: str, frames, fps: int = 30):
    """Write ``frames`` (iterable of (H, W, 3) uint8) as an uncompressed
    RGB AVI: every frame's pixels stored as they are."""
    frames = _frames_u8(frames)
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError("frames must all be (H, W, 3) of one size")
    bitmaps = [_dib_rows(f) for f in frames]
    return _write_avi(path, bitmaps, w, h, fps, b"DIB ", struct.pack("<I", _BI_RGB),
                      b"00db", len(bitmaps[0]))


def read_mjpeg_avi(path: str):
    """The frames ((H, W, 3) uint8) of an AVI written by
    :func:`write_mjpeg_avi` or :func:`write_rgb_avi`: the movi list's
    '00dc' chunks JPEG-decoded (PIL), its '00db' chunks read as BI_RGB
    bitmaps of the stream format's size."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI")
    pos = data.find(b"strf")
    if pos < 0:
        raise ValueError(f"{path}: no stream format")
    w, h = struct.unpack("<ii", data[pos + 12:pos + 20])
    pos = data.find(b"movi")
    if pos < 0:
        raise ValueError(f"{path}: no movi list")
    pos += 4
    stride = (3 * w + 3) & ~3
    frames = []
    while pos + 8 <= len(data) and data[pos:pos + 4] in (b"00dc", b"00db"):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        payload = data[pos + 8:pos + 8 + size]
        if data[pos:pos + 4] == b"00dc":
            from PIL import Image

            frames.append(np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")))
        else:
            rows = np.frombuffer(payload, np.uint8).reshape(h, stride)[:, :3 * w]
            frames.append(np.ascontiguousarray(rows.reshape(h, w, 3)[::-1, :, ::-1]))
        pos += 8 + size + (size % 2)
    return frames
