"""Host-side image bytes for the HTTP server: decode a request body, resize
it to the model's size, encode the mask as PNG.

Two codecs with one interface (``decode``, ``resize``, ``encode_png``):

- :class:`Cv2Codec`, the reference server's calls (``cv2.imdecode``,
  ``cv2.resize(INTER_LINEAR)``, ``cv2.imencode``), used when ``cv2`` imports;
- :class:`ZlibCodec` for machines without ``cv2``: PNG through ``zlib``
  (8-bit grey, RGB, grey+alpha and RGBA, non-interlaced, all five filters),
  and the port's half-pixel ``ops/resize.py::bilinear_resize`` rounded to
  uint8, which agrees with ``cv2.resize`` within one grey level. It reads no
  JPEG: such a body raises ``ValueError`` with a message that says so.

This is about the host's image bytes only; the model and the kernels run on
the predictor's device either way.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit, no palette)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey or (H, W, 3|4) uint8 -> PNG bytes (filter 0 on every
    row)."""
    a = np.ascontiguousarray(image)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"want (H, W) or (H, W, C) uint8, got {a.shape} {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    colour = {1: 0, 3: 2, 4: 6}.get(c)
    if colour is None:
        raise ValueError(f"unsupported channel count {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter. ``row`` and ``prev`` are uint8 vectors
    (``prev`` the unfiltered line above, zeros for the first)."""
    if kind == 0:
        return row
    if kind == 2:  # Up
        return row + prev
    n = row.size
    if kind == 1:  # Sub: a running sum per channel, modulo 256
        return np.cumsum(row.reshape(n // bpp, bpp), axis=0, dtype=np.uint8).reshape(n)
    # Average and Paeth depend on the pixel to the left: one pass in Python
    cur = bytearray(row.tobytes())
    up = prev.tobytes()
    if kind == 3:
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"bad PNG filter type {kind}")
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with the file's own channels (1, 2, 3 or
    4). 8 bits per sample, no palette, no interlace."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _compression, _filter, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}): want 8-bit grey/RGB/RGBA, non-interlaced")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data has the wrong length")
    lines = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = _unfilter_row(int(lines[y, 0]), lines[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w, bpp)


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, 1|2|3|4) -> (H, W, 3): grey replicated, alpha dropped."""
    c = image.shape[2]
    if c in (1, 2):
        return np.repeat(image[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(image[:, :, :3])


class ZlibCodec:
    """PNG only, through ``zlib``; resize through the port's bilinear."""

    name = "zlib"

    def decode(self, data: bytes) -> np.ndarray:
        """Request body -> (H, W, 3) uint8 RGB."""
        if data[:2] == b"\xff\xd8":
            raise ValueError("JPEG bodies need cv2, which is not installed here: "
                             "send a PNG (8-bit grey, RGB or RGBA)")
        if not data.startswith(PNG_SIGNATURE):
            raise ValueError("undecodable image")
        return to_rgb(decode_png(data))

    def resize(self, image: np.ndarray, height: int, width: int) -> np.ndarray:
        import torch

        from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize

        if image.shape[:2] == (height, width):
            return np.ascontiguousarray(image)
        x = torch.from_numpy(np.ascontiguousarray(image)).float()[None]
        y = bilinear_resize(x, height, width)[0]
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).numpy()

    def encode_png(self, grey: np.ndarray) -> bytes:
        return encode_png(grey)


class Cv2Codec:
    """The reference server's OpenCV calls."""

    name = "cv2"

    def __init__(self) -> None:
        import cv2

        self._cv2 = cv2

    def decode(self, data: bytes) -> np.ndarray:
        cv2 = self._cv2
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("undecodable image")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def resize(self, image: np.ndarray, height: int, width: int) -> np.ndarray:
        return self._cv2.resize(image, (width, height), interpolation=self._cv2.INTER_LINEAR)

    def encode_png(self, grey: np.ndarray) -> bytes:
        ok, png = self._cv2.imencode(".png", grey)
        if not ok:
            raise ValueError("PNG encoding failed")
        return png.tobytes()


def default_codec():
    """:class:`Cv2Codec` when ``cv2`` imports, else :class:`ZlibCodec`."""
    try:
        return Cv2Codec()
    except ImportError:
        return ZlibCodec()
