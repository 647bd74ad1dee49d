"""PNG reader and writer on numpy, `zlib` and `struct` (the port's stand-in
for PIL, which the card's machine does not have).

Reads non-interlaced 8-bit grey, grey-alpha, RGB and RGBA, and 16-bit grey
(TUM depth frames), with rows in any of the five filter types. Writes 8-bit
RGB and 16-bit grey. Anything else (palette, interlaced, other bit depths)
raises ValueError.

Filters run per byte, against the byte one pixel to the left (a), the byte
above (b) and the byte above-left (c). Sub, Up and None rows are whole-row
numpy operations. Average and Paeth chain along a row, so an image holding
such rows (PIL's encoder picks a filter per row) is reconstructed along
anti-diagonals: every pixel of one anti-diagonal depends only on the two
before it, so each step is one numpy operation over up to `height` pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the (colour type, bit depth) pairs read
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_READABLE = {(0, 8), (0, 16), (2, 8), (4, 8), (6, 8)}
_NONE, _SUB, _UP, _AVERAGE, _PAETH = range(5)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_rows(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Rows of only None, Sub and Up filters: (H, W, bpp) uint8."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for r in range(len(filt)):
        row = filt[r]
        if ftype[r] == _SUB:
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif ftype[r] == _UP:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_diagonals(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any filters: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    all on the two anti-diagonals before r + x."""
    h, w, bpp = filt.shape
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)   # zero row and column
    filt = filt.astype(np.int32)
    rows_all = np.arange(h)
    for k in range(h + w - 1):
        r = rows_all[max(0, k - w + 1):min(h - 1, k) + 1]
        x = k - r
        a = rec[r + 1, x]
        b = rec[r, x + 1]
        c = rec[r, x]
        t = ftype[r][:, None]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == _SUB, t == _UP, t == _AVERAGE, t == _PAETH],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: (H, W) for grey, (H, W, C) otherwise; uint8, or
    uint16 for 16-bit grey."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if (colour, depth) not in _READABLE:
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth "
                         f"{depth} is not supported")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"expected {height * (1 + width * bpp)}")
    raw = raw.reshape(height, 1 + width * bpp)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > _PAETH:
        raise ValueError(f"{path}: unknown PNG filter type {ftype.max()}")
    filt = raw[:, 1:].reshape(height, width, bpp)
    if np.isin(ftype, (_AVERAGE, _PAETH)).any():
        pix = _unfilter_diagonals(filt, ftype)
    else:
        pix = _unfilter_rows(filt, ftype)
    if depth == 16:
        return pix.reshape(height, width, 2).view(">u2")[..., 0] \
            .astype(np.uint16)
    return pix[..., 0] if channels == 1 else pix


def write_png(path: str, image: np.ndarray) -> None:
    """Encode (H, W, 3) uint8 as 8-bit RGB or (H, W) uint16 as 16-bit grey,
    every row Sub-filtered."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        colour, depth, pix = 2, 8, image
    elif image.dtype == np.uint16 and image.ndim == 2:
        colour, depth = 0, 16
        pix = image.astype(">u2").view(np.uint8).reshape(*image.shape, 2)
    else:
        raise ValueError(f"write_png takes (H, W, 3) uint8 or (H, W) uint16, "
                         f"not {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    pix = np.ascontiguousarray(pix)
    sub = pix.copy()
    sub[:, 1:] -= pix[:, :-1]                         # wraps modulo 256
    rows = np.concatenate([np.full((height, 1), _SUB, np.uint8),
                           sub.reshape(height, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                             depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
