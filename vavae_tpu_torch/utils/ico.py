"""The port's ICO and CUR reader: what PIL 12's ``IcoImagePlugin`` and
``CurImagePlugin`` make of a Windows icon or cursor, then
``convert("RGB")``.

- ICO: the directory's entries are sorted as ``IcoFile`` sorts them,
  largest first (width × height, a size byte of 0 meaning 256), then by
  colour depth (the bit count, else the log2 of the colour count, else
  256), else in file order, and the first is read. A PNG payload is decoded
  by ``utils/png.py``; any other payload is a DIB (``utils/bmp.py``'s
  ``layout`` and ``pixels``) whose lower half of rows is the image.
  Its AND mask (or, for an entry of 32 bits, its alpha bytes) only makes the
  alpha, which ``convert`` drops, but PIL reads it, so a file too short for
  it is refused. The image's own size stands where the directory's
  disagrees.
- CUR: the first entry, or a later one larger in both directory sizes; its
  payload is a DIB, read at half its height.
A file these plugins decline as they open it (a directory cut short or
empty, a DIB of no rows), ``Image.open`` hands to its other plugins: an
uncompressed TGA file starts with the bytes of a cursor's magic. Those
files raise ``NeedsPil``. What PIL refuses raises ``ValueError``: a payload
it refuses, a DIB of one row, a mask past the file, and images past PIL's
decompression-bomb limit.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.utils import bmp, png
from vavae_tpu_torch.utils.pil_limits import NeedsPil, bomb_check

ICO_MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"
_PNG = b"\x89PNG\r\n\x1a\n"


def is_ico(head: bytes) -> bool:
    """Whether ``head`` (a file's first 4 bytes or more) starts an icon or
    a cursor."""
    return head[:4] in (ICO_MAGIC, CUR_MAGIC)


class _Entry:
    """One ``IconHeader`` of the directory."""

    def __init__(self, s: bytes):
        if len(s) < 16:
            raise NeedsPil("an ICO file whose directory is cut short")
        self.width, self.height = s[0] or 256, s[1] or 256
        nb_color = s[2]
        self.bpp, self.size, self.offset = struct.unpack_from("<HII", s, 6)
        self.square = self.width * self.height
        self.color_depth = (self.bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2)))
                            or 256)


def _icon(data: bytes) -> _Entry:
    """The entry ``IcoImageFile`` reads."""
    (n,) = struct.unpack_from("<H", data, 4)
    entries = [_Entry(data[6 + 16 * i:22 + 16 * i]) for i in range(n)]
    entries.sort(key=lambda e: e.color_depth)
    entries.sort(key=lambda e: e.square, reverse=True)
    if not entries:
        raise NeedsPil("an ICO file without images")
    return entries[0]


def _dib_mask(data: bytes, entry: _Entry, lay) -> None:
    """Refuses the icon whose AND mask (alpha bytes for 32 bits) PIL cannot
    read whole."""
    w, h = lay.width, lay.height
    if entry.bpp == 32:
        if len(data) - min(lay.offset, len(data)) < 4 * w * h:
            raise ValueError("buffer is not large enough")
        return
    w32 = w + (-w % 32)
    total = w32 * h // 8
    at = entry.offset + entry.size - total
    if at < 0:
        raise ValueError(f"negative seek value {at}")
    if len(data[at:at + total]) < (h - 1) * (w32 // 8) + (w + 7) // 8:
        raise ValueError("not enough image data")


def _cursor(data: bytes) -> int:
    """The DIB offset of the entry ``CurImageFile`` reads."""
    (n,) = struct.unpack_from("<H", data, 4)
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif not s:
            raise NeedsPil("a CUR file whose directory is cut short")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if len(m) < 16:
        raise NeedsPil("a CUR file without cursors" if not m else
                       "a CUR file whose directory is cut short")
    return struct.unpack_from("<I", m, 12)[0]


def _payload(data: bytes):
    """The payload PIL reads, checked as PIL checks it before decoding:
    ("png", its offset) or ("dib", its layout, at half its height)."""
    if not is_ico(data):
        raise ValueError("not an ICO or CUR file")
    if len(data) < 6:
        raise NeedsPil("an ICO or CUR file cut short")
    if data[:4] == CUR_MAGIC:
        lay = bmp.layout(data, _cursor(data))
        lay.height //= 2
        if lay.width <= 0 or lay.height <= 0:  # PIL's ImageFile declines it
            raise NeedsPil(f"a CUR file of {lay.width}x{lay.height} pixels")
        bomb_check(lay.width, lay.height)
        return "dib", lay
    entry = _icon(data)
    if data[entry.offset:entry.offset + 8] == _PNG:
        bomb_check(*struct.unpack(">II", data[entry.offset + 16:entry.offset + 24]))
        return "png", entry.offset
    lay = bmp.layout(data, entry.offset)
    if lay.width <= 0 or lay.height <= 0:  # the DIB's ImageFile declines it
        raise NeedsPil(f"an ICO file of a {lay.width}x{lay.height} DIB")
    bomb_check(lay.width, lay.height)
    lay.height //= 2
    if lay.height <= 0:
        raise ValueError("tile cannot extend outside image")
    _dib_mask(data, entry, lay)
    return "dib", lay


def decode_ico(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """ICO or CUR bytes → (H, W, 3) uint8, as PIL's ``convert("RGB")``
    makes it. ``name`` labels the errors. Raises ``NeedsPil`` (with the
    reason alone) for a file these plugins decline."""
    try:
        kind, payload = _payload(data)
        if kind == "png":
            return png._rgb(png.decode_png(data[payload:]))
        return bmp.pixels(data, payload)
    except (ValueError, struct.error, zlib.error) as e:
        raise ValueError(f"{name}: {e}") from None


def read_ico(path: str) -> np.ndarray:
    """The icon or cursor at ``path`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_ico(f.read(), path)


def ico_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """Why ``read_ico`` refuses the icon or cursor open as ``f``, judged on
    its directory and payload headers, without decoding; None for a file
    that passes them or is neither. Raises ``NeedsPil`` for a file these
    plugins decline. The whole file is read, since the payload may lie
    anywhere in it."""
    if not is_ico(head):
        return None
    try:
        _payload(head + f.read())
    except (ValueError, struct.error) as e:
        return str(e)
    return None
