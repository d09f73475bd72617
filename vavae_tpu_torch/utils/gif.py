"""The port's GIF reader: what PIL 12's ``GifImagePlugin`` makes of the first
frame of a GIF87a or GIF89a file, then ``convert("RGB")``.

The headers are read here as the plugin reads them, quirks included:
- the canvas is the logical screen, grown to hold a first frame that
  passes its edge; outside the frame it holds the transparency index of a
  graphic control extension before the frame, else index 0 (never the
  background index, which only later frames use);
- the colours are the frame's local palette, else the global one; a
  palette whose entries are 0, 1, 2, ... in gray is dropped (a local one so
  dropped leaves the global one in use), and with neither the indices are
  read as gray; an index past the palette reads black; ``convert`` ignores
  transparency;
- extension blocks (graphic control, comment, application, plain text)
  are skipped sub-block by sub-block, as are stray bytes between blocks;
  a zero-width frame at x = 0 covers the whole canvas.
The LZW data are decoded by ``native/lzw_decoder.cpp`` (``gif_decode``),
which follows PIL's decoder and its reads: interlaced rows in four passes,
codes of up to 12 bits, the deferred clear, an EOI before the frame is full
needing more of the file than it holds; the indices are expanded there to
RGB too. What PIL refuses raises
``ValueError``: headers cut short, a file with no frame, a frame that
leaves the canvas empty, broken or truncated LZW data, and canvases past
PIL's decompression-bomb limit. ctypes releases the interpreter lock for
both calls, so threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import struct
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.native.build import load_library
from vavae_tpu_torch.utils.pil_limits import bomb_check

MAGICS = (b"GIF87a", b"GIF89a")
_ERR_LEN = 256
_GRAY = bytes(v for i in range(256) for v in (i, i, i))  # the palette of indices read as gray


def is_gif(head: bytes) -> bool:
    """Whether ``head`` (a file's first 6 bytes or more) starts a GIF."""
    return head[:6] in MAGICS


def _library() -> ctypes.CDLL:
    lib = load_library("lzw_decoder")
    if not getattr(lib, "_vavae_gif_bound", False):
        lib.gif_decode.restype = ctypes.c_int
        lib.gif_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.palette_rgb.restype = None
        lib.palette_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_void_p]
        lib._vavae_gif_bound = True
    return lib


class _Frame:
    """What the plugin's ``_open`` and ``_seek(0)`` read."""
    width: int  # of the canvas
    height: int
    box: tuple  # (x0, y0, x1, y1) of the frame
    interlace: bool
    bits: int  # the LZW minimum code size
    offset: int  # of the LZW data
    palette: Optional[bytes]  # None: the indices are gray
    transparency: Optional[int]


class _File:
    """``fp.read`` over bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        s = self.data[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def block(self) -> Optional[bytes]:
        """The plugin's ``data()``: one sub-block, None at a terminator."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def _needed(p: bytes) -> bool:
    """``_is_palette_needed``: False for a gray ramp 0, 1, 2, ..."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _u16(s: bytes, pos: int) -> int:
    if pos + 2 > len(s):
        raise ValueError("GIF header cut short")
    return struct.unpack_from("<H", s, pos)[0]


def _frame(data: bytes) -> _Frame:
    fp = _File(data)
    s = fp.read(13)
    if not is_gif(s):
        raise ValueError("not a GIF file")
    fr = _Frame()
    fr.width, fr.height = _u16(s, 6), _u16(s, 8)
    if len(s) < 13:
        raise ValueError("GIF header cut short")
    flags = s[10]
    global_palette = None
    if flags & 128:
        p = fp.read(3 << ((flags & 7) + 1))
        try:
            if _needed(p):
                global_palette = p
        except IndexError:
            raise ValueError("GIF palette cut short") from None
    s = fp.read(1)
    if not s or s == b";":
        raise ValueError("no more images in GIF file")
    palette, fr.transparency, interlace = None, None, None
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = fp.read(1)
            if not s:
                raise ValueError("GIF extension cut short")
            block = fp.block()
            if s[0] == 249 and block is not None:
                if not block:
                    raise ValueError("GIF graphic control extension cut short")
                if block[0] & 1:
                    if len(block) < 4:
                        raise ValueError("GIF graphic control extension cut short")
                    fr.transparency = block[3]
                _u16(block, 1)  # the duration, which the plugin reads
            elif s[0] == 254:
                while block:
                    block = fp.block()
                s = b""
                continue
            elif s[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                fp.block()
            while fp.block():
                pass
        elif s == b",":
            s = fp.read(9)
            x0, y0 = _u16(s, 0), _u16(s, 2)
            x1, y1 = x0 + _u16(s, 4), y0 + _u16(s, 6)
            if x1 > fr.width or y1 > fr.height:
                fr.width, fr.height = max(x1, fr.width), max(y1, fr.height)
                bomb_check(fr.width, fr.height)
            fr.box = (x0, y0, x1, y1)
            if len(s) < 9:
                raise ValueError("GIF image descriptor cut short")
            interlace = bool(s[8] & 64)
            if s[8] & 128:
                p = fp.read(3 << ((s[8] & 7) + 1))
                try:
                    palette = p if _needed(p) else False
                except IndexError:
                    raise ValueError("GIF palette cut short") from None
            b = fp.read(1)
            if not b:
                raise ValueError("GIF image data cut short")
            fr.bits, fr.offset = b[0], fp.pos
            break
        s = b""
    if interlace is None:
        raise ValueError("image not found in GIF frame")
    fr.interlace = interlace
    fr.palette = palette or global_palette or None  # a dropped local one leaves the global
    if fr.width <= 0 or fr.height <= 0:
        raise ValueError(f"GIF of {fr.width}x{fr.height} pixels")
    bomb_check(fr.width, fr.height)
    return fr


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """GIF bytes → (H, W, 3) uint8: the first frame on its canvas, as PIL's
    ``convert("RGB")`` makes it. ``name`` labels the errors."""
    try:
        fr = _frame(data)
        x0, y0, x1, y1 = fr.box
        if x0 == 0 and x1 == 0:  # PIL's setimage: the whole image
            x0, y0, x1, y1 = 0, 0, fr.width, fr.height
        if x1 - x0 <= 0 or y1 - y0 <= 0:
            raise ValueError("tile cannot extend outside image")
        fill = fr.transparency if fr.transparency is not None else 0
        idx = np.full((fr.height, fr.width), fill, np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        if _library().gif_decode(data, len(data), fr.offset, fr.bits, int(fr.interlace),
                                 idx.ctypes.data, fr.width, x0, y0, x1 - x0, y1 - y0, err,
                                 _ERR_LEN) != 0:
            raise ValueError(err.value.decode(errors="replace"))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if fr.palette is None:  # gray: the index itself
        pal = _GRAY
    else:  # black past the palette
        n = len(fr.palette) // 3
        pal = fr.palette[:3 * n] + bytes(3 * (256 - n))
    out = np.empty(idx.shape + (3,), np.uint8)
    _library().palette_rgb(idx.ctypes.data, idx.size, pal, out.ctypes.data)
    return out


def read_gif(path: str) -> np.ndarray:
    """The GIF at ``path`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_gif(f.read(), path)


def gif_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """Why ``read_gif`` refuses the file open as ``f``, judged on its headers
    up to the first frame's, without decoding; None for a file that passes
    them or is not a GIF. ``head`` holds the file's first bytes; the rest is
    read only when the headers run past them."""
    if not is_gif(head):
        return None
    try:
        fr = _frame(head)
    except ValueError:  # perhaps headers cut at the end of ``head``
        try:
            fr = _frame(head + f.read())
        except ValueError as e:
            return str(e)
    x0, y0, x1, y1 = fr.box
    if not (x0 == 0 and x1 == 0) and (x1 - x0 <= 0 or y1 - y0 <= 0):
        return "tile cannot extend outside image"
    return None
