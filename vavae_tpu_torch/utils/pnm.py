"""The port's PNM reader (numpy): what PIL 12's ``PpmImagePlugin`` makes of a
PBM, PGM, PPM or PFM file (``P1``-``P6``, ``Pf``), then ``convert("RGB")``.

It follows the plugin step by step, quirks included:
- the header: the magic up to the first whitespace (at most 6 bytes), then
  tokens of at most 10 bytes, separated by any whitespace, with ``#``
  comments running to the next CR or LF, even inside a token; numbers as
  Python's ``int`` reads them; the pixels start after the one whitespace
  byte that ends the last token; only the first image of a file is read;
- raw files (``P4``-``P6``): 1-bit rows of whole bytes, 1 black; 8-bit
  samples as they are at maxval 255; 16-bit gray at maxval 65535 (PIL's
  ``I;16B``) clipped to 255 by ``convert``; any other maxval scaled as
  ``round(v / maxval * out)``, Python's round (half to even), with ``out``
  255, or 65535 for gray whose maxval passes 255 (PIL's mode ``I``, which
  ``convert`` then clips to 255), samples past maxval clipped to ``out``;
- plain files (``P1``-``P3``): tokens read in PIL's blocks of 1 MiB, with
  its comment handling; a value past maxval, a negative one, one that is
  not a number or a token past 10 bytes refuses the file; a ``P1`` pixel
  is one byte, ``0`` or ``1``, whitespace between them optional;
- ``Pf`` (32-bit float gray, bottom row first, little-endian when the
  scale is negative): each value truncated toward 0 and clipped to 0-255,
  NaN as 0, as PIL takes mode ``F`` to RGB.
What PIL refuses raises ``ValueError``: a magic it does not know, a header
cut short, a token past 10 bytes, a maxval outside 1-65535, a scale of 0
or not finite, an empty image, pixel data cut short, and images past PIL's
decompression-bomb limit.
"""
from __future__ import annotations

import math
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.utils.pil_limits import bomb_check

MAGICS = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf")
_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"Pf": "F"}
_SAFEBLOCK = 1024 * 1024  # PIL's ImageFile.SAFEBLOCK: the plain decoders' read size


def is_pnm(head: bytes) -> bool:
    """Whether ``head`` (a file's first 2 bytes or more) starts a PBM, PGM,
    PPM or PFM file that this reader takes."""
    return head[:2] in MAGICS


class _Reader:
    """``fp.read(1)`` over bytes: at the end it returns b"" and stays."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.read1()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError("Reached EOF while reading header")
        if len(token) > 10:
            raise ValueError(f"Token too long in file header: {token.decode('latin-1')}")
        return token


class _Header:
    mode: str  # "1", "L", "RGB", "I" (gray past 8 bits) or "F"
    plain: bool
    width: int
    height: int
    maxval: int
    scale: float  # Pf: negative for little-endian
    offset: int  # of the pixel data


def _number(token: bytes, kind=int):
    try:
        return kind(token)
    except ValueError:
        raise ValueError(f"invalid PNM header token {token!r}") from None


def _header(data: bytes) -> _Header:
    r = _Reader(data)
    magic = b""
    for _ in range(6):
        c = r.read1()
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise ValueError("not a PPM file")
    hd = _Header()
    hd.mode, hd.plain = _MODES[magic], magic in (b"P1", b"P2", b"P3")
    hd.width, hd.height = _number(r.token()), _number(r.token())
    hd.maxval, hd.scale = 1, 1.0
    if hd.mode == "F":
        hd.scale = _number(r.token(), float)
        if hd.scale == 0.0 or not math.isfinite(hd.scale):
            raise ValueError("scale must be finite and non-zero")
    elif hd.mode != "1":
        hd.maxval = _number(r.token())
        if not 0 < hd.maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than 65536")
        if hd.maxval > 255 and hd.mode == "L":
            hd.mode = "I"
    hd.offset = r.pos
    if hd.width <= 0 or hd.height <= 0:
        raise ValueError(f"PNM of {hd.width}x{hd.height} pixels")
    bomb_check(hd.width, hd.height)
    return hd


def _raw(data: bytes, hd: _Header) -> np.ndarray:
    """``P4``-``P6`` and ``Pf``: (h, w) or (h, w, 3) values, 0-255 except
    mode I (0-65535, clipped later) and F (floats)."""
    w, h = hd.width, hd.height
    body = np.frombuffer(data, np.uint8, offset=min(hd.offset, len(data)))
    if hd.mode == "1":
        stride = (w + 7) // 8
        if body.size < stride * h:
            raise ValueError("image file is truncated")
        bits = np.unpackbits(body[:stride * h].reshape(h, stride), axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    if hd.mode == "F":
        if body.size < 4 * w * h:
            raise ValueError("image file is truncated")
        v = body[:4 * w * h].view("<f4" if hd.scale < 0 else ">f4").reshape(h, w)
        return v[::-1]
    bands = 3 if hd.mode == "RGB" else 1
    wide = hd.maxval > 255
    n = w * h * bands
    if body.size < n * (2 if wide else 1):
        raise ValueError("image file is truncated")
    v = body[:2 * n].view(">u2") if wide else body[:n]
    if hd.maxval != 255 and not (hd.maxval == 65535 and hd.mode == "I"):
        out = 65535 if hd.mode == "I" else 255
        v = np.minimum(out, np.rint(v / hd.maxval * out))
    shape = (h, w, 3) if bands == 3 else (h, w)
    return v.reshape(shape)


class _Blocks:
    """The plain decoders' reads: ``SAFEBLOCK`` bytes at a time from the
    pixel data, with comments cut as ``PpmPlainDecoder`` cuts them."""

    def __init__(self, data: bytes, offset: int):
        self.data, self.pos, self.spans = data, offset, False

    def read(self) -> bytes:
        block = self.data[self.pos:self.pos + _SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def uncommented(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block


def _plain_bits(data: bytes, hd: _Header) -> np.ndarray:
    total = hd.width * hd.height
    blocks, out = _Blocks(data, hd.offset), bytearray()
    while len(out) != total:
        block = blocks.read()
        if not block:
            break
        tokens = b"".join(blocks.uncommented(block).split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"Invalid token for this mode: {bad[:1].decode('latin-1')}")
        out = (out + tokens)[:total]
    if len(out) != total:
        raise ValueError("not enough image data")
    px = np.frombuffer(bytes(out), np.uint8).reshape(hd.height, hd.width)
    return np.where(px == ord("0"), 255, 0).astype(np.uint8)


def _plain_values(data: bytes, hd: _Header) -> np.ndarray:
    bands = 3 if hd.mode == "RGB" else 1
    out_max = 65535 if hd.mode == "I" else 255
    total = hd.width * hd.height * bands
    blocks, values, half = _Blocks(data, hd.offset), [], b""
    while len(values) != total:
        block = blocks.read()
        if not block:
            if not half:
                break
            block = b" "
        block = blocks.uncommented(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"Token too long found in data: {half[:11].decode('latin-1')}")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"Token too long found in data: {token[:11].decode('latin-1')}")
            value = _number(token)
            if value < 0:
                raise ValueError(f"Channel value is negative: {value}")
            if value > hd.maxval:
                raise ValueError(f"Channel value too large for this mode: {value}")
            values.append(round(value / hd.maxval * out_max))
            if len(values) == total:
                break
    if len(values) != total:
        raise ValueError("not enough image data")
    shape = (hd.height, hd.width, 3) if bands == 3 else (hd.height, hd.width)
    return np.array(values, np.int64).reshape(shape)


def _to_rgb(v: np.ndarray, mode: str) -> np.ndarray:
    if mode == "F":
        v = np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8)
    elif mode == "I":
        v = np.minimum(v, 255)
    v = v.astype(np.uint8)  # a copy: the raw samples are a view of the file's bytes
    return v if v.ndim == 3 else np.repeat(v[:, :, None], 3, axis=2)


def decode_pnm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PBM, PGM, PPM or PFM bytes → (H, W, 3) uint8, as PIL's
    ``convert("RGB")`` makes it. ``name`` labels the errors."""
    try:
        hd = _header(data)
        if not hd.plain:
            v = _raw(data, hd)
        elif hd.mode == "1":
            v = _plain_bits(data, hd)
        else:
            v = _plain_values(data, hd)
        return _to_rgb(v, hd.mode)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def read_pnm(path: str) -> np.ndarray:
    """The PNM file at ``path`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_pnm(f.read(), path)


def pnm_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """Why ``read_pnm`` refuses the file open as ``f``, judged on its header
    alone; None for a file that passes it or is not a PNM file. ``head``
    holds the file's first bytes; the rest is read only for a header that
    runs past them."""
    if not is_pnm(head):
        return None
    try:
        if _header(head).offset < len(head):
            return None
    except ValueError:
        pass  # perhaps a header cut at the end of ``head``
    try:
        _header(head + f.read())
    except ValueError as e:
        return str(e)
    return None
