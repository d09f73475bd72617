"""Hand-built GIF files for the tests of the port's GIF reader and for
``chip_smoke.py`` (which blocks PIL): a one-frame GIF writer and its LZW
encoder, written from the GIF89a specification."""
from __future__ import annotations

import struct


def lzw_codes(indices, min_size: int, deferred: bool = False) -> list:
    """GIF LZW: (code, width) pairs, a clear code first and EOI last; codes
    widen when the next free code passes 2^width; a full table of 4,096
    codes is cleared, or with ``deferred`` kept until the end."""
    clear = 1 << min_size

    def reset():
        return {bytes([i]): i for i in range(clear)}, clear + 2, min_size + 1

    table, nxt, width = reset()
    out = [(clear, width)]
    w = b""
    for k in indices:
        wk = w + bytes([k])
        if not w or wk in table:
            w = wk
            continue
        out.append((table[w], width))
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        elif not deferred:
            out.append((clear, width))
            table, nxt, width = reset()
        w = bytes([k])
    if w:
        out.append((table[w], width))
    out.append((clear + 1, width))
    return out


def pack(codes) -> bytes:
    """(code, width) pairs packed LSB first."""
    acc = nb = 0
    out = bytearray()
    for c, wd in codes:
        acc |= c << nb
        nb += wd
        while nb >= 8:
            out.append(acc & 255)
            acc >>= 8
            nb -= 8
    if nb:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def _table(palette: bytes, bits: int | None) -> tuple[int, bytes]:
    bits = bits or max(1, (len(palette) // 3 - 1).bit_length())
    return bits, palette + bytes(3 * (1 << bits) - len(palette))


def gif(w: int, h: int, indices, min_size: int, *, palette: bytes | None = None,
        palette_bits: int | None = None, box: tuple | None = None, ext: bytes = b"",
        interlace: bool = False, local: bytes | None = None, bg: int = 0,
        data: bytes | None = None, version: bytes = b"GIF89a", tail: bytes = b";") -> bytes:
    """A GIF of one frame: a ``w`` × ``h`` canvas, the frame at ``box`` (x0,
    y0, fw, fh; the whole canvas by default) holding ``indices`` (LZW data
    ``data`` if given), after the extension bytes ``ext``."""
    x0, y0, fw, fh = box or (0, 0, w, h)
    flags, table = 0, b""
    if palette is not None:
        bits, table = _table(palette, palette_bits)
        flags = 0x80 | (bits - 1)
    head = version + struct.pack("<HHBBB", w, h, flags, bg, 0) + table
    iflags, ltable = 0x40 if interlace else 0, b""
    if local is not None:
        lbits, ltable = _table(local, None)
        iflags |= 0x80 | (lbits - 1)
    if data is None:
        data = pack(lzw_codes(indices, min_size))
    return (head + ext + b"," + struct.pack("<HHHHB", x0, y0, fw, fh, iflags) + ltable
            + bytes([min_size]) + sub_blocks(data) + tail)


def interlaced_order(h: int) -> list:
    """The rows of an interlaced frame in the order they are stored."""
    return (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2)))


def gce(transparency: int | None = None, disposal: int = 0) -> bytes:
    flags = (disposal << 2) | (1 if transparency is not None else 0)
    return b"!\xf9\x04" + bytes([flags, 10, 0, transparency or 0]) + b"\0"
