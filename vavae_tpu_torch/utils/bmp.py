"""The port's BMP reader (numpy): what PIL 12's ``BmpImagePlugin`` and its
RLE decoder make of a ``BM`` file, then ``convert("RGB")``.

It follows the plugin step by step, quirks included:
- headers: the 12-byte core header and the 40, 52, 56, 64, 108 and 124-byte
  info headers (a height with its top byte 0xFF is a top-down image);
  BI_BITFIELDS masks from the header, or after a 40-byte one;
- pixels: 1, 4 and 8-bit palettes (BGR entries after a core header, BGRX
  after the others; a palette whose entries are 0, 1, 2, ... in gray is
  dropped and the indices read as gray, 0 and 255 for two colours, which
  then unpack one bit a pixel whatever the file's depth); 16-bit 5-5-5, and
  5-6-5 under BI_BITFIELDS, scaled as PIL's ``BGR;15``/``BGR;16`` unpackers
  scale (``v * 255 // 31``, ``v * 255 // 63``); 24-bit BGR; 32-bit BGRX and
  the bitfield layouts PIL takes; RLE8 and RLE4 as ``BmpRleDecoder`` reads
  them (its end-of-line padding, its delta that skips two bytes before the
  two it uses, an RLE4 absolute run of odd length dropping its last pixel,
  runs aligned on the file's even offsets);
- the pixel-data offset of the file header, moved past a palette that
  starts right after the header (by 4 bytes an entry, as PIL moves it);
- palette indices past the palette read black, as PIL 12 reads them.
What PIL refuses raises ``ValueError``: other header sizes, bit depths and
compressions (JPEG and PNG in BMP), other bitfield masks, palettes of more
than 256 entries (or none), an empty image, a row wider than the file's row stride, pixel
data cut short, an RLE stream that ends before the image is full, and
images past PIL's decompression-bomb limit.
"""
from __future__ import annotations

from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.utils.pil_limits import bomb_check

MAGIC = b"BM"
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_SUPPORTED_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
         (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR", (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA", (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR", (0x0, 0x0, 0x0, 0x0): "BGRA"},
    24: {(0xFF0000, 0xFF00, 0xFF): "BGR"},
    16: {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"},
}
# bits a pixel each raw mode unpacks, and for 24/32-bit modes the byte of R, G, B
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24,
             "BGRX": 32, "XBGR": 32, "BGXR": 32, "ABGR": 32, "RGBA": 32, "BGRA": 32, "BGAR": 32}
_RGB_BYTES = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "BGRA": (2, 1, 0), "XBGR": (3, 2, 1),
              "ABGR": (3, 2, 1), "BGXR": (3, 1, 0), "BGAR": (3, 1, 0), "RGBA": (0, 1, 2)}


class _Layout:
    """What the plugin's ``_bitmap`` reads from the headers."""
    width: int
    height: int
    mode: str  # "1", "L", "P", "RGB" or "RGBA"
    rawmode: str
    rle: Optional[bool]  # None: raw rows; else RLE4 (True) or RLE8
    stride: int
    direction: int  # -1: bottom-up rows
    offset: int  # of the pixel data
    palette: Optional[np.ndarray]  # (256, 3) for mode "P"


def _u16(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 2], "little")


def _u32(data: bytes, pos: int) -> int:
    if pos + 4 > len(data):
        raise ValueError("BMP header cut short")
    return int.from_bytes(data[pos:pos + 4], "little")


def layout(data: bytes, base: int = 14) -> _Layout:
    """The layout of the BMP file ``data`` (its info header at ``base`` =
    14), or of the DIB whose info header starts at ``base`` (no file header:
    the pixels follow the palette), as in an icon or cursor file, whose
    reader halves the height (the other half is the AND mask) and checks
    the size as PIL does there."""
    if base == 14 and data[:2] != MAGIC:
        raise ValueError("not a BMP file")
    lay = _Layout()
    offset = _u32(data, 10) if base == 14 else 0
    header_size = _u32(data, base)
    header = data[base + 4:base + max(header_size, 4)]
    if len(header) < header_size - 4:
        raise ValueError("BMP header cut short")
    pos = base + max(header_size, 4)  # the file position after the header
    masks = None
    if header_size == 12:
        lay.width, lay.height, bits = _u16(header, 0), _u16(header, 2), _u16(header, 6)
        compression, colors, padding, lay.direction = 0, 0, 3, -1
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = header[7] == 0xFF
        lay.direction = 1 if y_flip else -1
        lay.width = _u32(header, 0)
        lay.height = _u32(header, 4) if not y_flip else 2**32 - _u32(header, 4)
        bits, compression, colors, padding = _u16(header, 10), _u32(header, 12), _u32(header, 28), 4
        if compression == 3:
            if len(header) >= 48:
                masks = [_u32(header, 36 + 4 * i) for i in range(4 if len(header) >= 52 else 3)]
                masks += [0] * (4 - len(masks))
            else:
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"unsupported BMP header type ({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"unsupported BMP pixel depth ({bits})")
    lay.mode, lay.rawmode = _BIT2MODE[bits]
    lay.rle = None
    if compression == 3:
        table = _SUPPORTED_MASKS.get(bits, {})
        key = tuple(masks) if bits == 32 else tuple(masks[:3])
        if key not in table:
            raise ValueError("unsupported BMP bitfields layout")
        lay.rawmode = table[key]
        if "A" in lay.rawmode:
            lay.mode = "RGBA"
    elif compression in (1, 2):
        lay.rle = compression == 2
    elif compression != 0:
        raise ValueError(f"unsupported BMP compression ({compression})")
    lay.palette = None
    if lay.mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        entries = data[pos:pos + padding * colors]
        pos += len(entries)
        indices = (0, 255) if colors == 2 else range(colors)
        gray = all(entries[i * padding:i * padding + 3] == bytes((v & 255,)) * 3
                   for i, v in enumerate(indices))
        if gray:
            lay.mode = lay.rawmode = "1" if colors == 2 else "L"
        else:
            n = len(entries) // padding
            if n > 256:
                raise ValueError(f"BMP palette of {n} entries (PIL takes 256)")
            lay.palette = np.zeros((256, 3), np.uint8)
            bgr = np.frombuffer(entries[:n * padding], np.uint8).reshape(n, padding)
            lay.palette[:n] = bgr[:, 2::-1]
    lay.stride = ((lay.width * bits + 31) >> 3) & ~3
    lay.offset = offset or pos
    return lay


def _check_size(lay: _Layout) -> None:
    if lay.width <= 0 or lay.height <= 0:
        raise ValueError(f"BMP of {lay.width}x{lay.height} pixels")
    bomb_check(lay.width, lay.height)


def _unpack(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """Rows of raw bytes (h, >= row bytes) → (h, w) indices or gray values,
    or (h, w, 3) RGB, as PIL's unpacker for ``rawmode`` makes them."""
    h = rows.shape[0]
    bits = _RAW_BITS[rawmode]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :width]
        return px * 255 if rawmode == "1" else px
    if bits == 8:
        return rows[:, :width]
    if bits == 16:
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        if rawmode == "BGR;15":
            r, g = (v >> 10) & 31, ((v >> 5) & 31) * 255 // 31
        else:
            r, g = (v >> 11) & 31, ((v >> 5) & 63) * 255 // 63
        return np.stack([r * 255 // 31, g, (v & 31) * 255 // 31], -1).astype(np.uint8)
    px = rows[:, :width * bits // 8].reshape(h, width, bits // 8)
    return px[..., list(_RGB_BYTES[rawmode])]


def _rle(data: bytes, start: int, width: int, height: int, rle4: bool) -> bytes:
    """``BmpRleDecoder.decode``: the index bytes, read from ``start``."""
    out = bytearray()
    x, pos, n = 0, start, len(data)
    dest = width * height
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded run
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            if width:
                out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then uses the next two
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("BMP RLE delta cut short")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute run
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 0x0F))
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    return bytes(out)


def pixels(data: bytes, lay: _Layout) -> np.ndarray:
    """The image of layout ``lay`` as (H, W, 3) uint8, as PIL's
    ``convert("RGB")`` makes it (unchecked: ``decode_bmp`` checks the size)."""
    w, h = lay.width, lay.height
    if lay.rle is not None:
        if lay.mode not in ("P", "L"):
            raise ValueError(f"RLE pixels in a {lay.mode} BMP")
        px = _rle(data, lay.offset, w, h, lay.rle)
        if len(px) < w * h:
            raise ValueError("not enough image data")
        img = np.frombuffer(px, np.uint8, w * h).reshape(h, w)
    else:
        row_bytes = (w * _RAW_BITS[lay.rawmode] + 7) // 8
        if lay.stride < row_bytes:
            raise ValueError("BMP rows narrower than their pixels")
        need = lay.offset + (h - 1) * lay.stride + row_bytes if h else 0
        if need > len(data):
            raise ValueError("BMP pixel data cut short")
        buf = np.zeros(h * lay.stride, np.uint8)
        body = np.frombuffer(data, np.uint8)[lay.offset:lay.offset + h * lay.stride]
        buf[:len(body)] = body
        img = _unpack(buf.reshape(h, lay.stride), w, lay.rawmode)
    if lay.direction == -1:
        img = img[::-1]
    if lay.mode == "P":
        return lay.palette[img]
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2).astype(np.uint8)
    return np.ascontiguousarray(img)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes → (H, W, 3) uint8, as PIL's ``convert("RGB")`` makes it.
    ``name`` labels the errors."""
    try:
        lay = layout(data)
        _check_size(lay)
        return pixels(data, lay)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def read_bmp(path: str) -> np.ndarray:
    """The BMP file at ``path`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)


def bmp_refusal(path: str) -> Optional[str]:
    """Why ``read_bmp`` refuses the file at ``path``, judged on its headers,
    palette and size, without decoding its pixels; None for a file that
    passes them or is not a BMP file."""
    with open(path, "rb") as f:
        return bmp_head_refusal(f.read(2), f)


def bmp_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """``bmp_refusal`` of the file open as ``f``, whose first 2 bytes or
    more ``head`` holds; reads the rest of ``f`` only for a BMP file."""
    if head[:2] != MAGIC:
        return None
    data = head + f.read()
    try:
        lay = layout(data)
        _check_size(lay)
        if lay.rle is not None and lay.mode not in ("P", "L"):
            return f"RLE pixels in a {lay.mode} BMP"
        if lay.rle is None and lay.stride < (lay.width * _RAW_BITS[lay.rawmode] + 7) // 8:
            return "BMP rows narrower than their pixels"
    except ValueError as e:
        return str(e)
    return None
