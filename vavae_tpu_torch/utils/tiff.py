"""The port's TIFF reader: what PIL 12's ``TiffImagePlugin`` makes of the
first image of a TIFF file, then ``convert("RGB")``.

It reads the first IFD of a classic TIFF in either byte order, or of a
little-endian BigTIFF (PIL takes ``MM\\0+`` for a classic file, and so
refuses it), as the plugin reads it: tags of a type it does not know or
whose data lie past the file are dropped, a tag cut short ends the IFD, and
a one-value tag keeps its first value. The pixel layout is looked up in the
plugin's ``OPEN_INFO`` table (``_OPEN_INFO`` here) by byte order,
photometric interpretation, sample format, fill order, bits per sample and
extra samples; a layout the table lacks is refused, as PIL refuses it.

Pixels are read along the plugin's two paths:
- uncompressed files through its raw decoder, tile by tile as ``_setup``
  lists them: rows unpacked by the raw mode (FillOrder 2 as bit-reversed
  bytes, 16-bit samples by the file's byte order), the predictor ignored, a
  single strip that covers the image read from the last strip offset, and
  that strip mapped as ``Image.open(path)`` maps it, at the image's size
  after the Orientation tag swaps it; planes of a planar file read one
  8-bit band each;
- LZW, Deflate (8, 32946) and PackBits files as libtiff decodes them for
  PIL: each strip or tile decoded whole (LZW and PackBits by
  ``native/lzw_decoder.cpp``, Deflate by ``zlib``), its bits reversed first
  under FillOrder 2, 16 and 32-bit samples of a big-endian file swapped to
  the host's order, horizontal differencing (predictor 2) undone on 8, 16
  and 32-bit samples of LZW and Deflate strips; then unpacked by the raw
  mode with libtiff's native-order 16-bit modes, or, for a planar file,
  plane by plane into the image's bands (the high byte of 16-bit planes).
Then the modes are taken to RGB as ``convert`` takes them: 1, 2 and 4-bit
gray scaled to 0-255, WhiteIsZero inverted below 16 bits, palettes through
the ColorMap's high bytes (an index past it reads black), associated alpha
divided out (``RGBa``) and alpha dropped, 16-bit RGB and CMYK by their high
bytes, 16 and 32-bit integer gray clipped to 0-255, float gray truncated and
clipped, CMYK by PIL's ``cmyk2rgb``. Last, the Orientation tag is applied,
as the plugin's ``load_end`` applies it.

Files this reader leaves to PIL (it raises ``NeedsPil``, saying why): other
compressions (JPEG, CCITT, LZMA, ZSTD, WebP and the rest), YCbCr and
CIELab, 12-bit gray, predictor 3, old-style LZW, tag values of types other
than integers, and strip or tile lists that do not match the image. What PIL
refuses raises ``ValueError``: a missing or bad header or dimension, an
unknown layout or compression, a strip or tile offset or byte count below 0
(a signed tag) or past the file, broken or short compressed data, pixel data
cut short, and images past PIL's decompression-bomb limit.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.native.build import load_library
from vavae_tpu_torch.utils.pil_limits import NeedsPil, bomb_check

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
            b"II\x2b\x00")
_MAX_SAMPLES = 6  # PIL's MAX_SAMPLESPERPIXEL
_ERR_LEN = 256

# tags
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIP_OFFSETS, ORIENTATION,
 SAMPLES, ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH,
 TILE_OFFSETS, TILE_BYTES, EXTRA_SAMPLES, SAMPLE_FORMAT) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
    338, 339)
# the tags PIL keeps one value of (TiffTags' length 1)
_SCALAR = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER, ORIENTATION, SAMPLES,
           ROWS_PER_STRIP, PLANAR, PREDICTOR, TILE_WIDTH, TILE_LENGTH}
_USED = _SCALAR | {BITS, STRIP_OFFSETS, STRIP_BYTES, COLORMAP, TILE_OFFSETS, TILE_BYTES,
                   EXTRA_SAMPLES, SAMPLE_FORMAT}
# bytes of one value of each type PIL loads, and the struct code of the
# integer ones (type 1, BYTE, PIL keeps as bytes)
_UNIT = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8}
_INT_FMT = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L", 16: "Q"}
# COMPRESSION_INFO: the ones read here, and the ones PIL knows
_CODECS = {1: "raw", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}
_PIL_CODECS = {2, 3, 4, 6, 7, 32771, 32809, 34676, 34677, 34925, 50000, 50001}

# OPEN_INFO: (photometric, sample format, fill order, bits, extra samples) →
# (mode, raw mode), for both byte orders, then those of one byte order
_OPEN_INFO = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"), (1, (2,), 1, (8,), ()): ("L", "L"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"), (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"), (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"), (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"), (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"), (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"), (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
_OPEN_INFO_BY_ORDER = {
    b"II": {
        (0, (1,), 1, (16,), ()): ("I;16", "I;16"), (0, (3,), 1, (32,), ()): ("F", "F;32F"),
        (1, (1,), 1, (12,), ()): ("I;16", "I;12"), (1, (1,), 1, (16,), ()): ("I;16", "I;16"),
        (1, (1,), 2, (16,), ()): ("I;16", "I;16R"), (1, (1,), 1, (32,), ()): ("I", "I;32N"),
        (1, (2,), 1, (16,), ()): ("I", "I;16S"), (1, (2,), 1, (32,), ()): ("I", "I;32S"),
        (1, (3,), 1, (32,), ()): ("F", "F;32F"),
        (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
        (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
        (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
        (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
        (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
        (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L"),
    },
    b"MM": {
        (0, (3,), 1, (32,), ()): ("F", "F;32BF"), (1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
        (1, (2,), 1, (16,), ()): ("I", "I;16BS"), (1, (2,), 1, (32,), ()): ("I", "I;32BS"),
        (1, (3,), 1, (32,), ()): ("F", "F;32BF"),
        (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
        (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
        (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B"),
    },
}
# the modes Image.open(path) maps straight from the file (Image._MAPMODES)
_MAPMODES = {"L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B"}
_PIL_ONLY_MODES = {"LAB"}
_PIL_ONLY_RAWMODES = {"I;12", "I;16R"}
# how each orientation (2-8) is undone: (flip rows, flip columns, transpose
# after) as ImageOps.exif_transpose does it
_ORIENT = {2: (False, True, False), 3: (True, True, False), 4: (True, False, False),
           5: (False, False, True), 6: (True, False, True), 7: (True, True, True),
           8: (False, True, True)}


def is_tiff(head: bytes) -> bool:
    """Whether ``head`` (a file's first 4 bytes or more) starts a file that
    PIL's TIFF plugin takes (``PREFIXES``)."""
    return head[:4] in PREFIXES


def _library() -> ctypes.CDLL:
    lib = load_library("lzw_decoder")
    if not getattr(lib, "_vavae_tiff_bound", False):
        lib.tiff_decode_blocks.restype = ctypes.c_int
        lib.tiff_decode_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib._vavae_tiff_bound = True
    return lib


# ------------------------------------------------------------- the IFD ----

def _ifd(data: bytes) -> tuple[bytes, dict, dict, bool]:
    """(byte order, {tag: (type, raw bytes)}, {tag: count} of every entry,
    whether the IFD ran past the file) of the first IFD, as
    ``ImageFileDirectory_v2.load`` reads it."""
    order = data[:2]
    endian = "<" if order == b"II" else ">"
    bigtiff = data[2] == 43
    head = data[:16 if bigtiff else 8]
    if len(head) < (16 if bigtiff else 8):
        raise ValueError("TIFF header cut short")
    (pos,) = struct.unpack(endian + ("Q" if bigtiff else "L"), head[8 if bigtiff else 4:])
    if not pos:
        raise ValueError("no more images in TIFF file")
    if pos >= 2**63:
        raise ValueError("Unable to seek to frame")
    tags, counts = {}, {}

    def read(at: int, n: int) -> bytes:
        s = data[at:at + n]
        if len(s) != n:
            raise EOFError
        return s

    try:
        (count,) = struct.unpack(endian + ("Q" if bigtiff else "H"), read(pos, 8 if bigtiff else 2))
        pos += 8 if bigtiff else 2
        entry = 20 if bigtiff else 12
        for _ in range(count):
            tag, typ, n, field = struct.unpack(endian + ("HHQ8s" if bigtiff else "HHL4s"),
                                               read(pos, entry))
            pos += entry
            counts[tag] = n
            if typ not in _UNIT:
                continue
            size = n * _UNIT[typ]
            if size > (8 if bigtiff else 4):
                (at,) = struct.unpack(endian + ("Q" if bigtiff else "L"), field)
                value = read(at, size)  # cut short: PIL's load stops here
            else:
                value = field[:size]
            if value:
                tags[tag] = (typ, value)
    except EOFError:
        return order, tags, counts, True
    return order, tags, counts, False


def _value(order: bytes, tags: dict, tag: int, default=None):
    """The tag's value as PIL's ``tag_v2`` gives it: an int for a one-value
    tag, else a tuple; only integer types are taken."""
    if tag not in tags:
        return default
    typ, raw = tags[tag]
    if typ not in _INT_FMT:
        raise NeedsPil(f"TIFF tag {tag} of type {typ}")
    e, fmt = "<" if order == b"II" else ">", _INT_FMT[typ]
    vals = struct.unpack(f"{e}{len(raw) // _UNIT[typ]}{fmt}", raw)
    return vals[0] if tag in _SCALAR else vals


# ------------------------------------------------------------- layout -----

class _Layout:
    """What the plugin's ``_setup`` reads from the tags."""
    order: bytes
    width: int  # of the stored image (the tile size)
    height: int
    size: tuple  # (w, h) after the Orientation tag
    orientation: int
    mode: str
    rawmode: str
    codec: str  # "raw", "lzw", "deflate" or "packbits"
    planar: int
    fillorder: int
    bits: tuple
    extra: tuple  # ExtraSamples
    bps_count: int
    samples: int
    predictor: int
    tiled: bool
    block_w: int  # of a strip (the image's width) or tile
    block_h: int
    offsets: tuple
    counts: Optional[tuple]
    palette: Optional[np.ndarray]  # (256, 3) for mode P and PA


# the tags whose count libtiff holds to 1 (else the directory is refused)
_LIBTIFF_ONE = {WIDTH, LENGTH, COMPRESSION, ROWS_PER_STRIP, PLANAR, TILE_WIDTH, TILE_LENGTH}


def _layout(data: bytes) -> _Layout:
    order, tags, counts, cut = _ifd(data)
    v = lambda tag, default=None: _value(order, tags, tag, default)  # noqa: E731
    lay = _Layout()
    lay.order = order
    if 0xBC01 in tags:
        raise ValueError("Windows Media Photo files not yet supported")
    comp = v(COMPRESSION, 1)
    if comp in _PIL_CODECS:
        raise NeedsPil(f"TIFF compression {comp}")
    if comp not in _CODECS:
        raise ValueError(f"unknown TIFF compression {comp}")
    lay.codec = _CODECS[comp]
    lay.planar = v(PLANAR, 1)
    photo = v(PHOTOMETRIC, 0)
    lay.fillorder = v(FILLORDER, 1)
    lay.width, lay.height = v(WIDTH), v(LENGTH)
    if lay.width is None or lay.height is None:
        raise ValueError("Missing dimensions")
    lay.orientation = v(ORIENTATION, 1)
    lay.size = ((lay.height, lay.width) if lay.orientation in (5, 6, 7, 8)
                else (lay.width, lay.height))
    sample_format = v(SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bits, extra = v(BITS, (1,)), v(EXTRA_SAMPLES, ())
    lay.samples = v(SAMPLES, 1)
    if lay.samples > _MAX_SAMPLES:
        raise ValueError("Invalid value for samples per pixel")
    if lay.samples < len(bits):
        bits = bits[:lay.samples]
    elif lay.samples > len(bits) and len(bits) == 1:
        bits = bits * lay.samples
    if len(bits) != lay.samples:
        raise ValueError("unknown data organization")
    lay.bits, lay.extra = bits, extra
    # _setup's count of samples, which divides a planar tile's stride
    lay.bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    key = (photo, sample_format, lay.fillorder, bits, extra)
    table = _OPEN_INFO_BY_ORDER[order]
    if key not in _OPEN_INFO and key not in table:
        raise ValueError("unknown pixel mode")
    lay.mode, lay.rawmode = table.get(key) or _OPEN_INFO[key]
    if photo == 6 or lay.mode in _PIL_ONLY_MODES or lay.rawmode in _PIL_ONLY_RAWMODES:
        raise NeedsPil(f"TIFF of mode {lay.mode}, raw mode {lay.rawmode}")
    lay.predictor = v(PREDICTOR, 1) if lay.codec in ("lzw", "deflate") else 1
    if lay.codec != "raw":
        if lay.fillorder == 2:  # libtiff reverses the bits itself
            lay.mode, lay.rawmode = table.get(key[:2] + (1,) + key[3:]) or _OPEN_INFO[
                key[:2] + (1,) + key[3:]]
        if lay.rawmode == "I;16":
            lay.rawmode = "I;16N"
        elif lay.rawmode.endswith((";16B", ";16L")):
            lay.rawmode = lay.rawmode[:-1] + "N"
        if lay.predictor == 3:
            raise NeedsPil("TIFF with the floating-point predictor")
        # libtiff reads the directory again, and more strictly
        if cut:  # PIL's view ends there, libtiff reads on
            raise NeedsPil("TIFF directory running past the file")
        if any(t in _USED and t not in tags for t in counts):
            raise NeedsPil("TIFF tag of a type PIL does not read")
        if any(counts.get(t, 1) != 1 for t in _LIBTIFF_ONE):
            raise ValueError("TIFF tag of a count libtiff refuses")
    lay.tiled = STRIP_OFFSETS not in tags and TILE_OFFSETS in tags
    if lay.tiled:
        lay.offsets, lay.counts = v(TILE_OFFSETS), v(TILE_BYTES)
        lay.block_w, lay.block_h = v(TILE_WIDTH), v(TILE_LENGTH)
        if lay.block_w is None or lay.block_h is None:
            raise ValueError("Invalid tile dimensions")
    elif STRIP_OFFSETS in tags:
        lay.offsets, lay.counts = v(STRIP_OFFSETS), v(STRIP_BYTES)
        lay.block_w, lay.block_h = lay.width, v(ROWS_PER_STRIP, lay.height)
    else:
        raise ValueError("unknown data organization")
    if any(x < 0 for x in lay.offsets + (lay.counts or ())):  # a signed tag's value
        raise ValueError("TIFF strip or tile offset or byte count below 0")
    lay.palette = None
    if lay.mode in ("P", "PA"):
        cmap = v(COLORMAP)
        if cmap is None:
            raise ValueError("palette TIFF without a ColorMap")
        entries = np.array([c // 256 for c in cmap], np.uint8)
        n = len(entries) // 3
        lay.palette = np.zeros((256, 3), np.uint8)
        lay.palette[:n] = entries[:3 * n].reshape(3, n).T
    if lay.size[0] <= 0 or lay.size[1] <= 0:
        raise ValueError(f"TIFF of {lay.size[0]}x{lay.size[1]} pixels")
    bomb_check(*lay.size)
    return lay


# -------------------------------------------------------- unpacking -------

_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
# bits a pixel of each raw mode takes
_RAW_BITS = {
    "1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "P;1": 1, "P;1R": 1,
    "L;2": 2, "L;2I": 2, "L;2R": 2, "L;2IR": 2, "P;2": 2, "P;2R": 2,
    "L;4": 4, "L;4I": 4, "L;4R": 4, "L;4IR": 4, "P;4": 4, "P;4R": 4,
    "L": 8, "L;I": 8, "L;R": 8, "L;IR": 8, "P": 8, "P;R": 8,
    "LA": 16, "PA": 16, "PX": 16, "I;16": 16, "I;16N": 16, "I;16B": 16, "I;16S": 16,
    "I;16BS": 16, "RGB": 24, "RGB;R": 24, "RGBA": 32, "RGBa": 32, "RGBX": 32, "CMYK": 32,
    "I;32N": 32, "I;32S": 32, "I;32BS": 32, "F;32F": 32, "F;32BF": 32,
    "RGBAX": 40, "RGBaX": 40, "RGBXX": 40, "CMYKX": 40,
    "RGBAXX": 48, "RGBaXX": 48, "RGBXXX": 48, "CMYKXX": 48, "RGB;16L": 48, "RGB;16B": 48,
    "RGB;16N": 48, "RGBA;16L": 64, "RGBA;16B": 64, "RGBA;16N": 64, "RGBa;16L": 64,
    "RGBa;16B": 64, "RGBa;16N": 64, "RGBX;16L": 64, "RGBX;16B": 64, "RGBX;16N": 64,
    "CMYK;16L": 64, "CMYK;16B": 64, "CMYK;16N": 64,
}
# the one-character raw modes PIL unpacks into each mode (a plane of a
# planar, uncompressed file), and the bits each reads
_PLANE_RAWMODES = {"1": "1", "L": "L", "P": "LP", "I": "I", "F": "F", "RGB": "RGB",
                   "RGBA": "RGBA", "CMYK": "CMYK"}
_PLANE_BITS = {"1": 1, "I": 32, "F": 32}
_INT_DTYPES = {"I;16": "<u2", "I;16N": "<u2", "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2",
               "I;32N": "<i4", "I;32S": "<i4", "I;32BS": ">i4", "F;32F": "<f4", "F;32BF": ">f4"}


def _channels(mode: str) -> int:
    """Bytes a pixel of ``mode`` takes in the canvas here: 1 for 1, L, P
    and the integer and float modes, 3 for RGB, 4 for the others (as PIL
    stores LA and PA: the alpha, or a second plane, in a later byte)."""
    return {"RGB": 3, "LA": 4, "PA": 4, "RGBA": 4, "CMYK": 4}.get(mode, 1)


def _canvas(mode: str, w: int, h: int) -> np.ndarray:
    if mode.startswith("I"):
        return np.zeros((h, w), np.int64)
    if mode == "F":
        return np.zeros((h, w), np.float32)
    c = _channels(mode)
    return np.zeros((h, w, c) if c > 1 else (h, w), np.uint8)


def _unpack(rows: np.ndarray, w: int, rawmode: str) -> np.ndarray:
    """Rows of raw bytes (h, >= row bytes) → (h, w) values or (h, w, 4)
    pixels, as PIL's unpacker for ``rawmode`` makes them."""
    h = rows.shape[0]
    if rawmode.endswith("R") and rawmode not in ("I;16R",):
        rows, rawmode = _REVERSED[rows], rawmode[:-1].rstrip(";")
    bits = _RAW_BITS[rawmode]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
        if rawmode.startswith("P"):
            return v
        v = v * (255 // ((1 << bits) - 1))
        return (255 - v if rawmode.endswith("I") else v).astype(np.uint8)
    if rawmode in _INT_DTYPES:
        nb = bits // 8
        v = np.ascontiguousarray(rows[:, :w * nb]).view(_INT_DTYPES[rawmode]).reshape(h, w)
        return v if rawmode.startswith("F") else v.astype(np.int64)
    if rawmode in ("L", "P"):
        return rows[:, :w]
    if rawmode == "L;I":
        return 255 - rows[:, :w]
    nb = bits // 8
    px = rows[:, :w * nb].reshape(h, w, nb)
    if rawmode == "PX":
        return px[..., 0]
    if rawmode in ("LA", "PA"):
        out = np.zeros((h, w, 4), np.uint8)
        out[..., 0], out[..., 3] = px[..., 0], px[..., 1]
        return out
    if ";16" in rawmode:
        hi = 0 if rawmode.endswith("B") else 1  # the high byte of each sample
        px = px[..., hi::2]
        rawmode = rawmode.split(";")[0]
    out = px[..., :4 if rawmode.startswith(("RGBA", "RGBa", "CMYK")) else 3]
    return _unpremultiply(out.copy()) if rawmode.startswith("RGBa") else out


def _to_rgb(img: np.ndarray, lay: _Layout) -> np.ndarray:
    mode = lay.mode
    if mode in ("1", "L"):
        return np.repeat(img[:, :, None], 3, axis=2)
    if mode == "LA":
        return np.repeat(img[:, :, :1], 3, axis=2)
    if mode in ("P", "PA"):
        return lay.palette[img if mode == "P" else img[..., 0]]
    if mode.startswith("I"):
        return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "F":
        v = np.where(np.isnan(img), 0, np.clip(img, 0, 255)).astype(np.uint8)
        return np.repeat(v[:, :, None], 3, axis=2)
    if mode == "CMYK":  # PIL's cmyk2rgb
        nk = 255 - img[..., 3:4].astype(np.int32)
        t = img[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    return img[..., :3]


# ------------------------------------------------------------- decoding ---

def _raw_tiles(lay: _Layout) -> list:
    """``_setup``'s raw tiles: (offset, x0, y0, x1, y1, rawmode, stride),
    sorted by offset, of each run of equal boxes and modes the last."""
    offsets = lay.offsets
    w, h = lay.block_w, lay.block_h
    if w == lay.width and h == lay.height and lay.planar != 2:
        offsets = offsets[-1:]
    tiles, x, y, layer = [], 0, 0, 0
    for offset in offsets:
        stride = w * sum(lay.bits) / 8 if x + w > lay.width else 0
        rawmode = lay.rawmode
        if lay.planar == 2:
            if layer >= len(lay.rawmode):
                raise ValueError("more TIFF planes than bands")
            rawmode = lay.rawmode[layer]
            stride /= lay.bps_count
        tiles.append((offset, x, y, min(x + w, lay.width), min(y + h, lay.height), rawmode,
                      int(stride)))
        x += w
        if x >= lay.width:
            x, y = 0, y + h
            if y >= lay.height:
                y, layer = 0, layer + 1
    tiles.sort(key=lambda t: t[0])
    return [t for i, t in enumerate(tiles) if i + 1 == len(tiles) or tiles[i + 1][1:] != t[1:]]


def _decode_raw(data: bytes, lay: _Layout) -> np.ndarray:
    tiles = _raw_tiles(lay)
    body = np.frombuffer(data, np.uint8)
    if len(tiles) == 1 and tiles[0][5] == lay.mode and lay.mode in _MAPMODES:
        # Image.open(path) maps the strip at the image's size after the
        # Orientation tag, which swaps it for 5-8
        offset, stride = tiles[0][0], tiles[0][6]
        (w, h), c = lay.size, (2 if lay.mode.startswith("I;16") else _channels(lay.mode))
        if stride == 0 and offset + h * w * c > len(data):
            raise ValueError("buffer is not large enough")
        if offset + h * stride <= len(data):  # else PIL decodes it, as below
            if offset + (h - 1) * (stride or w * c) + w * c > len(data):
                # PIL maps rows longer than the stride, past its buffer
                raise ValueError("TIFF strip mapped past the end of the file")
            rows = np.lib.stride_tricks.as_strided(body[offset:], (h, w * c), (stride or w * c, 1))
            return _unpack(np.array(rows), w, lay.rawmode)
    img = _canvas(lay.mode, lay.width, lay.height)
    for offset, x0, y0, x1, y1, rawmode, stride in tiles:
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0:
            raise ValueError("tile cannot extend outside image")
        plane = lay.planar == 2
        if plane and rawmode not in _PLANE_RAWMODES.get(lay.mode, ""):
            raise ValueError("unknown raw mode for given image mode")
        if not plane and rawmode in ("L;IR", "P;1R", "P;2R", "P;4R"):
            raise ValueError("unknown raw mode for given image mode")
        bits = _PLANE_BITS.get(rawmode, 8) if plane else _RAW_BITS[rawmode]
        row = (tw * bits + 7) // 8
        stride = stride or row
        if stride < row:
            raise ValueError("TIFF tile rows narrower than their pixels")
        if offset + (th - 1) * stride + row > len(data):
            raise ValueError("image file is truncated")
        rows = np.lib.stride_tricks.as_strided(body[offset:], (th, row), (stride, 1))
        if plane and len(lay.mode) > 1 and lay.mode not in ("LA", "PA"):
            img[y0:y1, x0:x1, lay.mode.index(rawmode)] = rows[:, :tw]
        elif plane:
            img[y0:y1, x0:x1] = _unpack(np.array(rows), tw, {"1": "1", "I": "I;32N", "F": "F;32F"}
                                        .get(rawmode, "L"))
        else:
            img[y0:y1, x0:x1] = _unpack(np.array(rows), tw, rawmode)
    return img


def _inflate(raw: bytes, occ: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(raw, occ)
    except zlib.error as e:
        raise ValueError(f"ZIPDecode: {e}") from None
    if len(out) < occ:
        raise ValueError("ZIPDecode: Not enough data")
    return out


def _blocks(data: bytes, lay: _Layout, indices: list, occs: list, row: int,
            spp: int) -> np.ndarray:
    """Strips or tiles ``indices`` decoded whole (``occs`` bytes each), one
    after another, as libtiff's ``TIFFReadEncodedStrip`` / ``TIFFReadTile``
    give them: decoded, 16 and 32-bit samples of a big-endian file swapped
    to the host's order, predictor 2 undone along each row of ``row``
    bytes; one native call for them all."""
    bits = lay.bits[0]
    wide = bits in (16, 32) and all(b == bits for b in lay.bits)
    if lay.predictor != 1:
        if lay.predictor != 2 or bits not in (8, 16, 32) or not all(b == bits for b in lay.bits):
            raise ValueError(f"TIFF predictor {lay.predictor} with {bits}-bit samples")
        if row % (bits // 8 * spp):
            raise ValueError("TIFF rows not whole samples")
    for i in indices:  # as Python ints, which do not overflow
        if lay.counts[i] <= 0 or lay.offsets[i] + lay.counts[i] > len(data):
            raise ValueError(f"TIFF strip or tile {i} lies past the file")
    offsets = np.array([lay.offsets[i] for i in indices], np.int64)
    counts = np.array([lay.counts[i] for i in indices], np.int64)
    out = np.empty(sum(occs), np.uint8)
    codec = {"lzw": 5, "packbits": 32773}.get(lay.codec, 1)
    if lay.codec == "deflate":  # zlib, then the rest natively
        pos = 0
        for offset, count, occ in zip(offsets, counts, occs):
            raw = data[offset:offset + count]
            if lay.fillorder == 2:
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            out[pos:pos + occ] = np.frombuffer(_inflate(raw, occ), np.uint8)
            pos += occ
    sizes = np.array(occs, np.int64)  # held here: native code reads it
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _library().tiff_decode_blocks(
            data, len(data), offsets.ctypes.data, counts.ctypes.data, sizes.ctypes.data,
            len(indices), codec, int(lay.fillorder == 2), int(wide and lay.order == b"MM"),
            lay.predictor, row, spp, bits // 8, out.ctypes.data, err, _ERR_LEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out


def _bands(mode: str) -> int:
    return {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's ``RGBa`` unpacking: colour * 255 // alpha, clipped; 0 where
    alpha is 0."""
    a = img[..., 3].astype(np.int32)
    rgb = img[..., :3].astype(np.int32) * 255 // np.maximum(a, 1)[..., None]
    rgb = np.where(a[..., None] == 0, 0, np.minimum(rgb, 255))
    img[..., :3] = np.where(a[..., None] == 255, img[..., :3], rgb)
    return img


def _decode_codec(data: bytes, lay: _Layout, plan_only: bool = False) -> np.ndarray:
    """The image of a compressed file, decoded as libtiff and PIL's
    ``TiffDecode.c`` decode it; with ``plan_only``, only the checks made
    before any strip is read."""
    if lay.planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {lay.planar}")
    separate = lay.planar == 2
    bands = _bands(lay.mode)
    if separate and (bands == 1 and lay.samples > 1 or lay.extra[:1] == (999,)):
        raise NeedsPil(f"planar TIFF of raw mode {lay.rawmode}")
    planes = bands if separate and bands > 1 else 1  # read, of the file's planes
    if planes > 1 and lay.bits[0] not in (8, 16):
        raise ValueError(f"planar TIFF of {lay.bits[0]}-bit samples")
    spp = 1 if separate else lay.samples
    bw = lay.block_w
    bh = lay.block_h if lay.tiled else min(lay.block_h, lay.height)
    if bw <= 0 or bh <= 0:
        raise ValueError("TIFF tiles or strips of no pixels")
    across = -(-lay.width // bw) if lay.tiled else 1
    down = -(-lay.height // bh)
    n = across * down
    file_planes = lay.samples if separate else 1
    if lay.counts is None or len(lay.offsets) != n * file_planes or len(lay.counts) != len(
            lay.offsets):
        raise NeedsPil("TIFF strip or tile lists that do not match the image")
    row = (bw * spp * lay.bits[0] + 7) // 8  # TIFFScanlineSize / TIFFTileRowSize
    if not lay.tiled and (lay.width * _RAW_BITS[lay.rawmode] // planes + 7) // 8 > row:
        raise ValueError("TIFF rows narrower than the raw mode's")
    if plan_only:
        return None
    boxes = []  # (block index, x0, y0, x1, y1, plane, rows decoded) of each block read
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                x0, y0 = tx * bw, ty * bh
                x1, y1 = min(x0 + bw, lay.width), min(y0 + bh, lay.height)
                boxes.append((p * n + ty * across + tx, x0, y0, x1, y1, p,
                              bh if lay.tiled else y1 - y0))
    buf = _blocks(data, lay, [b[0] for b in boxes], [b[6] * row for b in boxes], row, spp)
    if planes == 1 and not lay.tiled:  # the strips are the image's rows
        return _unpack(buf.reshape(lay.height, row), lay.width, lay.rawmode)
    img = _canvas(lay.mode, lay.width, lay.height)
    pos = 0
    for _, x0, y0, x1, y1, p, rows_here in boxes:
        rows = buf[pos:pos + rows_here * row].reshape(rows_here, row)[:y1 - y0]
        pos += rows_here * row
        if planes > 1:  # the plane's sample (its high byte) into band p
            step = lay.bits[0] // 8
            img[y0:y1, x0:x1, p] = rows[:, step - 1::step][:, :x1 - x0]
        else:
            img[y0:y1, x0:x1] = _unpack(rows, x1 - x0, lay.rawmode)
    if planes > 1 and lay.mode == "RGBA" and (not lay.extra or lay.extra[0] in (0, 1)):
        img = _unpremultiply(img)  # as TiffDecode.c does for associated alpha, or none said
    return img


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    if orientation not in _ORIENT:
        return img
    flip_rows, flip_cols, transpose = _ORIENT[orientation]
    if flip_rows:
        img = img[::-1]
    if flip_cols:
        img = img[:, ::-1]
    return img.swapaxes(0, 1) if transpose else img


def _leaves_to_pil(data: bytes, lay: _Layout) -> None:
    """Raises ``NeedsPil`` for a TIFF of layout ``lay`` that this reader
    leaves to PIL: old-style LZW strips, and the codec path's checks."""
    if lay.codec == "raw":
        return
    if lay.codec == "lzw" and lay.counts is not None:
        for offset in lay.offsets:
            raw = data[offset:offset + 2]
            if lay.fillorder == 2:
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if raw[:1] == b"\0" and len(raw) > 1 and raw[1] & 1:
                raise NeedsPil("TIFF of old-style LZW")
    _decode_codec(data, lay, plan_only=True)


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8, as PIL's ``Image.open(path)`` and
    ``convert("RGB")`` make it. ``name`` labels the errors. Raises
    ``NeedsPil`` (with the reason alone) for a file left to PIL."""
    try:
        lay = _layout(data)
        _leaves_to_pil(data, lay)
        img = _decode_raw(data, lay) if lay.codec == "raw" else _decode_codec(data, lay)
        return np.ascontiguousarray(_orient(_to_rgb(img, lay), lay.orientation))
    except (ValueError, IndexError) as e:
        raise ValueError(f"{name}: {e}") from None


def read_tiff(path: str) -> np.ndarray:
    """The TIFF at ``path`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)


def tiff_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """Why ``read_tiff`` refuses the file open as ``f``, judged on its IFD
    alone; None for a file that passes it or is not a TIFF. Raises
    ``NeedsPil`` for a file left to PIL. ``head`` holds the file's first
    bytes; the rest is read too, since the IFD may lie anywhere."""
    if not is_tiff(head):
        return None
    data = head + f.read()
    try:
        _leaves_to_pil(data, _layout(data))
    except (ValueError, IndexError) as e:
        return str(e)
    return None
