"""The port's JPEG reader: ``native/jpeg_decoder.cpp`` through ctypes.

It decodes what PIL's ``Image.open(p).convert("RGB")`` decodes through
libjpeg-turbo, bit for bit: baseline, extended-sequential and progressive
files, Huffman- or arithmetic-coded, and lossless Huffman files, 8-bit,
gray, YCbCr, RGB, and Adobe CMYK or YCCK, with any sampling factors of
integral ratios, restart intervals and any size; progressive files whose
scans leave coefficients unrefined are block-smoothed as libjpeg smooths
them. Corrupt data decodes as libjpeg-turbo's C code decodes it (its x86
SIMD inverse DCT can round out-of-range coefficients differently). What PIL
refuses too (hierarchical and arithmetic-coded lossless files, precisions
other than 8 bits, and a frame past PIL's decompression-bomb bound) raises
``ValueError`` naming the file; nothing is handed to PIL. ``jpeg_refusal``
finds those from their frame header, without decoding. ctypes releases the
interpreter lock for the call, so threads decode in parallel.
"""
from __future__ import annotations

import ctypes
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.native.build import load_library
from vavae_tpu_torch.utils.pil_limits import bomb_check

_ERR_LEN = 512
_MAGIC = b"\xff\xd8\xff"
CHECK_HEAD = 1 << 14  # bytes read first: the SOF of most files lies in them


def _library() -> ctypes.CDLL:
    lib = load_library("jpeg_decoder")
    if not getattr(lib, "_vavae_bound", False):
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode_rgb.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_check.restype = ctypes.c_int
        lib.jpeg_check.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_int]
        lib._vavae_bound = True
    return lib


def _size(lib: ctypes.CDLL, data: bytes) -> tuple[int, int]:
    """(height, width) from the frame header, which ``jpeg_header`` reads
    without allocating anything by the pixel, held to PIL's bomb bound;
    ``ValueError`` for what either refuses."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int64 * 2)()
    if lib.jpeg_header(data, len(data), dims, err, _ERR_LEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    bomb_check(dims[1], dims[0])
    return dims[0], dims[1]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8 RGB. ``name`` labels the errors."""
    lib = _library()
    try:
        size = _size(lib, data)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    out = np.empty((*size, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_decode_rgb(data, len(data), out.ctypes.data, out.nbytes, err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The JPEG at ``path`` as (H, W, 3) uint8, as PIL's ``convert("RGB")``
    makes it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def jpeg_refusal(path: str) -> Optional[str]:
    """Why ``read_jpeg`` refuses the file at ``path``, judged on its frame
    header alone: an SOF marker or a precision that PIL does not decode
    either, or a frame past PIL's decompression-bomb bound; else None, as
    for a file that is not a JPEG or is truncated (which PIL refuses too). Reads the first 16 KiB of most files, and all
    of one whose frame header lies further in."""
    with open(path, "rb") as f:
        return jpeg_head_refusal(f.read(CHECK_HEAD), f)


def jpeg_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """``jpeg_refusal`` of the file open as ``f``, whose first ``CHECK_HEAD``
    bytes (or all, if fewer) ``head`` holds; reads the rest of ``f`` only for
    a JPEG whose frame header lies past them."""
    if head[:3] != _MAGIC:
        return None
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.jpeg_check(head, len(head), err, _ERR_LEN)
    if rc == 1 and len(head) == CHECK_HEAD:
        head += f.read()
        rc = lib.jpeg_check(head, len(head), err, _ERR_LEN)
    if rc < 0:
        return err.value.decode(errors="replace")
    if rc == 0:  # the frame header lies in head
        try:
            _size(lib, head)
        except ValueError as e:
            return str(e)
    return None

