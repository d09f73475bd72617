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
other than 8 bits) raises ``ValueError`` naming the file; nothing is handed
to PIL. ``refused_jpegs`` finds those from their frame header, without
decoding. ctypes releases the interpreter lock for the call, so threads
decode in parallel.
"""
from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from vavae_tpu_torch.native.build import load_library

_ERR_LEN = 512
_MAGIC = b"\xff\xd8\xff"
_CHECK_HEAD = 1 << 14  # bytes read first: the SOF of most files lies in them
_CHECK_THREADS = 8


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


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8 RGB. ``name`` labels the errors."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int64 * 2)()
    if lib.jpeg_header(data, len(data), dims, err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    out = np.empty((dims[0], dims[1], 3), np.uint8)
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
    either; else None, as for a file that is not a JPEG or is truncated
    (which PIL refuses too). Reads the first 16 KiB of most files, and all
    of one whose frame header lies further in."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    with open(path, "rb") as f:
        data = f.read(_CHECK_HEAD)
        if data[:3] != _MAGIC:
            return None
        rc = lib.jpeg_check(data, len(data), err, _ERR_LEN)
        if rc == 1 and len(data) == _CHECK_HEAD:
            data += f.read()
            rc = lib.jpeg_check(data, len(data), err, _ERR_LEN)
    return err.value.decode(errors="replace") if rc < 0 else None


def refused_jpegs(paths: Sequence[str]) -> list[tuple[str, str]]:
    """(path, reason) for each of ``paths`` that ``jpeg_refusal`` refuses,
    in the order of ``paths``, checked on a pool of threads."""
    with ThreadPoolExecutor(_CHECK_THREADS) as pool:
        reasons = list(pool.map(jpeg_refusal, paths))
    return [(p, r) for p, r in zip(paths, reasons) if r is not None]
