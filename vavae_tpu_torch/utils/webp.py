"""The port's WebP reader: ``native/webp_decoder.cpp`` through ctypes.

It decodes what PIL's ``Image.open(p).convert("RGB")`` decodes through
libwebp 1.6, bit for bit: lossy (VP8) files with libwebp's fancy upsampling
and YUV conversion, lossless (VP8L) files, lossy files with an ALPH chunk,
VP8X files with ICC, EXIF or XMP chunks, and the first frame of an
animation, placed on its transparent-black canvas. What libwebp refuses
(a file cut short, a corrupt bitstream, an invalid container) raises
``ValueError`` naming the file; nothing is handed to PIL. ``webp_refusal``
finds the files refused from their container and frame headers, without
decoding. ctypes releases the interpreter lock for the call, so threads
decode in parallel.
"""
from __future__ import annotations

import ctypes
from typing import BinaryIO, Optional

import numpy as np

from vavae_tpu_torch.native.build import load_library

_ERR_LEN = 512
MAGIC_OFFSETS = ((0, b"RIFF"), (8, b"WEBP"))
# facts of ``webp_facts``, in ``kInfo*`` order (native/webp_decoder.cpp)
FACTS = ("lossless", "alpha", "alpha_filter", "frames", "transforms", "cache_bits",
         "prefix_groups", "partitions", "filter_type", "segments", "intra4",
         "skip_proba", "predictor_modes", "alpha_8b")


def is_webp(head: bytes) -> bool:
    """Whether ``head`` (a file's first 12 bytes or more) starts a RIFF WebP
    file."""
    return all(head[o:o + len(m)] == m for o, m in MAGIC_OFFSETS)


def _library() -> ctypes.CDLL:
    lib = load_library("webp_decoder")
    if not getattr(lib, "_vavae_bound", False):
        lib.webp_header.restype = ctypes.c_int
        lib.webp_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int]
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_char_p, ctypes.c_int]
        lib._vavae_bound = True
    return lib


def _decode(data: bytes, name: str, channels: int, info) -> np.ndarray:
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int64 * 2)()
    if lib.webp_header(data, len(data), dims, err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    out = np.empty((dims[0], dims[1], channels), np.uint8)
    if lib.webp_decode(data, len(data), channels, out.ctypes.data, out.nbytes, info, err,
                       _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def decode_webp(data: bytes, name: str = "<bytes>", alpha: bool = False) -> np.ndarray:
    """WebP bytes → (H, W, 3) uint8 RGB, or (H, W, 4) RGBA with ``alpha``
    (PIL's ``convert("RGBA")``: 255 where the file has no alpha). ``name``
    labels the errors."""
    return _decode(data, name, 4 if alpha else 3, None)


def read_webp(path: str) -> np.ndarray:
    """The WebP file at ``path`` as (H, W, 3) uint8, as PIL's
    ``convert("RGB")`` makes it."""
    with open(path, "rb") as f:
        return decode_webp(f.read(), path)


def webp_facts(data: bytes) -> dict:
    """What the first frame's bitstream uses (``FACTS``), from a decode: for
    the tests that show which coding tools a fixture exercises."""
    info = (ctypes.c_int64 * len(FACTS))()
    _decode(data, "<bytes>", 3, info)
    return dict(zip(FACTS, info))


def webp_refusal(path: str) -> Optional[str]:
    """Why ``read_webp`` refuses the file at ``path``, judged on its
    container and its first frame's bitstream header, without decoding;
    None for a file that passes them or is not a WebP file."""
    with open(path, "rb") as f:
        return webp_head_refusal(f.read(12), f)


def webp_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """``webp_refusal`` of the file open as ``f``, whose first 12 bytes or
    more ``head`` holds; reads the rest of ``f`` only for a WebP file (its
    container is walked to its end)."""
    if not is_webp(head):
        return None
    data = head + f.read()
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int64 * 2)()
    if _library().webp_header(data, len(data), dims, err, _ERR_LEN) != 0:
        return err.value.decode(errors="replace")
    return None
