"""Build-and-load for the port's host C++ libraries.

Each ``native/<name>.cpp`` (the shard reader, the JPEG and WebP decoders
and the LZW and PackBits decoders of GIF and TIFF)
exposes a plain C interface. It is compiled with ``g++`` into a shared
library under ``build/vavae_tpu_torch/`` (beside the package, listed in
``.gitignore``) at first use, named by the hash of its source and of the
compiler flags, and loaded with ctypes. The flags keep the floating-point
order the source writes (``-ffp-contract=off``, no ``-ffast-math``). The
finished file is put in place with an atomic rename, a failed build raises
with the compiler's output, and nothing is compiled when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vavae_tpu_torch"
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]
LINK = {"shard_reader": [], "jpeg_decoder": [], "webp_decoder": [], "lzw_decoder": []}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless the library for this source and
    these flags exists; returns the library's path."""
    src = SRC / f"{name}.cpp"
    flags = GXX_FLAGS + LINK[name]
    h = hashlib.sha256(src.read_bytes() + "\0".join(flags).encode())
    out = BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; {name}.cpp is built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    cmd = [gxx, *GXX_FLAGS, str(src), "-o", str(tmp), *LINK[name]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {name}.cpp ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never loads a half-written file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``native/<name>.cpp``, built on first use (once
    per process, whichever thread asks first)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib
