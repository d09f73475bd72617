"""Build-and-load for the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/vavae_tpu_torch/``
(beside the package, listed in ``.gitignore``) at first use, named by the
hash of its source and of every header it includes from ``csrc/`` (so an
edited source or header is rebuilt), and loaded with ctypes. Nothing is
compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vavae_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly or
    through another header, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use"
        )
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source and its
    headers (keyed by their hash) exists; returns the library's path."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"{name}.{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a reader never loads a half-written file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
