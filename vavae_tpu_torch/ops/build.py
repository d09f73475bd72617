"""Build-and-load for the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/vavae_tpu_torch/``
(beside the package, listed in ``.gitignore``) at first use, named by the
hash of its source and of every header it includes from ``csrc/`` (so an
edited source or header is rebuilt), and loaded with ctypes. Nothing is
compiled when a module is imported. The compiler's report (``-Xptxas -v``:
each kernel's registers and spills) is kept beside the library and read by
``kernel_resources``.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    if out.exists() and out.with_suffix(".log").exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a reader never loads a half-written file
    return out


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGISTERS = re.compile(r"Used (\d+) registers")
_LENGTH = re.compile(r"\d+")


def _kernel_name(mangled: str) -> str:
    """``..._GLOBAL__N_...21attn_fwd_wgmma_kernelILi80EEEv...`` ->
    ``attn_fwd_wgmma_kernel<80>`` (integer template arguments; a type
    argument as its mangled name): the kernel is the length-prefixed name
    that ends in ``_kernel`` and opens a template argument list (the length
    may follow digits of the namespace's hash, so every tail of a run of
    digits is tried)."""
    for m in _LENGTH.finditer(mangled):
        for k in range(len(m.group())):
            name = mangled[m.end():m.end() + int(m.group()[k:])]
            rest = mangled[m.end() + len(name):]
            if name.endswith("_kernel") and rest.startswith("I") and "EEv" in rest:
                targs = rest[1:rest.index("EEv")]
                args = re.findall(r"L[ib](-?\d+)E|\d+(\w+?)(?=L|$)|^([a-z])", targs)
                return f"{name}<{', '.join(next(a for a in g if a) for g in args)}>"
    return mangled


def kernel_resources(name: str) -> dict:
    """Registers and spill bytes of each kernel in ``csrc/<name>.cu``, from
    the ``-Xptxas -v`` report of its build: ``{kernel: {"registers": r,
    "spill_stores": s, "spill_loads": l}}``."""
    report = build(name).with_suffix(".log").read_text()
    out, kernel = {}, None
    for line in report.splitlines():
        if m := _ENTRY.search(line):
            kernel = _kernel_name(m.group(1))
            out[kernel] = {}
        elif kernel and (m := _SPILLS.search(line)):
            out[kernel].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif kernel and (m := _REGISTERS.search(line)):
            out[kernel]["registers"] = int(m.group(1))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
