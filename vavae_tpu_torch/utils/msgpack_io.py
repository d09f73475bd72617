"""A standard-library reader and writer of flax's msgpack serialization.

``flax.serialization.to_bytes`` is msgpack of the state dict (tuples and
lists turned into dicts keyed ``"0"``, ``"1"``, …) with three ext types: 1 an
ndarray, 3 a numpy scalar (both a msgpack ``(shape, dtype name, raw C-order
bytes)`` payload) and 2 a Python complex (``(real, imag)``). An array larger
than ``MAX_CHUNK_SIZE`` bytes is written as ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}`` of flat pieces. The JAX package's
legacy ``.msgpack`` checkpoints and LoRA files are such bytes; the card's
machine has no ``msgpack`` package, so the port reads and writes them here.

bfloat16 arrays travel under the dtype name ``bfloat16``; numpy has no such
type, so they decode to ``Bf16Bits``, a uint16 view of the bits, which
``widen`` turns into float32 and the encoder writes back as bfloat16.
``encode`` gives the bytes flax writes for the same tree: maps in sorted key
order (flax maps the tree through ``jax.tree_util`` first, which sorts
them; the pieces of a chunked array keep their index order), the smallest
integer and length formats, floats as float64.
"""
from __future__ import annotations

import os
import struct
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from vavae_tpu_torch.utils.safetensors_io import load_tree

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_SCALAR = 1, 2, 3


class Bf16Bits(np.ndarray):
    """A bfloat16 array held as its uint16 bits."""


def widen(x):
    """float32 values of a ``Bf16Bits`` array; anything else unchanged."""
    if isinstance(x, Bf16Bits):
        return (np.asarray(x).astype(np.uint32) << 16).view(np.float32)
    return x


# -- decoder -----------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            return {"bin": self.take, "str": self.str, "array": self.array, "map": self.map}[kind](n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_SCALAR):
            arr = _array_from_payload(data)
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")


def _array_from_payload(data: memoryview) -> np.ndarray:
    shape, name, raw = _Reader(data).obj()
    name = name if isinstance(name, str) else bytes(name).decode()
    if name == "bfloat16":
        return np.frombuffer(raw, np.uint16).reshape(shape).view(Bf16Bits)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    flat = np.concatenate([np.asarray(c) for c in chunks])
    out = flat.reshape(shape)
    return out.view(Bf16Bits) if isinstance(chunks[0], Bf16Bits) else out


def decode(data) -> Any:
    """The tree of flax msgpack bytes: dicts, Python scalars, numpy arrays
    (writable when ``data`` is a ``bytearray``) and ``Bf16Bits``."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return out


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return decode(bytearray(f.read()))


# -- encoder -----------------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                           (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
        if n >= low:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int]) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of length {n} is too long")


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _sized(len(data), None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _array_payload(arr: np.ndarray) -> bytes:
    if isinstance(arr, Bf16Bits):
        name, raw = "bfloat16", np.ascontiguousarray(arr).view(np.uint16).tobytes()
    else:
        name, raw = arr.dtype.name, arr.tobytes("C")
    return _pack([list(arr.shape), name, raw])


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16).view(Bf16Bits)
        return x.numpy()
    return x


def _chunked(arr: np.ndarray) -> dict:
    chunk = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + chunk]
                       for j, i in enumerate(range(0, flat.size, chunk))}}


def _pack(x, sort: bool = True) -> bytes:
    x = _host_array(x)
    if x is None:
        return b"\xc0"
    if x is True or x is False:
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            return _pack(_chunked(x), sort=False)
        return _ext(EXT_NDARRAY, _array_payload(x))
    if isinstance(x, np.generic):
        return _ext(EXT_SCALAR, _array_payload(np.asarray(x)))
    if isinstance(x, int):
        return _int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, complex):
        return _ext(EXT_COMPLEX, _pack([x.real, x.imag]))
    if isinstance(x, str):
        raw = x.encode("utf-8")
        return _sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        return _sized(len(raw), None, 0, (0xC4, 0xC5, 0xC6)) + raw
    if isinstance(x, Mapping):
        items = sorted(x.items()) if sort else x.items()
        return _sized(len(x), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(v, sort) for k, v in items)
    if isinstance(x, (list, tuple)):
        return _sized(len(x), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(_pack(v, sort) for v in x)
    raise TypeError(f"cannot encode {type(x).__name__} as msgpack")


def encode(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of a state-dict tree whose leaves are
    numpy arrays, torch tensors (bf16 as bfloat16), numpy or Python scalars,
    strings or None."""
    return _pack(tree)


def write_msgpack(path: str, tree: Any) -> None:
    """``encode(tree)`` to ``path`` atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(encode(tree))
    os.replace(tmp, path)


# -- state files of either format ----------------------------------------------------


def warn_legacy_rope(path: str) -> None:
    """The JAX package's warning on a legacy msgpack DiT checkpoint."""
    warnings.warn(
        f"restoring legacy msgpack checkpoint {path}: if it holds DiT weights trained "
        "before the split-half RoPE layout change (models/posembed.py), q/k columns are "
        "in the old interleaved layout and attention will be silently wrong — re-export "
        "via utils/torch_convert.py rope_permutation or retrain.",
        stacklevel=3,
    )


def _widen_tree(tree):
    if isinstance(tree, dict):
        return {k: _widen_tree(v) for k, v in tree.items()}
    return widen(tree)


def load_state_tree(path: str) -> dict:
    """A JAX-package state file, ``.safetensors`` or legacy ``.msgpack``
    (with the JAX package's RoPE-layout warning), as a nested dict of numpy
    arrays, bf16 widened to float32. A msgpack file's None leaves stay None
    and its empty subtrees stay empty dicts."""
    if str(path).endswith(".msgpack"):
        warn_legacy_rope(path)
        return _widen_tree(read_msgpack(path))
    return load_tree(path)
