"""A numpy-only reader and writer of the safetensors format.

The file is an 8-byte little-endian header length, a JSON header mapping
each name to ``{dtype, shape, data_offsets}`` (plus optional
``__metadata__``), then the raw bytes. Neither direction needs the
``safetensors`` package. ``load_tree`` also undoes the JAX package's
train-state encoding (``vavae_tpu/train/checkpoint.py``): keys joined with
``|``, bf16 leaves stored as uint16 and named in the ``tree`` metadata;
``tree_metadata`` writes it.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_, "BF16": np.uint16,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}
SEP = "|"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_header(path: str) -> tuple[dict, int]:
    """The JSON header of ``path`` and the file offset where the data starts."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def map_safetensors(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Read-only views of every tensor of ``path`` over one memory map of the
    file (BF16 left as its uint16 bits), and the file's metadata."""
    header, start = read_header(path)
    meta = header.pop("__metadata__", None) or {}
    size = os.path.getsize(path) - start
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=start, shape=(size,))
            if size else np.zeros((0,), np.uint8))
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        out[name] = data[begin:end].view(_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out, meta


def read_safetensors(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """All tensors of ``path`` as numpy copies (BF16 widened to float32), and
    the file's metadata."""
    header, _ = read_header(path)
    tensors, meta = map_safetensors(path)
    out = {}
    for name, arr in tensors.items():
        out[name] = bf16_bits_to_float32(arr) if header[name]["dtype"] == "BF16" else arr.copy()
    return out, meta


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray],
                      metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` to ``path`` atomically (a temporary file, then a
    rename, so a reader never sees half a file). Arrays are written in C
    order whatever their strides; 0-d arrays keep their shape."""
    header: dict[str, Any] = {}
    offset = 0
    for name, a in tensors.items():
        a = np.asarray(a)
        if a.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors name")
        header[name] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)


def unflatten(flat: dict[str, Any], sep: str = SEP) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten(tree: Mapping, prefix: str = "", sep: str = SEP) -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key, sep))
        else:
            flat[key] = v
    return flat


def tree_metadata(bf16_keys=(), empty_keys=()) -> dict[str, str]:
    """The ``tree`` metadata of a JAX-package state file: no None leaves,
    the empty subtrees (optax's ``EmptyState``) and the bf16 leaves (stored
    as uint16 bits) named, split-half RoPE layout (format 2)."""
    meta = {"none": [], "empty": list(empty_keys),
            "dtypes": {k: "bfloat16" for k in bf16_keys}, "format_version": 2}
    return {"tree": json.dumps(meta)}


def load_tree(path: str) -> dict:
    """A JAX-package state file as a nested dict of numpy arrays."""
    tensors, meta = read_safetensors(path)
    tree_meta = json.loads(meta.get("tree", "{}"))
    for key, dt in tree_meta.get("dtypes", {}).items():
        if dt == "bfloat16" and key in tensors:
            tensors[key] = bf16_bits_to_float32(tensors[key])
    return unflatten(tensors)
