"""A numpy-only reader of the safetensors format.

The file is an 8-byte little-endian header length, a JSON header mapping
each name to ``{dtype, shape, data_offsets}`` (plus optional
``__metadata__``), then the raw bytes. Reading it needs no ``safetensors``
package. ``load_tree`` also undoes the JAX package's train-state encoding
(``vavae_tpu/train/checkpoint.py``): keys joined with ``|``, bf16 leaves
stored as uint16 and named in the ``tree`` metadata.
"""
from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_, "BF16": np.uint16,
}
SEP = "|"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """All tensors of ``path`` as numpy (BF16 widened to float32), and the
    file's metadata."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        arr = np.frombuffer(data[begin:end], dtype=_DTYPES[info["dtype"]])
        if info["dtype"] == "BF16":
            arr = bf16_bits_to_float32(arr)
        out[name] = arr.reshape(info["shape"]).copy()
    return out, meta


def unflatten(flat: dict[str, Any], sep: str = SEP) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_tree(path: str) -> dict:
    """A JAX-package state file as a nested dict of numpy arrays."""
    tensors, meta = read_safetensors(path)
    tree_meta = json.loads(meta.get("tree", "{}"))
    for key, dt in tree_meta.get("dtypes", {}).items():
        if dt == "bfloat16" and key in tensors:
            tensors[key] = bf16_bits_to_float32(tensors[key])
    return unflatten(tensors)
