"""The native shard reader (``native/shard_reader.cpp``) through ctypes: the
threaded, mmap-backed batch assembler of ``ImgLatentDataset.batches``, over
latent shards of ``latents`` (N, C, H, W), an optional ``latents_flip`` of
the same shape (a flipped row reads ``latents`` without one) and ``labels``
(N,): what the JAX package's dataset reads. Latents may be F16, F32, F64,
an integer type or BOOL, labels any of those, as numpy loads them.

Each batch equals ``ImgLatentDataset.reference_batch``, the Python
assembly, bit for bit: the same gather, ``astype(np.float32)``, CHW → HWC
transpose and ``((x − μ) / σ) · multiplier`` in float32, in that order,
and labels as ``np.asarray(label, np.int32)`` makes them. The headers are
read here; a shard the reader does not take (BF16 or F8, which numpy
cannot load either, a missing tensor, a length or shape that does not
match), a build failure or a failed read raises, naming the file. Nothing
falls back to Python.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from vavae_tpu_torch.native.build import load_library
from vavae_tpu_torch.utils.safetensors_io import read_header

_ERR_LEN = 1024
# the reader's type codes (shard_reader.cpp's DType) and element sizes
_TYPES = {name: (code, size) for code, (name, size) in enumerate((
    ("F32", 4), ("F16", 2), ("F64", 8), ("I8", 1), ("U8", 1), ("I16", 2), ("U16", 2),
    ("I32", 4), ("U32", 4), ("I64", 8), ("U64", 8), ("BOOL", 1)))}


def _library() -> ctypes.CDLL:
    lib = load_library("shard_reader")
    if not getattr(lib, "_vavae_bound", False):
        p = ctypes.c_void_p
        lib.shard_reader_open.restype = p
        lib.shard_reader_open.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), p, p, p, p, p, p, p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int]
        lib.shard_reader_len.restype = ctypes.c_int64
        lib.shard_reader_len.argtypes = [p]
        lib.shard_reader_batch.restype = ctypes.c_int
        lib.shard_reader_batch.argtypes = [
            p, p, p, ctypes.c_int, p, p, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
            ctypes.c_int64, p, p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.shard_reader_close.restype = None
        lib.shard_reader_close.argtypes = [p]
        lib._vavae_bound = True
    return lib


def shard_layout(path: str) -> dict:
    """The tensors of one shard as the reader takes them: ``rows``, the
    latent shape ``chw``, and for ``latents``, ``latents_flip`` (the
    latents' own where the shard has none) and ``labels`` the file offset
    and the type code. Raises ``ValueError`` naming the file for anything
    else."""
    header, start = read_header(path)
    for key in ("latents", "labels"):
        if key not in header:
            raise ValueError(f"{path}: no {key!r} tensor; the shard reader needs latents "
                             "and labels")
    lat, lab = header["latents"], header["labels"]
    flip = header.get("latents_flip", lat)
    for key, t in (("latents", lat), ("latents_flip", flip)):
        if t["dtype"] not in _TYPES or len(t["shape"]) != 4:
            raise ValueError(f"{path}: {key} is {t['dtype']} {t['shape']}; the shard reader "
                             "takes F16, F32, F64, integer or BOOL (N, C, H, W)")
    if flip["shape"] != lat["shape"]:
        raise ValueError(f"{path}: latents_flip {flip['shape']} does not match latents "
                         f"{lat['shape']}")
    if lab["dtype"] not in _TYPES or len(lab["shape"]) != 1:
        raise ValueError(f"{path}: labels are {lab['dtype']} {lab['shape']}; the shard reader "
                         "takes F16, F32, F64, integer or BOOL (N,)")
    rows = int(lat["shape"][0])
    if lab["shape"][0] != rows:
        raise ValueError(f"{path}: {lab['shape'][0]} labels for {rows} latents")
    item = int(np.prod(lat["shape"][1:]))
    layout = {"rows": rows, "chw": tuple(int(s) for s in lat["shape"][1:])}
    for key, t, count in (("latents", lat, rows * item), ("latents_flip", flip, rows * item),
                          ("labels", lab, rows)):
        code, size = _TYPES[t["dtype"]]
        begin, end = t["data_offsets"]
        if end - begin != count * size:
            raise ValueError(f"{path}: {key} holds {end - begin} bytes, expected {count * size}")
        layout[key] = start + begin
        layout[key + "_type"] = code
    return layout


class NativeShardReader:
    """Batches of the shards at ``paths`` (in that order, their rows one
    after another), assembled by ``threads`` threads (0: one a core)."""

    def __init__(self, paths: Sequence[str], threads: int = 0):
        if not paths:
            raise ValueError("no shards to read")
        layouts = [shard_layout(p) for p in paths]
        chw = layouts[0]["chw"]
        for p, lay in zip(paths, layouts):
            if lay["chw"] != chw:
                raise ValueError(f"{p}: latents of shape {lay['chw']}, the first shard's are {chw}")
        self.C, self.H, self.W = chw
        self.threads = threads
        self._lib = _library()
        self._handle: Optional[int] = None
        col = lambda key, dtype: np.array([lay[key] for lay in layouts], dtype)  # noqa: E731
        rows, lat, flip = col("rows", np.int64), col("latents", np.int64), col("latents_flip", np.int64)
        lab = col("labels", np.int64)
        types = [col(k + "_type", np.int32) for k in ("latents", "latents_flip", "labels")]
        names = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        err = ctypes.create_string_buffer(_ERR_LEN)
        handle = self._lib.shard_reader_open(
            len(paths), names, rows.ctypes.data, lat.ctypes.data, flip.ctypes.data,
            lab.ctypes.data, *[t.ctypes.data for t in types], self.C * self.H * self.W, err,
            _ERR_LEN)
        if not handle:
            raise OSError(err.value.decode(errors="replace"))
        self._handle = handle
        self._n = int(self._lib.shard_reader_len(handle))

    def __len__(self) -> int:
        return self._n

    def batch(self, indices: np.ndarray, flip: np.ndarray, mean: Optional[np.ndarray],
              std: Optional[np.ndarray], multiplier: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """indices (B,) and flips (B,) bool → ((B, H, W, C) float32, (B,)
        int32). ``mean``/``std`` hold C values each, or are None for no
        normalisation."""
        if self._handle is None:
            raise ValueError("the shard reader is closed")
        idx = np.ascontiguousarray(indices, np.int64)
        fl = np.ascontiguousarray(flip, np.uint8)
        if idx.ndim != 1 or fl.shape != idx.shape:
            raise ValueError(f"indices {idx.shape} and flips {fl.shape} must be one (B,) each")
        normalize = mean is not None
        m = np.ascontiguousarray(np.reshape(mean, -1) if normalize else np.zeros(self.C), np.float32)
        s = np.ascontiguousarray(np.reshape(std, -1) if normalize else np.ones(self.C), np.float32)
        if m.shape != (self.C,) or s.shape != (self.C,):
            raise ValueError(f"mean {m.shape} and std {s.shape} must hold {self.C} values each")
        B = len(idx)
        out = np.empty((B, self.H, self.W, self.C), np.float32)
        labels = np.empty((B,), np.int32)
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.shard_reader_batch(
            self._handle, idx.ctypes.data, fl.ctypes.data, B, m.ctypes.data, s.ctypes.data,
            int(normalize), float(multiplier), self.C, self.H * self.W, out.ctypes.data,
            labels.ctypes.data, self.threads, err, _ERR_LEN)
        if rc != 0:
            raise ValueError(err.value.decode(errors="replace"))
        return out, labels

    def close(self) -> None:
        if self._handle is not None:
            self._lib.shard_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
