"""Latent-shard dataset (port of ``vavae_tpu/data/latent_dataset.py``).

Shards are safetensors files holding ``latents`` (N, C, H, W), optionally
``latents_flip`` of the same shape (a flipped row reads ``latents``
without it), and ``labels`` (N,), of any dtype numpy loads (latents are
cast to float32, labels to int32, as the JAX package casts them). Each shard is memory-mapped once (its
header gives the offsets), and items are views into the map. Channel stats
come from a ``latents_stats.safetensors`` cache, or a reference
``latents_stats.pt`` (read through a lazy ``torch.load``), or are computed
from ≤10k random items and cached with the numpy writer.

``batches`` yields NHWC float32 batches in the JAX package's order, with
its flips and its normalisation ``(x − μ) / σ · multiplier``, bit for bit:
the same ``default_rng(seed + epoch)`` shuffle and ``default_rng([seed,
epoch, 1])`` flip stream (``index_batches``). The batches are assembled by
the native shard reader (``data/native_loader.py``: C++, threaded, over its
own maps), opened at the first batch; a shard it does not take raises there.
``reference_batch`` is the same assembly in Python, the JAX package's
arithmetic in its order, which the reader equals bit for bit; the tests and
``chip_smoke.py`` hold the two together.
"""
from __future__ import annotations

import os
import warnings
from glob import glob
from typing import Iterator, Optional, Tuple

import numpy as np

from vavae_tpu_torch.data.native_loader import NativeShardReader
from vavae_tpu_torch.parallel.mesh import process_index
from vavae_tpu_torch.utils.safetensors_io import map_safetensors, write_safetensors

STATS_FILE = "latents_stats.safetensors"


class ImgLatentDataset:
    def __init__(self, data_dir: str, latent_norm: bool = True, latent_multiplier: float = 1.0,
                 seed: int = 0):
        self.data_dir = data_dir
        self.latent_norm = latent_norm
        self.latent_multiplier = float(latent_multiplier)
        self._rng = np.random.default_rng(seed)

        self.files = [f for f in sorted(glob(os.path.join(data_dir, "*.safetensors")))
                      if not f.endswith(STATS_FILE)]
        if not self.files:
            raise FileNotFoundError(f"no latent shards in {data_dir}")
        self._shards = [map_safetensors(f)[0] for f in self.files]
        sizes = [len(s["labels"]) for s in self._shards]
        self._shard_of = np.repeat(np.arange(len(sizes)), sizes)
        self._row_of = np.concatenate([np.arange(n) for n in sizes])

        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None
        if latent_norm:
            self._mean, self._std = self._latent_stats()
        self._native: Optional[NativeShardReader] = None  # opened by the first batch

    # -- stats -------------------------------------------------------------------

    def _latent_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Channel stats (1, C, 1, 1), the reference cache layout."""
        np_cache = os.path.join(self.data_dir, STATS_FILE)
        pt_cache = os.path.join(self.data_dir, "latents_stats.pt")
        if os.path.exists(np_cache):
            tensors, _ = map_safetensors(np_cache)
            return np.array(tensors["mean"]), np.array(tensors["std"])
        if os.path.exists(pt_cache):
            import torch

            stats = torch.load(pt_cache, map_location="cpu", weights_only=False)
            return stats["mean"].numpy(), stats["std"].numpy()
        mean, std = self.compute_latent_stats()
        if process_index() == 0:  # every process computes the same; one writes
            write_safetensors(np_cache, {"mean": mean, "std": std})
        return mean, std

    def compute_latent_stats(self, num_samples: int = 10000) -> Tuple[np.ndarray, np.ndarray]:
        n = min(num_samples, len(self))
        idxs = self._rng.choice(len(self), n, replace=False)
        lats = np.stack([self._read("latents", int(i)) for i in idxs])  # (n, C, H, W)
        mean = lats.mean(axis=(0, 2, 3), keepdims=True)[0][None]
        std = lats.std(axis=(0, 2, 3), keepdims=True, ddof=1)[0][None]
        return mean.astype(np.float32), std.astype(np.float32)

    @property
    def latent_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) each (1, C, 1, 1); used by sampling to un-normalise."""
        if self._mean is None:
            return np.zeros((1, 1, 1, 1), np.float32), np.ones((1, 1, 1, 1), np.float32)
        return self._mean, self._std

    # -- items -------------------------------------------------------------------

    def _read(self, key: str, idx: int) -> np.ndarray:
        return self._shards[self._shard_of[idx]][key][self._row_of[idx]]

    def __len__(self) -> int:
        return len(self._shard_of)

    # -- batching ----------------------------------------------------------------

    def batches(self, batch_size: int, *, shuffle: bool = True, drop_last: bool = True,
                seed: int = 0, rows: Optional[Tuple[int, int]] = None,
                epochs: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (latents (B, H, W, C) float32, labels (B,) int32) forever, or
        for ``epochs`` passes: the items and flips of ``index_batches``,
        assembled by the native reader."""
        if self._native is None:  # opened (and its library built) at the first batch
            self._native = NativeShardReader(self.files)
        it = self.index_batches(batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                                rows=rows, epochs=epochs)
        for idxs, flips in it:
            yield self._native.batch(idxs, flips, self._mean, self._std, self.latent_multiplier)

    def reference_batch(self, idxs: np.ndarray, flips: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The batch of items ``idxs`` (``latents_flip`` where ``flips`` and
        the shard has it) assembled in Python: what ``batches`` yields for
        them, bit for bit."""
        lats = np.stack([self._read("latents_flip" if fl and "latents_flip" in self._shards[
            self._shard_of[i]] else "latents", int(i)).astype(np.float32)
            for i, fl in zip(idxs, flips)])
        # the JAX package's cast, label by label (an array of mixed types would promote)
        labels = np.array([np.asarray(self._read("labels", int(i)), np.int32) for i in idxs],
                          np.int32)
        if self.latent_norm:  # the JAX package's arithmetic, in its order
            lats = (lats - self._mean[0]) / self._std[0]
        lats = lats * self.latent_multiplier
        return np.ascontiguousarray(lats.transpose(0, 2, 3, 1)), labels

    def index_batches(self, batch_size: int, *, shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0, rows: Optional[Tuple[int, int]] = None,
                      epochs: Optional[int] = None
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (items (B,), flips (B,) bool) of each batch, forever or for
        ``epochs`` passes. ``rows`` = (i, n) yields rows [i·b, (i+1)·b),
        b = batch_size / n, of each batch one process would yield, with that
        batch's flips: n processes then read together exactly the global
        batches of one, each as many (a process with one more would wait
        forever in a collective), so a world of n takes a world of 1's
        steps."""
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            stop = len(order) - (len(order) % batch_size) if drop_last else len(order)
            if stop == 0:
                msg = (f"dataset ({len(order)} items) is smaller than batch_size {batch_size}"
                       + (" with drop_last" if drop_last else "") + " — the epoch yields zero batches")
                if epochs is None:
                    raise ValueError(msg + " and epochs=None would spin forever")
                warnings.warn(msg, stacklevel=2)
            # a seed space disjoint from the shuffle stream (seed + epoch)
            flip_rng = np.random.default_rng([seed, epoch, 1])
            for s in range(0, stop, batch_size):
                idxs = order[s: s + batch_size]
                flips = flip_rng.random(len(idxs)) > 0.5
                if rows is not None:
                    i, n = rows
                    b = len(idxs) // n
                    idxs, flips = idxs[i * b:(i + 1) * b], flips[i * b:(i + 1) * b]
                yield idxs, flips
            epoch += 1
