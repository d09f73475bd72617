"""Image-folder datasets (port of ``vavae_tpu/data/image_folder.py``): the
recursive class-per-subdirectory scan, the micro-Doppler split files and the
real + generated mixed-domain set, as NHWC float32 batches in [-1, 1].

Images are read by ``utils/png.py:read_image_rgb`` (PNG, JPEG, WebP, BMP,
GIF, TIFF, PNM, ICO and CUR by the port's own decoders, whatever the file's
name; other types through PIL, imported only for them) and resized by
``utils/pil_resize.py``, PIL's fixed-point BICUBIC, so items equal the JAX
package's bit for bit. Orders, labels, shuffles and striping are its own.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vavae_tpu_torch.utils.pil_resize import resize_uint8
from vavae_tpu_torch.utils.png import read_image_rgb

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".JPEG", ".PNG")


def _load_image(path: str, image_size: int) -> np.ndarray:
    """Short side BICUBIC-resized to ``image_size``, center crop, [-1, 1]
    (the LDM micro-Doppler transform)."""
    img = read_image_rgb(path)
    h, w = img.shape[:2]
    scale = image_size / min(w, h)
    arr = resize_uint8(img, (round(w * scale), round(h * scale)), "bicubic").astype(np.float32)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    arr = arr[cy : cy + image_size, cx : cx + image_size]
    return arr / 127.5 - 1.0


class ImageFolderDataset:
    """Recursive folder scan; class id from the immediate parent dir when the
    layout is class-per-subdir, else 0."""

    def __init__(self, root: str, image_size: int = 256, recursive: bool = True):
        self.root = root
        self.image_size = image_size
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.items: List[Tuple[str, int]] = []
        if classes:
            for c in classes:
                pattern = os.path.join(root, c, "**", "*") if recursive else os.path.join(root, c, "*")
                for p in sorted(glob(pattern, recursive=recursive)):
                    if p.endswith(IMG_EXTS):
                        self.items.append((p, self.class_to_idx[c]))
        else:
            for p in sorted(glob(os.path.join(root, "*"))):
                if p.endswith(IMG_EXTS):
                    self.items.append((p, 0))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[idx]
        return _load_image(path, self.image_size), label

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        epochs: Optional[int] = None,
        workers: int = 8,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``workers`` threads decode the images of each batch concurrently
        (zlib and numpy release the GIL for the heavy parts). Ordering and
        the shuffle stream are identical for any worker count."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=max(1, workers)) if workers > 1 else None
        try:
            epoch = 0
            while epochs is None or epoch < epochs:
                order = np.arange(len(self))
                if shuffle:
                    np.random.default_rng(seed + epoch).shuffle(order)
                if process_count > 1:
                    # equalize BEFORE striping (same as ImgLatentDataset.batches):
                    # otherwise processes get counts differing by one and the
                    # extra batch's data-parallel collective waits forever
                    order = order[: len(order) - (len(order) % process_count)]
                order = order[process_index::process_count]
                stop = len(order) - (len(order) % batch_size) if drop_last else len(order)
                if stop == 0:
                    msg = (
                        f"per-process dataset ({len(order)} items after striping "
                        f"{process_count} ways) is smaller than batch_size "
                        f"{batch_size}"
                        + (" with drop_last" if drop_last else "")
                        + " — the epoch yields zero batches"
                    )
                    if epochs is None:
                        raise ValueError(msg + " and epochs=None would spin forever")
                    import warnings

                    warnings.warn(msg, stacklevel=2)
                for s in range(0, stop, batch_size):
                    idxs = [int(i) for i in order[s : s + batch_size]]
                    items = list(pool.map(self.__getitem__, idxs)) if pool else [
                        self[i] for i in idxs
                    ]
                    imgs, labels = zip(*items)
                    yield np.stack(imgs), np.asarray(labels, np.int32)
                epoch += 1
        finally:
            if pool:
                pool.shutdown(wait=False)


def parse_user_id(name: str) -> Optional[int]:
    """User-dir name → 0-based class id (domain_classifier_training.py:373-389):
    ``ID_k`` is 1-based (→ k-1), ``User_k``/``user_k`` already 0-based, a bare
    number is taken as-is; anything else is skipped (None)."""
    if name.startswith("ID_"):
        try:
            return int(name.split("_")[1]) - 1
        except (IndexError, ValueError):
            return None
    if name.startswith(("User_", "user_")):
        try:
            return int(name.split("_")[1])
        except (IndexError, ValueError):
            return None
    try:
        return int(name)
    except ValueError:
        return None


class MixedDomainDataset(ImageFolderDataset):
    """Real + generated multi-source classifier dataset — the "does synthetic
    data improve cross-domain generalization" experiment
    (domain_adaptation_experiment/domain_classifier_training.py:279-541).

    Semantics matched to the reference's ``DomainAdaptationDataset``:
      - real data comes from a presplit JSON (either the reference's
        ``{"train": {user_folder: [paths]}, "val": ...}`` layout from its
        prepare_dataset_split.py, or this repo's flat
        ``{"train": [{"path", "user_id"}]}`` layout) or, without a split
        file, from an ``ID_*``/``User_*``/``user_*`` directory scan with a
        deterministic per-user 80/20 split (``random.Random(42 + user_id)``
        shuffle, reference :441-452);
      - generated dirs (same per-user layout) are merged into the TRAIN
        split only, each tagged ``generated_{i}`` (reference :313-320, 454+);
      - a data-statistics summary is printed at construction (reference
        ``_print_data_statistics``), also available as ``summary()``.
    """

    def __init__(
        self,
        real_dir: Optional[str] = None,
        generated_dirs: Optional[List[str]] = None,
        split: str = "train",
        image_size: int = 256,
        use_generated: bool = False,
        split_file: Optional[str] = None,
        train_ratio: float = 0.8,
        verbose: bool = True,
    ):
        self.image_size = image_size
        self.split = split
        self.class_to_idx = {}
        self.items: List[Tuple[str, int]] = []
        self.sources: List[str] = []  # parallel to items: "real"/"generated_i"

        if real_dir:
            if split_file:
                self._load_presplit(split_file, split)
            else:
                self._load_dir(real_dir, "real", split, train_ratio)
        if use_generated and split == "train":
            for i, gdir in enumerate(generated_dirs or []):
                if not os.path.isdir(gdir):
                    print(f"warning: generated dir not found: {gdir}")
                    continue
                self._load_dir(gdir, f"generated_{i + 1}", split, train_ratio)
        if not self.items:
            raise ValueError("MixedDomainDataset found no images")
        if verbose:
            s = self.summary()
            amp = (f"{s['generated'] / s['real']:.2f}x" if s["real"]
                   else "no real data")
            print(
                f"[{split}] real {s['real']} + generated {s['generated']} "
                f"(amplification {amp}) over {s['users']} users; "
                f"per-source: {s['per_source']}"
            )

    def _load_presplit(self, split_file: str, split: str) -> None:
        with open(split_file) as f:
            data = json.load(f)
        entries = data.get(split, {})
        if isinstance(entries, dict):
            # reference layout: {user_folder_name: [image paths]}
            for folder, paths in entries.items():
                uid = parse_user_id(folder)
                if uid is None:
                    print(f"warning: cannot parse user id from {folder!r}")
                    continue
                for p in paths:
                    if os.path.exists(p):
                        self.items.append((p, uid))
                        self.sources.append("real")
        else:
            # this repo's flat layout (prepare_dataset_split.py)
            for e in entries:
                if isinstance(e, dict):
                    path = e.get("path") or e.get("file")
                    uid = int(e.get("user_id", e.get("label", 0)))
                else:
                    path, uid = e[0], int(e[1])
                # same missing-file policy as the reference layout above:
                # skip at construction instead of raising mid-epoch in the
                # decode pool
                if not os.path.exists(path):
                    print(f"warning: image file missing: {path}")
                    continue
                self.items.append((path, uid))
                self.sources.append("real")

    def _load_dir(self, root: str, tag: str, split: str, train_ratio: float) -> None:
        import random as _random

        user_dirs = []
        for d in sorted(os.listdir(root)):
            full = os.path.join(root, d)
            uid = parse_user_id(d)
            if os.path.isdir(full) and uid is not None:
                user_dirs.append((uid, full))
        if not user_dirs:
            print(f"warning: no ID_*/User_*/user_* dirs under {root}")
            return
        for uid, full in user_dirs:
            paths = []
            for ext in ("*.png", "*.jpg", "*.jpeg"):
                paths.extend(glob(os.path.join(full, ext)))
            paths.sort()
            if tag == "real":
                # deterministic per-user split: the same files land in train
                # vs val across instantiations (reference seeds 42 + user_id)
                _random.Random(42 + uid).shuffle(paths)
                cut = int(len(paths) * train_ratio)
                paths = paths[:cut] if split == "train" else paths[cut:]
            elif split != "train":
                continue  # generated data never enters validation
            for p in paths:
                self.items.append((p, uid))
                self.sources.append(tag)

    def summary(self) -> dict:
        per_source: dict = {}
        users = set()
        for (_, uid), src in zip(self.items, self.sources):
            per_source[src] = per_source.get(src, 0) + 1
            users.add(uid)
        real = per_source.get("real", 0)
        return {
            "real": real,
            "generated": len(self.items) - real,
            "users": len(users),
            "per_source": per_source,
        }


class SplitFileDataset(ImageFolderDataset):
    """Micro-Doppler split-file dataset. Accepts every split-JSON layout the
    reference reads or writes (microdoppler_dataset_diffusion.py:38-85,
    extract_microdoppler_features.py:87-110, and this repo's
    prepare_dataset_split):

      - flat list:  {"train": [{"path":..., "user_id":...}, ...]} (ours;
        ``[path, uid]`` pairs also accepted)
      - per-user dict: {"train": {"ID_1": [rel_paths...], ...}} — the
        reference prepare_dataset_split.py output; user ids parsed from the
        folder name (`parse_user_id` conventions), missing files skipped with
        a warning like the reference
      - legacy list of strings: directory names (scanned recursively for
        images, user id from the dir name) or file paths (user id from the
        first path component)

    Relative paths resolve against ``root`` (the reference's dataset_root)."""

    def __init__(self, split_file: str, split: str = "train", image_size: int = 256,
                 root: Optional[str] = None, user_id: Optional[int] = None):
        self.image_size = image_size
        with open(split_file) as f:
            data = json.load(f)
        if split not in data:
            raise ValueError(f"Split {split!r} not found in {split_file}")
        entries = data[split]
        self.items = []

        def resolve(path: str) -> str:
            if root and not os.path.isabs(path):
                return os.path.join(root, path)
            return path

        def add(path: str, uid: int) -> None:
            if user_id is None or uid == user_id:
                self.items.append((path, uid))

        if isinstance(entries, dict):
            # reference layout: {user_folder: [paths]}; missing files skipped
            # (microdoppler_dataset_diffusion.py:41-56)
            for folder, paths in sorted(entries.items()):
                uid = parse_user_id(folder)
                if uid is None:
                    continue
                for p in paths:
                    p = resolve(p)
                    if os.path.isfile(p):
                        add(p, uid)
                    else:
                        print(f"SplitFileDataset: missing file skipped: {p}")
        else:
            for e in entries:
                if isinstance(e, dict):
                    path = resolve(e.get("path") or e.get("file"))
                    uid = int(e.get("user_id", e.get("label", 0)))
                    # same missing-file policy as the dict layout above: skip
                    # at construction instead of raising mid-epoch in the
                    # decode pool
                    if os.path.isfile(path):
                        add(path, uid)
                    else:
                        print(f"SplitFileDataset: missing file skipped: {path}")
                elif isinstance(e, str):
                    # legacy layout (microdoppler_dataset_diffusion.py:57-83)
                    p = resolve(e)
                    if os.path.isdir(p):
                        uid = parse_user_id(os.path.basename(e.rstrip("/")))
                        for f_ in sorted(glob(os.path.join(p, "**", "*"),
                                              recursive=True)):
                            if f_.endswith(IMG_EXTS):
                                add(f_, uid if uid is not None else 0)
                    elif os.path.isfile(p):
                        # reference gate: non-existent legacy file entries are
                        # dropped (microdoppler_dataset_diffusion.py:76); uid
                        # from the first path component that parses (absolute
                        # entries have a leading '' component)
                        uid = next(
                            (u for u in map(parse_user_id, e.split(os.sep))
                             if u is not None),
                            0,
                        )
                        add(p, uid)
                    else:
                        print(f"SplitFileDataset: missing file skipped: {p}")
                else:
                    add(resolve(e[0]), int(e[1]))
        self.class_to_idx = {}
