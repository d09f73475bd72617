"""LSUN and ImageNet dataset classes (port of ``vavae_tpu/data/ldm_datasets.py``):
LDM-format trees, no downloads.

  - ``LSUNBase`` reads a txt filelist under ``data_root`` (score-sde centre
    crop → resize → random horizontal flip → [-1, 1]); the six
    Churches/Bedrooms/Cats Train/Validation subclasses carry their default
    filelist locations.
  - ``ImageNetTrain``/``ImageNetValidation`` read a prepared tree
    ``root/data/<synset>/*.JPEG`` through a sorted ``filelist.txt`` (built
    on first use, byte for byte as the JAX package builds it), drop the
    known-bad file, label by sorted synset (or ``index_synset.yaml``), resize
    the smallest side to ``size`` with BILINEAR and crop ``size``² at random
    (train) or in the centre (validation).

Images are read by ``utils/png.py:read_image_rgb`` (the port's JPEG, WebP
and BMP decoders, bit-exact with PIL's; LSUN's own export writes WebP
files) and resized by
``utils/pil_resize.py`` (PIL's fixed-point filters), so items equal the JAX
package's bit for bit. Crops draw from the stdlib ``random`` and LSUN's flip
from ``random.random()``, as there, so one ``random.seed`` gives both
packages the same draws. All classes plug into
``ImageFolderDataset.batches`` (threaded decode, process striping) through
``__getitem__``.
"""
from __future__ import annotations

import os
import random
from glob import glob
from typing import Optional, Tuple

import numpy as np

from vavae_tpu_torch.data.image_folder import ImageFolderDataset
from vavae_tpu_torch.utils import yaml_io
from vavae_tpu_torch.utils.pil_resize import resize_uint8
from vavae_tpu_torch.utils.png import read_image_rgb

_RESAMPLE = {"linear": "bilinear", "bilinear": "bilinear", "bicubic": "bicubic",
             "lanczos": "lanczos"}


class LSUNBase(ImageFolderDataset):
    """LSUN split driven by a txt filelist (ldm/data/lsun.py:9-59).

    ``__getitem__`` → (image float32 [-1, 1] HWC, 0); ``example(i)`` returns
    the reference's dict form (image + relative/absolute paths). The flip
    draws fresh randomness at each access, like torchvision's
    RandomHorizontalFlip (seed ``random`` for reproducible runs).
    """

    def __init__(self, txt_file: str, data_root: str, size: Optional[int] = None,
                 interpolation: str = "bicubic", flip_p: float = 0.5):
        with open(txt_file) as f:
            self.image_paths = [p for p in f.read().splitlines() if p.strip()]
        self.data_root = data_root
        self.size = size
        self.image_size = size or 256
        self.flip_p = flip_p
        self.interpolation = _RESAMPLE[interpolation]
        self.items = [(os.path.join(data_root, p), 0) for p in self.image_paths]

    def _process(self, path: str) -> np.ndarray:
        img = read_image_rgb(path)
        # score-sde preprocessing: centre square crop, THEN resize
        h, w = img.shape[0], img.shape[1]
        crop = min(h, w)
        img = img[(h - crop) // 2: (h + crop) // 2, (w - crop) // 2: (w + crop) // 2]
        if self.size is not None:
            img = resize_uint8(img, (self.size, self.size), self.interpolation)
        if self.flip_p > 0 and random.random() < self.flip_p:
            img = img[:, ::-1]
        return (img / 127.5 - 1.0).astype(np.float32)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        return self._process(self.items[i][0]), 0

    def example(self, i: int) -> dict:
        """Reference-format item dict (lsun.py:39-58)."""
        rel = self.image_paths[i]
        return {"relative_file_path_": rel, "file_path_": os.path.join(self.data_root, rel),
                "image": self._process(os.path.join(self.data_root, rel))}


def _lsun_subclass(name, txt, root, train):
    def __init__(self, flip_p=(0.5 if train else 0.0), data_root=None, txt_file=None, **kwargs):
        LSUNBase.__init__(self, txt_file=txt_file or txt, data_root=data_root or root,
                          flip_p=flip_p, **kwargs)

    return type(name, (LSUNBase,), {"__init__": __init__})


# the six reference subclasses with their default filelist locations
LSUNChurchesTrain = _lsun_subclass(
    "LSUNChurchesTrain", "data/lsun/church_outdoor_train.txt", "data/lsun/churches", True)
LSUNChurchesValidation = _lsun_subclass(
    "LSUNChurchesValidation", "data/lsun/church_outdoor_val.txt", "data/lsun/churches", False)
LSUNBedroomsTrain = _lsun_subclass(
    "LSUNBedroomsTrain", "data/lsun/bedrooms_train.txt", "data/lsun/bedrooms", True)
LSUNBedroomsValidation = _lsun_subclass(
    "LSUNBedroomsValidation", "data/lsun/bedrooms_val.txt", "data/lsun/bedrooms", False)
LSUNCatsTrain = _lsun_subclass("LSUNCatsTrain", "data/lsun/cat_train.txt", "data/lsun/cats", True)
LSUNCatsValidation = _lsun_subclass(
    "LSUNCatsValidation", "data/lsun/cat_val.txt", "data/lsun/cats", False)


_IGNORE_FILES = {"n06596364_9591.JPEG"}  # imagenet.py:49-52


class ImageNetBase(ImageFolderDataset):
    """Prepared-tree ImageNet (imagenet.py:134-270 without the downloads).

    Layout: ``root/data/<synset>/*.JPEG``. ``filelist.txt`` is built from a
    sorted glob if absent and kept, as the reference writes it after its tar
    extraction. Labels are sorted-unique-synset indices (imagenet.py:103-108);
    ``keep_orig_class_label=True`` with an ``index_synset.yaml`` in root uses
    the canonical ILSVRC indices.
    """

    random_crop = False
    expected_length: Optional[int] = None

    def __init__(self, data_root: str, size: int = 256, random_crop: Optional[bool] = None,
                 keep_orig_class_label: bool = False, strict_length: bool = False):
        self.root = data_root
        self.datadir = os.path.join(data_root, "data")
        self.size = size
        self.image_size = size
        if random_crop is not None:
            self.random_crop = random_crop
        if not os.path.isdir(self.datadir):
            raise FileNotFoundError(
                f"{self.datadir} not found: provide the extracted ImageNet tree "
                "(root/data/<synset>/*.JPEG); the reference's torrent download is not "
                "replicated")
        txt = os.path.join(data_root, "filelist.txt")
        if not os.path.exists(txt):
            files = glob(os.path.join(self.datadir, "**", "*.JPEG"), recursive=True)
            files = sorted(os.path.relpath(p, self.datadir) for p in files)
            with open(txt, "w") as f:
                f.write("\n".join(files) + "\n")
        with open(txt) as f:
            relpaths = [p for p in f.read().splitlines() if p]
        relpaths = [p for p in relpaths if os.path.basename(p) not in _IGNORE_FILES]
        if strict_length and self.expected_length is not None and \
                len(relpaths) != self.expected_length:
            raise ValueError(f"{txt}: {len(relpaths)} files, expected {self.expected_length}")

        synsets = [p.split(os.sep)[0].split("/")[0] for p in relpaths]
        uniq = sorted(set(synsets))
        if keep_orig_class_label:
            with open(os.path.join(data_root, "index_synset.yaml")) as f:
                idx2syn = yaml_io.safe_load(f)
            syn2idx = {v: k for k, v in idx2syn.items()}
            class_of = {s: syn2idx[s] for s in uniq}
        else:
            class_of = {s: i for i, s in enumerate(uniq)}
        self.class_to_idx = dict(class_of)
        self.items = [(os.path.join(self.datadir, p), class_of[s])
                      for p, s in zip(relpaths, synsets)]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[idx]
        img = read_image_rgb(path)
        h, w = img.shape[:2]
        # taming ImagePaths: smallest side → size, then crop to size²
        scale = self.size / min(w, h)
        arr = resize_uint8(img, (max(self.size, round(w * scale)),
                                 max(self.size, round(h * scale))), "bilinear")
        H, W = arr.shape[:2]
        if self.random_crop:
            y0 = random.randint(0, H - self.size)
            x0 = random.randint(0, W - self.size)
        else:
            y0, x0 = (H - self.size) // 2, (W - self.size) // 2
        arr = arr[y0: y0 + self.size, x0: x0 + self.size]
        return (arr / 127.5 - 1.0).astype(np.float32), label


class ImageNetTrain(ImageNetBase):
    NAME = "ILSVRC2012_train"
    random_crop = True  # imagenet.py:160-161 default True
    expected_length = 1281167


class ImageNetValidation(ImageNetBase):
    NAME = "ILSVRC2012_validation"
    random_crop = False  # imagenet.py:225-226 default False
    expected_length = 50000
