"""Image dataset reader: zip archive or directory of images with optional
`dataset.json` labels, max_size subset selection, and x-flip augmentation.

Counterpart of ``diff_sampler_tpu/eval/dataset.py`` (itself the reference's
``diff-solvers-main/dataset.py:27-258``): host code on numpy and PIL that
yields uint8 NHWC batches, the same as the JAX package's, which feed the
Inception detector.  No torch DataLoader: PNGs decode one at a time on the
calling thread.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np
import PIL.Image

__all__ = ["ImageFolderDataset"]

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class ImageFolderDataset:
    """uint8 NHWC image dataset from a directory tree or zip archive.

    Mirrors the reference semantics: sorted filename order, optional
    dataset.json {"labels": [[fname, label], ...]}, max_size random subset
    with fixed seed, optional xflip doubling (dataset.py:35-61, 174-258).
    """

    def __init__(self, path: str, resolution: Optional[int] = None,
                 max_size: Optional[int] = None, use_labels: bool = False,
                 xflip: bool = False, random_seed: int = 0):
        self._path = path
        self._zipfile = None
        self.resolution = resolution

        if os.path.isdir(path):
            self._type = "dir"
            self._all_fnames = {
                os.path.relpath(os.path.join(root, f), start=path)
                for root, _dirs, files in os.walk(path) for f in files
            }
        elif path.endswith(".zip"):
            self._type = "zip"
            self._all_fnames = set(self._get_zipfile().namelist())
        else:
            raise IOError(f"Path must be a directory or zip: {path}")

        self._image_fnames = sorted(
            f for f in self._all_fnames
            if os.path.splitext(f)[1].lower() in _EXTS)
        if not self._image_fnames:
            raise IOError("No image files found in the specified path")

        self._raw_labels = self._load_raw_labels() if use_labels else None

        raw_n = len(self._image_fnames)
        self._raw_idx = np.arange(raw_n, dtype=np.int64)
        if max_size is not None and raw_n > max_size:
            np.random.RandomState(random_seed % (1 << 31)).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    # -- file access --------------------------------------------------------

    def _get_zipfile(self):
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _open_file(self, fname):
        if self._type == "dir":
            return open(os.path.join(self._path, fname), "rb")
        return self._get_zipfile().open(fname, "r")

    def _load_raw_labels(self):
        if "dataset.json" not in self._all_fnames:
            return None
        with self._open_file("dataset.json") as f:
            labels = json.load(f).get("labels")
        if labels is None:
            return None
        labels = dict(labels)
        labels = [labels[fname.replace("\\", "/")] for fname in self._image_fnames]
        labels = np.array(labels)
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])

    # -- reading ------------------------------------------------------------

    def __len__(self) -> int:
        return self._raw_idx.size

    @property
    def label_dim(self) -> int:
        if self._raw_labels is None:
            return 0
        if self._raw_labels.ndim == 1:
            return int(self._raw_labels.max() + 1)
        return self._raw_labels.shape[1]

    def _load_image(self, raw_idx: int) -> np.ndarray:
        fname = self._image_fnames[raw_idx]
        with self._open_file(fname) as f:
            img = PIL.Image.open(f)
            img = img.convert("RGB") if img.mode not in ("RGB", "L") else img
            arr = np.array(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.resolution and arr.shape[0] != self.resolution:
            img = PIL.Image.fromarray(arr.squeeze())
            img = img.resize((self.resolution, self.resolution), PIL.Image.LANCZOS)
            arr = np.array(img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        return arr  # HWC uint8

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img = self._load_image(int(self._raw_idx[idx]))
        if self._xflip[idx]:
            img = img[:, ::-1]
        label = self.get_label(idx)
        return img.copy(), label

    def get_label(self, idx: int) -> np.ndarray:
        if self._raw_labels is None:
            return np.zeros(0, np.float32)
        label = self._raw_labels[self._raw_idx[idx]]
        if label.ndim == 0:  # int -> one-hot (dataset.py:100-105)
            onehot = np.zeros(self.label_dim, np.float32)
            onehot[int(label)] = 1.0
            return onehot
        return label.astype(np.float32)

    def batches(self, batch_size: int, *, shard_index: int = 0,
                num_shards: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images [B,H,W,C] uint8, labels) batches; round-robin
        sharding across processes (sample.py:167-169 pattern)."""
        idx = np.arange(len(self))
        shards = np.array_split(idx, max(1, len(idx) // batch_size) or 1)
        for batch_idx in shards[shard_index::num_shards]:
            pairs = [self[i] for i in batch_idx]
            imgs = np.stack([p[0] for p in pairs])
            labels = np.stack([p[1] for p in pairs])
            yield imgs, labels
