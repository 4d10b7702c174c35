"""Datasets (port of ``data/datasets.py``).

The port keeps its own numpy copies, so a seed gives the same arrays as
the JAX package's, bit for bit (the same crc32 salt of the split and the
same ``default_rng`` stream per index):

- :class:`SyntheticDataset` (``datasets.py:58``): class-dependent Gaussian
  images, ``(image [H, W, 3] float32, label int64)``, HWC as the JAX
  package feeds its NHWC model;
- :class:`SyntheticTextDataset` (``datasets.py:99``): per-index Markov
  chains over a per-split transition table, host-shifted ``(inputs
  [seq_len], targets [seq_len])`` int32 pairs;
- :class:`ImageFolderDataset` (``datasets.py:287``): ``<root>/<split>/
  <class>/<image>`` with torchvision's sorted class mapping; crop boxes and
  flips are sampled on the host from per-sample streams
  (:func:`sample_rng`, :func:`sample_crop_params`), pixels come from PIL
  here or, a batch at a time, from the native decoder
  (:mod:`..native`), which the loader drives through :meth:`crop_task`.

- :class:`TokenFileDataset` (``datasets.py:163-200``): a memory-mapped
  ``<root>/<split>.bin`` of token ids in non-overlapping ``seq_len + 1``
  windows, ``(inputs, targets)`` int32 pairs.

``get_dataset`` knows ``imagenet``, ``synthetic``/``fake``/
``fake_imagenet``, ``synthetic_text``/``fake_text`` and ``tokens``/
``tokenbin``.
"""
from __future__ import annotations

import logging
import os
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageFolderDataset",
    "SyntheticDataset",
    "SyntheticTextDataset",
    "TokenFileDataset",
    "fetch_sample",
    "get_dataset",
    "sample_crop_params",
    "sample_rng",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class SyntheticDataset:
    """Deterministic fake ImageNet: standard-normal images with a mean shift
    by class, so short runs have something to learn."""

    def __init__(self, n_samples: int = 1280, n_classes: int = 1000, image_size: int = 224,
                 split: str = "train", seed: int = 0):
        self.n_samples = int(n_samples)
        self.n_classes = int(n_classes)
        self.image_size = int(image_size)
        # crc32, not hash(): the same salt in every process
        self._salt = (zlib.crc32(split.encode()) & 0xFFFF) ^ seed

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.int64]:
        rng = np.random.default_rng(self._salt * 1_000_003 + idx)
        label = idx % self.n_classes
        img = rng.standard_normal((self.image_size, self.image_size, 3), dtype=np.float32)
        img += 0.1 * ((label % 16) - 8) / 8.0
        return img, np.int64(label)


class SyntheticTextDataset:
    """Deterministic fake corpus: per-index Markov-chain token sequences
    over a fixed random bigram table (90% table steps, 10% random jumps), so
    short LM runs have learnable next-token structure."""

    def __init__(self, n_samples: int = 1024, vocab_size: int = 512, seq_len: int = 128,
                 split: str = "train", seed: int = 0):
        self.n_samples = int(n_samples)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        # crc32, not hash(): the same salt in every process
        self._salt = (zlib.crc32(split.encode()) & 0xFFFF) ^ seed
        table_rng = np.random.default_rng(self._salt)
        self._successors = table_rng.integers(
            0, self.vocab_size, (self.vocab_size, 8), dtype=np.int32
        )
        self._succ_rows = None  # python-list view for the sequential walk

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self._salt * 1_000_003 + idx)
        cur = int(rng.integers(0, self.vocab_size))
        choices = rng.integers(0, 8, self.seq_len).tolist()
        jumps = (rng.random(self.seq_len) < 0.1).tolist()
        randoms = rng.integers(0, self.vocab_size, self.seq_len).tolist()
        if self._succ_rows is None:
            self._succ_rows = self._successors.tolist()
        succ = self._succ_rows
        out = [cur]
        for t in range(self.seq_len):
            cur = randoms[t] if jumps[t] else succ[cur][choices[t]]
            out.append(cur)
        toks = np.asarray(out, dtype=np.int32)
        return toks[:-1], toks[1:]


class TokenFileDataset:
    """``<root>/<split>.bin`` of little-endian token ids, cut into
    non-overlapping ``seq_len + 1`` windows; window ``i`` yields the
    host-shifted ``(inputs, targets)``.  ``<root>/meta.json`` may set
    ``dtype`` (default ``uint16``) and ``vocab_size``.  The file is mapped
    in each process that reads it (a pickled dataset carries its path, not
    its tokens)."""

    def __init__(self, root: str, split: str, seq_len: int = 128):
        import json

        self.root = os.path.expanduser(root)
        self.seq_len = int(seq_len)
        self.path = os.path.join(self.root, f"{split}.bin")
        if not os.path.isfile(self.path):
            raise FileNotFoundError(f"token file not found: {self.path}")
        self.dtype = np.dtype("uint16")
        self.vocab_size: Optional[int] = None
        meta_path = os.path.join(self.root, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as fp:
                meta = json.load(fp)
            self.dtype = np.dtype(meta.get("dtype", "uint16"))
            self.vocab_size = meta.get("vocab_size")
        self._tokens = None
        n_tokens = os.path.getsize(self.path) // self.dtype.itemsize
        self.n_windows = (n_tokens - 1) // self.seq_len
        if self.n_windows <= 0:
            raise ValueError(
                f"{self.path}: {n_tokens} tokens < one {self.seq_len + 1}-token window")

    def __getstate__(self):
        return {**self.__dict__, "_tokens": None}

    def __len__(self) -> int:
        return self.n_windows

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._tokens is None:
            self._tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        start = int(idx) * self.seq_len
        window = np.asarray(self._tokens[start:start + self.seq_len + 1], dtype=np.int32)
        return window[:-1], window[1:]


def sample_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """Per-sample augmentation stream ``default_rng([seed, epoch, idx])``:
    reproducible whichever thread or process draws it."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(epoch), int(idx)])


def fetch_sample(dataset, idx: int, seed: int, epoch: int):
    """``dataset[idx]``, through ``get_sample(idx, rng)`` with the per-sample
    stream where the dataset augments."""
    get = getattr(dataset, "get_sample", None)
    if get is not None:
        return get(idx, sample_rng(seed, epoch, idx))
    return dataset[int(idx)]


def sample_crop_params(w: int, h: int, rng: Optional[np.random.Generator], train: bool,
                       scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), resize_to: int = 256,
                       size: int = 224) -> Tuple[float, float, float, float, bool]:
    """The source crop box ``(x, y, cw, ch)`` and the horizontal flip.

    Train: torchvision's ``RandomResizedCrop`` (10 attempts at an area- and
    aspect-jittered box, then a centre crop at the clamped aspect) and a
    flip with p = 0.5.  Val: Resize(``resize_to``) + CenterCrop(``size``)
    as one source box, so every backend resamples the original once.
    """
    if train:
        if rng is None:
            raise ValueError("train crop sampling requires an RNG")
        area = w * h
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*scale)
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = int(rng.integers(0, w - cw + 1))
                y = int(rng.integers(0, h - ch + 1))
                return float(x), float(y), float(cw), float(ch), bool(rng.random() < 0.5)
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            cw, ch = int(round(h * ratio[1])), h
        else:
            cw, ch = w, h
        x, y = (w - cw) // 2, (h - ch) // 2
        return float(x), float(y), float(cw), float(ch), bool(rng.random() < 0.5)
    s = resize_to / min(w, h)
    cw = size / s
    ch = size / s
    return (w - cw) / 2, (h - ch) / 2, cw, ch, False


class ImageFolderDataset:
    """``<root>/<split>/<class_dir>/<image>``, torchvision's semantics.

    Classes take indices in sorted order of their directory names.
    Samples are ``(uint8 [size, size, 3], int64 label)``; the loader
    normalises them with :attr:`norm_mean`/:attr:`norm_std`, on the host or
    on the card.  A file that neither libjpeg nor PIL decodes is
    quarantined: zero pixels under its true label, one
    ``data_corrupt_samples`` count each time, one log line per path.
    """

    norm_mean = IMAGENET_MEAN
    norm_std = IMAGENET_STD

    def __init__(self, root: str, split: str, image_size: int = 224,
                 train_transform: Optional[bool] = None):
        self.root = os.path.expanduser(root)
        self.split = split
        self.image_size = image_size
        self.train = train_transform if train_transform is not None else (split == "train")
        split_dir = os.path.join(self.root, split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"dataset split dir not found: {split_dir}")
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {split_dir}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(split_dir, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        # header dims, (w, h) a sample, w == 0 unseen: allocated at first
        # use under the lock, so two threads cannot each install an array
        self._dims_cache: Optional[np.ndarray] = None
        self._dims_lock = threading.Lock()
        self._corrupt_logged: set = set()  # guarded by _corrupt_lock
        self._corrupt_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.samples)

    def __getstate__(self):
        # locks do not pickle; a worker starts with an empty memo
        state = self.__dict__.copy()
        state.update(_dims_lock=None, _dims_cache=None, _corrupt_lock=None,
                     _corrupt_logged=set())
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._dims_lock = threading.Lock()
        self._corrupt_lock = threading.Lock()

    def image_dims(self, idx: int) -> Tuple[int, int]:
        """``(width, height)`` from the header alone, memoised: the crop
        sampling that needs it runs serially before each native batch."""
        if self._dims_cache is None:
            with self._dims_lock:
                if self._dims_cache is None:
                    self._dims_cache = np.zeros((len(self.samples), 2), np.int32)
        w, h = self._dims_cache[idx]
        if w:
            return int(w), int(h)
        from PIL import Image

        try:
            with Image.open(self.samples[idx][0]) as im:
                dims = im.size
        except (OSError, ValueError, SyntaxError):
            # the decode fails this row too, and quarantines it
            dims = (self.image_size, self.image_size)
        self._dims_cache[idx] = dims
        return dims

    def crop_task(self, idx: int, rng: Optional[np.random.Generator]):
        """``(path, label, (x, y, cw, ch, flip))`` for the native batch decode."""
        path, label = self.samples[idx]
        w, h = self.image_dims(idx)
        return path, label, sample_crop_params(w, h, rng, self.train, size=self.image_size)

    def _pil_pixels(self, im, params) -> np.ndarray:
        from PIL import Image

        x, y, cw, ch, flip = params
        im = im.convert("RGB").resize((self.image_size, self.image_size), Image.BILINEAR,
                                      box=(x, y, x + cw, y + ch))
        if flip:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(im, dtype=np.uint8)

    def _quarantine(self, idx: int, exc: Exception) -> np.ndarray:
        """Zero pixels for a sample that does not decode, instead of a raise
        that would kill a pool worker over a file no respawn can fix."""
        from ..telemetry.registry import get_registry

        get_registry().counter("data_corrupt_samples").inc()
        path = self.samples[idx][0]
        with self._corrupt_lock:
            first = path not in self._corrupt_logged
            self._corrupt_logged.add(path)
        if first:
            logging.getLogger(__name__).warning(
                "quarantined corrupt sample %s (%s: %s) — feeding zero pixels with its "
                "label; fix or remove the file", path, type(exc).__name__, exc)
        return np.zeros((self.image_size, self.image_size, 3), np.uint8)

    def decode_with_params(self, idx: int, params) -> np.ndarray:
        """PIL pixels for already-sampled params: the loader's repair of a row
        the native decoder refused, with the params that row was given."""
        from PIL import Image

        try:
            with Image.open(self.samples[idx][0]) as im:
                return self._pil_pixels(im, params)
        except (OSError, ValueError, SyntaxError) as e:
            return self._quarantine(idx, e)

    def get_sample(self, idx: int, rng: Optional[np.random.Generator]):
        """The PIL path: one open for the header, the params and the pixels."""
        from PIL import Image

        path, label = self.samples[idx]
        try:
            with Image.open(path) as im:
                w, h = im.size
                params = sample_crop_params(w, h, rng, self.train, size=self.image_size)
                return self._pil_pixels(im, params), np.int64(label)
        except (OSError, ValueError, SyntaxError) as e:
            return self._quarantine(idx, e), np.int64(label)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.int64]:
        # the epoch-0 stream; loaders draw (seed, epoch, idx) streams instead
        return self.get_sample(idx, sample_rng(0, 0, idx))


def get_dataset(name: str, root: str, split: str, n_classes: Optional[int] = None,
                n_samples: Optional[int] = None, seq_len: Optional[int] = None,
                image_size: int = 224):
    """Dataset factory (reference: train_distributed.py:171-181), with the
    JAX package's defaults: images ``n_samples`` 12,800 (train) and 1,280
    (val), 1000 classes, ``image_size`` 224; LM datasets (``n_classes`` the
    vocabulary size) 4096 and 512 samples, ``seq_len`` 128.  ``imagenet``
    reads ``<root>/<split>`` (a missing directory raises
    ``FileNotFoundError``); ``tokens``/``tokenbin`` read
    ``<root>/<split>.bin``, and a ``meta.json`` ``vocab_size`` above
    ``n_classes`` raises ``ValueError``."""
    key = name.lower()
    if key == "imagenet":
        return ImageFolderDataset(root, split, image_size=image_size)
    if key in ("synthetic", "fake", "fake_imagenet"):
        n = n_samples if n_samples else (12_800 if split == "train" else 1_280)
        return SyntheticDataset(n_samples=n, n_classes=n_classes or 1000,
                                image_size=image_size, split=split)
    if key in ("synthetic_text", "fake_text"):
        n = n_samples if n_samples else (4_096 if split == "train" else 512)
        return SyntheticTextDataset(n_samples=n, vocab_size=n_classes or 512,
                                    seq_len=seq_len or 128, split=split)
    if key in ("tokens", "tokenbin"):
        ds = TokenFileDataset(root, split, seq_len=seq_len or 128)
        if ds.vocab_size is not None and n_classes and ds.vocab_size > n_classes:
            raise ValueError(f"{root}/meta.json vocab_size {ds.vocab_size} exceeds "
                             f"dataset.n_classes {n_classes}")
        return ds
    raise KeyError(f"unknown dataset '{name}' (the port has: imagenet, synthetic, "
                   "synthetic_text, tokens)")
