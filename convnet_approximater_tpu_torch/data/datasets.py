"""Datasets (port of ``convnet_approximater_tpu/data/datasets.py``, the same
classes and the same bytes).

No download: CIFAR-10 reads the standard python pickle batches from a local
root and fails with a clear message when they are missing; ``Synthetic``
draws deterministic data from a seeded ``numpy.random.RandomState`` (the same
stream as the JAX package, so the same images); ``Npz`` loads pre-processed
arrays.  Every dataset holds ``images`` (N, H, W, C) uint8 and ``labels``
(N,) int arrays; the loader batches, resizes, normalises and moves them.
"""

from __future__ import annotations

import os
import pickle
import numpy as np

from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg

DATASET = Registry("DATASET")

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)


class ArrayDataset:
    """Base: in-memory (images, labels)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert len(images) == len(labels)
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]


@DATASET.register_module()
class Synthetic(ArrayDataset):
    """Deterministic random dataset (for smoke tests and throughput runs).

    ``signal`` > 0 mixes a fixed per-class pattern into each image (the same
    patterns across splits), which makes the task learnable.
    """

    def __init__(self, num_samples: int = 512, image_size=(224, 224, 3),
                 num_classes: int = 10, seed: int = 0, split: str = "train",
                 signal: float = 0.0):
        rs = np.random.RandomState(seed + (0 if split == "train" else 1))
        images = rs.randint(0, 256, (num_samples,) + tuple(image_size), dtype=np.uint8)
        labels = rs.randint(0, num_classes, (num_samples,), dtype=np.int64)
        if signal > 0:
            pat_rs = np.random.RandomState(seed + 12345)  # split-independent
            patterns = pat_rs.randint(0, 256, (num_classes,) + tuple(image_size))
            mixed = (1 - signal) * images + signal * patterns[labels]
            images = np.clip(mixed, 0, 255).astype(np.uint8)
        super().__init__(images, labels)
        self.num_classes = num_classes


@DATASET.register_module()
class CIFAR10(ArrayDataset):
    """CIFAR-10 from the standard python pickle batches under ``root``
    (``cifar-10-batches-py/``).  No download (zero-egress container)."""

    num_classes = 10

    def __init__(self, root: str, split: str = "train"):
        base = root
        for cand in (root, os.path.join(root, "cifar-10-batches-py")):
            if os.path.exists(os.path.join(cand, "test_batch")):
                base = cand
                break
        names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        images, labels = [], []
        for n in names:
            path = os.path.join(base, n)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 batch {path} not found; place the python-version "
                    f"batches under {root} (no network download available)"
                )
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.append(np.asarray(d[b"labels"], dtype=np.int64))
        super().__init__(np.concatenate(images), np.concatenate(labels))


@DATASET.register_module()
class ImageFolder(ArrayDataset):
    """torchvision-style class-per-subdirectory tree, decoded with PIL.

    ``root/<split>/<class_name>/*.{jpg,jpeg,png,bmp}``; falls back to
    ``root/<class_name>/...`` when there is no split directory.  Classes are
    sorted lexicographically (torchvision convention) so label indices match
    checkpoints trained elsewhere.  Images are decoded once into an in-memory
    uint8 pool at ``image_size`` (nearest resize) — the framework's datasets
    are array-pools (see module doc); for ImageNet-scale corpora pre-convert
    to ``Npz`` instead.
    """

    _EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, split: str = "train", image_size=(224, 224),
                 max_samples: int = 0):
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            base = root
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"ImageFolder root {root!r} not found (no network download "
                f"available — place a class-per-subdirectory tree there)")
        classes = sorted(d for d in os.listdir(base)
                         if os.path.isdir(os.path.join(base, d)))
        if not classes:
            raise FileNotFoundError(
                f"ImageFolder {base!r} has no class subdirectories")
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover - PIL is in the image
            raise ImportError("ImageFolder needs PIL to decode images; "
                              "pre-convert to Npz instead") from e
        th, tw = tuple(image_size)
        images, labels = [], []
        for ci, cname in enumerate(classes):
            cdir = os.path.join(base, cname)
            for fname in sorted(os.listdir(cdir)):
                if not fname.lower().endswith(self._EXTS):
                    continue
                with Image.open(os.path.join(cdir, fname)) as im:
                    im = im.convert("RGB").resize((tw, th), Image.NEAREST)
                    images.append(np.asarray(im, dtype=np.uint8))
                labels.append(ci)
                if max_samples and len(labels) >= max_samples:
                    break
            if max_samples and len(labels) >= max_samples:
                break
        if not images:
            raise FileNotFoundError(f"ImageFolder {base!r}: no decodable "
                                    f"images under {self._EXTS}")
        super().__init__(np.stack(images), np.asarray(labels, np.int64))
        self.classes = classes
        self.num_classes = len(classes)


@DATASET.register_module()
class Npz(ArrayDataset):
    """Pre-processed arrays: ``images`` (N, H, W, C), ``labels`` (N,)."""

    def __init__(self, path: str, split: str = "train"):
        with np.load(path) as d:
            key_i = f"{split}_images" if f"{split}_images" in d else "images"
            key_l = f"{split}_labels" if f"{split}_labels" in d else "labels"
            super().__init__(d[key_i], d[key_l])


def build_dataset(cfg, **kwargs) -> ArrayDataset:
    return build_from_cfg(cfg, DATASET, **kwargs)
