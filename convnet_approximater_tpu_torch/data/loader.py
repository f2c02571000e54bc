"""Batch loader (port of ``convnet_approximater_tpu/data/loader.py``).

One route for every batch: the host gathers the batch's uint8 images from
the dataset's array (with the nearest resize, or the crop/flip augmentation,
as index arithmetic in numpy), a background thread keeps up to ``prefetch``
such batches ready in pinned memory, and the consumer copies each to
``device`` and normalises it there, ``(x - 255 mean) / (255 std)`` in
float32, in the JAX package's order.  Batches come out as NCHW float32
tensors that are ``channels_last`` in memory (an NHWC block, the JAX
package's layout) with int64 labels.

The shuffle order and the augmentation draws come from ``RandomState``
seeds of the same form as the JAX package's, so both loaders give the same
batches.  The JAX package's C++ batch prep (``data/_native``) is a host
speed-up that is not ported (``ROADMAP.md`` queue 1 item 5); RandAugment
(``aug=dict(rand_aug=...)``) is not ported either.  Augmentation with dense
labels (segmentation masks) is refused: it would move the images and not
their masks.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .datasets import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, ArrayDataset

AUG_KEYS = ("hflip", "crop_pad", "rrc_scale")


def _resize_nearest(images: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    H, W = images.shape[1:3]
    th, tw = size
    if (H, W) == (th, tw):
        return images
    ri = (np.arange(th) * H // th).astype(np.int64)
    ci = (np.arange(tw) * W // tw).astype(np.int64)
    return images[:, ri][:, :, ci]


def _reflect_index(idx: np.ndarray, size: int) -> np.ndarray:
    """Map possibly out-of-range indices into [0, size) by edge reflection
    (numpy ``pad(mode='reflect')``: -k -> k, size-1+k -> size-1-k)."""
    idx = np.abs(idx)
    over = idx > size - 1
    idx = np.where(over, 2 * (size - 1) - idx, idx)
    return np.clip(idx, 0, size - 1)


def draw_aug_params(rs: np.random.RandomState, n: int, H: int, W: int, *,
                    hflip: float = 0.0, crop_pad: int = 0, rrc_scale=None):
    """Draw per-image augmentation parameters: a source rectangle
    ``(y0, x0, ch, cw)`` (``y0``/``x0`` may be negative for reflect-padded
    crops), nearest-resized to the output size, and a flip flag."""
    if rrc_scale is not None:
        areas = rs.uniform(rrc_scale[0], rrc_scale[1], n) * H * W
        log_ratio = rs.uniform(np.log(3 / 4), np.log(4 / 3), n)
        ch = np.clip(np.round(np.sqrt(areas / np.exp(log_ratio))), 1, H).astype(np.int64)
        cw = np.clip(np.round(np.sqrt(areas * np.exp(log_ratio))), 1, W).astype(np.int64)
        y0 = np.asarray([rs.randint(0, H - c + 1) for c in ch], np.int64)
        x0 = np.asarray([rs.randint(0, W - c + 1) for c in cw], np.int64)
    elif crop_pad > 0:
        p = crop_pad
        ch = np.full(n, H, np.int64)
        cw = np.full(n, W, np.int64)
        y0 = rs.randint(0, 2 * p + 1, n).astype(np.int64) - p
        x0 = rs.randint(0, 2 * p + 1, n).astype(np.int64) - p
    else:
        ch = np.full(n, H, np.int64)
        cw = np.full(n, W, np.int64)
        y0 = np.zeros(n, np.int64)
        x0 = np.zeros(n, np.int64)
    flip = (rs.uniform(size=n) < hflip) if hflip > 0 else np.zeros(n, bool)
    return y0, x0, ch, cw, flip


def apply_aug(images: np.ndarray, params, out_hw) -> np.ndarray:
    """Apply :func:`draw_aug_params`'s rectangles and flips to a batch."""
    y0, x0, ch, cw, flip = params
    n = len(images)
    H, W = images.shape[1:3]
    th, tw = out_hw
    out = np.empty((n, th, tw, images.shape[3]), images.dtype)
    r = np.arange(th)
    c = np.arange(tw)
    for i in range(n):
        rows = _reflect_index(y0[i] + (r * ch[i]) // th, H)
        cs = (tw - 1 - c) if flip[i] else c
        cols = _reflect_index(x0[i] + (cs * cw[i]) // tw, W)
        out[i] = images[i][rows][:, cols]
    return out


def augment_batch(images: np.ndarray, rs: np.random.RandomState, *,
                  hflip: float = 0.0, crop_pad: int = 0, rrc_scale=None,
                  out_size=None) -> np.ndarray:
    """Train-time augmentation of a host batch: ``hflip`` (probability of a
    horizontal flip per image), ``crop_pad`` (reflect-pad by N, then a random
    crop back) and ``rrc_scale`` ((lo, hi) area fraction of a random resized
    crop to ``out_size``, aspect 3/4..4/3, nearest resize).  The input
    resolution is kept unless ``rrc_scale`` is set."""
    H, W = images.shape[1:3]
    out_hw = tuple(out_size) if (rrc_scale is not None and out_size) else (H, W)
    params = draw_aug_params(rs, len(images), H, W, hflip=hflip, crop_pad=crop_pad,
                             rrc_scale=rrc_scale)
    return apply_aug(images, params, out_hw)


def check_aug(aug) -> dict:
    """The augmentation config as a dict; RandAugment is not ported."""
    aug = dict(aug or {})
    if aug.get("rand_aug"):
        raise NotImplementedError(
            "aug=dict(rand_aug=...): RandAugment (data/randaug.py) is not ported to the "
            "PyTorch port yet (ROADMAP.md queue 1 item 5, with TrainHelper and mixup.py)")
    aug.pop("rand_aug", None)
    unknown = set(aug) - set(AUG_KEYS)
    if unknown:
        raise ValueError(f"unknown augmentation keys {sorted(unknown)}; known: {AUG_KEYS}")
    return aug


class Loader:
    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = True,
        mean=IMAGENET_DEFAULT_MEAN,
        std=IMAGENET_DEFAULT_STD,
        image_size: Optional[Tuple[int, int]] = None,
        seed: int = 0,
        device="cuda",
        prefetch: int = 2,
        aug=None,
        dtype=torch.float32,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.mean = np.asarray(mean, np.float32) * 255.0
        self.std = np.asarray(std, np.float32) * 255.0
        self.image_size = tuple(image_size) if image_size is not None else None
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.dtype = dtype  # the normalised images' type (float32, or bfloat16 to serve)
        # hflip, crop_pad, rrc_scale; None or {} = no augmentation
        self.aug = check_aug(aug)
        if self.aug and np.ndim(dataset.labels) > 1:
            # the JAX Loader crops and flips the images alone, so its dense masks
            # would no longer line up with their pixels; the port refuses
            raise ValueError(
                f"aug={self.aug} with dense labels (shape {np.shape(dataset.labels)}): the "
                f"augmentation moves the images and not their masks, so the labels would "
                f"no longer match the pixels; train segmentation without aug")
        self._mean = torch.from_numpy(self.mean).to(self.device)
        self._std = torch.from_numpy(self.std).to(self.device)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Vary the shuffle order per epoch (analog of sampler.set_epoch)."""
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The batch at dataset indices ``idx`` on the host, before
        normalisation: (B, H, W, C) images in the dataset's dtype, int64 labels."""
        labels = self.dataset.labels[idx].astype(np.int64)
        pool = self.dataset.images
        if self.aug:
            H, W = pool.shape[1:3]
            out_hw = self.image_size or (H, W)
            rs = np.random.RandomState(
                (self.seed * 1000003 + self._epoch * 9176
                 + (int(idx[0]) if len(idx) else 0)) % (2 ** 31))
            images = apply_aug(pool[idx], draw_aug_params(rs, len(idx), H, W, **self.aug),
                               out_hw)
        else:
            images = pool[idx]
            if self.image_size is not None:
                images = _resize_nearest(images, self.image_size)
        return np.ascontiguousarray(images), labels

    def _prep(self, idx: np.ndarray):
        images, labels = (torch.from_numpy(a) for a in self.gather(idx))
        if self.device.type == "cuda":
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels

    def _put(self, batch):
        images, labels = batch
        x = images.to(self.device, non_blocking=True)
        x = ((x.float() - self._mean) / self._std).to(self.dtype)  # normalised in float32
        return x.permute(0, 3, 1, 2), labels.to(self.device, non_blocking=True)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self._epoch)
            return rs.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator:
        order = self._indices()
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

        if self.prefetch <= 0:
            for idx in batches:
                yield self._put(self._prep(idx))
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()  # set when the consumer abandons iteration
        failure = []

        def put(item) -> bool:
            # a bounded put that re-checks cancellation, so a consumer breaking
            # out of the loop (max_steps_per_epoch, max_eval_batches) cannot
            # strand the worker on a full queue
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx in batches:
                    if cancel.is_set() or not put(self._prep(idx)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                failure.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield self._put(item)
            if failure:
                raise failure[0]
        finally:
            cancel.set()
            try:  # drain so an in-flight put can finish
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
