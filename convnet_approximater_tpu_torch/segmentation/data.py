"""Synthetic segmentation data (port of ``convnet_approximater_tpu/segmentation/data.py``,
the same bytes).

A deterministic, learnable dense-label task with no external data: each image
is a grid of cells, each cell draws a class whose fixed colour signature is
mixed into its pixels, and the mask labels each pixel with its cell's class.
"""

from __future__ import annotations

import numpy as np

from convnet_approximater_tpu_torch.data.datasets import DATASET, ArrayDataset


@DATASET.register_module()
class SyntheticSeg(ArrayDataset):
    """``images`` (N, H, W, 3) uint8; ``labels`` (N, H, W) int64 masks.

    ``grid``: cells per side.  ``signal``: 0..1 strength of the per-class
    colour signature (0 = pure noise, unlearnable).  ``ignore_border``: mark a
    1-pixel cell border with ``ignore_index``.
    """

    def __init__(self, num_samples: int = 128, image_size=(32, 32), num_classes: int = 7,
                 grid: int = 4, seed: int = 0, split: str = "train", signal: float = 0.7,
                 ignore_border: bool = False, ignore_index: int = 255):
        H, W = tuple(image_size)
        rs = np.random.RandomState(seed + (0 if split == "train" else 1))
        pat_rs = np.random.RandomState(seed + 54321)  # split-independent
        colors = pat_rs.randint(0, 256, (num_classes, 3))  # class signatures

        cell_cls = rs.randint(0, num_classes, (num_samples, grid, grid))
        ys = (np.arange(H) * grid // H).clip(0, grid - 1)
        xs = (np.arange(W) * grid // W).clip(0, grid - 1)
        labels = cell_cls[:, ys][:, :, xs].astype(np.int64)  # (N, H, W)

        noise = rs.randint(0, 256, (num_samples, H, W, 3))
        mixed = (1 - signal) * noise + signal * colors[labels]
        images = np.clip(mixed, 0, 255).astype(np.uint8)

        if ignore_border:
            yb = np.isin(np.arange(H), (np.arange(1, grid) * H) // grid)
            xb = np.isin(np.arange(W), (np.arange(1, grid) * W) // grid)
            labels[:, yb, :] = ignore_index
            labels[:, :, xb] = ignore_index

        super().__init__(images, labels)
        self.num_classes = num_classes
