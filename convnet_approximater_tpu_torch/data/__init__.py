from .datasets import (CIFAR10, CIFAR10_MEAN, CIFAR10_STD, DATASET, IMAGENET_DEFAULT_MEAN,
                       IMAGENET_DEFAULT_STD, ArrayDataset, ImageFolder, Npz, Synthetic,
                       build_dataset)
from .loader import Loader, apply_aug, augment_batch, draw_aug_params
