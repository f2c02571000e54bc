"""Leaf layers of the port; containers are ``torch.nn``'s own."""

from .layers import (GELU, AdaptiveAvgPool2d, BatchNorm2d, Conv2d, DataShard, Dropout,
                     GlobalBatchNorm, GroupNorm, Identity, LayerNorm, Linear, MaxPool2d,
                     MicrobatchStats, ReLU, bernoulli_rows, channels_last, current_shard, drop_weight_caches,
                     flatten_hwc, frozen_params_keys, gelu, init_weights, microbatch_stats,
                     params_key, sharded_batch)
