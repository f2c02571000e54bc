"""Module filters: which matching modules the Runner registers as switchable
(port of ``convnet_approximater_tpu/filters/``).

A filter is called on every module of the approximater's source type that
the breadth-first registration walk meets, in order, until one rejects it.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

from torch import nn

from convnet_approximater_tpu_torch.nn import Conv2d
from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg


class ModuleFilter(ABC):
    @abstractmethod
    def filter(self, module: nn.Module) -> bool:
        ...

    def __call__(self, module: nn.Module) -> bool:
        return self.filter(module)


FILTER = Registry("FILTER")


def build_filter(cfg, **kwargs) -> ModuleFilter:
    return build_from_cfg(cfg, FILTER, **kwargs)


def _conv(module) -> Conv2d:
    if not isinstance(module, Conv2d):
        raise TypeError(f"this filter takes Conv2d modules, got {type(module).__name__}")
    return module


@FILTER.register_module()
class SimpleConvFilter(ModuleFilter):
    """Scheme-1 precondition: rejects grouped, dilated and bias-less convs."""

    def filter(self, module) -> bool:
        conv = _conv(module)
        return conv.groups == 1 and max(conv.dilation) == 1 and conv.bias is not None


@FILTER.register_module()
class IndicesFilter(ModuleFilter):
    """Passes the candidates at the given 1-based positions of the stream of
    modules that reach it; the cursor advances once per candidate."""

    def __init__(self, indices: Tuple[int, ...]):
        self.indices = frozenset(int(i) for i in indices)
        self.curr = 1

    def filter(self, module) -> bool:
        passed = self.curr in self.indices
        self.curr += 1
        return passed


@FILTER.register_module()
class KernelSizeFilter(ModuleFilter):
    """Passes convs whose spatial kernel is within [min_kernel, max_kernel] in
    both dims (the default rejects exactly the 1x1 convs)."""

    def __init__(self, min_kernel: int = 2, max_kernel: int = 10**9):
        self.min_kernel = min_kernel
        self.max_kernel = max_kernel

    def filter(self, module) -> bool:
        kh, kw = _conv(module).kernel_size
        return min(kh, kw) >= self.min_kernel and max(kh, kw) <= self.max_kernel


@FILTER.register_module()
class DepthwiseConvFilter(ModuleFilter):
    """Passes square stride-1 undilated depthwise convs with k >= min_kernel."""

    def __init__(self, min_kernel: int = 3):
        self.min_kernel = min_kernel

    def filter(self, module) -> bool:
        conv = _conv(module)
        kh, kw = conv.kernel_size
        return (conv.groups == conv.in_channels == conv.out_channels
                and kh == kw >= self.min_kernel
                and conv.stride == (1, 1)
                and conv.dilation == (1, 1))


@FILTER.register_module()
class DenseKxKFilter(ModuleFilter):
    """Passes dense undilated spatial convs with at least ``min_in`` input
    channels: the targets of a channel-rank factorization."""

    def __init__(self, min_kernel: int = 2, min_in: int = 8):
        self.min_kernel = min_kernel
        self.min_in = min_in

    def filter(self, module) -> bool:
        conv = _conv(module)
        return (conv.groups == 1
                and conv.dilation == (1, 1)
                and min(conv.kernel_size) >= self.min_kernel
                and conv.in_channels >= self.min_in)
