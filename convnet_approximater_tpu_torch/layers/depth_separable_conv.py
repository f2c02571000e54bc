"""Depthwise strip-conv blocks of MSCA (port of
``convnet_approximater_tpu/layers/depth_separable_conv.py``).

``CascadeConv`` applies a horizontal (1, k) depthwise conv, then a vertical
(k, 1) one; the order matters to MscaRep's border algebra.

An eval-mode forward of a ``CascadeConv`` or ``ParallelConv`` whose structure
the kernel expresses (depthwise, stride 1, odd k padded by k // 2, float32 or
bfloat16 weights (packed as float32; the kernel reads and writes x's type),
at most ``MAX_BRANCHES`` cascades, with branches times the largest k at most
``MAX_BANK_ROWS``, plus an optional identity) runs as one
:func:`~convnet_approximater_tpu_torch.ops.parallel_cascade.parallel_cascade`
call (the CUDA kernel on the card, its plain version on the CPU) when no
gradient can be asked of it (eval mode under ``torch.no_grad()`` or
``torch.inference_mode()``); any other structure, a training forward and an
eval forward under autograd (the kernel has no backward) take the module path.
The taps are packed once per change of the weights, keyed on the parameters'
version counters.

``FixPaddingBias2d`` is the border frame of FfnRep's merged conv; its (H, W, C)
correction map is built once per weight version and map size in eval mode
without autograd, so the forward is one broadcast add.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from convnet_approximater_tpu_torch.nn import Conv2d, Identity, params_key
from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
from convnet_approximater_tpu_torch.ops.msca_fused import (MAX_BRANCHES, fix_strip,
                                                           pack_cascade_weights)
from convnet_approximater_tpu_torch.parallel.tp_layers import whole_weights


def no_grad_eval(module: nn.Module) -> bool:
    """Whether no gradient can be asked of ``module``'s forward: eval mode with
    autograd off.  Only then may a layer take a kernel that has no backward."""
    return not module.training and not torch.is_grad_enabled()


def _strip_fits(conv: nn.Conv2d, k: int, vertical: bool) -> bool:
    """Whether ``conv`` is the depthwise (1, k) or (k, 1) strip the kernel runs
    (float32 or bfloat16 weights: any other type, such as a float64 copy, takes
    the module path)."""
    p = k // 2
    return (conv.groups == conv.in_channels == conv.out_channels
            and conv.kernel_size == ((k, 1) if vertical else (1, k))
            and conv.padding == ((p, 0) if vertical else (0, p))
            and conv.stride == (1, 1) and conv.dilation == (1, 1)
            and conv.padding_mode == "zeros"
            and all(t.dtype in (torch.float32, torch.bfloat16) for t in conv.parameters()))


class _StripBank(nn.Module):
    """Dispatch of a strip bank to ``parallel_cascade`` in eval mode without autograd."""

    def bank(self) -> Tuple[List["CascadeConv"], bool]:
        """The cascades and whether an identity branch is added."""
        raise NotImplementedError

    def _module_forward(self, x):
        raise NotImplementedError

    def _weights_key(self):
        cascades, identity = self.bank()
        return (tuple(id(c) for c in cascades), identity) + params_key(self)

    @torch.no_grad()
    def packed(self) -> Optional[dict]:
        """The kernel's arguments (taps and biases as float32 copies of the
        weights), or None when the structure does not fit it; packed again only
        after the weights changed."""
        key = self._weights_key()
        if key != getattr(self, "_pack_key", None):
            with whole_weights(self):  # the whole taps under tensor parallelism
                cascades, identity = self.bank()
                fits = (0 < len(cascades) <= MAX_BRANCHES
                        and len(cascades) * max(c.kernel_size for c in cascades)
                        <= cascade_ops.MAX_BANK_ROWS
                        and all(c.kernel_size % 2 == 1
                                and _strip_fits(c.conv1, c.kernel_size, False)
                                and _strip_fits(c.conv2, c.kernel_size, True) for c in cascades))
                self._pack = None
                if fits:
                    w1, b1, w2, b2, ks = pack_cascade_weights(
                        [c.conv1.weight[:, 0, 0, :].t() for c in cascades],
                        [c.conv1.bias for c in cascades],
                        [c.conv2.weight[:, 0, :, 0].t() for c in cascades],
                        [c.conv2.bias for c in cascades])
                    self._pack = dict(w1=w1, b1=b1, w2=w2, b2=b2, ks=ks, identity=identity)
            self._pack_key = key
        return self._pack

    def drop_caches(self):
        self._pack = self._pack_key = None

    def uses_kernel(self) -> bool:
        return no_grad_eval(self) and self.packed() is not None

    def forward(self, x):
        packed = self.packed() if no_grad_eval(self) else None
        if packed is None:
            return self._module_forward(x)
        y = cascade_ops.parallel_cascade(
            x.permute(0, 2, 3, 1).contiguous(),  # a view when x is channels_last
            **packed)
        return y.permute(0, 3, 1, 2)

    def macs(self, x_shape) -> int:
        """Multiply-accumulates of one forward on an NCHW input of ``x_shape``."""
        B, C, H, W = x_shape
        return B * C * H * W * sum(2 * c.kernel_size for c in self.bank()[0])


class CascadeConv(_StripBank):
    """Depthwise (1, k) then (k, 1).  ``bias`` is the second conv's bias flag,
    ``first_bias`` the first's."""

    def __init__(self, dim: int, kernel_size: int, padding: int, bias: bool,
                 first_bias: bool):
        super().__init__()
        self.dim = dim
        self.kernel_size = kernel_size
        self.conv1 = Conv2d(dim, dim, (1, kernel_size), padding=(0, padding), groups=dim,
                            bias=first_bias)
        self.conv2 = Conv2d(dim, dim, (kernel_size, 1), padding=(padding, 0), groups=dim,
                            bias=bias)

    def bank(self):
        return [self], False

    def _module_forward(self, x):
        return self.conv2(self.conv1(x))


class ParallelConv(_StripBank):
    """Sum of :class:`CascadeConv` branches (+ optional identity branch).

    ``all_bias=True`` gives every conv a bias; otherwise only the last
    branch's second conv has one.  This is both MSCA's original multi-scale
    strip bank (k = 7, 11, 21 + identity) and MscaRep's ``decomp >= 2`` target.
    """

    def __init__(self, dim: int, kernel_sizes, paddings, nbranch: int,
                 all_bias: bool, identity: bool):
        super().__init__()
        self.dim = dim
        if isinstance(kernel_sizes, int):
            kernel_sizes = [kernel_sizes] * nbranch
        if isinstance(paddings, int):
            paddings = [paddings] * nbranch
        if len(kernel_sizes) != nbranch or len(paddings) != nbranch:
            raise ValueError(f"need {nbranch} kernel sizes and paddings, got "
                             f"{kernel_sizes} and {paddings}")
        self.branches = nn.ModuleList([
            CascadeConv(dim, kernel_sizes[i], paddings[i],
                        bias=all_bias or i == nbranch - 1, first_bias=all_bias)
            for i in range(nbranch)
        ])
        if identity:
            self.branches.append(Identity())

    def bank(self):
        cascades = [m for m in self.branches if isinstance(m, CascadeConv)]
        others = [m for m in self.branches if not isinstance(m, CascadeConv)]
        if any(not isinstance(m, Identity) for m in others) or len(others) > 1:
            return [], False  # not a bank the kernel expresses
        return cascades, bool(others)

    def _module_forward(self, x):
        out = None
        for branch in self.branches:
            y = branch(x)
            out = y if out is None else out + y
        return out


class FixPaddingBias(nn.Module):
    """Learnable residuals on the top and bottom ``padding`` rows.

    ``res`` is (2, C, p): ``res[0]`` runs from the top row down, ``res[1]``
    ends at the bottom row.  Both apply where the two strips overlap
    (maps lower than 2 p).
    """

    def __init__(self, num_channels: int, padding: int):
        super().__init__()
        self.num_channels = num_channels
        self.p = padding
        self.res = nn.Parameter(torch.randn(2, num_channels, padding))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            self.res.normal_(generator=generator)

    def forward(self, x):
        strip = fix_strip(self.res.transpose(1, 2), x.shape[2])  # (H, C)
        return x + strip.t()[None, :, :, None]


class FixPaddingBias2d(nn.Module):
    """Learnable border frame of a 2-D merged kernel: the 2-D form of
    :class:`FixPaddingBias`, for FfnRep's fc1 (1x1, biased) merged into a
    zero-padded k x k depthwise conv, which is exact except where taps fall
    outside the map, in a frame of width ``p = k // 2``.

    * ``res_v`` (2, C, p): top and bottom row strips, broadcast across W;
    * ``res_h`` (2, C, p): left and right column strips, broadcast across H;
    * ``res_c`` (2, 2, C, p, p): the four p x p corners, which undo the taps
      counted by both a row and a column strip.

    Side 0 (top, left) is indexed by the distance from its edge, side 1
    (bottom, right) runs toward its edge.  On maps smaller than p the strips
    are clipped to ``min(H, p)`` rows and ``min(W, p)`` columns, and strips of
    both sides overlap below 2 p, as in the JAX package.
    """

    def __init__(self, num_channels: int, padding: int):
        super().__init__()
        self.num_channels = num_channels
        self.p = padding
        C, p = num_channels, padding
        self.res_v = nn.Parameter(torch.zeros(2, C, p))  # drawn by init_weights
        self.res_h = nn.Parameter(torch.zeros(2, C, p))
        self.res_c = nn.Parameter(torch.zeros(2, 2, C, p, p))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            for t in (self.res_v, self.res_h, self.res_c):
                t.normal_(generator=generator)

    def correction(self, H: int, W: int) -> torch.Tensor:
        """The (H, W, C) map the forward adds."""
        C, p = self.num_channels, self.p
        pv, ph = min(H, p), min(W, p)
        rv, rh, rc = self.res_v, self.res_h, self.res_c
        sv = rv.new_zeros(H, C)
        sv[:pv] += rv[0, :, :pv].t()
        sv[H - pv:] += rv[1, :, p - pv:].t()
        sh = rh.new_zeros(W, C)
        sh[:ph] += rh[0, :, :ph].t()
        sh[W - ph:] += rh[1, :, p - ph:].t()
        m = sv[:, None, :] + sh[None, :, :]
        m[:pv, :ph] += rc[0, 0, :, :pv, :ph].permute(1, 2, 0)
        m[:pv, W - ph:] += rc[0, 1, :, :pv, p - ph:].permute(1, 2, 0)
        m[H - pv:, :ph] += rc[1, 0, :, p - pv:, :ph].permute(1, 2, 0)
        m[H - pv:, W - ph:] += rc[1, 1, :, p - pv:, p - ph:].permute(1, 2, 0)
        return m

    @torch.no_grad()
    def _cached_correction(self, H: int, W: int, rows=None) -> torch.Tensor:
        """:meth:`correction`, one per map size (and per rows ``(lo, hi)`` of it,
        a spatially sharded rank's: ``parallel/spatial.py``), all built again
        after a weight changed.  A map stays at its address while the weights
        stay, which a captured CUDA graph relies on."""
        key = params_key(self)
        if key != getattr(self, "_maps_key", None):
            self._maps, self._maps_key = {}, key
        size = (H, W) if rows is None else (H, W, rows)
        if size not in self._maps:
            m = self.correction(H, W)
            self._maps[size] = m if rows is None else m[rows[0]:rows[1]].clone()
        return self._maps[size]

    def drop_caches(self):
        self._maps = self._maps_key = None

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        m = self._cached_correction(H, W) if no_grad_eval(self) else self.correction(H, W)
        return x + m.permute(2, 0, 1)[None]
