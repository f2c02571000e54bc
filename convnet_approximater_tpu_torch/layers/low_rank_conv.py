"""Jaderberg low-rank target layers (port of
``convnet_approximater_tpu/layers/low_rank_conv.py``).

``LowRankExpConvV1`` is a grouped basis conv ``s_conv`` (C -> C*M, groups C;
output channel ``c*M + m`` applies basis m to input channel c) and a 1x1
mixing conv ``d_conv`` that carries the bias; ``decomp()`` splits every basis
into a rank-1 vertical/horizontal pair (:class:`SeparableConv`).

An eval-mode forward with autograd off runs as one
:func:`~convnet_approximater_tpu_torch.ops.lowrank_conv.lowrank_conv` call (the
CUDA kernel on the card, its plain version on the CPU), at every shape.  The
kernel reads the bases of input channel 0 only, so the weights are packed
(with the kernel's layout beside them), and checked to be shared by all C
channels, once per change of the weights:
a layer whose bases are per-channel (after fine-tuning) takes the module path
and logs that once.  A training forward and an eval forward under autograd
take the module path, since the kernel has no backward, and so does a layer
whose ``d_conv`` ``quantize_int8`` made an int8 module.

``LowRankExpConvV2`` (scheme 2), ``LowRankExpConvV3`` (channel rank) and
``LowRankExpConvV4`` (Tucker-2) are chains of dense ``Conv2d`` children with
the JAX package's child names, so checkpoints carry across as they are; they
have no kernel of their own, in the JAX package either.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.modules.utils import _pair

from convnet_approximater_tpu_torch.nn import Conv2d, params_key
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
from convnet_approximater_tpu_torch.parallel.tp_layers import whole_weights
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .depth_separable_conv import no_grad_eval
from .substitution import LAYER

# the tolerance of the JAX package's own check (``_taps_channel_shared``)
SHARED_RTOL, SHARED_ATOL = 1e-5, 1e-6


class SeparableConv(nn.Module):
    """Separable form of the grouped basis conv (C -> C*M, groups C):
    ``v_conv`` (kh, 1) grouped C -> C*M, then ``h_conv`` (1, kw) depthwise over
    C*M; each strides its own axis; no biases."""

    def __init__(self, in_channels: int, num_bases: int, kernel_size, stride, padding):
        super().__init__()
        (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
        cm = in_channels * num_bases
        self.v_conv = Conv2d(in_channels, cm, (kh, 1), stride=(sh, 1), padding=(ph, 0),
                             groups=in_channels, bias=False)
        self.h_conv = Conv2d(cm, cm, (1, kw), stride=(1, sw), padding=(0, pw), groups=cm,
                             bias=False)

    def forward(self, x):
        return self.h_conv(self.v_conv(x))


@LAYER.register_module()
class LowRankExpConvV1(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 num_base: int, decomp: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.num_base = num_base
        if decomp:
            self.s_conv = SeparableConv(in_channels, num_base, self.kernel_size, self.stride,
                                        self.padding)
        else:
            self.s_conv = Conv2d(in_channels, in_channels * num_base, self.kernel_size,
                                 stride=self.stride, padding=self.padding, groups=in_channels,
                                 bias=False)
        self.d_conv = Conv2d(in_channels * num_base, out_channels, 1)
        self._pack_key = None
        self._pack: Optional[dict] = None
        self._warned_per_channel = False

    # -- dispatch --------------------------------------------------------
    def _weights_key(self):
        return (id(self.s_conv),) + params_key(self)

    @torch.no_grad()
    def bases_shared(self) -> bool:
        """Whether every input channel's group holds the same M bases (for the
        separable form, the same rank-1 products v x h: an SVD may flip the
        signs of both factors of a pair)."""
        C, M = self.in_channels, self.num_base
        if isinstance(self.s_conv, SeparableConv):
            v = self.s_conv.v_conv.weight[:, 0, :, 0].reshape(C, M, -1)
            h = self.s_conv.h_conv.weight[:, 0, 0, :].reshape(C, M, -1)
            per_c = v[..., :, None].float() * h[..., None, :].float()
        else:
            per_c = self.s_conv.weight[:, 0].reshape(C, M, *self.kernel_size).float()
        return bool(torch.allclose(per_c, per_c[:1].expand_as(per_c), rtol=SHARED_RTOL,
                                   atol=SHARED_ATOL))

    def packed(self) -> Optional[dict]:
        """The kernel's weights (:func:`lowrank_params_from_module`, and under
        ``"kernel"`` their layout for the CUDA kernel,
        :func:`~convnet_approximater_tpu_torch.ops.lowrank_conv.pack_kernel_weights`),
        or None when the bases are per-channel; packed and checked again only
        after the weights changed."""
        key = self._weights_key()
        if key != self._pack_key:
            with whole_weights(self):  # the whole mix under tensor parallelism
                shared = self.bases_shared()
                if not shared and not self._warned_per_channel:
                    get_logger().warning(
                        "LowRankExpConvV1: the bases differ between input channels "
                        "(fine-tuned?); this layer runs the module path, not lowrank_conv")
                    self._warned_per_channel = True
                self._pack = None
                if shared:
                    params = lowrank_ops.lowrank_params_from_module(self)
                    taps = {k: params[k] for k in ("v", "h", "bases") if k in params}
                    params["kernel"] = lowrank_ops.pack_kernel_weights(params["A_mc"], **taps)
                    self._pack = params
            self._pack_key = key
        return self._pack

    def drop_caches(self):
        self._pack = self._pack_key = None

    def _may_fuse(self) -> bool:
        # an int8 d_conv (quantize_int8) runs as its own module
        return no_grad_eval(self) and type(self.d_conv) is Conv2d

    def uses_kernel(self) -> bool:
        return self._may_fuse() and self.packed() is not None

    def forward(self, x):
        packed = self.packed() if self._may_fuse() else None
        if packed is None:
            return self.d_conv(self.s_conv(x))
        kw = dict(packed)
        y = lowrank_ops.lowrank_conv(
            x.permute(0, 2, 3, 1).contiguous(),  # a view when x is channels_last
            kw.pop("A_mc"), kw.pop("b"), kernel_size=self.kernel_size, stride=self.stride,
            padding=self.padding, packed=kw.pop("kernel"), **kw)
        return y.permute(0, 3, 1, 2)

    # -- post-hoc spatial factorization ----------------------------------
    @torch.no_grad()
    def decomp(self):
        """Split each (kh, kw) basis of ``s_conv`` into a rank-1 pair by SVD on
        the weights' device: vertical ``u0 sqrt(s0)``, horizontal
        ``vh0 sqrt(s0)``.  ``s_conv`` becomes a :class:`SeparableConv`."""
        if isinstance(self.s_conv, SeparableConv):
            return
        w = self.s_conv.weight[:, 0].float()  # (C*M, kh, kw)
        u, s, vh = torch.linalg.svd(w, full_matrices=False)
        s0 = s[:, 0].sqrt()
        sep = SeparableConv(self.in_channels, self.num_base, self.kernel_size, self.stride,
                            self.padding).to(w.device)
        sep.v_conv.weight.copy_((u[:, :, 0] * s0[:, None])[:, None, :, None])
        sep.h_conv.weight.copy_((vh[:, 0, :] * s0[:, None])[:, None, None, :])
        self.s_conv = sep

    def macs(self, x_shape) -> int:
        """Multiply-accumulates of one forward on an NCHW input of ``x_shape``."""
        B, C, H, W = x_shape
        kh, kw = self.kernel_size
        Ho, Wo = lowrank_ops.out_size(H, W, self.kernel_size, self.stride, self.padding)
        cm = C * self.num_base
        if isinstance(self.s_conv, SeparableConv):
            basis = B * cm * (Ho * W * kh + Ho * Wo * kw)
        else:
            basis = B * cm * Ho * Wo * kh * kw
        return basis + B * Ho * Wo * cm * self.out_channels


@LAYER.register_module()
class LowRankExpConvV2(nn.Module):
    """Scheme 2: a dense vertical (kh, 1) conv C -> M (``v_conv``, no bias), then
    a horizontal (1, kw) conv M -> N (``h_conv``, the bias carrier); each strides
    and pads its own axis.  ``grouped=True`` makes ``h_conv`` the reference's
    grouped M -> M conv (checkpoint parity only: it cannot stand in for an
    N-output conv)."""

    def __init__(self, in_channels: int, out_channels: int, num_base: int, kernel_size,
                 stride, padding, grouped: bool = False):
        super().__init__()
        (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_base = num_base
        self.grouped = grouped
        self.v_conv = Conv2d(in_channels, num_base, (kh, 1), stride=(sh, 1), padding=(ph, 0),
                             bias=False)
        self.h_conv = Conv2d(num_base, num_base if grouped else out_channels, (1, kw),
                             stride=(1, sw), padding=(0, pw), groups=num_base if grouped else 1)

    def forward(self, x):
        return self.h_conv(self.v_conv(x))


@LAYER.register_module()
class LowRankExpConvV3(nn.Module):
    """Channel rank: a dense k x k conv C -> r (``basis_conv``, no bias), then a
    1x1 conv r -> N (``mix_conv``, the bias carrier)."""

    def __init__(self, in_channels: int, out_channels: int, num_base: int, kernel_size,
                 stride, padding):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_base = num_base
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.basis_conv = Conv2d(in_channels, num_base, self.kernel_size, stride=self.stride,
                                 padding=self.padding, bias=False)
        self.mix_conv = Conv2d(num_base, out_channels, 1)

    def forward(self, x):
        return self.mix_conv(self.basis_conv(x))


@LAYER.register_module()
class LowRankExpConvV4(nn.Module):
    """Tucker-2: a 1x1 conv C -> r1 (``in_conv``), a dense k x k core r1 -> r2
    (``core_conv``, with the stride and padding), a 1x1 conv r2 -> N
    (``out_conv``, the bias carrier); ``num_base`` is r1 = r2 or the pair
    (r1, r2)."""

    def __init__(self, in_channels: int, out_channels: int, num_base, kernel_size, stride,
                 padding):
        super().__init__()
        r1, r2 = num_base if isinstance(num_base, (tuple, list)) else (num_base, num_base)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_base = (int(r1), int(r2))
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.in_conv = Conv2d(in_channels, self.num_base[0], 1, bias=False)
        self.core_conv = Conv2d(self.num_base[0], self.num_base[1], self.kernel_size,
                                stride=self.stride, padding=self.padding, bias=False)
        self.out_conv = Conv2d(self.num_base[1], out_channels, 1)

    def forward(self, x):
        return self.out_conv(self.core_conv(self.in_conv(x)))
