"""Multi-Scale Conv Attention (port of ``convnet_approximater_tpu/layers/msca.py``).

``conv0`` (k1 x k1 depthwise) -> ``sd_convs`` (strip-conv bank at k in
{7, 11, 21} + identity, or what MscaRep made of it) -> ``channel_mix`` (1x1)
-> gate ``x * attn``.  An eval-mode forward whose structure the fused kernel
can express runs as one :func:`~convnet_approximater_tpu_torch.ops.msca_fused.msca_fused`
call (the CUDA kernel on the card, its plain version on the CPU), with the
kernel's weight layouts built once per weight version, at every map size, when
no gradient can be asked of it (eval mode, autograd off); a
training forward and an eval forward under autograd take the module path,
since the kernel has no backward.  A block whose conv0 is a cascade (``MscaRep(decomp_conv0=True)``)
takes the module path too, where conv0 and the bank each run
:func:`~convnet_approximater_tpu_torch.ops.parallel_cascade.parallel_cascade`,
and so does a block whose ``channel_mix`` is not a plain ``Conv2d`` (an int8
module of ``quantize_int8``, a QAT twin).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from convnet_approximater_tpu_torch.nn import Conv2d, params_key
from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

from .depth_separable_conv import CascadeConv, FixPaddingBias, ParallelConv, no_grad_eval
from .substitution import LAYER


@LAYER.register_module()
class MSCA(nn.Module):
    def __init__(self, num_channel: int, k1_size: int, k_sizes):
        super().__init__()
        self.num_channel = num_channel
        self.k1_size = k1_size
        self.k_sizes = tuple(k_sizes)
        self.conv0 = Conv2d(num_channel, num_channel, k1_size, padding=k1_size // 2,
                            groups=num_channel)
        self.sd_convs = ParallelConv(num_channel, list(self.k_sizes),
                                     [k // 2 for k in self.k_sizes], len(self.k_sizes),
                                     all_bias=True, identity=True)
        self.channel_mix = Conv2d(num_channel, num_channel, 1)

    def _fuse_parts(self):
        """``(bank, fix or None)`` when the fused kernel can express
        ``sd_convs``, else None."""
        sd = self.sd_convs
        fix = None
        if isinstance(sd, nn.Sequential) and len(sd) == 2 and isinstance(sd[1], FixPaddingBias):
            sd, fix = sd[0], sd[1]
        if isinstance(sd, (ParallelConv, CascadeConv)) and sd.packed() is not None:
            return sd, fix
        return None

    def can_fuse(self) -> bool:
        return (no_grad_eval(self) and isinstance(self.conv0, Conv2d)
                and type(self.channel_mix) is Conv2d and self._fuse_parts() is not None)

    @torch.no_grad()
    def _kernel_weights(self) -> dict:
        """The kernel's weight layouts, built again only after a weight changed
        (keyed on every parameter's version counter, as ``bank.packed()`` is)."""
        key = params_key(self)
        if key != getattr(self, "_kernel_key", None):
            bank, fix = self._fuse_parts()
            packed = bank.packed()
            res, fix_p = None, 0
            if fix is not None:
                res, fix_p = fix.res.transpose(1, 2).contiguous(), fix.p  # (2, p, C)
                res = res.float()
            # the kernel's weights are float32 copies of bf16 ones
            self._kernel_args = dict(
                w0=self.conv0.weight[:, 0].permute(1, 2, 0).float().contiguous(),  # (k0, k0, C)
                b0=self.conv0.bias.float(),
                w1=packed["w1"], b1=packed["b1"], w2=packed["w2"], b2=packed["b2"],
                wm=self.channel_mix.weight[:, :, 0, 0].t().float().contiguous(),  # (C in, C out)
                bm=self.channel_mix.bias.float(), res=res,
                ks=packed["ks"], identity=packed["identity"], fix_p=fix_p)
            self._kernel_key = key
        return self._kernel_args

    def _fused_forward(self, x):
        y = fused_ops.msca_fused(x.permute(0, 2, 3, 1).contiguous(),  # a view when channels_last
                                 **self._kernel_weights())
        return y.permute(0, 3, 1, 2)

    def macs(self, x_shape) -> int:
        """Multiply-accumulates of the fused forward on an NCHW input of ``x_shape``."""
        bank, _ = self._fuse_parts()
        cascades, _ = bank.bank()
        taps = self.conv0.weight[0].numel() + sum(
            c.conv1.weight[0].numel() + c.conv2.weight[0].numel() for c in cascades)
        B, C, H, W = x_shape
        return B * H * W * C * (taps + C)

    def forward(self, x):
        if self.can_fuse():
            return self._fused_forward(x)
        attn = self.channel_mix(self.sd_convs(self.conv0(x)))
        return x * attn

    def switchable_layer(self) -> str:
        """Name of the submodule a freeze schedule unfreezes."""
        return "sd_convs"


@LAYER.register_module()
class MSCAProfile(MSCA):
    """MSCA on the module path, its three stages named for ``torch.profiler``."""

    def forward(self, x):
        with record_function("CONV0"):
            attn = self.conv0(x)
        with record_function("SD_CONVS"):
            attn = self.sd_convs(attn)
        with record_function("CHANNEL_MIX"):
            attn = self.channel_mix(attn)
        return attn * x
