"""int8 post-training quantization for serving (port of the PTQ half of
``convnet_approximater_tpu/layers/quant.py``).

Weights are symmetric per-output-channel int8 (scale = absmax / 127 over the
rest of the weight), quantized once by ``deploy.quantize_int8``; activations
are symmetric per-tensor int8 with a static scale calibrated from sample
batches.  Both modules run :func:`~convnet_approximater_tpu_torch.ops.qmatmul.qmatmul`
(the CUDA kernel on the card, its plain version on the CPU): ``QuantLinear``
on its flattened (M, K) input, ``QuantConv2d`` through im2col.  They are
inference-only and raise in training mode.

Layouts are torch's: ``weight_q`` is (out, in) for ``QuantLinear`` and OIHW
for ``QuantConv2d``; ``convert.params_from_jax`` transposes the JAX package's
(in, out) and HWIO.  The packed weight of the kernel is made once per change
of the parameters, keyed on their version counters.

Quantization-aware training (the QAT half of the JAX module): ``QATConv2d``
and ``QATLinear`` are the training twins of the dense layers, with the same
parameters; their forward quantize-dequantizes the input (per tensor, at the
scale of an absmax observer) and the weight (per output channel, on the PTQ
grid) with a straight-through gradient, and runs the float conv or matmul on
the module path.  ``deploy.convert_qat_to_int8`` turns them into
``QuantConv2d``/``QuantLinear`` with the learned scales.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from convnet_approximater_tpu_torch.nn import Conv2d, params_key
from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops
from convnet_approximater_tpu_torch.ops.qmatmul import (INT8_MAX,  # noqa: F401
                                                        quantize_activation)


def _quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (output channel first) symmetric int8 of a weight."""
    w32 = w.detach().float()
    absmax = w32.abs().flatten(1).amax(dim=1)
    scale = absmax.clamp_min(1e-12) / INT8_MAX
    shape = (-1,) + (1,) * (w.dim() - 1)
    w_q = torch.clamp(torch.round(w32 / scale.reshape(shape)), -INT8_MAX, INT8_MAX)
    return w_q.to(torch.int8), scale


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW conv weight -> (int8 OIHW weight, float32 per-out-channel scale)."""
    return _quantize_rows(w)


def quantize_linear_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) Linear weight -> (int8 weight, float32 per-out-feature scale)."""
    return _quantize_rows(w)


class _QuantBase(nn.Module):
    """``weight_q``, ``w_scale``, ``act_scale`` and an optional ``bias``, held as
    parameters that take no gradient (so they count as the JAX params do)."""

    def _init_params(self, w_shape, out: int, bias: bool):
        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.weight_q = frozen(torch.zeros(w_shape, dtype=torch.int8))
        self.w_scale = frozen(torch.ones(out))
        self.act_scale = frozen(torch.ones(()))
        self.register_parameter("bias", frozen(torch.zeros(out)) if bias else None)
        self._pack_key = None
        self._packed: Optional[torch.Tensor] = None

    def _flat_weight(self) -> torch.Tensor:
        """``weight_q`` as the (N, K) matrix in the order of this layer's im2col."""
        raise NotImplementedError

    def packed(self) -> torch.Tensor:
        """The kernel's weight, packed again only after the parameters changed."""
        key = params_key(self)
        if key != self._pack_key:
            self._packed = qmatmul_ops.pack_qweight(self._flat_weight().detach())
            self._pack_key = key
        return self._packed

    def drop_caches(self):
        self._packed = self._pack_key = None

    def _matmul(self, x2d: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError(f"{type(self).__name__} is inference-only (serving PTQ)")
        return qmatmul_ops.qmatmul(x2d.contiguous(), self.packed(), self.act_scale,
                                   self.w_scale, self.bias)


class QuantLinear(_QuantBase):
    """Serving-form int8 Linear: per-out-feature int8 weights, a calibrated static
    per-tensor input scale, an exact integer sum and a dequant + bias epilogue."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self._init_params((out_features, in_features), out_features, bias)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, act_scale: float) -> "QuantLinear":
        mod = cls(lin.in_features, lin.out_features, bias=lin.bias is not None)
        w_q, w_scale = quantize_linear_weight(lin.weight)
        mod.weight_q.data, mod.w_scale.data = w_q, w_scale
        mod.act_scale.data = torch.tensor(act_scale, dtype=torch.float32, device=w_q.device)
        if lin.bias is not None:
            mod.bias.data = lin.bias.detach().float().clone()
        return mod.eval()

    def _flat_weight(self):
        return self.weight_q

    def forward(self, x):
        y = self._matmul(x.reshape(-1, self.in_features))
        return y.reshape(*x.shape[:-1], self.out_features)

    def macs(self, x_shape) -> int:
        return math.prod(x_shape[:-1]) * self.in_features * self.out_features


class QuantConv2d(_QuantBase):
    """Serving-form int8 conv (``groups == 1``) on NCHW maps, as one ``qmatmul``
    over im2col rows.  When the stride equals the kernel and there is no
    padding (patchify: ConvNeXt's stem and downsamples), im2col is a reshape of
    the NHWC view in (kh, kw, C) order; any other conv unfolds in (C, kh, kw)
    order.  The packed weight follows the same order."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, bias: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self._init_params((out_channels, in_channels) + self.kernel_size, out_channels, bias)

    @classmethod
    @torch.no_grad()
    def from_conv(cls, conv: nn.Conv2d, act_scale: float) -> "QuantConv2d":
        if conv.groups != 1 or conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError("only dense zero-padded convs quantize")
        mod = cls(conv.in_channels, conv.out_channels, conv.kernel_size, stride=conv.stride,
                  padding=conv.padding, dilation=conv.dilation, bias=conv.bias is not None)
        w_q, w_scale = quantize_weight_per_channel(conv.weight)
        mod.weight_q.data, mod.w_scale.data = w_q, w_scale
        mod.act_scale.data = torch.tensor(act_scale, dtype=torch.float32, device=w_q.device)
        if conv.bias is not None:
            mod.bias.data = conv.bias.detach().float().clone()
        return mod.eval()

    @property
    def patchify(self) -> bool:
        return (self.stride == self.kernel_size and self.padding == (0, 0)
                and self.dilation == (1, 1))

    def _flat_weight(self):
        w = self.weight_q
        if self.patchify:
            w = w.permute(0, 2, 3, 1)  # (N, kh, kw, C)
        return w.reshape(self.out_channels, -1)

    def out_size(self, H: int, W: int, padding=None) -> Tuple[int, int]:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        (ph, pw), (dh, dw) = padding or self.padding, self.dilation
        return ((H + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
                (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1)

    def forward(self, x):
        return self.conv(x, self.padding)

    def conv(self, x, padding):
        """The layer on ``x`` zero-padded by ``padding`` (the spatial form's
        window carries its rows' padding and passes ``(0, pw)``)."""
        B, C, H, W = x.shape
        Ho, Wo = self.out_size(H, W, padding)
        kh, kw = self.kernel_size
        if self.patchify:
            cols = x.permute(0, 2, 3, 1)[:, :Ho * kh, :Wo * kw]  # NHWC view
            cols = cols.reshape(B, Ho, kh, Wo, kw, C).permute(0, 1, 3, 2, 4, 5)
            # the copy comes before the reshape: a trace with a symbolic batch then
            # keeps it, where a reshape at batch 1 could give a strided view
            cols = cols.contiguous().reshape(B * Ho * Wo, kh * kw * C)
        else:
            cols = F.unfold(x, self.kernel_size, dilation=self.dilation, padding=padding,
                            stride=self.stride)  # (B, C kh kw, L)
            cols = cols.transpose(1, 2).contiguous().reshape(B * Ho * Wo, -1)
        y = self._matmul(cols).reshape(B, Ho, Wo, self.out_channels)
        return y.permute(0, 3, 1, 2)  # NCHW, channels_last in memory

    def macs(self, x_shape) -> int:
        B, C, H, W = x_shape
        Ho, Wo = self.out_size(H, W)
        kh, kw = self.kernel_size
        return B * Ho * Wo * self.out_channels * C * kh * kw


# -- quantization-aware training ---------------------------------------------

def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """int8 quantize-dequantize with a straight-through gradient: the forward is
    ``clip(round(x / scale), -127, 127) * scale`` (``scale`` broadcasts, so a
    per-channel grid works); the gradient is 1 where ``|x / scale| <= 127`` and 0
    outside; no gradient reaches ``scale`` (clamped at 1e-12)."""
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32, device=x.device).detach(),
                    min=1e-12).to(x.dtype)
    r = x / s
    q = torch.clamp(torch.round(r), -INT8_MAX, INT8_MAX) * s
    xm = x * (r.abs() <= INT8_MAX).to(x.dtype)
    return xm + (q - xm).detach()


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (dim 0) fake-quant of a live weight, on the grid of
    :func:`quantize_weight_per_channel`, so the QAT forward sees the weights
    the int8 module will run."""
    absmax = w.detach().float().abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return fake_quant(w, torch.clamp(absmax, min=1e-12) / INT8_MAX)


class _Observed:
    """The input absmax observer of a QAT twin: a 0-d ``act_absmax`` buffer, an
    EMA at ``qat_momentum`` updated under ``no_grad`` in training mode only
    (the first training batch sets it), frozen in eval; a twin that has not
    seen a training batch (0) leaves its input unquantized."""

    def _init_observer(self, qat_momentum: float, device):
        self.qat_momentum = qat_momentum
        self.register_buffer("act_absmax", torch.zeros((), dtype=torch.float32, device=device))

    def _fake_quant_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().amax().float()
                m = self.qat_momentum
                self.act_absmax.copy_(torch.where(self.act_absmax > 0,
                                                  (1 - m) * self.act_absmax + m * cur, cur))
        absmax = self.act_absmax.clone()
        return torch.where(absmax > 0, fake_quant(x, absmax / INT8_MAX), x)


class QATConv2d(Conv2d, _Observed):
    """Fake-quant training twin of :class:`QuantConv2d` (``groups == 1``), with the
    parameters of the :class:`Conv2d` it replaces."""

    def __init__(self, *args, qat_momentum: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_observer(qat_momentum, self.weight.device)

    @classmethod
    def from_conv(cls, conv: nn.Conv2d, qat_momentum: float = 0.1) -> "QATConv2d":
        """The twin of ``conv``, holding ``conv``'s own parameter tensors."""
        if conv.groups != 1:
            raise ValueError("only dense convs quantize")
        with torch.device("meta"):
            mod = cls(conv.in_channels, conv.out_channels, conv.kernel_size, stride=conv.stride,
                      padding=conv.padding, dilation=conv.dilation, bias=conv.bias is not None,
                      qat_momentum=qat_momentum)
        mod.weight, mod.bias = conv.weight, conv.bias
        mod.act_absmax = torch.zeros((), dtype=torch.float32, device=conv.weight.device)
        return mod.train(conv.training)

    def dense(self) -> Conv2d:
        """The plain :class:`Conv2d` holding this twin's parameter tensors."""
        with torch.device("meta"):
            mod = Conv2d(self.in_channels, self.out_channels, self.kernel_size,
                         stride=self.stride, padding=self.padding, dilation=self.dilation,
                         bias=self.bias is not None)
        mod.weight, mod.bias = self.weight, self.bias
        return mod.train(self.training)

    def forward(self, x):
        return F.conv2d(self._fake_quant_input(x), fake_quant_weight(self.weight), self.bias,
                        self.stride, self.padding, self.dilation, 1)


class QATLinear(nn.Linear, _Observed):
    """Fake-quant training twin of :class:`QuantLinear`, with the parameters of the
    ``Linear`` it replaces (per-out-feature weight grid)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 qat_momentum: float = 0.1, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self._init_observer(qat_momentum, self.weight.device)

    @classmethod
    def from_linear(cls, lin: nn.Linear, qat_momentum: float = 0.1) -> "QATLinear":
        """The twin of ``lin``, holding ``lin``'s own parameter tensors."""
        mod = cls(lin.in_features, lin.out_features, bias=lin.bias is not None,
                  qat_momentum=qat_momentum, device="meta")
        mod.weight, mod.bias = lin.weight, lin.bias
        mod.act_absmax = torch.zeros((), dtype=torch.float32, device=lin.weight.device)
        return mod.train(lin.training)

    def dense(self) -> nn.Linear:
        """The plain ``Linear`` holding this twin's parameter tensors."""
        mod = nn.Linear(self.in_features, self.out_features, bias=self.bias is not None,
                        device="meta")
        mod.weight, mod.bias = self.weight, self.bias
        return mod.train(self.training)

    def forward(self, x):
        return F.linear(self._fake_quant_input(x), fake_quant_weight(self.weight), self.bias)
