"""Plain operations the references share: torch functionals only, in the
precision of the tensors given, nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gelu(x):
    """GELU in its tanh form, the form the configurations state."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm_last(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def layer_norm_channels(x, w, b, eps):
    """LayerNorm over the channels of an NCHW map."""
    return layer_norm_last(x.permute(0, 2, 3, 1), w, b, eps).permute(0, 3, 1, 2)


def batch_norm_eval(x, p: dict, name: str, eps: float):
    """Inference batch norm of an NCHW map with the running statistics."""
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + eps)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def conv(x, p: dict, name: str, stride=1, padding=0, groups=1):
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride, padding, 1, groups)


def low_rank(kernels, rank: int):
    """The best rank-``rank`` approximation of each (k, k) kernel of a (C, k, k)
    stack, by its singular value decomposition."""
    u, s, vh = torch.linalg.svd(kernels, full_matrices=False)
    return (u[..., :rank] * s[..., None, :rank]) @ vh[..., :rank, :]


class Int8:
    """Symmetric post-training quantization as a configuration states it:
    per-output-channel weights at ``absmax / Q``, per-tensor activations at a
    static ``absmax / Q`` over the calibration batches, ``Q = 2^(bits-1) - 1``,
    round half to even, an exact integer sum, then ``* (a * w_scale) + bias``.

    ``observe`` mode records each named input's absmax and computes in float;
    ``quantize`` mode computes the integer product with the recorded scales."""

    def __init__(self, bits: int = 8):
        self.q = float(2 ** (bits - 1) - 1)
        self.absmax = {}
        self.observing = True

    def _scale(self, name):
        return max(float(self.absmax[name]), 1e-12) / self.q

    def _grid(self, t, scale):
        return torch.clamp(torch.round(t / scale), -self.q, self.q)

    def _weight(self, w):
        ws = w.abs().flatten(1).amax(dim=1).clamp_min(1e-12) / self.q
        return self._grid(w, ws.reshape((-1,) + (1,) * (w.dim() - 1))), ws

    def _observe(self, name, x):
        cur = float(x.abs().amax())
        self.absmax[name] = max(self.absmax.get(name, 0.0), cur)

    def linear(self, name, x, w, b):
        if self.observing:
            self._observe(name, x)
            return F.linear(x, w, b)
        a = self._scale(name)
        wq, ws = self._weight(w)
        return F.linear(self._grid(x, a), wq) * (a * ws) + b

    def conv(self, name, x, w, b, stride):
        if self.observing:
            self._observe(name, x)
            return F.conv2d(x, w, b, stride)
        a = self._scale(name)
        wq, ws = self._weight(w)
        return F.conv2d(self._grid(x, a), wq, None, stride) * (a * ws)[:, None, None] \
            + b[:, None, None]
