"""Plain reference of ConvNeXt (Liu et al., arXiv:2201.03545) on a dict of
weights named as the checkpoints name them.

DwSepRep's rank-r split of each block's depthwise k x k conv is worked out
again here (each channel's kernel cut to its best rank r by an SVD; the bias
kept), and so is ``quantize_int8`` (:class:`~reference.ops.Int8`: the
calibration's absmax at the input of every conv with ``groups == 1`` and of
every linear, over the calibration batches through this reference's own float
forward; per-channel weight scales of the split model's weights).
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from yardstick.recipe import Rewrites

from .ops import Int8, gelu, layer_norm_channels, layer_norm_last, low_rank


def _dense(q: Optional[Int8], name, x, w, b):
    return F.linear(x, w, b) if q is None else q.linear(name, x, w, b)


def _patchify(q: Optional[Int8], name, x, w, b, stride):
    return F.conv2d(x, w, b, stride) if q is None else q.conv(name, x, w, b, stride)


def strips(x, h, v, b, k):
    """A depthwise (1, k) conv of taps ``h`` (C, k), then a (k, 1) conv of taps
    ``v`` (C, k) with bias ``b``: a rank-1 separable k x k conv."""
    C = x.shape[1]
    y = F.conv2d(x, h[:, None, None, :], None, padding=(0, k // 2), groups=C)
    return F.conv2d(y, v[:, None, :, None], b, padding=(k // 2, 0), groups=C)


def forward(p: dict, x, model: dict, rw: Rewrites, q: Optional[Int8] = None, sep=None,
            taps=None):
    """Logits of the NCHW images ``x`` (normalised), in ``x``'s precision; with
    ``q``, the convs with ``groups == 1`` and the linears go through it; with
    ``sep`` ({block: (h, v, b)}), each block's depthwise conv is the rank-1
    separable conv of those taps; ``taps`` collects each depthwise conv's output."""
    eps, k = model["ln_eps"], model["kernel_size"]
    for s, depth in enumerate(model["depths"]):
        pre = f"downsample_layers.{s}"
        if s == 0:
            x = _patchify(q, f"{pre}.0", x, p[f"{pre}.0.weight"], p[f"{pre}.0.bias"],
                          model["stem_stride"])
            x = layer_norm_channels(x, p[f"{pre}.1.weight"], p[f"{pre}.1.bias"], eps)
        else:
            x = layer_norm_channels(x, p[f"{pre}.0.weight"], p[f"{pre}.0.bias"], eps)
            x = _patchify(q, f"{pre}.1", x, p[f"{pre}.1.weight"], p[f"{pre}.1.bias"], 2)
        for i in range(depth):
            b = f"stages.{s}.{i}"
            if sep is not None:
                y = strips(x, *sep[b], k)
            else:
                w = p[f"{b}.dwconv.weight"]
                if rw.dw_rank is not None:
                    w = low_rank(w[:, 0], rw.dw_rank)[:, None]
                y = F.conv2d(x, w, p[f"{b}.dwconv.bias"], padding=k // 2, groups=x.shape[1])
            if taps is not None:
                taps.append(y)
            y = layer_norm_last(y.permute(0, 2, 3, 1), p[f"{b}.norm.weight"],
                                p[f"{b}.norm.bias"], eps)
            y = gelu(_dense(q, f"{b}.pwconv1", y, p[f"{b}.pwconv1.weight"],
                            p[f"{b}.pwconv1.bias"]))
            y = _dense(q, f"{b}.pwconv2", y, p[f"{b}.pwconv2.weight"], p[f"{b}.pwconv2.bias"])
            x = x + (y * p[f"{b}.gamma.gamma"]).permute(0, 3, 1, 2)
    x = layer_norm_last(x.mean(dim=(2, 3)), p["norm.weight"], p["norm.bias"], eps)
    return _dense(q, "head", x, p["head.weight"], p["head.bias"])


def calibrated(p: dict, calib, model: dict, rw: Rewrites, bits: int) -> Int8:
    """An :class:`Int8` that has observed the float forward on every batch of
    ``calib``, switched to quantize."""
    q = Int8(bits)
    for x in calib:
        forward(p, x, model, rw, q)
    q.observing = False
    return q


def build(p: dict, model: dict, rw: Rewrites, calib=(), bits: int = 8):
    """The reference's forward on the weights ``p``, in their precision; with
    ``quantize_int8`` in the recipe, at ``bits`` (8 as served; fewer for a
    control) from ``calib``."""
    q = calibrated(p, calib, model, rw, bits) if rw.int8_calib_batches else None
    return lambda x: forward(p, x, model, rw, q)
