"""Plain reference of the MSCAN classifier (SegNeXt's MSCAN backbone, Guo et
al., arXiv:2209.08575, with global average pooling and a linear head), on a
dict of weights named as the checkpoints name them.

It computes the served model's function from the dense weights: the exact
rewrites (FfnRep, the BN fold, 1x1 convs as matmuls) are computed in their
original form, and MscaRep's rank-r bank is worked out again here: the strip
bank's merged kernel (the identity plus every branch's vertical-times-
horizontal taps), cut to its best rank r by an SVD, and the bank's own bias
as the original computes it, the first bias of each branch through its
zero-padded vertical taps (what the border fix restores).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yardstick.recipe import Rewrites

from .ops import batch_norm_eval, conv, gelu, layer_norm_channels, low_rank


def bank_kernel(p: dict, name: str, k_sizes, dtype):
    """(merged (C, K, K), bias map function) of a strip bank with an identity."""
    K = max(k_sizes)
    C = p[f"{name}.branches.0.conv1.weight"].shape[0]
    merged = torch.zeros(C, K, K, dtype=dtype, device=p[f"{name}.branches.0.conv1.weight"].device)
    merged[:, K // 2, K // 2] = 1.0
    for i, k in enumerate(k_sizes):
        h = p[f"{name}.branches.{i}.conv1.weight"][:, 0, 0, :]  # (C, k)
        v = p[f"{name}.branches.{i}.conv2.weight"][:, 0, :, 0]  # (C, k)
        o = (K - k) // 2
        merged[:, o:o + k, o:o + k] += v[:, :, None] * h[:, None, :]

    def bias_map(H):  # (1, C, H, 1): each branch's b1 through its vertical taps, plus b2
        out = 0
        for i, k in enumerate(k_sizes):
            b1 = p[f"{name}.branches.{i}.conv1.bias"]
            col = b1[None, :, None, None].expand(1, C, H, 1)
            w2 = p[f"{name}.branches.{i}.conv2.weight"]
            out = out + F.conv2d(col, w2, p[f"{name}.branches.{i}.conv2.bias"],
                                 padding=(k // 2, 0), groups=C)
        return out
    return merged, bias_map


def msca(x, p, name, model, rw: Rewrites):
    u = conv(x, p, f"{name}.conv0", padding=model["k1_size"] // 2, groups=x.shape[1])
    merged, bias_map = bank_kernel(p, f"{name}.sd_convs", model["k_sizes"], x.dtype)
    if rw.msca_rank is not None:
        merged = low_rank(merged, rw.msca_rank)
    K = merged.shape[-1]
    attn = F.conv2d(u, merged[:, None], None, padding=K // 2, groups=u.shape[1])
    attn = attn + bias_map(u.shape[2])
    return x * conv(attn, p, f"{name}.channel_mix")


def block(x, p, name, model, rw):
    eps = model["bn_eps"]
    y = batch_norm_eval(x, p, f"{name}.norm1", eps)
    a = gelu(conv(y, p, f"{name}.attn.proj_1"))
    a = conv(msca(a, p, f"{name}.attn.spatial_gating_unit", model, rw), p,
             f"{name}.attn.proj_2") + y
    x = x + p[f"{name}.layer_scale_1"][:, None, None] * a
    y = batch_norm_eval(x, p, f"{name}.norm2", eps)
    C4 = p[f"{name}.mlp.fc1.weight"].shape[0]
    f = conv(y, p, f"{name}.mlp.fc1")
    f = gelu(conv(f, p, f"{name}.mlp.dconv", padding=model["ffn_kernel"] // 2, groups=C4))
    f = conv(f, p, f"{name}.mlp.fc2")
    return x + p[f"{name}.layer_scale_2"][:, None, None] * f


def forward(p: dict, x, model: dict, rw: Rewrites):
    """Logits of the NCHW images ``x`` (normalised), in ``x``'s precision."""
    if rw.dw_rank is not None or rw.int8_calib_batches:
        raise ValueError("the MSCAN reference has no DwSepRep or int8 form")
    eps = model["bn_eps"]
    for s, nb in enumerate(model["num_blocks"]):
        pre = f"backbone.layers.{s}"
        if s == 0:
            x = batch_norm_eval(conv(x, p, f"{pre}.0.proj.0", 2, 1), p, f"{pre}.0.proj.1", eps)
            x = gelu(x)
            x = batch_norm_eval(conv(x, p, f"{pre}.0.proj.3", 2, 1), p, f"{pre}.0.proj.4", eps)
        else:
            x = batch_norm_eval(conv(x, p, f"{pre}.0.proj", 2, 1), p, f"{pre}.0.norm", eps)
        for b in range(nb):
            x = block(x, p, f"{pre}.1.{b}", model, rw)
        x = layer_norm_channels(x, p[f"{pre}.2.weight"], p[f"{pre}.2.bias"], model["ln_eps"])
    return F.linear(x.mean(dim=(2, 3)), p["head.weight"], p["head.bias"])


def build(p: dict, model: dict, rw: Rewrites, calib=(), bits: int = 8):
    """The reference's forward on the weights ``p``, in their precision."""
    return lambda x: forward(p, x, model, rw)
