"""Light-Ham decode head of SegNeXt (port of
``convnet_approximater_tpu/segmentation/ham_head.py``).

The tapped backbone stages are resized to the first tapped stage's size (1/8
of the input), concatenated and squeezed to ``ham_channels`` by a 1x1 conv;
the **Hamburger** factorises the ReLU'd map ``X (C x N)`` as ``D @ R`` by
multiplicative NMF updates and puts the low-rank reconstruction in place of
an attention map; an align conv with GroupNorm and a 1x1 classifier give
logits at 1/8 of the input resolution (:func:`upsample_logits` resizes them to
the labels).

Gradients follow the JAX code, not its docstring (which says the iterations
run under ``stop_gradient``): the start (D, R) and the last dictionary are
detached, while the iterations and the last coefficient update are
differentiated, so R carries the gradient through every update.  The
dictionary starts from a fixed draw, the ``nmf_init`` buffer (1, C, rank), uniform in [1e-3, 1)
from a ``torch.Generator`` seeded 42, so eval is deterministic.  The JAX
package draws it from ``jax.random`` with key 42, which the port cannot
reproduce: a JAX checkpoint carries no draw, and the port keeps its own, an
equally valid NMF start (the JAX module's own note); the parity tests carry
JAX's draw across through :func:`~convnet_approximater_tpu_torch.convert.params_from_jax`.
The products are ``torch.bmm`` calls and the resizes ``F.interpolate``, as the
JAX package computes them with ``einsum`` and ``jax.image.resize``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.nn import Conv2d, Dropout, GroupNorm
from convnet_approximater_tpu_torch.parallel.spatial import global_size, pixel_sums, resize_rows

NMF_SEED = 42


def _gn_groups(channels: int, wanted: int = 32) -> int:
    """Largest divisor of ``channels`` not above ``wanted`` (SegNeXt uses 32
    groups; narrow widths need a valid fallback)."""
    g = min(wanted, channels)
    while channels % g:
        g -= 1
    return g


def nmf_draw(channels: int, rank: int) -> torch.Tensor:
    """The default dictionary start: (1, C, rank), uniform in [1e-3, 1), from a
    generator seeded :data:`NMF_SEED`."""
    gen = torch.Generator().manual_seed(NMF_SEED)
    return torch.rand(1, channels, rank, generator=gen) * (1.0 - 1e-3) + 1e-3


def nmf2d(x: torch.Tensor, d0: torch.Tensor, iters: int, eps: float = 1e-6) -> torch.Tensor:
    """Low-rank NMF reconstruction of ``x`` (B, N, C) -> (B, N, C), from the
    dictionary start ``d0`` (1, C, rank): ``iters`` multiplicative updates of
    R then D, one more update of R with the last D detached, and D @ R.
    ``(D^T D) R`` and ``D (R R^T)`` are formed in that order.  R is per pixel;
    ``X R^T`` and ``R R^T`` sum over every pixel (``parallel.pixel_sums``: over
    the model ranks' rows inside a spatial forward)."""
    X = F.relu(x.float()).transpose(1, 2)  # (B, C, N)
    B, C, _ = X.shape
    D = d0.float()
    D = (D / (torch.linalg.vector_norm(D, dim=1, keepdim=True) + eps)).expand(B, C, -1)

    def update_r(D, R):
        Dt = D.transpose(1, 2)
        return R * (torch.bmm(Dt, X) / (torch.bmm(torch.bmm(Dt, D), R) + eps))

    with torch.no_grad():
        R = torch.bmm(D.transpose(1, 2), X).clamp_min(eps)
    for _ in range(iters):
        R = update_r(D, R)
        Rt = R.transpose(1, 2)
        XRt, RRt = pixel_sums(torch.bmm(X, Rt), torch.bmm(R, Rt))
        D = D * (XRt / (torch.bmm(D, RRt) + eps))
    D = D.detach()
    Y = torch.bmm(D, update_r(D, R))  # (B, C, N)
    return Y.transpose(1, 2).to(x.dtype)


class Hamburger(nn.Module):
    """ham_in (1x1) -> NMF context -> ham_out (1x1) -> GroupNorm, residual, ReLU."""

    def __init__(self, ham_channels: int, rank: int = 64, iters: int = 6, gn_groups: int = 0):
        super().__init__()
        gn_groups = gn_groups or _gn_groups(ham_channels)
        self.rank = rank
        self.iters = iters
        self.ham_in = Conv2d(ham_channels, ham_channels, 1, bias=False)
        self.ham_out = Conv2d(ham_channels, ham_channels, 1, bias=False)
        self.norm = GroupNorm(gn_groups, ham_channels)
        self.register_buffer("nmf_init", nmf_draw(ham_channels, rank))

    def forward(self, x):
        B, C, H, W = x.shape
        y = self.ham_in(x).permute(0, 2, 3, 1).reshape(B, H * W, C)  # a view when channels_last
        y = nmf2d(y, self.nmf_init, self.iters).reshape(B, H, W, C).permute(0, 3, 1, 2)
        y = self.norm(self.ham_out(y))
        return F.relu(x + y)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW map to ``size`` (H, W), half-pixel centres.
    ``jax.image.resize(..., "bilinear")`` gives the same when it enlarges, as
    on every path here (when it shrinks it antialiases, this does not).
    Inside a spatial forward, this rank's rows (``parallel.resize_rows``)."""
    return resize_rows(x, size)


class LightHamHead(nn.Module):
    """Concat the tapped stages at the first one's size -> squeeze ->
    Hamburger -> align + GroupNorm -> classifier (logits at 1/8 of the input)."""

    def __init__(self, in_channels, num_classes: int, ham_channels: int = 256,
                 align_channels: int = 0, rank: int = 64, iters: int = 6,
                 dropout: float = 0.1):
        super().__init__()
        align_channels = align_channels or ham_channels
        self.in_channels = tuple(in_channels)
        self.squeeze = Conv2d(sum(self.in_channels), ham_channels, 1)
        self.hamburger = Hamburger(ham_channels, rank=rank, iters=iters)
        self.align = Conv2d(ham_channels, align_channels, 1)
        self.align_norm = GroupNorm(_gn_groups(align_channels), align_channels)
        self.drop = Dropout(dropout)
        self.cls = Conv2d(align_channels, num_classes, 1)

    def forward(self, feats):
        target = global_size(feats[0])  # spatially sharded: the rows on stage 2's split
        x = torch.cat([feats[0]] + [resize_bilinear(f, target) for f in feats[1:]], dim=1)
        x = self.hamburger(F.relu(self.squeeze(x)))
        x = F.relu(self.align_norm(self.align(x)))
        return self.cls(self.drop(x))


def upsample_logits(logits: torch.Tensor, size) -> torch.Tensor:
    """Resize 1/8-scale logits to the labels' resolution (mmseg's convention);
    spatially sharded, ``size`` is the whole image's and the rows are the
    input's split."""
    return resize_bilinear(logits, size)
