"""FfnRep: exact re-parameterization of the conv-FFN's fc1 + depthwise conv
(port of ``convnet_approximater_tpu/core/ffn_rep.py``).

fc1 (1x1, biased) and the depthwise k x k conv merge into one dense k x k conv
(:class:`~convnet_approximater_tpu_torch.layers.MergedFFN`).  The merge is exact
away from the borders; at distance t < p = k // 2 from an edge the dense conv
adds ``b1`` through taps that fall outside the map, where the original pads
fc1's output (bias included) with zeros.  By inclusion-exclusion over rows and
columns out of bounds the correction is

    correction[m, h, w] = -b1_m * S[m, h, w],
    S = (rows out) + (cols out) - (rows and cols out: the corners),

each a closed-form partial sum of the depthwise kernel D, held by
:class:`~convnet_approximater_tpu_torch.layers.FixPaddingBias2d`.  Weights are
OIHW here.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import MergedFFN, Substitution
from convnet_approximater_tpu_torch.models.mscan import FFN

from .approximater import APP, Approximater


def merged_ffn_solve(fc1: nn.Conv2d, dconv: nn.Conv2d, p: int):
    """Closed-form merged kernel, bias and border-fix params of ``dconv(fc1(x))``.

    ``fc1``: 1x1 conv C -> M (its bias, if any, is b1); ``dconv``: depthwise
    k x k conv over M with ``k == 2 p + 1``.  Returns ``(weight (M, C, k, k),
    bias (M,), res_v (2, M, p), res_h (2, M, p), res_c (2, 2, M, p, p))`` on the
    convs' device.
    """
    w1 = fc1.weight[:, :, 0, 0]  # (M, C)
    M = w1.shape[0]
    b1 = fc1.bias if fc1.bias is not None else w1.new_zeros(M)
    d = dconv.weight[:, 0]  # (M, k, k)
    bd = dconv.bias if dconv.bias is not None else w1.new_zeros(M)
    k = d.shape[1]
    if d.shape[2] != k or k != 2 * p + 1:
        raise ValueError(f"merged_ffn_solve: need a square {2 * p + 1}-tap dconv, got "
                         f"{tuple(d.shape[1:])}")
    weight = d[:, None] * w1[:, :, None, None]
    bias = b1 * d.sum(dim=(1, 2)) + bd
    rs, cs = d.sum(dim=2), d.sum(dim=1)  # (M, k) row and column sums
    # at distance t from the top edge, rows a < p - t of D are out of bounds; at
    # distance t from the bottom, rows a > p + t.  Side 1 (bottom, right) of
    # FixPaddingBias2d runs toward its edge, so its partial sums are reversed.
    top = [slice(None, p - t) for t in range(p)]
    bot = [slice(p + t + 1, None) for t in range(p)]
    a_top = torch.stack([rs[:, r].sum(dim=1) for r in top], dim=1)  # (M, p)
    a_bot = torch.stack([rs[:, r].sum(dim=1) for r in bot], dim=1).flip(1)
    b_lft = torch.stack([cs[:, c].sum(dim=1) for c in top], dim=1)
    b_rgt = torch.stack([cs[:, c].sum(dim=1) for c in bot], dim=1).flip(1)
    res_v = -b1[:, None] * torch.stack([a_top, a_bot])  # (2, M, p)
    res_h = -b1[:, None] * torch.stack([b_lft, b_rgt])

    # the corners: + b1 * (taps out of bounds in both axes), undoing the double
    # count of the strip sums
    def corner(rows, cols):  # (M, p, p)
        return torch.stack([torch.stack([d[:, r, c].sum(dim=(1, 2)) for c in cols], dim=1)
                            for r in rows], dim=1)

    res_c = b1[:, None, None] * torch.stack([
        torch.stack([corner(top, top), corner(top, bot).flip(2)]),
        torch.stack([corner(bot, top).flip(1), corner(bot, bot).flip(1, 2)]),
    ])  # (2, 2, M, p, p)
    return weight, bias, res_v, res_h, res_c


@APP.register_module()
class FfnRep(Approximater):
    """Merge FFN's fc1 and depthwise conv into one dense conv (exact, with the
    closed-form border fix when ``fix``)."""

    _src_type = FFN
    _tgt_type = "MergedFFN"

    def __init__(self, fix: bool = True):
        self.fix = fix

    def _get_tgt_args(self, src: FFN) -> Dict:
        return dict(num_channel=src.num_channel, hidden_channel=src.hidden_channel,
                    drop=src.drop_rate, kernel_size=src.dconv.kernel_size[0], fix=self.fix)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        sub.new.fc2.load_state_dict(sub.old.fc2.state_dict())

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        src: FFN = sub.old_module
        tgt: MergedFFN = sub.new_module
        weight, bias, res_v, res_h, res_c = merged_ffn_solve(src.fc1, src.dconv,
                                                             tgt.kernel_size // 2)
        tgt.conv.weight.copy_(weight)
        tgt.conv.bias.copy_(bias)
        if self.fix:
            tgt.fix.res_v.copy_(res_v)
            tgt.fix.res_h.copy_(res_h)
            tgt.fix.res_c.copy_(res_c)

    def _postprocess(self, sub: Substitution):
        pass
