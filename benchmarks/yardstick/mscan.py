"""The yardstick's counts for MSCAN (SegNeXt's backbone with a classifier
head): the shapes of the port's kernel calls and the multiply-accumulates of
one image, from the configuration and the recipe alone.

MACs are counted as ``hooks/model_analysis.py::count_macs`` counts them on the
served model: every conv and linear at its executed shape, MSCA as its conv0,
its bank's taps and its channel mix, a merged FFN as its dense k x k conv.
Norms, activations and the gate are not counted.  All of it runs in float32.
"""

from __future__ import annotations

from .costs import PEAK_F32, msca_cost
from .recipe import Rewrites


def conv_out(H: int, k: int, stride: int, pad: int) -> int:
    return (H + 2 * pad - k) // stride + 1


def stage_sizes(image: int, n_stages: int):
    """Map sizes of the stages: a stem of two stride-2 3x3 convs, then one
    stride-2 3x3 downsample per stage."""
    H = conv_out(conv_out(image, 3, 2, 1), 3, 2, 1)
    sizes = [H]
    for _ in range(n_stages - 1):
        H = conv_out(H, 3, 2, 1)
        sizes.append(H)
    return sizes


def blocks(model: dict, image: int):
    """(stage, H, C, hidden, ffn index 1-based) of every block, stage-major."""
    out, n = [], 0
    sizes = stage_sizes(image, len(model["num_channels"]))
    for s, (C, nb, r) in enumerate(zip(model["num_channels"], model["num_blocks"],
                                       model["exp_ratios"])):
        for _ in range(nb):
            n += 1
            out.append((s, sizes[s], C, C * r, n))
    return out


def bank_taps(model: dict, rw: Rewrites) -> int:
    """Taps per element of the strip bank: every branch's (1, k) and (k, 1)."""
    if rw.msca_rank is not None:
        return rw.msca_rank * 2 * max(model["k_sizes"])
    return sum(2 * k for k in model["k_sizes"])


def macs_per_image(model: dict, rw: Rewrites, image: int) -> dict:
    """``{"float32": MACs}`` of one image's forward."""
    cin, widths = model["in_channels"], model["num_channels"]
    H1 = conv_out(image, 3, 2, 1)
    total = H1 * H1 * (widths[0] // 2) * cin * 9
    H = conv_out(H1, 3, 2, 1)
    total += H * H * widths[0] * (widths[0] // 2) * 9
    k0, kf = model["k1_size"], model["ffn_kernel"]
    sizes = stage_sizes(image, len(widths))
    for s in range(1, len(widths)):
        total += sizes[s] ** 2 * widths[s] * widths[s - 1] * 9
    for _, H, C, M, n in blocks(model, image):
        px = H * H
        total += 2 * px * C * C                        # proj_1, proj_2
        total += px * C * (k0 * k0 + bank_taps(model, rw) + C)  # conv0, the bank, the mix
        if n in rw.ffn_merged:
            total += px * C * M * kf * kf              # fc1 and the dwconv merged
        else:
            total += px * C * M + px * M * kf * kf     # fc1, the dwconv
        total += px * M * C                            # fc2
    total += widths[-1] * model["num_classes"]
    return {"float32": total}


def kernel_calls(model: dict, rw: Rewrites, batch: int, image: int) -> dict:
    """``{kernel: [(bytes, operations, peak), ...]}`` of one forward: every MSCA
    block is one ``msca_fused`` call, on the original bank (the identity and
    the strips) or on MscaRep's rank-r bank with its border fix."""
    if rw.msca_rank is None:
        ks, identity, p = tuple(model["k_sizes"]), True, 0
    else:
        ks, identity, p = (max(model["k_sizes"]),) * rw.msca_rank, False, max(model["k_sizes"]) // 2
    calls = [msca_cost(H, C, ks, identity, p, model["k1_size"], batch) + (PEAK_F32,)
             for _, H, C, _, _ in blocks(model, image)]
    return {"msca_fused": calls}
