"""The yardstick's counts for ConvNeXt: the shapes of the port's kernel calls
and the multiply-accumulates of one image, from the configuration and the
recipe alone.

MACs are counted as ``hooks/model_analysis.py::count_macs`` counts them on the
served model: the patchify stem and downsamples, each block's depthwise k x k
(or DwSepRep's rank-r strips) and its two linears, and the head.  Norms,
activations and the layer scale are not counted.  After ``quantize_int8`` the
convs with ``groups == 1`` and the linears are int8; the depthwise ones stay
float32.
"""

from __future__ import annotations

from .costs import PEAK_F32, PEAK_INT8, cascade_cost, qmm_cost
from .recipe import Rewrites


def stage_sizes(model: dict, image: int):
    H = image // model["stem_stride"]
    return [H // 2 ** s for s in range(len(model["dims"]))]


def macs_per_image(model: dict, rw: Rewrites, image: int) -> dict:
    """``{"float32": MACs, "int8": MACs}`` of one image's forward."""
    dims, k, r = model["dims"], model["kernel_size"], model["mlp_ratio"]
    sizes = stage_sizes(model, image)
    s0 = model["stem_stride"]
    dense = sizes[0] ** 2 * dims[0] * model["in_channels"] * s0 * s0
    dense += sum(sizes[s] ** 2 * dims[s] * dims[s - 1] * 4 for s in range(1, len(dims)))
    dense += dims[-1] * model["num_classes"]
    depthwise = 0
    taps = k * k if rw.dw_rank is None else 2 * k * rw.dw_rank
    for s, (C, n) in enumerate(zip(dims, model["depths"])):
        px = sizes[s] ** 2
        dense += n * 2 * px * C * C * r
        depthwise += n * px * C * taps
    if rw.int8_calib_batches:
        return {"float32": depthwise, "int8": dense}
    return {"float32": depthwise + dense}


def kernel_calls(model: dict, rw: Rewrites, batch: int, image: int) -> dict:
    """``{kernel: [(bytes, operations, peak), ...]}`` of one forward: each
    DwSepRep strip bank is one ``parallel_cascade`` call, each int8 conv and
    linear one ``qmatmul`` over its (M, K) rows."""
    dims, k, r = model["dims"], model["kernel_size"], model["mlp_ratio"]
    sizes = stage_sizes(model, image)
    calls = {}
    if rw.dw_rank is not None:
        calls["parallel_cascade"] = [
            cascade_cost(sizes[s], C, (k,) * rw.dw_rank, False, batch) + (PEAK_F32,)
            for s, (C, n) in enumerate(zip(dims, model["depths"])) for _ in range(n)]
    if rw.int8_calib_batches:
        s0 = model["stem_stride"]
        shapes = [(batch * sizes[0] ** 2, model["in_channels"] * s0 * s0, dims[0])]
        for s, (C, n) in enumerate(zip(dims, model["depths"])):
            if s:
                shapes.append((batch * sizes[s] ** 2, 4 * dims[s - 1], C))
            M = batch * sizes[s] ** 2
            shapes += [(M, C, C * r), (M, C * r, C)] * n
        shapes.append((batch, dims[-1], model["num_classes"]))
        calls["qmatmul"] = [qmm_cost(*mkn) + (PEAK_INT8,) for mkn in shapes]
    return calls
