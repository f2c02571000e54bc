"""The yardstick's counts: by hand at small shapes, against the program's own
MAC count (``hooks/model_analysis.py::count_macs``) and against the kernel
calls the program makes."""

from collections import Counter
from unittest import mock

import pytest
import torch
import tiny
from yardstick import convnext, costs, mscan
from yardstick.recipe import read_recipe

from benchkit import family, serve, spec, weights


def test_costs_by_hand():
    # one (1, 2, 2, 1) map, k0 = 3, one 3-tap branch, no identity, fix on 1 row:
    # per element 2*9 + 1 (conv0) + 4*3 + 2 (the branch) + 2*1 + 2 (mix, bias, gate) = 37
    assert costs.msca_cost(2, 1, (3,), False, 1, 3, 1) == (4 * (2 * 4 + 22), 4 * 37 + 2 * 1 * 2)
    # 4 elements, 4*3 + 2 + 1 per element; x, out and 2*3 + 2 packed taps and biases
    assert costs.cascade_cost(2, 1, (3,), True, 1) == (4 * (8 + 8), 4 * 15)
    # x 2x3 f32, w 3x4 int8, scales and bias 2*4+1 f32, y 2x4 f32; 2*2*4*3 ops
    assert costs.qmm_cost(2, 3, 4) == (24 + 12 + 36 + 32, 48)
    assert costs.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert costs.bound(1.0, 2 * 67e12) == (2.0, "operations")
    assert costs.bound(1.0, 1979e12, costs.PEAK_INT8) == (1.0, "operations")
    assert costs.least_seconds([(3.35e12, 1.0, costs.PEAK_F32), (1.0, 67e12, costs.PEAK_F32)]) == 2.0


def program_model(name, recipe=(), image=32, batch=2):
    """The program's model of a tiny cell, filled from a seed, after ``recipe``."""
    fam, model = tiny.CELLS[name]
    net = family.load(fam).build(model, torch.device("cpu"))
    weights.fill(net, torch.Generator().manual_seed(5))
    net = net.eval()
    calib = [torch.randn(batch, 3, image, image, generator=torch.Generator().manual_seed(6))]
    serve.apply_recipe(net, list(recipe), calib, 7)
    return net.eval(), model


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
@pytest.mark.parametrize("with_recipe", [False, True])
def test_macs_match_count_macs(name, with_recipe):
    from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs

    recipe = spec.load_cell(name).workload["recipe"] if with_recipe else []
    net, model = program_model(name, recipe)
    counts = {"mscan": mscan, "convnext": convnext}[tiny.CELLS[name][0]]
    ours = counts.macs_per_image(model, read_recipe(recipe), 32)
    x = torch.zeros(1, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    assert sum(ours.values()) == count_macs(net, x)


def test_dense_macs_at_published_sizes():
    """The dense models at the configurations' published widths, at 64^2."""
    from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs

    for name, counts in (("mscan_t.serve_f32_b128", mscan), ("convnext_t.serve_int8_b128", convnext)):
        cell = spec.load_cell(name)
        net = family.load(cell.config["family"]).build(cell.config["model"], torch.device("cpu"))
        weights.fill(net, torch.Generator().manual_seed(5))
        x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
        ours = counts.macs_per_image(cell.config["model"], read_recipe([]), 64)["float32"]
        assert ours == count_macs(net.eval(), x)


def recorded_calls(net, x):
    """The (kernel, cost) of every port kernel call of one forward, the cost
    from the call's own arguments."""
    from convnet_approximater_tpu_torch.ops import msca_fused as mf
    from convnet_approximater_tpu_torch.ops import parallel_cascade as pc
    from convnet_approximater_tpu_torch.ops import qmatmul as qm

    calls = []

    def msca(x, w0, b0, w1, b1, w2, b2, wm, bm, res=None, *, ks, identity, fix_p):
        B, H, W, C = x.shape
        calls.append(("msca_fused", costs.msca_cost(H, C, ks, identity, fix_p, w0.shape[0], B)))
        return mf.msca_fused_ref(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks=ks,
                                 identity=identity, fix_p=fix_p)

    def cascade(x, w1, b1, w2, b2, *, ks, identity):
        B, H, W, C = x.shape
        calls.append(("parallel_cascade", costs.cascade_cost(H, C, ks, identity, B)))
        return pc.parallel_cascade_ref(x, w1, b1, w2, b2, ks=ks, identity=identity)

    def qmatmul(x, w, a, ws, bias=None):
        calls.append(("qmatmul", costs.qmm_cost(x.shape[0], x.shape[1], ws.shape[0])))
        return qm.qmatmul_ref(x, w, a, ws, bias)

    with mock.patch.object(mf, "msca_fused", msca), mock.patch.object(pc, "parallel_cascade", cascade), \
            mock.patch.object(qm, "qmatmul", qmatmul), torch.no_grad():
        net(x)
    return calls


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_kernel_calls_match_the_program(name):
    recipe = spec.load_cell(name).workload["recipe"]
    net, model = program_model(name, recipe)
    x = torch.randn(2, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    got = Counter(recorded_calls(net, x))
    counts = {"mscan": mscan, "convnext": convnext}[tiny.CELLS[name][0]]
    want = Counter((k, (b, f)) for k, calls in counts.kernel_calls(model, read_recipe(recipe), 2, 32).items()
                   for b, f, _ in calls)
    assert got == want and got
