"""The plain references against the program's CPU path at tiny widths."""

import pytest
import torch
import tiny
from reference import convnext, mscan, ops
from yardstick.recipe import Rewrites, read_recipe

from benchkit import family, serve, spec, weights


def program_and_weights(name, recipe):
    fam, model = tiny.CELLS[name]
    net = family.load(fam).build(model, torch.device("cpu"))
    dense = weights.fill(net, torch.Generator().manual_seed(21))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(22))
    serve.apply_recipe(net.eval(), recipe, [x.contiguous(memory_format=torch.channels_last)], 23)
    return net.eval(), {k: v.double() for k, v in dense.items()}, model, x


@pytest.mark.parametrize("name,with_recipe", [(n, r) for n in tiny.SERVE_CELLS for r in (False, True)])
def test_reference_holds_the_program(name, with_recipe):
    recipe = spec.load_cell(name).workload["recipe"] if with_recipe else []
    net, p, model, x = program_and_weights(name, recipe)
    rw = read_recipe(recipe)
    ref = {"mscan": mscan, "convnext": convnext}[tiny.CELLS[name][0]]
    forward = ref.build(p, model, rw, [x.double()])
    with torch.no_grad():
        got = net(x.contiguous(memory_format=torch.channels_last)).double()
    want = forward(x.double())
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_low_rank_is_the_best_rank_r_approximation():
    k = torch.randn(5, 7, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    s = torch.linalg.svdvals(k)
    for r in (1, 3, 7):
        err = torch.linalg.matrix_norm(k - ops.low_rank(k, r))
        assert torch.allclose(err, s[:, r:].square().sum(-1).sqrt(), atol=1e-12)


def test_int8_grid():
    q = ops.Int8(bits=8)
    x = torch.tensor([[0.5, -1.0, 2.0]], dtype=torch.float64)
    w = torch.tensor([[1.0, 0.0, -0.5], [0.25, 0.25, 0.25]], dtype=torch.float64)
    q.linear("l", x, w, torch.zeros(2, dtype=torch.float64))
    q.observing = False
    a = 2.0 / 127
    xq = torch.round(x / a)
    wq = torch.round(w / (w.abs().amax(1, keepdim=True) / 127))
    want = (xq @ wq.t()) * (a * (w.abs().amax(1) / 127))
    assert torch.allclose(q.linear("l", x, w, torch.zeros(2, dtype=torch.float64)), want,
                          rtol=1e-15, atol=0)
    assert ops.Int8(bits=4).q == 7.0


def test_recipe_facts():
    rw = read_recipe(spec.load_cell("convnext_t.serve_int8_b128").workload["recipe"])
    assert rw == Rewrites(dw_rank=1, int8_calib_batches=2)
    rw = read_recipe(spec.load_cell("mscan_t.serve_f32_b128").workload["recipe"])
    assert rw == Rewrites(msca_rank=1, ffn_merged=(1, 2, 3, 4, 5, 6))
    with pytest.raises(ValueError):
        read_recipe([{"pass": "prune_width"}])
