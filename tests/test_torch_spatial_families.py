"""Spatial sharding of the other model families in the port
(``parallel/spatial.py``): the pools, ``LowRankExpConvV1`` on
``lowrank_conv``, ``QuantConv2d`` on ``qmatmul``, the adaptive pools and the
flattening heads.

On the CPU without ranks, each row form against the whole layer, its ranks
emulated (:func:`emulated`: the exchange slices the whole map, the layout is
the split's):

* ``MaxPool2d`` on a negative map (its ``-inf`` padding at the image's
  edges, not the halo's zeros), bit for bit;
* ``AdaptiveAvgPool2d`` to 7x7 and 6x6 with bins straddling shard edges
  (13 rows to 6, 1 row to 7), bit for bit;
* ``lowrank_conv_ref`` on each window of a ``LowRankExpConvV1`` (the full
  ``bases`` form and the separable ``v``/``h`` form, strides 1, 2 and 4,
  one-row windows), within 1e-5 of the whole map's rows;
* ``QuantConv2d`` windows (the im2col form, patchify, the stride-2 1x1 of a
  downsample), bit for bit;
* ``lowrank_conv``'s planner on every window height of the card's paths.

Over gloo ranks (``tests/torch_ranks.py::spatial_families_job``), on a
(1 x 2) mesh and an uneven (1 x 3) one (ResNet's stage 4 at 48^2: 2 rows
as 1, 1, 0): scheme-1 ResNet-18 (16 separable sites), VGG-11 with a V2, a V3
and a V4 site, the dodecomp AlexNet and int8 ResNet-18, each against the JAX
package's replicated forward on the same weights (float32 within 1e-4 of the
largest logit, int8 within 1e-3), and scheme-1 ResNet-18 against JAX's
``spatial_sharding`` forward on its CPU devices too; each rank's kernel
calls per forward and its collectives (the one gathered map is the pooled
map of a flattening head).  The weights are the port's, carried to JAX (its
apps in deploy mode build the bare structures).
"""

import contextlib
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV1 as JV1  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV2 as JV2  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV3 as JV3  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV4 as JV4  # noqa: E402
from convnet_approximater_tpu.filters import IndicesFilter as JIndices  # noqa: E402
from convnet_approximater_tpu.filters import KernelSizeFilter as JKernelSize  # noqa: E402
from convnet_approximater_tpu.filters import SimpleConvFilter as JSimpleConv  # noqa: E402
from convnet_approximater_tpu.models import VGG as JVGG  # noqa: E402
from convnet_approximater_tpu.models import AlexNet as JAlexNet  # noqa: E402
from convnet_approximater_tpu.models import ResNet as JResNet  # noqa: E402
from convnet_approximater_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.core import (LowRankExpV1, LowRankExpV2,  # noqa: E402
                                                 LowRankExpV3, LowRankExpV4)
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.filters import (IndicesFilter,  # noqa: E402
                                                    KernelSizeFilter, SimpleConvFilter)
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1  # noqa: E402
from convnet_approximater_tpu_torch.layers.quant import QuantConv2d  # noqa: E402
from convnet_approximater_tpu_torch.models import VGG, AlexNet, ResNet  # noqa: E402
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops  # noqa: E402
from convnet_approximater_tpu_torch.parallel import spatial  # noqa: E402
from convnet_approximater_tpu_torch.parallel.tp_layers import ModelAxis  # noqa: E402
from tests.test_torch_spatial_sharding import (jax_forward, jax_structure,  # noqa: E402
                                               jvars_of, take)

torch.set_num_threads(1)
LOGITS = 1e-4       # float32 logits: max-abs error over max |logit|
INT8_LOGITS = 1e-3  # int8 logits
KERNEL_RTOL = 1e-5  # lowrank_conv_ref on a window against the whole map's rows
MESHES = (2, 3)     # (1 x n) meshes: model axes of 2 and 3 ranks
FAMILIES = ("resnet18_s1", "vgg_v234", "alexnet_dodecomp", "int8_resnet18")
KERNELS = {"resnet18_s1": ("lowrank_conv", 16), "alexnet_dodecomp": ("lowrank_conv", 4),
           "int8_resnet18": ("qmatmul", 21), "vgg_v234": (None, 0)}


# -- the row forms against the whole layer (ranks emulated) ----------------------
@contextlib.contextmanager
def emulated(whole: torch.Tensor, r: int, n: int):
    """Rank ``r`` of ``n`` inside a spatial forward over the NCHW map
    ``whole``: its exchanges slice the whole map, every layout is the split's."""
    H = whole.shape[2]
    rows = spatial.Rows(H, tuple(spatial.row_split(H, n)))
    plan = spatial.SpatialPlan(ModelAxis(r, n, None, tuple(range(n))))
    nhwc = whole.permute(0, 2, 3, 1)

    def fetch(xh, layout, needs, axis, fill=0.0):
        return [t.contiguous() for t in take_filled(nhwc, needs[r], fill)]

    token = spatial._forward.set(spatial._Forward(plan, ()))
    try:
        with mock.patch.object(spatial, "fetch_rows", fetch), \
                mock.patch.object(spatial, "_layout", lambda p, name, x: rows):
            yield plan, rows.bounds[r]
    finally:
        spatial._forward.reset(token)


def take_filled(whole: torch.Tensor, ranges, fill: float) -> list:
    """:func:`take` with ``fill`` outside the map."""
    out = take(whole, ranges)
    H = whole.shape[1]
    for t, (lo, hi) in zip(out, ranges):
        t[:, :max(0, min(hi, 0) - lo)] = fill
        t[:, t.shape[1] - max(0, hi - max(lo, H)):] = fill
    return out


def row_outputs(layer, x: torch.Tensor, n: int) -> list:
    """Each emulated rank's output of ``layer``'s row form on its rows of ``x``."""
    outs = []
    for r in range(n):
        with emulated(x, r, n) as (plan, (lo, hi)), torch.no_grad():
            layer.__dict__["_spatial"] = spatial.SpatialLeaf(plan, "layer")
            try:
                outs.append(spatial._form(layer)(layer, x[:, :, lo:hi]))
            finally:
                del layer.__dict__["_spatial"]
    return outs


def map_of(B, C, H, W, seed, negative=False):
    x = torch.randn(B, C, H, W, generator=torch.Generator().manual_seed(seed))
    if negative:
        x = -x.abs() - 1.0
    return x.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("pool", [(3, 2, 1), (3, 2, 0), (2, 2, 0)],
                         ids=["resnet-stem", "alexnet", "vgg"])
@pytest.mark.parametrize("H,n", [(7, 2), (12, 3), (13, 2), (27, 3), (56, 2)])
def test_max_pool_rows_pad_with_minus_infinity(pool, H, n):
    """Every value of the map is below -1, so a window padded with the halo's
    zeros would put 0 in the edge rows; the pool's own padding is -inf."""
    k, s, p = pool
    layer = torch.nn.MaxPool2d(k, s, padding=p).eval()
    x = map_of(2, 4, H, 9, H + n, negative=True)
    whole = layer(x)
    got = torch.cat(row_outputs(layer, x, n), dim=2)
    assert torch.equal(got, whole)
    assert float(got.max()) < -1.0


@pytest.mark.parametrize("out", [7, 6])
@pytest.mark.parametrize("H,n", [(13, 2), (13, 3), (1, 2), (14, 3), (5, 2), (7, 3)])
def test_adaptive_pool_bins_straddle_shard_edges(out, H, n):
    """Output rows of ``row_split(out, n)``, each the mean of its bin of
    global rows: 13 rows to 6 gives bins [4, 7) and [6, 9) over the shard
    edge at 7 (and at 5 and 10 over 3 ranks)."""
    layer = torch.nn.AdaptiveAvgPool2d((out, out)).eval()
    x = map_of(2, 3, H, 8, H * out + n)
    whole = layer(x)
    parts = row_outputs(layer, x, n)
    assert [t.shape[2] for t in parts] == [hi - lo for lo, hi in spatial.row_split(out, n)]
    assert torch.equal(torch.cat(parts, dim=2), whole)


def shared_v1(C, N, M, k, s, p, decomp, seed):
    """A ``LowRankExpConvV1`` whose M bases every input channel shares (the
    kernel's condition), as the scheme-1 solve gives."""
    gen = torch.Generator().manual_seed(seed)
    layer = LowRankExpConvV1(C, N, k, s, p, M, decomp=False)
    with torch.no_grad():
        layer.s_conv.weight.copy_(torch.randn(M, 1, k, k, generator=gen).repeat(C, 1, 1, 1))
        layer.d_conv.weight.copy_(torch.randn(N, C * M, 1, 1, generator=gen) * 0.3)
        layer.d_conv.bias.copy_(torch.randn(N, generator=gen))
        if decomp:
            layer.decomp()
    return layer.eval()


LOWRANK = {  # (C, N, M, k, stride, padding)
    "3x3 s1": (4, 6, 3, 3, 1, 1), "3x3 s2": (4, 5, 4, 3, 2, 1), "5x5 s1": (3, 4, 2, 5, 1, 2),
    "11x11 s4": (3, 4, 2, 11, 4, 2)}


@pytest.mark.parametrize("decomp", [False, True], ids=["bases", "separable"])
@pytest.mark.parametrize("conv", LOWRANK)
@pytest.mark.parametrize("H,n", [(9, 2), (16, 3), (23, 2), (40, 3)])
def test_lowrank_windows_match_the_whole_map(decomp, conv, H, n):
    C, N, M, k, s, p = LOWRANK[conv]
    if H + 2 * p < k:
        pytest.skip("the kernel is taller than the padded map")
    layer = shared_v1(C, N, M, k, s, p, decomp, H + n)
    x = map_of(2, C, H, 11, H * 3 + n)
    with torch.no_grad():
        assert layer.uses_kernel()
        whole = layer(x)
    calls = torch_ranks.Calls(lowrank_ops, "lowrank_conv")
    try:
        parts = row_outputs(layer, x, n)
    finally:
        calls.close()
    assert [t.shape[2] for t in parts] == [hi - lo for lo, hi in
                                           spatial.row_split(whole.shape[2], n)]
    assert len(calls.shapes) == sum(t.shape[2] > 0 for t in parts)  # one call per window
    got = torch.cat(parts, dim=2)
    assert float((got - whole).abs().max() / whole.abs().max()) < KERNEL_RTOL


QUANT = {  # (C, N, kernel, stride, padding)
    "3x3 s1": (4, 6, 3, 1, 1), "3x3 s2": (4, 6, 3, 2, 1), "7x7 s2 stem": (3, 8, 7, 2, 3),
    "1x1 s2 downsample": (6, 5, 1, 2, 0), "1x1 s1": (6, 5, 1, 1, 0),
    "patchify 2x2": (4, 6, 2, 2, 0), "patchify 4x4": (3, 6, 4, 4, 0)}


@pytest.mark.parametrize("conv", QUANT)
@pytest.mark.parametrize("H,n", [(8, 2), (15, 3), (24, 2), (12, 3)])
def test_quant_conv_windows_are_bit_equal(conv, H, n):
    """The activation scale is static, so each output of a window's im2col
    is the whole layer's, bit for bit; the stride-2 1x1 keeps the global
    rows' parity (an odd rank start takes the next even row)."""
    C, N, k, s, p = QUANT[conv]
    dense = torch.nn.Conv2d(C, N, k, stride=s, padding=p)
    torch.nn.init.normal_(dense.weight, generator=torch.Generator().manual_seed(H))
    layer = QuantConv2d.from_conv(dense, 0.02)
    x = map_of(2, C, H, 12, H + n)
    with torch.no_grad():
        whole = layer(x)
    assert torch.equal(torch.cat(row_outputs(layer, x, n), dim=2), whole)


# the scheme-1 shapes of the card's paths at 224^2: (H, C, M, N, k, stride, padding)
RESNET18_SHAPES = ([(56, 64, 4, 64, 3, 1, 1), (56, 64, 4, 128, 3, 2, 1), (28, 128, 4, 128, 3, 1, 1),
                    (28, 128, 4, 256, 3, 2, 1), (14, 256, 4, 256, 3, 1, 1),
                    (14, 256, 4, 512, 3, 2, 1), (7, 512, 4, 512, 3, 1, 1)])
VGG16_SHAPES = [(224, 64, 16, 64, 3, 1, 1), (112, 64, 16, 128, 3, 1, 1),
                (112, 128, 16, 128, 3, 1, 1), (56, 128, 16, 256, 3, 1, 1),
                (56, 256, 16, 256, 3, 1, 1), (28, 256, 16, 512, 3, 1, 1),
                (28, 512, 16, 512, 3, 1, 1), (14, 512, 16, 512, 3, 1, 1)]
ALEXNET_SHAPES = [(27, 64, 8, 192, 5, 1, 2), (13, 192, 8, 384, 3, 1, 1),
                  (13, 384, 6, 256, 3, 1, 1), (13, 256, 4, 256, 3, 1, 1)]


@pytest.mark.parametrize("path,shapes", [("resnet18", RESNET18_SHAPES), ("vgg16", VGG16_SHAPES),
                                         ("alexnet", ALEXNET_SHAPES)])
def test_lowrank_plan_takes_every_window_height(path, shapes):
    """``plan`` sees a window's height: every window of b=64 at 224^2 over
    2 and 3 ranks, and every height from one output row up, fits a plan."""
    for H, C, M, N, k, s, p in shapes:
        Ho = (H + 2 * p - k) // s + 1
        heights = {(rows - 1) * s + k for rows in range(1, Ho + 1)}
        for n in MESHES:
            heights |= {(o1 - o0 - 1) * s + k for o0, o1 in spatial.row_split(Ho, n) if o1 > o0}
        for Hw in sorted(heights):
            got = lowrank_ops.plan(64, Hw, H, C, M, N, (k, k), (s, s), (0, p))
            assert got.smem <= lowrank_ops.SMEM_MAX, (H, Hw)


# -- the families over gloo ranks ---------------------------------------------------
def port_models() -> dict:
    """The four families with the port's weights, and each one's dense source."""
    rs = np.random.RandomState(0)
    x48 = rs.randn(2, 48, 48, 3).astype(np.float32)
    x96 = rs.randn(2, 96, 96, 3).astype(np.float32)
    out, dense = {}, {}
    model = torch_ranks.randomize(ResNet(18, 16), 0)
    dense["resnet18_s1"] = torch_ranks.randomize(ResNet(18, 16), 0)
    assert apply_app(model, LowRankExpV1(num_bases=(3,) * 16, do_decomp=True),
                     [KernelSizeFilter(2), IndicesFilter(tuple(range(2, 18)))]) == 16
    out["resnet18_s1"] = (model, x48)
    model = torch_ranks.randomize(VGG(depth=11, num_classes=16), 1)
    dense["vgg_v234"] = torch_ranks.randomize(VGG(depth=11, num_classes=16), 1)
    for app, index in ((LowRankExpV2(num_bases=(4,)), 2), (LowRankExpV3(num_bases=(4,)), 3),
                       (LowRankExpV4(num_bases=(4,)), 4)):
        assert apply_app(model, app, [IndicesFilter((index,))]) == 1
    out["vgg_v234"] = (model, x48)
    model = torch_ranks.randomize(AlexNet(num_classes=16), 2)
    dense["alexnet_dodecomp"] = torch_ranks.randomize(AlexNet(num_classes=16), 2)
    assert apply_app(model, LowRankExpV1(num_bases=(8, 8, 6, 4), do_decomp=True),
                     [SimpleConvFilter(), IndicesFilter((2, 3, 4, 5))]) == 4
    out["alexnet_dodecomp"] = (model, x96)
    model = torch_ranks.randomize(ResNet(18, 16), 3)
    dense["int8_resnet18"] = torch_ranks.randomize(ResNet(18, 16), 3)
    assert deploy.fold_batchnorm(model) == 20
    assert deploy.quantize_int8(model, [torch_ranks.nchw(x48)]) == 21
    out["int8_resnet18"] = (model, x48)
    return out, dense


def jax_model(name, model, dense):
    """The JAX model of ``name`` holding the port model's weights."""
    if name == "resnet18_s1":
        jmodel = JResNet(depth=18, num_classes=16)
        jax_structure(jmodel, JV1(num_bases=(3,) * 16, init_decomp=True, deploy=True),
                      [JKernelSize(2), JIndices(tuple(range(2, 18)))], dense)
    elif name == "vgg_v234":
        jmodel = JVGG(depth=11, num_classes=16)
        for app, index in ((JV2(num_bases=(4,), deploy=True), 2),
                           (JV3(num_bases=(4,), deploy=True), 3),
                           (JV4(num_bases=(4,), deploy=True), 4)):
            jax_structure(jmodel, app, [JIndices((index,))], dense)
    elif name == "alexnet_dodecomp":
        jmodel = JAlexNet(num_classes=16)
        jax_structure(jmodel, JV1(num_bases=(8, 8, 6, 4), init_decomp=True, deploy=True),
                      [JSimpleConv(), JIndices((2, 3, 4, 5))], dense)
    else:  # the JAX fold and quantization build the int8 structure; the port's weights follow
        jmodel = JResNet(depth=18, num_classes=16)
        jv = jvars_of(dense)
        jdeploy.fold_batchnorm(jmodel, jv)
        assert jdeploy.quantize_int8(jmodel, jv, [np.zeros((1, 32, 32, 3), np.float32)]) == 21
    return jmodel, jvars_of(model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    port, dense = port_models()
    with torch.no_grad():
        whole = {name: m(torch_ranks.nchw(x)).numpy() for name, (m, x) in port.items()}
    jax_ref = {}
    for name, (m, x) in port.items():
        jmodel, jv = jax_model(name, m, dense[name])
        jax_ref[name] = jax_forward(jmodel, jv, x)
        if name == "resnet18_s1":
            jax_ref["sp"] = {n: jax_forward(jmodel, jv, x, jmake_mesh(
                data=1, model=n, devices=jax.devices()[:n])) for n in MESHES}
    path = d / "cases.pt"
    torch.save({name: dict(model=m, x=x) for name, (m, x) in port.items()}, path)
    ranks = {n: torch_ranks.spawn(torch_ranks.spatial_families_job, n, d / f"1x{n}",
                                  path=str(path)) for n in MESHES}
    return dict(whole=whole, jax=jax_ref, ranks=ranks,
                x={name: x for name, (_, x) in port.items()})


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax_replicated(runs, name, n):
    bound = INT8_LOGITS if name.startswith("int8") else LOGITS
    assert rel(runs["whole"][name], runs["jax"][name]) < bound
    for rank in runs["ranks"][n]:
        got = rank[name]
        assert rel(got["y"].numpy(), runs["jax"][name]) < bound, name
        assert got["same"]  # the cached layouts give the first forward's logits
    assert np.abs(runs["jax"][name]).max() > 1e-2


@pytest.mark.parametrize("n", MESHES)
def test_scheme1_resnet18_matches_jax_spatially_sharded(runs, n):
    for rank in runs["ranks"][n]:
        assert rel(rank["resnet18_s1"]["y"].numpy(), runs["jax"]["sp"][n]) < LOGITS


@pytest.mark.parametrize("n", MESHES)
def test_each_rank_runs_the_kernels_on_its_windows(runs, n):
    """One kernel call per site on every rank that holds rows of its output:
    all of them over 2 ranks; over 3, the rank that holds none of ResNet's
    2-row stage 4 skips its 4 sites (its 5 int8 convs)."""
    x = runs["x"]
    for index, rank in enumerate(runs["ranks"][n]):
        for name, (kernel, per) in KERNELS.items():
            calls = rank[name]["calls"]
            assert rank[name]["rows"] == (2, 3, x[name].shape[1] // n, x[name].shape[2])
            if kernel is None:  # V2-V4: chains of convs, no kernel of their own
                assert not any(calls.values()), name
                continue
            want = per - (4 if name == "resnet18_s1" else 5 if name.startswith("int8") else 0) * (
                n == 3 and index == 2)
            assert len(calls[kernel]) == want, (name, index)
            assert sum(len(v) for v in calls.values()) == want, name


@pytest.mark.parametrize("n", MESHES)
def test_only_the_pooled_map_is_gathered(runs, n):
    """A warm forward's collectives: the input's row count, the global mean's
    sums (ResNet) or the pooled map's rows (VGG's 512 x 7, AlexNet's 256 x 6
    columns of the rows a rank may hold); the halos travel point to point."""
    for rank in runs["ranks"][n]:
        for name in FAMILIES:
            got = rank[name]
            assert got["sent"] > 0
            if name in ("vgg_v234", "alexnet_dodecomp"):
                o, c = (7, 512) if name == "vgg_v234" else (6, 256)
                top = -(-o // n)
                assert got["all_gather"] == [1, 2 * c * top * o] and got["all_reduce"] == []
                assert got["gathered"] == 4 * 2 * c * top * o
            else:
                assert got["all_gather"] == [1] and got["all_reduce"] == [2 * 512 + 1]
                assert got["gathered"] == 0


def test_a_window_form_holds_the_rank_rows_once():
    """A window form whose input owns its memory makes it a view of the
    window's copy of its rows (the same values): the rank does not hold its
    rows twice while the kernel runs.  The model's input is left as it is."""
    layer = shared_v1(4, 6, 3, 3, 1, 1, True, 0)
    plan = spatial.SpatialPlan(ModelAxis(0, 1, None, (0,)))
    layer.__dict__["_spatial"] = spatial.SpatialLeaf(plan, "layer")
    given = map_of(2, 4, 9, 7, 1)
    x = given.clone(memory_format=torch.channels_last)
    want = x.clone()
    token = spatial._forward.set(spatial._Forward(plan, (), given.data_ptr()))
    try:
        with torch.no_grad():
            window = spatial._window(layer, x)
            spatial._window(layer, given)
    finally:
        spatial._forward.reset(token)
        del layer.__dict__["_spatial"]
    assert window.shape == (2, 11, 7, 4)  # a zero row above and below
    assert x.untyped_storage().data_ptr() == window.untyped_storage().data_ptr()
    assert torch.equal(x, want) and torch.equal(window[:, 1:10], want.permute(0, 2, 3, 1))
    assert given.is_contiguous(memory_format=torch.channels_last)  # the model's input stays
