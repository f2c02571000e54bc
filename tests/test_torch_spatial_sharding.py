"""Spatial sharding of eval forwards in the port (``parallel/spatial.py``):
the image rows over the mesh's ``model`` axis, halo exchanges written out.

On the CPU without ranks, each halo form against the whole map, its ranks
emulated by slicing the map as the exchange assembles it:

* ``msca_fused_ref`` on each rank's window, its border strips remapped by
  ``window_fix``, against the whole map's rows (maps below and above
  ``2 fix_p``, halos taller than a shard), and ``window_fix`` itself against
  ``fix_strip`` on every window of small maps;
* ``parallel_cascade_ref`` on the windows, bit for bit;
* ``FixPaddingBias2d``'s correction sliced to a rank's rows;
* the conv forms (3x3 s2, 4x4 s4, 2x2 s2, depthwise 3x3 and 7x7 and a 21-row
  strip run on the rank's rows with their edges recomputed) against the
  whole conv's rows;
* what stays refused in one process, and ResNet, VGG and AlexNet (their
  pools and flattening heads) against their whole forwards.

Over gloo ranks (``tests/torch_ranks.py::spatial_job``), on a (2 data x 2
model) mesh at 32^2 and an uneven (1 x 3) mesh at 48^2 (stage 4 of MSCAN: 2
rows over 3 ranks, one rank empty): the tiny flagship
(``__graft_entry__._build_flagship(tiny=True)``'s MSCAN, MscaRep d1+fix),
the tiny headline surface (d1+fix, FfnRep on FFNs 1-2, the BN fold, the 1x1
convs as matmuls) and tiny ConvNeXt DwSepRep r1, each against the JAX
package's replicated forward on the same weights, and the flagship against
JAX's spatially sharded forward on its CPU devices
(``tests/test_parallel.py::test_spatial_sharding_matches_replicated``), at
that test's rtol 2e-4 and atol 2e-5.  The weights are the port's, carried to
JAX (its apps in deploy mode build the bare structures): a JAX ``init`` of
the flagship costs most of a minute here.  Each rank's kernel calls per
forward, its collectives (no map is gathered) and the refusals across ranks.
"""

import copy
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu.core import DwSepRep as JDwSepRep  # noqa: E402
from convnet_approximater_tpu.core import FfnRep as JFfnRep  # noqa: E402
from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.deploy import enable_pw_matmul as jenable_pw  # noqa: E402
from convnet_approximater_tpu.deploy import fold_batchnorm as jfold  # noqa: E402
from convnet_approximater_tpu.filters import DepthwiseConvFilter as JDepthwise  # noqa: E402
from convnet_approximater_tpu.filters import IndicesFilter as JIndicesFilter  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from convnet_approximater_tpu.parallel import replicate as jreplicate  # noqa: E402
from convnet_approximater_tpu.parallel import spatial_sharding as jspatial  # noqa: E402
from convnet_approximater_tpu.utils.serialize import tree_get, unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import parallel  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import DwSepRep, FfnRep, MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.deploy import enable_pw_matmul, fold_batchnorm  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.filters import DepthwiseConvFilter, IndicesFilter  # noqa: E402
from convnet_approximater_tpu_torch.layers import FixPaddingBias2d  # noqa: E402
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d  # noqa: E402
from convnet_approximater_tpu_torch.ops.msca_fused import fix_strip, msca_fused_ref  # noqa: E402
from convnet_approximater_tpu_torch.ops.parallel_cascade import parallel_cascade_ref  # noqa: E402
from convnet_approximater_tpu_torch.parallel import MESH_TODO, spatial  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # tests/test_parallel.py::test_spatial_sharding_matches_replicated
KERNEL_RTOL = 1e-5       # msca_fused_ref on a window against the whole map's rows
# __graft_entry__._build_flagship(tiny=True)'s MSCAN
FLAGSHIP = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
                num_classes=16)
MODELS = ("flagship", "headline", "convnext_r1")
# (data, model, NHWC input): (2 x 2) as the JAX test's 4 x 2 batch split; (1 x 3) uneven maps
MESHES = {"2x2": (2, 2, (8, 32, 32, 3)), "1x3": (1, 3, (2, 48, 48, 3))}
BLOCK_MAP = (4, 8, 48, 9)  # NCHW: 24 or 16 rows a rank, each window's edge inside the map


# -- the models: solved in the port, their weights carried to JAX -------------------
def port_models() -> dict:
    """The three tiny surfaces, each solved by the port's apps from random weights."""
    flagship = torch_ranks.randomize(MSCAN_Classifier(**FLAGSHIP), 0)
    dense_flagship = copy.deepcopy(flagship)
    assert apply_app(flagship, MscaRep(decomp=1, fix=True)) == 4
    headline = copy.deepcopy(flagship)
    assert apply_app(headline, FfnRep(fix=True), [IndicesFilter((1, 2))]) == 2
    assert fold_batchnorm(headline) == 5 and enable_pw_matmul(headline) == 18
    convnext = torch_ranks.randomized("convnext", 0)
    dense_convnext = copy.deepcopy(convnext)
    assert apply_app(convnext, DwSepRep(ranks=1), [DepthwiseConvFilter()]) == 10
    return dict(flagship=flagship.eval(), headline=headline.eval(),
                convnext_r1=convnext.eval(), dense=(dense_flagship, dense_convnext))


def jvars_of(model) -> dict:
    v = unflatten_tree({k: jnp.asarray(a) for k, a in params_to_jax(model.state_dict()).items()})
    v.setdefault("state", {})
    return v


def _zeros(key, shape, dtype=jnp.float32, *args, **kwargs):
    return jnp.zeros(shape, dtype)


def jax_structure(jmodel, app, filters, dense) -> None:
    """``app`` (in deploy mode) builds its bare targets in ``jmodel`` from the
    dense port model's weights; their random draws, overwritten at once, are
    skipped."""
    jmodel.register_switchable(app.src_type, filters)
    jv = jvars_of(dense)
    with mock.patch("jax.random.uniform", _zeros), mock.patch("jax.random.normal", _zeros):
        for idx, name in enumerate(jmodel.switchable_names):
            tgt, tparams = app.initialize(jmodel.get_switchable_module(idx),
                                          tree_get(jv["params"], name), jax.random.key(0))
            jmodel.set_switchable_module(idx, tgt, jv, {"params": tparams})


def jax_models(port: dict) -> dict:
    """Each surface's JAX model holding the port's solved weights."""
    dense_flagship, dense_convnext = port["dense"]
    flagship = JClassifier(**FLAGSHIP)
    jax_structure(flagship, JMscaRep(decomp=1, fix=True, deploy=True), [], dense_flagship)
    headline = copy.deepcopy(flagship)
    jax_structure(headline, JFfnRep(fix=True, deploy=True), [JIndicesFilter((1, 2))],
                  port["flagship"])
    assert jfold(headline, jvars_of(port["flagship"])) == 5 and jenable_pw(headline) == 18
    convnext = JConvNeXt(**torch_ranks.TINY_CONVNEXT)
    jax_structure(convnext, JDwSepRep(ranks=1, deploy=True), [JDepthwise()], dense_convnext)
    return {name: (m, jvars_of(port[name]))
            for name, m in (("flagship", flagship), ("headline", headline),
                            ("convnext_r1", convnext))}


def jax_forward(jmodel, jv, x, mesh=None):
    """JAX's eval logits: replicated, or over ``mesh`` with ``x`` spatially sharded."""
    def fwd(params, state, xx):
        return jmodel.apply(params, xx, state=state, training=False)[0]

    params, state, xx = jv["params"], jv["state"], jnp.asarray(x)
    if mesh is not None:
        params, state = jreplicate(params, mesh), jreplicate(state, mesh)
        xx = jax.device_put(xx, jspatial(mesh))  # B over data, H over model
    return np.asarray(jax.jit(fwd)(params, state, xx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spatial")
    port = port_models()
    jmodels = jax_models(port)
    models = {name: port[name] for name in MODELS}
    # one block of each surface on a map tall enough that the windows' edges fall inside it
    blocks = {"d1+fix block": port["flagship"].backbone.layers[0][1][0],
              "headline block (MergedFFN)": port["headline"].backbone.layers[0][1][0],
              "ConvNeXt r1 block": port["convnext_r1"].stages[0][0]}
    maps = np.random.RandomState(8).randn(*BLOCK_MAP).astype(np.float32)
    with torch.no_grad():
        whole_blocks = {name: b(torch.from_numpy(maps).contiguous(
            memory_format=torch.channels_last)).numpy() for name, b in blocks.items()}
    out = {"blocks": whole_blocks}
    for mesh_name, (data, model, shape) in MESHES.items():
        x = np.random.RandomState(7).randn(*shape).astype(np.float32)
        with torch.no_grad():
            whole = {name: m(torch_ranks.nchw(x)).numpy() for name, m in models.items()}
        jmesh = jmake_mesh(data=data, model=model, devices=jax.devices()[:data * model])
        out[mesh_name] = dict(
            x=x, whole=whole,
            jax={name: jax_forward(*jmodels[name], x) for name in MODELS},
            jax_sp=jax_forward(*jmodels["flagship"], x, jmesh),
            ranks=torch_ranks.spawn(torch_ranks.spatial_job, data * model, d / mesh_name,
                                    models=models, x=x, data=data,
                                    blocks={k: copy.deepcopy(b) for k, b in blocks.items()},
                                    maps=maps, extras=mesh_name == "2x2"))
    return out


# -- the halo forms against the whole map (no ranks) -----------------------------
def take(whole: torch.Tensor, ranges) -> list:
    """What the exchange assembles from an NHWC map: each range's rows, zeros
    outside the map."""
    H = whole.shape[1]
    out = []
    for lo, hi in ranges:
        parts = [whole.new_zeros((whole.shape[0], max(0, min(hi, 0) - lo)) + whole.shape[2:]),
                 whole[:, max(lo, 0):min(hi, H)],
                 whole.new_zeros((whole.shape[0], max(0, hi - max(lo, H))) + whole.shape[2:])]
        out.append(torch.cat(parts, dim=1).contiguous())
    return out


def packed_bank(C: int, ks, gen):
    k_max = max(ks)
    w1 = torch.zeros(len(ks), k_max, C)
    w2 = torch.zeros(len(ks), k_max, C)
    for i, k in enumerate(ks):  # the taps centred in k_max
        off = (k_max - k) // 2
        w1[i, off:off + k] = torch.randn(k, C, generator=gen) * 0.3
        w2[i, off:off + k] = torch.randn(k, C, generator=gen) * 0.3
    return dict(w1=w1, b1=torch.randn(len(ks), C, generator=gen),
                w2=w2, b2=torch.randn(len(ks), C, generator=gen))


@pytest.mark.parametrize("H,n", [(5, 2), (15, 2), (19, 3), (33, 5), (56, 2), (14, 2), (7, 2)])
def test_msca_fused_on_windows_matches_the_whole_map(H, n):
    """d1+fix's block (k0 5, one 21-tap cascade, fix_p 10: a halo of 12 rows):
    each rank's window with its strips remapped gives the whole map's rows."""
    gen = torch.Generator().manual_seed(H * 7 + n)
    B, W, C = 2, 9, 8
    kw = dict(packed_bank(C, (21,), gen), w0=torch.randn(5, 5, C, generator=gen) * 0.2,
              b0=torch.randn(C, generator=gen), wm=torch.randn(C, C, generator=gen) * 0.3,
              bm=torch.randn(C, generator=gen), res=torch.randn(2, 10, C, generator=gen),
              ks=(21,), identity=False, fix_p=10)
    x = torch.randn(B, H, W, C, generator=gen)
    whole = msca_fused_ref(x, **kw)
    rows = spatial.Rows(H, tuple(spatial.row_split(H, n)))
    for (lo, hi), need in zip(rows.bounds, spatial._window_needs(rows, 12)):
        if hi <= lo:
            assert need == []
            continue
        (window,) = take(x, need)
        top = need[0][0]
        got = msca_fused_ref(window, **dict(kw, res=spatial.window_fix(kw["res"], H, top,
                                                                       window.shape[1])))
        want = whole[:, lo:hi]
        got = got[:, lo - top:hi - top]
        assert float((got - want).abs().max() / want.abs().max()) < KERNEL_RTOL, (lo, hi)


def test_window_fix_places_the_image_strips_on_every_window():
    gen = torch.Generator().manual_seed(0)
    for p in (1, 3, 10):
        res = torch.randn(2, p, 4, generator=gen)
        for H in range(1, 2 * p + 6):
            image = fix_strip(res, H)
            for top in range(H):
                for n in range(1, H - top + 1):
                    got = fix_strip(spatial.window_fix(res, H, top, n), n)
                    assert torch.equal(got, image[top:top + n]), (p, H, top, n)


@pytest.mark.parametrize("ks,identity", [((7,), False), ((7, 11, 21), True)])
@pytest.mark.parametrize("H,n", [(8, 2), (14, 3), (28, 2), (9, 4)])
def test_parallel_cascade_on_windows_is_bit_equal(ks, identity, H, n):
    gen = torch.Generator().manual_seed(H + n)
    kw = dict(packed_bank(6, ks, gen), ks=ks, identity=identity)
    x = torch.randn(2, H, 5, 6, generator=gen)
    whole = parallel_cascade_ref(x, **kw)
    rows = spatial.Rows(H, tuple(spatial.row_split(H, n)))
    for (lo, hi), need in zip(rows.bounds, spatial._window_needs(rows, max(ks) // 2)):
        if hi > lo:
            (window,) = take(x, need)
            got = parallel_cascade_ref(window, **kw)
            top = need[0][0]
            assert torch.equal(got[:, lo - top:hi - top], whole[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("H", [2, 5, 12, 29])
def test_fix_padding_bias_2d_rows_are_the_correction_s(H):
    fix = FixPaddingBias2d(6, 3)
    fix.init_weights(torch.Generator().manual_seed(H))
    whole = fix.correction(H, 7)
    for lo, hi in spatial.row_split(H, 3):
        with torch.no_grad():
            rows = fix._cached_correction(H, 7, (lo, hi))
        assert torch.equal(rows, whole[lo:hi])
        assert fix._cached_correction(H, 7, (lo, hi)) is rows  # one per rows and weights


CONVS = {
    "3x3 s2": dict(in_channels=4, out_channels=6, kernel_size=3, stride=2, padding=1),
    "4x4 s4": dict(in_channels=3, out_channels=6, kernel_size=4, stride=4),
    "2x2 s2": dict(in_channels=4, out_channels=5, kernel_size=2, stride=2),
    "depthwise 3x3": dict(in_channels=6, out_channels=6, kernel_size=3, padding=1, groups=6),
    "depthwise 7x7": dict(in_channels=4, out_channels=4, kernel_size=7, padding=3, groups=4),
    "strip 21x1": dict(in_channels=4, out_channels=4, kernel_size=(21, 1), padding=(10, 0),
                       groups=4),
}


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("H,n", [(7, 2), (16, 2), (23, 3), (48, 4), (56, 2)])
def test_conv_rows_match_the_whole_conv(conv, H, n):
    """Each rank's output rows from its own rows and the ranges it asks for,
    strided windows straddling a shard's edge and stride-1 shards that
    recompute their edges among them."""
    torch.manual_seed(H + n)
    layer = Conv2d(**CONVS[conv]).eval()
    x = torch.randn(2, layer.in_channels, H, 11).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        whole = layer(x)
        rows = spatial.Rows(H, tuple(spatial.row_split(H, n)))
        out = spatial.conv_split(layer, rows, n)
        needs = spatial._conv_needs(layer, rows, out)
        assert spatial.row_split(whole.shape[2], n) == out
        for r, ((lo, hi), (o0, o1)) in enumerate(zip(rows.bounds, out)):
            got = spatial.conv_rows(layer, x[:, :, lo:hi], take(x.permute(0, 2, 3, 1), needs[r]),
                                    rows, out, r)
            assert got.shape == whole[:, :, o0:o1].shape
            np.testing.assert_allclose(got.numpy(), whole[:, :, o0:o1].numpy(), rtol=1e-5,
                                       atol=1e-6)
    edges = [spatial._edges_only(layer, b, o) for b, o in zip(rows.bounds, out)]
    if conv == "depthwise 3x3" and H >= 16:
        assert all(edges)  # the FFN's dconv: no copy of the rank's whole map


# -- one process ---------------------------------------------------------------
def test_the_layout_and_one_process():
    assert parallel.spatial_sharding(None).spec == ("data", "model")
    assert spatial.row_split(7, 2) == [(0, 4), (4, 7)]
    assert spatial.row_split(2, 3) == [(0, 1), (1, 2), (2, 2)]
    model = torch_ranks.randomized("mscan", 0)
    x = torch_ranks.nchw(np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        spatial.stats.reset()
        got = parallel.spatial_module(model, None)(parallel.shard_spatial(x, None))
    # the head's mean is a sum over H W: the same up to its rounding
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert spatial.stats.sent_bytes == 0
    assert parallel.is_spatial(model)
    parallel.unspatial_module(model)
    assert not parallel.is_spatial(model) and "forward" not in model.__dict__


def test_what_stays_refused_in_one_process():
    from convnet_approximater_tpu_torch.classification import TrainHelper
    from convnet_approximater_tpu_torch.deploy import compile_serving
    from convnet_approximater_tpu_torch.models import VGG, AlexNet, ResNet

    model = parallel.spatial_module(torch_ranks.randomized("mscan", 0), None)
    x = torch.zeros(1, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    with pytest.raises(NotImplementedError, match="training mode or with autograd on"):
        model(x)  # autograd on
    with torch.no_grad(), pytest.raises(NotImplementedError, match="training mode"):
        model.train()(x)
    model.eval()
    with pytest.raises(NotImplementedError, match="compile_serving") as e:
        compile_serving(model, x)
    assert MESH_TODO in str(e.value) and "item 12b" in str(e.value)
    with pytest.raises(NotImplementedError, match="TrainHelper: training"):
        TrainHelper(model, {}, device="cpu")
    # the pools, the flattening heads and the families refused before have row forms now
    for net, hw in ((ResNet(18, 10), 32), (VGG(depth=11, num_classes=10), 32),
                    (AlexNet(num_classes=10), 64)):
        net = torch_ranks.randomize(net, 0)
        xx = torch_ranks.nchw(np.random.RandomState(1).randn(2, hw, hw, 3).astype(np.float32))
        with torch.no_grad():
            want = net(xx)
            got = parallel.spatial_module(net, None)(parallel.shard_spatial(xx, None))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="no row form") as e:
        parallel.spatial_module(torch.nn.Sequential(Conv2d(3, 4, 3), torch.nn.AvgPool2d(2)), None)
    assert MESH_TODO in str(e.value)
    with pytest.raises(ValueError, match="spatially sharded already"):
        parallel.spatial_module(model, None)


# -- over gloo ranks -------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
def test_flagship_matches_jax_replicated_and_spatially_sharded(runs, mesh):
    r = runs[mesh]
    for rank in r["ranks"]:
        got = rank["flagship"]["y"].numpy()
        np.testing.assert_allclose(got, r["jax"]["flagship"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, r["jax_sp"], rtol=RTOL, atol=ATOL)
        assert rank["flagship"]["same"]
    assert np.abs(r["jax"]["flagship"]).max() > 1e-2  # the logits carry the blocks' work


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["headline", "convnext_r1"])
def test_surfaces_match_jax_replicated(runs, mesh, name):
    r = runs[mesh]
    np.testing.assert_allclose(r["whole"][name], r["jax"][name], rtol=RTOL, atol=ATOL)
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank[name]["y"].numpy(), r["jax"][name], rtol=RTOL,
                                   atol=ATOL)
        assert rank[name]["same"]


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_runs_the_kernels_on_its_windows(runs, mesh):
    """One kernel call per MSCA block (per strip bank) on every rank that holds
    rows of its map; the window holds the rank's rows and its halo, clipped
    to the image."""
    data, model, (B, H, _, _) = MESHES[mesh]
    for index, rank in enumerate(runs[mesh]["ranks"]):
        m = index % model
        assert rank["flagship"]["rows"] == (B // data, 3, H // model, H)
        for name, kernel, sizes in (("flagship", "msca_fused", (H // 4, H // 8, H // 16,
                                                                 -(-H // 32))),
                                    ("headline", "msca_fused", (H // 4, H // 8, H // 16,
                                                                -(-H // 32))),
                                    ("convnext_r1", "parallel_cascade",
                                     (H // 4,) * 2 + (H // 8,) * 2 + (H // 16,) * 4
                                     + (H // 32,) * 2)):
            halo = 12 if kernel == "msca_fused" else 3
            want = []
            for size in sizes:
                lo, hi = spatial.row_split(size, model)[m]
                if hi > lo:
                    want.append(min(hi + halo, size) - max(lo - halo, 0))
            got = rank[name][kernel]
            assert got == len(want), (name, index)
            assert [w[0][1] for w in rank[name]["windows"]] == want, (name, index)


@pytest.mark.parametrize("mesh", MESHES)
def test_blocks_match_the_whole_block_at_inner_shard_edges(runs, mesh):
    """A d1+fix block (its MSCA's window of 12 halo rows, the FFN's dconv run
    on the rank's rows with its edges recomputed), the headline surface's
    first block (MergedFFN's conv and FixPaddingBias2d at absolute rows) and
    a ConvNeXt r1 block (the strip bank's window of 3 rows), on 48 rows:
    every window's edge lies inside the map, not at the image's."""
    for rank in runs[mesh]["ranks"]:
        for name, want in runs["blocks"].items():
            np.testing.assert_allclose(rank[f"block/{name}"].numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_no_rank_gathers_a_map(runs):
    """A warm forward's collectives: one all_gather of the input's row count
    and one all_reduce of the head's sums (32 channels) and rows; the halos
    travel point to point."""
    for mesh, (data, model, (B, H, W, C)) in MESHES.items():
        for rank in runs[mesh]["ranks"]:
            for name in MODELS:
                got = rank[name]
                assert got["all_gather"] == [1], (mesh, name)
                assert got["all_reduce"] == [B // data * 32 + 1], (mesh, name)
                assert got["sent"] > 0


def test_what_stays_refused_across_ranks(runs):
    for rank in runs["2x2"]["ranks"]:
        got = rank["refused"]
        assert set(got) == {"training", "autograd", "compile_serving", "pipeline after",
                            "pipeline before", "pools", "no row form", "uneven"}
        for case in ("training", "autograd", "compile_serving", "pipeline after",
                     "pipeline before", "no row form"):
            assert MESH_TODO in got[case], case
        y, want = got["pools"]  # ResNet-18's pools have row forms now: its whole logits
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
        assert "should be divisible by 2, but it is equal to 31" in got["uneven"]
    # JAX refuses the same layout at device_put
    with pytest.raises(ValueError, match="should be divisible by 2, but it is equal to 31"):
        jax.device_put(np.zeros((8, 31, 32, 3), np.float32),
                       jspatial(jmake_mesh(data=4, model=2)))


def test_the_heads_mean_is_plain_outside_a_spatial_forward():
    x = torch.randn(2, 3, 5, 4)
    assert torch.equal(spatial.global_mean(x), x.mean(dim=(2, 3)))
