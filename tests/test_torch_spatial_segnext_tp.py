"""Spatial sharding of SegNeXt and beside tensor parallelism in the port
(``parallel/spatial.py``): the Ham head's resizes, NMF and GroupNorm over
split rows, and models that ``tp.shard_module`` laid out over the same model
axis.

On the CPU without ranks:

* ``resize_rows`` (``resize_bilinear``) on each emulated rank's output rows,
  the source rows clamped at the image's edges (not zero-padded), against
  the whole resize (1e-6) and JAX's ``resize_bilinear``;
* ``nmf2d`` over a map's rows split between threads that sum ``X R^T`` and
  ``R R^T`` over every split (``pixel_sums``), an empty split among them,
  against the whole NMF (1e-4, the NMF tests' bound);
* ``GroupNorm`` from every split's moments (``group_moments``,
  ``group_norm_rows``) against the whole norm (1e-5).

Over gloo ranks (``tests/torch_ranks.py::spatial_families_job``), on (1 x 2)
and (1 x 3) meshes at 48^2 (stage 4: 2 rows, over 3 ranks 1, 1, 0): the tiny
SegNeXt of the JAX tests with MscaRep d1+fix, ``full_res`` off and on,
against the JAX package's replicated forward and its ``spatial_sharding``
forward (1e-4 of the largest logit); the graft's tiny MSCAN d1+fix
(``__graft_entry__._build_flagship(tiny=True)``) under the ``mscan`` preset
over (1 x 2) against the JAX replicated forward and JAX's own composition of
the two (``dryrun_multichip``: the ``mscan`` preset's ``shard_variables`` and
a ``spatial_sharding`` input); the same MSCAN at widths 12/24/36/48 under
the preset over (1 x 3) (the tiny widths do not divide by 3, and JAX's
``device_put`` refuses them too); int8 ResNet-18 under the ``resnet`` preset
over (1 x 2) against the JAX int8 forward (1e-3).  ResNet's widths do not
divide by 3, so it has no (1 x 3) case.  Each rank keeps its shards, its
warm forward gathers no weight, and the tensor-parallel forms come back with
``unspatial_module``.
"""

import copy
import threading
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu import segmentation as jseg  # noqa: E402
from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from convnet_approximater_tpu.parallel import shard_variables as jshard  # noqa: E402
from convnet_approximater_tpu.parallel import spatial_sharding as jspatial  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.models import MSCAN_Classifier, ResNet  # noqa: E402
from convnet_approximater_tpu_torch.nn import GroupNorm  # noqa: E402
from convnet_approximater_tpu_torch.parallel import spatial  # noqa: E402
from convnet_approximater_tpu_torch.segmentation import ham_head  # noqa: E402
from tests.test_torch_segmentation import TINY, jax_draw, tiny_dense, to_jax  # noqa: E402
from tests.test_torch_spatial_families import (INT8_LOGITS, LOGITS, emulated,  # noqa: E402
                                               jax_model, rel)
from tests.test_torch_spatial_sharding import (FLAGSHIP, jax_forward,  # noqa: E402
                                               jax_structure, jvars_of)

torch.set_num_threads(1)
MESHES = (2, 3)
WIDE = dict(FLAGSHIP, num_channels=(12, 24, 36, 48), num_classes=18)  # divisible by 3
# each mesh's cases: (name, kernel, calls per forward on a rank holding rows of every map)
CASES = {2: (("segnext", "msca_fused", 5), ("segnext_full", "msca_fused", 5),
             ("mscan_tp", "msca_fused", 4), ("int8_tp", "qmatmul", 21)),
         3: (("segnext", "msca_fused", 5), ("segnext_full", "msca_fused", 5),
             ("mscan_tp", "msca_fused", 4))}


# -- the Ham head's pieces over split rows (no ranks) ------------------------------
@pytest.mark.parametrize("size,to", [((3, 5), (6, 10)), ((2, 4), (6, 12)), ((6, 6), (48, 48)),
                                     ((5, 4), (13, 11)), ((4, 6), (16, 24))])
@pytest.mark.parametrize("n", MESHES)
def test_resize_rows_clamp_at_the_edges(size, to, n):
    x = torch.randn(2, 3, *size, generator=torch.Generator().manual_seed(sum(to) + n)).contiguous(
        memory_format=torch.channels_last)
    whole = ham_head.resize_bilinear(x, to)
    parts = []
    for r in range(n):
        with emulated(x, r, n) as (_, (lo, hi)), torch.no_grad():
            parts.append(ham_head.resize_bilinear(x[:, :, lo:hi], to))
    assert [t.shape[2] for t in parts] == [hi - lo for lo, hi in spatial.row_split(to[0], n)]
    got = torch.cat(parts, dim=2)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    y_j = np.asarray(jseg.resize_bilinear(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), to))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), y_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("H,n", [(6, 2), (7, 3), (2, 3)])
def test_nmf_over_split_pixels_matches_the_whole(H, n):
    """Each thread holds the pixels of its rows (none: the third of 2 rows
    over 3); the two sums over all pixels are summed over the threads
    before ``eps``, as ``all_reduce`` sums them over the model ranks."""
    B, W, C, rank = 2, 5, 12, 4
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(H + n))
    d0 = torch.from_numpy(jax_draw(C, rank).copy())
    whole = ham_head.nmf2d(x.reshape(B, H * W, C), d0, 3)
    barrier, slots, local = threading.Barrier(n), [None] * n, threading.local()

    def sums(*ts):
        slots[local.rank] = ts
        barrier.wait()
        out = tuple(sum(s[i] for s in slots) for i in range(len(ts)))
        barrier.wait()
        return out

    parts, errors = [None] * n, []

    def run(r, lo, hi):
        local.rank = r
        try:
            parts[r] = ham_head.nmf2d(x[:, lo:hi].reshape(B, (hi - lo) * W, C), d0, 3)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)
            barrier.abort()

    with mock.patch.object(ham_head, "pixel_sums", sums):
        threads = [threading.Thread(target=run, args=(r, lo, hi))
                   for r, (lo, hi) in enumerate(spatial.row_split(H, n))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors
    got = torch.cat(parts, dim=1)
    assert rel(got.numpy(), whole.numpy()) < 1e-4


@pytest.mark.parametrize("H,n", [(6, 2), (7, 3), (2, 3), (13, 2)])
def test_group_norm_from_every_splits_moments(H, n):
    gn = GroupNorm(4, 12)
    with torch.no_grad():
        gn.weight.copy_(torch.linspace(0.5, 1.5, 12))
        gn.bias.copy_(torch.linspace(-1, 1, 12))
    x = (torch.randn(2, 12, H, 5, generator=torch.Generator().manual_seed(H)) * 3 + 1).contiguous(
        memory_format=torch.channels_last)
    whole = gn(x).detach()
    bounds = spatial.row_split(H, n)
    with torch.no_grad():
        moments = torch.stack([spatial.group_moments(x[:, :, lo:hi], 4) for lo, hi in bounds])
        parts = [spatial.group_norm_rows(gn, x[:, :, lo:hi], moments) for lo, hi in bounds]
    assert all(t.is_contiguous(memory_format=torch.channels_last) for t in parts)
    assert rel(torch.cat(parts, dim=2).numpy(), whole.numpy()) < 1e-5


# -- SegNeXt and tensor parallelism over gloo ranks -----------------------------------
def port_cases() -> dict:
    """The port models: tiny SegNeXt d1+fix (its dense source beside it), the
    graft's MSCAN d1+fix and its width-3 twin, int8 ResNet-18."""
    x = np.random.RandomState(0).randn(2, 48, 48, 3).astype(np.float32)
    dense_seg = tiny_dense()
    seg = copy.deepcopy(dense_seg)
    assert apply_app(seg, MscaRep(decomp=1, fix=True)) == 5
    seg_full = copy.deepcopy(seg)
    seg_full.full_res = True
    out = dict(segnext=dict(model=seg, x=x), segnext_full=dict(model=seg_full, x=x))
    dense = dict(segnext=dense_seg)
    for name, spec, seed in (("mscan_tp", FLAGSHIP, 5), ("mscan_tp3", WIDE, 6)):
        m = torch_ranks.randomize(MSCAN_Classifier(**spec), seed)
        dense[name] = copy.deepcopy(m)
        assert apply_app(m, MscaRep(decomp=1, fix=True)) == 4
        out[name] = dict(model=m, x=x, tp="mscan")
    q = torch_ranks.randomize(ResNet(18, 16), 7)
    dense["int8_tp"] = torch_ranks.randomize(ResNet(18, 16), 7)
    deploy.fold_batchnorm(q)
    assert deploy.quantize_int8(q, [torch_ranks.nchw(x)]) == 21
    out["int8_tp"] = dict(model=q, x=x, tp="resnet")
    return out, dense


def jax_cases(port: dict, dense: dict) -> dict:
    """Each case's JAX logits on the port's weights: replicated; SegNeXt
    spatially sharded over each mesh; the graft's MSCAN under the ``mscan``
    preset with a spatially sharded input over (1 x 2)."""
    x = port["segnext"]["x"]
    jseg_model = jseg.SegNeXt(**TINY)
    jax_structure(jseg_model, JMscaRep(decomp=1, fix=True, deploy=True), [], dense["segnext"])
    jv = to_jax(port["segnext"]["model"])
    jv.setdefault("state", {})
    out = {"segnext": jax_forward(jseg_model, jv, x),
           "segnext_sp": {n: jax_forward(jseg_model, jv, x, jmake_mesh(
               data=1, model=n, devices=jax.devices()[:n])) for n in MESHES}}
    jseg_model.full_res = True
    out["segnext_full"] = jax_forward(jseg_model, jv, x)
    for name, spec in (("mscan_tp", FLAGSHIP), ("mscan_tp3", WIDE)):
        jmodel = JClassifier(**spec)
        jax_structure(jmodel, JMscaRep(decomp=1, fix=True, deploy=True), [], dense[name])
        jv = jvars_of(port[name]["model"])
        out[name] = jax_forward(jmodel, jv, x)
        if name == "mscan_tp":  # __graft_entry__.dryrun_multichip's composition
            mesh = jmake_mesh(data=1, model=2, devices=jax.devices()[:2])
            sv = jshard(jv, mesh, 2, tp_rules="mscan")
            xs = jax.device_put(jnp.asarray(x), jspatial(mesh))
            out["mscan_tp_sp"] = np.asarray(jax.jit(lambda p, s, xx: jmodel.apply(
                p, xx, state=s, training=False)[0])(sv["params"], sv["state"], xs))
    jmodel, jv = jax_model("int8_resnet18", port["int8_tp"]["model"], dense["int8_tp"])
    out["int8_tp"] = jax_forward(jmodel, jv, x)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("segnext_tp")
    port, dense = port_cases()
    with torch.no_grad():
        whole = {name: c["model"](torch_ranks.nchw(c["x"])).numpy() for name, c in port.items()}
    jax_ref = jax_cases(port, dense)
    ranks = {}
    for n, cases in CASES.items():
        path = d / f"cases{n}.pt"
        names = [name for name, _, _ in cases]
        torch.save({name: port["mscan_tp3" if (n, name) == (3, "mscan_tp") else name]
                    for name in names}, path)
        ranks[n] = torch_ranks.spawn(torch_ranks.spatial_families_job, n, d / f"1x{n}",
                                     path=str(path))
    return dict(whole=whole, jax=jax_ref, ranks=ranks)


def want_of(runs, n, name):
    return runs["jax"]["mscan_tp3" if (n, name) == (3, "mscan_tp") else name]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", ["segnext", "segnext_full"])
def test_segnext_matches_jax_replicated_and_spatially_sharded(runs, name, n):
    assert rel(runs["whole"][name].transpose(0, 2, 3, 1), runs["jax"][name]) < LOGITS
    for rank in runs["ranks"][n]:
        got = rank[name]["y"].numpy()
        assert got.shape == runs["jax"][name].transpose(0, 3, 1, 2).shape
        assert rel(got.transpose(0, 2, 3, 1), runs["jax"][name]) < LOGITS
        if name == "segnext":
            assert rel(got.transpose(0, 2, 3, 1), runs["jax"]["segnext_sp"][n]) < LOGITS
        assert rank[name]["same"]


@pytest.mark.parametrize("n", MESHES)
def test_tensor_parallel_models_match_jax(runs, n):
    """The spatial forward of a tensor-parallel model runs on its whole
    weights: its logits are the replicated model's, and (over 1 x 2) JAX's
    composition of the ``mscan`` preset and a spatially sharded input."""
    for name, _, _ in CASES[n]:
        if name.startswith("segnext"):
            continue
        bound = INT8_LOGITS if name.startswith("int8") else LOGITS
        want = want_of(runs, n, name)
        for rank in runs["ranks"][n]:
            assert rel(rank[name]["y"].numpy(), want) < bound, name
            assert rel(rank[name]["tp_after"].numpy(), want) < bound, name  # its TP forms again
            assert rank[name]["same"]
            own, sharded = rank[name]["held"]
            assert rank[name]["held_after"] == (own, sharded) and sharded > 0
            if (n, name) == (2, "mscan_tp"):
                assert rel(rank[name]["y"].numpy(), runs["jax"]["mscan_tp_sp"]) < LOGITS


@pytest.mark.parametrize("n", MESHES)
def test_kernels_and_collectives_per_forward(runs, n):
    """A warm forward: one kernel call per site on every rank holding rows of
    its map (over 3 ranks the last holds none of stage 4's 2 rows, so one
    MSCA block and ResNet's stage-4 convs fewer); the input's row count, the
    head's sums (the classifiers) or the Ham head's two GroupNorms' moments
    and its NMF's three sums; no weight is gathered again."""
    B, C, r, G = 2, TINY["ham_channels"], TINY["ham_rank"], TINY["ham_channels"]
    for index, rank in enumerate(runs["ranks"][n]):
        last = n == 3 and index == n - 1
        for name, kernel, per in CASES[n]:
            got = rank[name]
            assert len(got["calls"][kernel]) == per - last, (name, index)
            assert sum(len(v) for v in got["calls"].values()) == per - last
            assert got["sent"] > 0 and got["gathered"] == 0
            if name.startswith("segnext"):
                assert got["all_gather"] == [1, 3 * B * G, 3 * B * G]
                assert got["all_reduce"] == [B * (C * r + r * r)] * TINY["ham_iters"]
            else:
                width = {"mscan_tp": (48 if n == 3 else 32), "int8_tp": 512}[name]
                assert got["all_gather"] == [1] and got["all_reduce"] == [B * width + 1]
