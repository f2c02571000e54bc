"""The pieces of data-parallel training across processes in the port, on 2
gloo ranks on the CPU (``tests/torch_ranks.py``), held to one process and to
the JAX package:

* ``BatchNorm2d`` in training inside ``nn.sharded_batch``: each rank's forward
  and backward on its half of a batch of 16, concatenated (the affine
  gradients summed), equal one process on the whole batch, and the JAX
  ``BatchNorm2d`` in training: outputs, input, weight and bias gradients and
  running statistics within ``BN_TOL`` (1e-6, relative norm).
* The sharded ``Loader`` with augmentation (crop and flip, a random resized
  crop, RandAugment before a crop and flip), through the native prep and
  through numpy, two epochs: the ranks' rows concatenated are the unsharded
  loader's batches bit for bit (the normalised images, the labels, the uint8
  rows), and the uint8 rows are the JAX package's augmentation of the same
  batch, drawn from its seed.
* Mixup and CutMix of the global batch's draw, each rank mixing its rows with
  partners from the gathered batch: bit-equal to one process.
* ``save_sharded`` across the 2 ranks restores in one process bit for bit,
  with every replicated tensor written once (the files hold one copy of the
  bytes); a one-process checkpoint restores on each rank bit for bit.
* What stays refused names the rest of ROADMAP.md item 12b: ``model_parallel``
  (and beside ``pipeline_parallel``, which trains through a pipelined stage: its
  output and gradients within 1e-5 of the plain training step).
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu import nn as jnn  # noqa: E402
from convnet_approximater_tpu.data import Synthetic as JSynthetic  # noqa: E402
from convnet_approximater_tpu.data import loader as jloader  # noqa: E402
from convnet_approximater_tpu.data import randaug as jrandaug  # noqa: E402
from convnet_approximater_tpu_torch import nn as tnn  # noqa: E402
from convnet_approximater_tpu_torch.data.mixup import MixDraw, apply_mix  # noqa: E402
from convnet_approximater_tpu_torch.utils import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.utils.sharded_ckpt import (restore_sharded,  # noqa: E402
                                                               save_sharded)

torch.set_num_threads(1)
WORLD = 2
BN_TOL = 1e-6
REST = ("spatial sharding", "item 12b")
LOADER_CASES = {
    "crop and flip": dict(aug=dict(hflip=0.5, crop_pad=2)),
    "random resized crop": dict(aug=dict(rrc_scale=(0.4, 1.0), hflip=0.5), image_size=(10, 10)),
    "rand_aug, crop and flip": dict(aug=dict(rand_aug=dict(n=2, m=9), hflip=0.5, crop_pad=2)),
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def bn_inputs():
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((16, 5, 4, 6)) * 2 + 1.5).astype(np.float32)  # NHWC, C = 6
    dy = rs.standard_normal(x.shape).astype(np.float32)
    state = {"weight": torch.from_numpy(rs.uniform(0.5, 1.5, 6).astype(np.float32)),
             "bias": torch.from_numpy(rs.uniform(-1, 1, 6).astype(np.float32)),
             "running_mean": torch.from_numpy(rs.uniform(-1, 1, 6).astype(np.float32)),
             "running_var": torch.from_numpy(rs.uniform(0.5, 1.5, 6).astype(np.float32))}
    return dict(x=x, dy=dy, state=state)


def mix_inputs():
    rs = np.random.RandomState(1)
    images = torch_ranks.nchw(rs.standard_normal((16, 9, 7, 3)).astype(np.float32))
    targets = torch.from_numpy(np.eye(5, dtype=np.float32)[rs.randint(0, 5, 16)] * 0.9 + 0.02)
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(2))
    draws = [MixDraw(False, 0.37, perm), MixDraw(True, 0.61, perm, 4, 6),
             MixDraw(True, 0.2, perm.flip(0), 0, 1)]  # a box clipped at the border
    return dict(images=images, targets=targets, draws=draws)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_pieces")
    rs = np.random.RandomState(3)
    tree = {"params": {"w": rs.standard_normal((64, 33)).astype(np.float32),
                       "b": rs.standard_normal(33).astype(np.float32)},
            "opt": {"count": np.int64(7)}, "meta": {"epoch": 2, "metric": 0.25}}
    one = str(d / "one.ckpt.dcp")
    save_sharded(one, tree, wait=True)
    bn, mix = bn_inputs(), mix_inputs()
    # the unsharded batches first: this also builds the native batch prep for the ranks
    alone = {(name, native): torch_ranks.loader_batches(dict(case, native=native))
             for name, case in LOADER_CASES.items() for native in (True, False)}
    trees = dict(tree=tree, one=one, two=str(d / "two.ckpt.dcp"))
    ranks = torch_ranks.spawn(torch_ranks.pieces_job, WORLD, d / "ranks", bn=bn,
                              loader_cases=LOADER_CASES, mix=mix, trees=trees)
    return dict(ranks=ranks, alone=alone, bn=bn, mix=mix, tree=tree, one=one,
                two=trees["two"])


def bn_one_process(bn):
    norm = tnn.BatchNorm2d(6)
    norm.load_state_dict(bn["state"])
    x = torch_ranks.nchw(bn["x"]).requires_grad_()
    y = norm.train()(x)
    (y * torch_ranks.nchw(bn["dy"])).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=norm.weight.grad, db=norm.bias.grad,
                mean=norm.running_mean, var=norm.running_var)


def bn_jax(bn):
    st = {k: v.numpy() for k, v in bn["state"].items()}
    mod = jnn.Sequential(jnn.BatchNorm2d(6))
    state = {"0": {"mean": jnp.asarray(st["running_mean"]), "var": jnp.asarray(st["running_var"])}}

    def f(x, scale, bias):
        y, new_state, _ = mod.apply({"0": {"scale": scale, "bias": bias}}, x, state=state,
                                    training=True)
        return jnp.sum(y * bn["dy"]), (y, new_state)

    (_, (y, new_state)), (dx, dw, db) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(bn["x"]), jnp.asarray(st["weight"]), jnp.asarray(st["bias"]))
    nhwc = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731  (as NCHW)
    return dict(y=nhwc(y), dx=nhwc(dx), dw=np.asarray(dw), db=np.asarray(db),
                mean=np.asarray(new_state["0"]["mean"]), var=np.asarray(new_state["0"]["var"]))


def test_batchnorm_over_the_ranks_is_one_batch_norm(setup):
    ranks = setup["ranks"]
    assert [r["shard"] for r in ranks] == [(0, WORLD), (1, WORLD)]
    got = {k: torch.cat([r["bn"][k] for r in ranks]) for k in ("y", "dx")}
    got.update({k: sum(r["bn"][k] for r in ranks) for k in ("dw", "db")})
    got.update({k: ranks[0]["bn"][k] for k in ("mean", "var")})
    for r in ranks[1:]:  # every rank keeps the same running statistics
        assert all(torch.equal(r["bn"][k], ranks[0]["bn"][k]) for k in ("mean", "var"))
    one, jax_ = bn_one_process(setup["bn"]), bn_jax(setup["bn"])
    for k, v in got.items():
        assert rel(v, one[k]) <= BN_TOL, (k, rel(v, one[k]))
        assert rel(v, jax_[k]) <= BN_TOL, (k, rel(v, jax_[k]))
    # outside sharded_batch, or in eval, the layer is torch's batch norm, bits and all
    norm = tnn.BatchNorm2d(6)
    norm.load_state_dict(setup["bn"]["state"])
    x = torch_ranks.nchw(setup["bn"]["x"])
    with tnn.sharded_batch(None):
        y = norm.train()(x)
    state = setup["bn"]["state"]
    want = torch.nn.functional.batch_norm(x, state["running_mean"].clone(),
                                          state["running_var"].clone(), state["weight"],
                                          state["bias"], True, 0.1, 1e-5)
    assert torch.equal(y, want)


@pytest.mark.parametrize("native", [True, False], ids=["native prep", "numpy"])
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_sharded_loader_with_aug_is_the_unsharded_batch(setup, case, native):
    want = setup["alone"][(case, native)]
    got = [r["loaders"][(case, native)] for r in setup["ranks"]]
    assert len(want) == len(got[0]) == len(got[1]) == 6  # 3 batches of 16, two epochs
    for i, batch in enumerate(want):
        for key in ("x", "y"):
            assert torch.equal(torch.cat([g[i][key] for g in got]), batch[key]), (i, key)
        assert np.array_equal(np.concatenate([g[i]["u8"] for g in got]), batch["u8"]), i
    # the uint8 batches are the JAX package's augmentation, drawn from its seed
    aug, size = LOADER_CASES[case]["aug"], LOADER_CASES[case].get("image_size")
    images = JSynthetic(48, (12, 13, 3), 4, seed=1).images
    for epoch in (0, 1):
        order = np.random.RandomState(3 + epoch).permutation(48)
        for b in range(3):
            idx = order[b * 16:(b + 1) * 16]
            rs = np.random.RandomState((3 * 1000003 + epoch * 9176 + int(idx[0])) % 2 ** 31)
            batch = images[idx]
            if "rand_aug" in aug:
                batch = jrandaug.rand_augment_batch(batch, rs, **aug["rand_aug"])
            rest = {k: v for k, v in aug.items() if k != "rand_aug"}
            ref = jloader.apply_aug(batch, jloader.draw_aug_params(rs, 16, 12, 13, **rest),
                                    size or (12, 13))
            assert np.array_equal(want[3 * epoch + b]["u8"], ref), (epoch, b)


def test_mixup_and_cutmix_across_the_ranks_are_one_process(setup):
    mix = setup["mix"]
    for k, draw in enumerate(mix["draws"]):
        want = apply_mix(draw, mix["images"], mix["targets"])
        for j in range(2):
            got = torch.cat([r["mix"][k][j] for r in setup["ranks"]])
            assert torch.equal(got, want[j]), (k, j)
        assert not torch.equal(want[0], mix["images"])  # the draw mixed something


def test_the_sharded_checkpoint_across_world_sizes(setup):
    tree = setup["tree"]

    def same(got, want=tree):
        flat_got = {k: np.asarray(v) for k, v in flatten_tree(got).items()}
        flat_want = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
        assert set(flat_got) == set(flat_want)
        return all(np.array_equal(flat_got[k], v) and np.asarray(flat_got[k]).dtype == v.dtype
                   for k, v in flat_want.items())

    assert same(restore_sharded(setup["two"]))  # written by 2 ranks, read by one process
    for r in setup["ranks"]:  # written by one process, read by each rank
        assert same(r["restored"])

    def data_bytes(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
                   if f.endswith(".distcp"))

    # each replicated tensor written once: the ranks' files hold one copy of the bytes
    assert data_bytes(setup["two"]) == data_bytes(setup["one"])


def test_what_stays_refused_names_the_rest_of_item_12b(setup):
    from convnet_approximater_tpu_torch.classification import TrainHelper
    from convnet_approximater_tpu_torch.models import build_model

    for r in setup["ranks"]:  # a pipelined stage trains: the plain step's output and gradients
        got = r["pipelined_training"]
        np.testing.assert_allclose(got["y"].numpy(), got["plain"].numpy(), rtol=1e-5, atol=1e-6)
        for name, (g, want) in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.parallel import MESH_TODO

    model = build_model(dict(type="TinyBNNet", num_classes=4))
    # tensor parallelism is ported (parallel/tp.py): the helper takes model_parallel
    assert TrainHelper(model, dict(model_parallel=2), device="cpu").cfg.model_parallel == 2
    with pytest.raises(ValueError, match="share the mesh's model axis"):
        TrainHelper(model, dict(model_parallel=2, pipeline_parallel=2), device="cpu")
    # spatial sharding serves eval forwards (parallel/spatial.py): what stays refused is
    # training under it, on the data axis as anywhere
    spatial = parallel.spatial_module(MSCAN_Classifier(
        num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=4), None)
    with pytest.raises(NotImplementedError) as e:
        TrainHelper(spatial, dict(use_mesh=True), device="cpu")
    msg = str(e.value)
    assert MESH_TODO in msg and "training under spatial sharding" in msg
    assert all(word in msg for word in REST) and msg.count("item 12b") == 1, msg
    assert "tp.py" not in msg and "tensor" not in msg  # tensor parallelism composes with it
    assert "a pipeline beside it" in msg and "compile_serving" in msg  # what stays refused
