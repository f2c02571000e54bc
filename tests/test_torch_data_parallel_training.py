"""Data-parallel training across processes in the port, on 2 gloo ranks on the
CPU (``tests/torch_ranks.py``), global batch 16 (the JAX runs split it over
the 8 CPU devices of ``tests/conftest.py``):

* ``L2Reconstruct`` (asym, L2 + CE, ``use_mesh``) on TinyBNNet, TinyNet with a
  BatchNorm after each conv, 2 ``sgd`` steps from the JAX run's weights after
  Optimize: the weights at world size 2 within ``STEP_TOL`` (1e-5, relative)
  of the JAX hook's over its 8-device mesh (running statistics within
  ``STEP_TOL`` relative and ``ATOL`` absolute), and of the port's world size
  1; each step's global loss, CE and norm (the ranks' mean) within
  ``STEP_TOL`` and ``ATOL`` of both; the ranks' sharded checkpoint, restored
  in one process, is rank 0's weights bit for bit.
* ``TrainHelper`` on a tiny MSCAN with drop path 0.2, dropout 0.1, Mixup 0.8,
  CutMix 1.0, label smoothing, clipping, crop-and-flip augmentation, EMA and
  ``grad_accum=2``, each rank from other random weights (the run replicates
  the first rank's): the weights, EMA and optimizer state of world size 1,
  each element within ``STEP_TOL`` relative and ``ATOL`` absolute (a bias
  before a conv and a BatchNorm has a gradient of rounding noise alone, so
  its values stay near 1e-10), each step's global loss too.  With those draws off, on TinyBNNet:
  the weights and EMA within 1e-5 of the JAX ``TrainHelper`` over its mesh.
* Preemption: a notice on rank 1 alone stops both ranks before the same
  step; rank 0 alone writes the npz checkpoint, which holds its weights.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
import torch_ranks  # noqa: E402
from convnet_approximater_tpu.classification import train as jtrain  # noqa: E402
from convnet_approximater_tpu.hooks import HOOK as JHOOK  # noqa: E402
from convnet_approximater_tpu.models import MODEL as JMODEL  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild_model  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.utils import load_flat  # noqa: E402
from tests.test_torch_finetune import ATOL, STEP_TOL, rel, run_jax  # noqa: E402

torch.set_num_threads(1)
WORLD = 2

if "TinyBNNet" not in JMODEL:

    @JMODEL.register_module()
    class TinyBNNet(JSwitchableModel):
        """The JAX twin of the port's TinyBNNet (``tests/torch_ranks.py``)."""

        def __init__(self, num_classes=4, init_cfg=None):
            super().__init__(init_cfg=init_cfg)
            self.features = jnn.Sequential(
                jnn.Conv2d(3, 8, 3, padding=1), jnn.BatchNorm2d(8), jnn.ReLU(),
                jnn.MaxPool2d(2, 2),
                jnn.Conv2d(8, 12, 3, padding=1), jnn.BatchNorm2d(12), jnn.ReLU(),
                jnn.Conv2d(12, 12, 3, padding=1), jnn.BatchNorm2d(12), jnn.ReLU())
            self.head = jnn.Linear(12, num_classes)

        def __call__(self, params, x, ctx):
            x = self.child("features", params, x, ctx)
            return self.child("head", params, x.mean(axis=(1, 2)), ctx)


L2_CFG = """
model = dict(type="TinyBNNet", num_classes=4)
app = dict(type="LowRankExpV1", max_iter=0, min_lmda=0, max_lmda=0, init_method="svd",
           lmda_length=1, num_bases=(2, 2))
filters = [dict(type="SimpleConvFilter"), dict(type="IndicesFilter", indices=(2, 3))]
hooks = [{first}dict(type="L2Reconstruct", priority=50, asym=True, l2_weight=1.0, cls_weight=0.1,
              dataset_args=dict(batch_size=16), data_config=dict(image_size=(16, 16)),
              optim_args=dict(opt="sgd", lr=0.05, momentum=0.9), sche_args=dict(epochs=1),
              other_args=dict(num_classes=4, max_steps_per_epoch=2, max_eval_batches=1,
                              log_interval=1, use_mesh=True{extra}))]
"""
HELPER = dict(batch_size=16, epochs=1, max_steps_per_epoch=4, max_eval_batches=1, log_interval=1,
              use_mesh=True, opt="sgd", lr=0.05, momentum=0.9, sched=None, label_smoothing=0.1,
              clip_grad=1.0, ema_decay=0.9, grad_accum=2, seed=0)
PLAIN = dict(HELPER, image_size=(16, 16), num_classes=4)
MIXED = dict(HELPER, image_size=(32, 32), num_classes=16, mixup=0.8, cutmix=1.0,
             aug=dict(hflip=0.5, crop_pad=2))
PREEMPT = dict(PLAIN, ema_decay=0.0, grad_accum=1)
MIXED_SEED = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_training")
    # the JAX L2Reconstruct over its 8-device mesh, and its weights after Optimize
    jrunner, jsteps = run_jax(d, L2_CFG.format(
        first='dict(type="SnapshotForPort", priority=10), ', extra=""), "jax_l2")
    weights = str(d / "after_optimize.npz")
    np.savez(weights, **JHOOK.get("SnapshotForPort").flat)
    port_cfg = d / "port_l2.py"
    port_cfg.write_text(L2_CFG.format(first=f'dict(type="LoadFlat", priority=10, path={weights!r}), ',
                                      extra=', ckpt_backend="sharded"'))
    # the JAX TrainHelper on TinyBNNet over its mesh, from the weights the port starts from
    jmodel = jbuild_model(dict(type="TinyBNNet", num_classes=4))
    jvars = {"params": jmodel.init(jax.random.key(0)), "state": jmodel.init_state()}
    init = str(d / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in jser.flatten_tree(jvars).items()})
    jhelper = jtrain.TrainHelper(jmodel, jvars, dict(PLAIN, work_dir=str(d / "jax_helper")))
    jhelper.train()
    ranks = torch_ranks.spawn(
        torch_ranks.training_job, WORLD, d / "ranks",
        l2=dict(cfg=str(port_cfg), work=str(d / "l2_world2")),
        mixed=dict(seed=MIXED_SEED, cfg=dict(MIXED, work_dir=str(d / "mixed_world2"))),
        plain=dict(weights=init, cfg=dict(PLAIN, work_dir=str(d / "plain_world2"))),
        preempt=dict(work=str(d / "preempt"), cfg=PREEMPT))
    one = dict(l2=torch_ranks.l2_run(str(port_cfg), str(d / "l2_world1")),
               mixed=torch_ranks.helper_run(torch_ranks.tiny_mscan_drop(MIXED_SEED),
                                            dict(MIXED, work_dir=str(d / "mixed_world1"))))
    return dict(ranks=ranks, one=one, jax_l2=(jrunner, jsteps), jax_helper=jhelper,
                l2_work=str(d / "l2_world2"))


def global_steps(ranks, key):
    """Each step's mean over the ranks of their rows' values (every rank holds as many rows)."""
    return np.mean([np.asarray(r[key]["steps"], np.float64) for r in ranks], axis=0)


def close(got, want, tol=STEP_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.abs(want) + ATOL), (got, want)


def close_state(got: dict, want: dict):
    """Parameters within STEP_TOL relative, running statistics within STEP_TOL and ATOL."""
    got, want = params_to_jax(got), {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for k in want:
        if k.startswith("params/"):
            assert rel(got[k], want[k]) <= STEP_TOL, (k, rel(got[k], want[k]))
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL, atol=ATOL, err_msg=k)


def test_l2reconstruct_over_two_ranks_matches_one_process_and_jax(runs):
    ranks, one = runs["ranks"], runs["one"]["l2"]
    jrunner, jsteps = runs["jax_l2"]
    for r in ranks[1:]:  # the ranks hold one model
        assert all(torch.equal(v, ranks[0]["l2"]["state"][k]) for k, v in r["l2"]["state"].items())
    steps = global_steps(ranks, "l2")
    assert steps.shape == (2, 3)
    close(steps, jsteps)
    close(steps, one["steps"])
    jflat = jser.flatten_tree(jrunner.variables)
    close_state(ranks[0]["l2"]["state"], jflat)
    close_state(ranks[0]["l2"]["state"], params_to_jax(one["state"]))
    # the ranks' sharded checkpoint, restored in one process: rank 0's trained weights bit
    # for bit (the Runner's PostProcess changes the model after the hook)
    ckpt = load_flat(os.path.join(runs["l2_work"], "last.ckpt.dcp"))
    for k, v in params_to_jax(ranks[0]["l2"]["trained"]).items():
        assert np.array_equal(ckpt[k], v), k
    assert int(ckpt["meta/epoch"]) == 0 and any(k.startswith("opt/") for k in ckpt)


def test_train_helper_with_draws_over_two_ranks_matches_one_process(runs):
    ranks, one = runs["ranks"], runs["one"]["mixed"]
    close(global_steps(ranks, "mixed"), one["steps"])
    for key in ("state", "ema"):
        for r in ranks[1:]:
            assert all(torch.equal(v, ranks[0]["mixed"][key][k])
                       for k, v in r["mixed"][key].items())
        got, want = ranks[0]["mixed"][key], one[key]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=STEP_TOL, atol=ATOL,
                                       err_msg=f"{key} {k}")
    got, want = ranks[0]["mixed"]["opt"], one["opt"]
    assert (got["count"], got["mini_step"]) == (want["count"], want["mini_step"]) == (2, 0)
    for n, leaves in want.items():
        if isinstance(leaves, dict):
            for k, v in leaves.items():
                np.testing.assert_allclose(got[n][k], v, rtol=STEP_TOL, atol=ATOL,
                                           err_msg=f"opt {n} {k}")


def test_train_helper_over_two_ranks_matches_jax(runs):
    got, jhelper = runs["ranks"][0]["plain"], runs["jax_helper"]
    close_state(got["state"], jser.flatten_tree(jhelper.variables))
    close_state(got["ema"], jser.flatten_tree(jhelper._ema))


def test_a_notice_on_one_rank_stops_both(runs):
    first, second = (r["preempt"] for r in runs["ranks"])
    assert len(first["steps"]) == len(second["steps"]) == 2  # the 3rd read raised it on rank 1
    assert first["files"] == ["last.ckpt.npz"] and second["files"] is None  # rank 0 alone
    ckpt = load_flat(os.path.join(str(runs["l2_work"]).replace("l2_world2", "preempt"), "rank0",
                                  "last.ckpt.npz"))
    assert int(ckpt["meta/epoch"]) == -1
    for k, v in params_to_jax(first["state"]).items():
        assert np.array_equal(ckpt[k], v), k
