"""Pipelined training across processes in the port (``parallel/pp.py``'s
``pipeline_blocks_train`` under ``models/stage_exec.py`` and
``TrainHelper(pipeline_parallel=pp)``), on gloo ranks on the CPU
(``tests/torch_ranks.py``), held against the JAX package in this process
(8 CPU devices, ``tests/conftest.py``) and against one process:

* a training step of the tiny MSCAN of ``tests/test_pipeline_parallel.py``
  over 4 pipe ranks at M = 1 and M = 4, and over data 2 x pipe 2 at M = 4
  (each data rank holds whole microbatches) and M = 1 (one microbatch spans
  both data ranks): the loss, every gradient and the new BatchNorm state
  against the JAX step pipelined the same way, within the JAX test's
  tolerances (loss 1e-5; gradients rtol 5e-4, atol 1e-5; state 1e-5, 1e-6);
* ConvNeXt's gradients through a pipelined stage in eval mode, against JAX's;
* ``TrainHelper(pipeline_parallel=4, pipeline_microbatches=1)`` against the
  JAX ``TrainHelper`` (weights rtol 5e-4, atol 5e-5), the ranks' weights
  bit-equal, its npz checkpoint restored in one process equal to the
  gathered weights, and a run resumed from it equal to the uninterrupted run;
* over data 2 x pipe 2: drop path, dropout and Mixup/CutMix at M = 4 against
  one process with the stage engine at axis size 1 and the same M (within
  ``STEP_TOL``), ``grad_accum=2`` (sharded checkpoint) and ``amp`` at M = 1
  against the unpipelined run (``amp`` within ``AMP_TOL``), and a (d, M)
  that neither divides refused;
* ``model_parallel`` with ``pipeline_parallel`` refused; ``model_parallel``
  alone taken, and spatial sharding what stays refused.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu.classification import train as jtrain  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JMSCAN  # noqa: E402
from convnet_approximater_tpu.nn.module import Ctx, _merge_state  # noqa: E402
from convnet_approximater_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.utils import flatten_tree, load_flat  # noqa: E402
from tests.test_torch_finetune import ATOL, STEP_TOL  # noqa: E402

torch.set_num_threads(1)
AMP_TOL = 2e-2  # a bf16 run against its float32 twin (tests/test_torch_amp_training.py)
HELPER = dict(batch_size=16, image_size=(32, 32), num_classes=4, epochs=1, lr=5e-3, sched=None,
              log_interval=100, opt="sgd", momentum=0.0, max_steps_per_epoch=2,
              max_eval_batches=1)  # tests/test_train_helper.py's pipelined run
DRAWS = dict(batch_size=16, image_size=(32, 32), num_classes=16, epochs=1, max_steps_per_epoch=4,
             max_eval_batches=1, log_interval=1, opt="sgd", lr=0.05, momentum=0.9, sched=None,
             label_smoothing=0.1, clip_grad=1.0, ema_decay=0.9, grad_accum=2, seed=0)
MIXED = dict(DRAWS, mixup=0.8, cutmix=1.0, aug=dict(hflip=0.5, crop_pad=2),
             pipeline_parallel=2, pipeline_microbatches=4)
ACCUM = dict(DRAWS, pipeline_parallel=2, pipeline_microbatches=1)
SEED = 5


def weights(kind, path):
    """Random weights from seed 0 for the ``kind`` model (ConvNeXt's layer
    scales 1, or its blocks would hide under any tolerance), saved as a flat
    npz at ``path``; the JAX model and its variables holding them."""
    from convnet_approximater_tpu_torch.models import ConvNeXt, MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights

    spec = {"mscan": torch_ranks.PP_MSCAN, "convnext": torch_ranks.PP_CONVNEXT,
            "helper": torch_ranks.PP_HELPER_MSCAN}[kind]
    model = (ConvNeXt if kind == "convnext" else MSCAN_Classifier)(**spec)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if kind == "convnext" and name.endswith("gamma"):
                t.fill_(1.0)
    flat = params_to_jax(model.state_dict())
    np.savez(path, **flat)
    jmodel = (JConvNeXt if kind == "convnext" else JMSCAN)(**spec)
    return jmodel, jser.unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def jax_step(model, variables, x, labels, mesh, M):
    """The JAX pipelined training step of ``tests/test_pipeline_parallel.py``:
    loss, gradients and new state."""
    model.backbone.enable_pipeline(mesh, num_microbatches=M)

    def loss_fn(params, state):
        ctx = Ctx(training=True, rng=jax.random.key(7), state=state)
        logits = model(params, x, ctx)
        one_hot = jax.nn.one_hot(labels, logits.shape[-1])
        loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * one_hot, axis=-1))
        return loss, _merge_state(state, ctx.state_out)

    try:
        (loss, state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["state"])
    finally:
        model.backbone.enable_pipeline(None)
    return float(loss), jser.flatten_tree({"params": grads}), jser.flatten_tree({"state": state})


def jax_eval_grads(model, params, x, mesh):
    def loss(p):
        y, _, _ = model.apply(p, x, training=False)
        return jnp.sum(y ** 2)

    model.enable_pipeline(mesh, num_microbatches=1)
    try:
        grads = jax.jit(jax.grad(loss))(params)
    finally:
        model.enable_pipeline(None)
    return jser.flatten_tree({"params": grads})


def merged_grads(ranks, key):
    """Every gradient, each from a rank that holds it; the ranks that hold a
    parameter hold the same bits."""
    out = {}
    for r in ranks:
        for name, g in r[key]["grads"].items():
            if name in out:
                assert torch.equal(out[name], g), name
            out[name] = g
    return out


def merged_state(ranks, key):
    out = {}
    for r in ranks:
        out.update(r[key]["state"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp_training")
    x = np.random.RandomState(6).randn(8, 32, 32, 3).astype(np.float32)
    labels = np.arange(8) % 16
    npz = {kind: str(d / f"{kind}.npz") for kind in ("mscan", "convnext", "helper")}
    jmodels = {kind: weights(kind, path) for kind, path in npz.items()}
    jax_out = {}
    devices = jax.devices()
    for label, mesh, M in (("pipe4_m1", jmake_mesh(data=2, model=4), 1),
                           ("pipe4_m4", jmake_mesh(data=2, model=4), 4),
                           ("dp2pp2_m4", jmake_mesh(data=2, model=2, devices=devices[:4]), 4)):
        jax_out[label] = jax_step(*jmodels["mscan"], x, labels, mesh, M)
    # at M = 1 the microbatch is the whole batch on any mesh: one JAX step stands for both
    jax_out["dp2pp2_m1"] = jax_out["pipe4_m1"]
    jax_out["convnext"] = jax_eval_grads(jmodels["convnext"][0], jmodels["convnext"][1]["params"],
                                         x, jmake_mesh(data=2, model=4))
    jhelper = jtrain.TrainHelper(*jmodels["helper"], dict(
        HELPER, pipeline_parallel=4, pipeline_microbatches=1, work_dir=str(d / "jax_helper")))
    jhelper.train()
    one = str(d / "helper_one")
    pipe4 = torch_ranks.spawn(torch_ranks.pipe4_job, 4, d / "pipe4", npz=npz, x=x, labels=labels,
                              helper=dict(cfg=dict(HELPER, pipeline_parallel=4,
                                                   pipeline_microbatches=1), runs=dict(
                                  one=dict(work_dir=one),
                                  two=dict(epochs=2, work_dir=str(d / "helper_two")),
                                  resumed=dict(epochs=2, work_dir=str(d / "helper_resumed"),
                                               resume=os.path.join(one, "checkpoint-0.ckpt.npz")))))
    dp2pp2 = torch_ranks.spawn(torch_ranks.dp2pp2_job, 4, d / "dp2pp2", npz=npz, x=x,
                               labels=labels, runs=dict(
                                   mixed=(SEED, True, dict(MIXED, work_dir=str(d / "mixed"))),
                                   accum=(SEED, False, dict(ACCUM, ckpt_backend="sharded",
                                                            work_dir=str(d / "accum"))),
                                   amp=(SEED, False, dict(ACCUM, amp=True,
                                                          work_dir=str(d / "amp"))),
                                   refused=(SEED, False, dict(ACCUM, pipeline_microbatches=3,
                                                              work_dir=str(d / "refused")))))
    alone = dict(
        mixed=torch_ranks.axis_one_run(torch_ranks.tiny_mscan_drop(SEED),
                                       dict(MIXED, work_dir=str(d / "mixed_one")),
                                       str(d / "store_one")),
        accum=torch_ranks.helper_run(torch_ranks.tiny_mscan(SEED),
                                     dict(ACCUM, work_dir=str(d / "accum_one"))),
        amp=torch_ranks.helper_run(torch_ranks.tiny_mscan(SEED),
                                   dict(ACCUM, amp=True, work_dir=str(d / "amp_one"))))
    return dict(jax=jax_out, jhelper=jhelper, pipe4=pipe4, dp2pp2=dp2pp2, alone=alone, dir=d)


def hold_step(ranks, key, want, stages):
    loss, jgrads, jstate = want
    assert all(r[key]["stages"] == stages for r in ranks)
    np.testing.assert_allclose([r[key]["loss"] for r in ranks], loss, rtol=1e-5)
    grads = params_to_jax(merged_grads(ranks, key))
    assert set(grads) == set(jgrads)
    for k, v in jgrads.items():
        np.testing.assert_allclose(grads[k], np.asarray(v), rtol=5e-4, atol=1e-5, err_msg=k)
    state = params_to_jax(merged_state(ranks, key))
    assert set(state) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world,key,label,stages", [
    ("pipe4", "step1", "pipe4_m1", [2]),
    ("pipe4", "step4", "pipe4_m4", [2]),
    ("dp2pp2", "step4", "dp2pp2_m4", [2, 3]),
    ("dp2pp2", "step1", "dp2pp2_m1", [2, 3]),
])
def test_pipelined_step_matches_jax(runs, world, key, label, stages):
    hold_step(runs[world], key, runs["jax"][label], stages)


def test_eval_mode_gradients_through_a_pipelined_stage_match_jax(runs):
    grads = params_to_jax(merged_grads(runs["pipe4"], "convnext"))
    want = runs["jax"]["convnext"]
    assert set(grads) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(grads[k], np.asarray(v), rtol=5e-4, atol=5e-5, err_msg=k)


def same_on_every_rank(ranks, run, keys=("state",)):
    for key in keys:
        for r in ranks[1:]:
            assert set(r[run][key]) == set(ranks[0][run][key])
            assert all(torch.equal(v, ranks[0][run][key][k]) for k, v in r[run][key].items()), key


def test_train_helper_pipelined_matches_jax_and_resumes(runs):
    ranks, d = runs["pipe4"], runs["dir"]
    assert all(r["one"]["stages"] == [[2]] for r in ranks)  # the engine engaged
    same_on_every_rank(ranks, "one")
    got = params_to_jax(ranks[0]["one"]["state"])
    want = jser.flatten_tree(runs["jhelper"].variables)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=5e-4, atol=5e-5, err_msg=k)
    # the checkpoint written under the pipeline holds the whole model and optimizer
    ckpt = load_flat(os.path.join(str(d / "helper_one"), "last.ckpt.npz"))
    for k, v in got.items():
        assert np.array_equal(ckpt[k], v), k
    params = set(ranks[0]["one"]["params"])
    assert {k.split("/")[1] for k in ckpt if k.startswith("opt/") and k.count("/") == 2} == params
    # resumed from it (loaded before the release), the second epoch as the run that went on
    same_on_every_rank(ranks, "resumed")
    assert ranks[0]["resumed"]["steps"] == ranks[0]["two"]["steps"][2:]
    for k, v in ranks[0]["two"]["state"].items():
        assert torch.equal(ranks[0]["resumed"]["state"][k], v), k


def test_draws_over_data_and_pipe_match_one_process(runs):
    ranks, alone = runs["dp2pp2"], runs["alone"]["mixed"]
    assert all(r["mixed"]["stages"] == [[0, 1, 2, 3]] * 2 for r in ranks)  # model and EMA
    assert alone["stages"] == [[0, 1, 2, 3]] * 2
    same_on_every_rank(ranks, "mixed", ("state", "ema"))
    steps = np.mean([r["mixed"]["steps"] for r in ranks], axis=0)
    np.testing.assert_allclose(steps, alone["steps"], rtol=STEP_TOL, atol=ATOL)
    for key in ("state", "ema"):
        for k, v in alone[key].items():
            np.testing.assert_allclose(ranks[0]["mixed"][key][k].numpy(), v.numpy(),
                                       rtol=STEP_TOL, atol=ATOL, err_msg=f"{key} {k}")


@pytest.mark.parametrize("run,tol", [("accum", STEP_TOL), ("amp", AMP_TOL)])
def test_grad_accum_and_amp_pipelined_match_unpipelined(runs, run, tol):
    ranks, alone = runs["dp2pp2"], runs["alone"][run]
    assert all(r[run]["stages"] == [[0, 1, 2, 3]] * 2 for r in ranks)
    same_on_every_rank(ranks, run, ("state", "ema"))
    steps = np.mean([r[run]["steps"] for r in ranks], axis=0)
    np.testing.assert_allclose(steps, alone["steps"], rtol=tol, atol=ATOL)
    for key in ("state", "ema"):
        for k, v in alone[key].items():
            np.testing.assert_allclose(ranks[0][run][key][k].numpy(), v.numpy(), rtol=tol,
                                       atol=ATOL if tol == STEP_TOL else tol, err_msg=f"{key} {k}")
    if run == "accum":  # each pipe rank wrote its own blocks: restored in one process, whole
        ckpt = load_flat(os.path.join(str(runs["dir"] / "accum"), "last.ckpt.dcp"))
        want = dict(params_to_jax(ranks[0][run]["state"]))
        want.update({f"ema/{k}": v for k, v in params_to_jax(ranks[0][run]["ema"]).items()})
        for k, v in want.items():
            assert np.array_equal(ckpt[k], v), k
        params = set(ranks[0][run]["params"])
        assert {k.split("/")[1] for k in ckpt if k.startswith("opt/") and k.count("/") == 2
                } == params


def test_what_stays_refused(runs):
    from convnet_approximater_tpu_torch.classification import TrainHelper
    from convnet_approximater_tpu_torch.models import build_model

    assert all("one must divide the other" in r["refused"] for r in runs["dp2pp2"])
    model = build_model(dict(type="TinyBNNet", num_classes=4))
    with pytest.raises(ValueError, match="share the mesh's model axis"):
        TrainHelper(model, dict(model_parallel=2, pipeline_parallel=2), device="cpu")
    # tensor parallelism is ported (parallel/tp.py): model_parallel alone constructs
    assert TrainHelper(model, dict(model_parallel=2), device="cpu").cfg.model_parallel == 2
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.parallel import MESH_TODO

    # spatial sharding serves eval forwards (parallel/spatial.py); beside a pipeline, whose
    # ranks hold only their own blocks' weights, it stays refused in either order
    tiny = dict(num_channels=(8, 16), num_blocks=(2, 2), exp_ratios=(2, 2), num_classes=4)
    piped = MSCAN_Classifier(**tiny)
    parallel.release(piped.backbone.layers[1][1][1])  # a block another pipe rank owns
    with pytest.raises(NotImplementedError) as e:
        parallel.spatial_module(piped, None)
    assert MESH_TODO in str(e.value) and "tp.py" not in str(e.value)
    assert "spatial sharding beside a pipeline" in str(e.value)
    spatial = parallel.spatial_module(MSCAN_Classifier(**tiny), None)
    with pytest.raises(NotImplementedError, match="pipeline.*of a spatially sharded model"):
        spatial.backbone.enable_pipeline(object())  # refused before the mesh is read
    with pytest.raises(NotImplementedError, match="TrainHelper: training under spatial"):
        TrainHelper(spatial, dict(pipeline_parallel=2), device="cpu")

