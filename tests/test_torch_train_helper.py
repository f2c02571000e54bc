"""The port's TrainHelper against the JAX package's.

* ``ema_update`` on the same trees: within 1e-7.
* ``TrainHelper`` in float32 on TinyNet, the JAX run's initial weights carried
  into the port, both on the same ``Synthetic`` batches: each step's loss,
  the ``summary.csv`` rows and the final parameters (and EMA) within
  ``STEP_TOL`` (1e-5 relative), in three cases, each one JAX run: label
  smoothing + clipping + a cosine schedule; EMA + ``grad_accum=2``; and a
  resume from the JAX run's epoch-0 checkpoint (with its optax state, which
  the test has the JAX helper save) into a port run of epoch 1.  ``sgd``,
  except in the resume case, where the moments are restored: Adam's first
  step is sign-like, so an element with a near-zero gradient takes the sign
  of its rounding.
* What the port refuses still raises ``NotImplementedError``, citing ROADMAP.
* ``train_baseline`` runs on the CPU at a tiny size and writes its checkpoint.
"""

import math
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.classification import train as jtrain  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild_model  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.classification import TrainHelper, ema_update  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.models import build_model  # noqa: E402
from convnet_approximater_tpu_torch.utils import serialize as tser  # noqa: E402
from tests.test_torch_finetune import ATOL, STEP_TOL, rel, summary  # noqa: E402  (TinyNet)

torch.set_num_threads(1)

BASE = dict(batch_size=8, image_size=(16, 16), num_classes=4, epochs=2, max_steps_per_epoch=3,
            max_eval_batches=1, log_interval=1, use_mesh=False)
SGD = dict(opt="sgd", lr=0.05, momentum=0.9, sched=None)
CASES = {
    "smoothing_clip_cosine": dict(SGD, label_smoothing=0.1, clip_grad=1.0, sched="cosine",
                                  warmup_epochs=1),
    "ema_grad_accum": dict(SGD, ema_decay=0.9, grad_accum=2),
    "resume": dict(opt="adamw", lr=1e-3, sched="cosine", ema_decay=0.9, grad_accum=2),
}


def jax_tinynet():
    model = jbuild_model(dict(type="TinyNet", num_classes=4))
    return model, {"params": model.init(jax.random.key(0)), "state": model.init_state()}


def port_model(flat):
    model = build_model(dict(type="TinyNet", num_classes=4))
    missing, unexpected = model.load_state_dict(params_from_jax(flat), strict=False)
    assert not missing and not unexpected
    return model


def run_jax(cfg, save_opt=False):
    """The JAX helper's run: its per-step losses, and the helper; with
    ``save_opt`` each epoch checkpoint also carries the optax state after the
    epoch's last step (the JAX helper saves one only when preempted)."""
    model, variables = jax_tinynet()
    helper = jtrain.TrainHelper(model, variables, cfg)
    losses, last = [], {}
    loop = helper._loop

    def recording_loop(*args):
        args = list(args)
        train_step, saver = args[4], args[8]

        def step(*a):
            out = train_step(*a)
            losses.append(float(out[4]))
            last["opt"] = out[2]
            return out

        if save_opt and saver is not None:
            save = saver.save_checkpoint
            saver.save_checkpoint = lambda v, e, m, opt_state=None: save(
                v, e, m, opt_state=last["opt"])
        args[4] = step
        return loop(*args)

    helper._loop = recording_loop
    return helper, losses


def run_port(model, cfg):
    helper = TrainHelper(model, cfg, device="cpu")
    losses = []
    step = helper.train_step

    def recording(*a, **k):
        out = step(*a, **k)
        losses.append(float(out))
        return out

    helper.train_step = recording
    return helper, helper.train(), losses


def close_losses(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= STEP_TOL * abs(b) + ATOL, (i, a, b)


def close_trees(got: dict, want: dict, prefix="params/"):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert rel(got[k], want[k]) <= STEP_TOL, (k, rel(got[k], want[k]))


def close_summaries(got_path, want_path, epochs):
    got, want = summary(got_path), summary(want_path)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == epochs
    for g, w in zip(got, want):
        for key in ("train_loss", "eval_loss"):
            assert math.isclose(g[key], w[key], rel_tol=STEP_TOL, abs_tol=ATOL), (key, g, w)
        assert g["eval_top1"] == w["eval_top1"] and g["eval_top5"] == w["eval_top5"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_helper_matches_jax(tmp_path, case):
    cfg = dict(BASE, **CASES[case])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, init = jax_tinynet()
    init_flat = {k: np.asarray(v) for k, v in jser.flatten_tree(init).items()}
    jhelper, jlosses = run_jax(dict(cfg, work_dir=jdir), save_opt=(case == "resume"))
    jhelper.train()
    jflat = {k: np.asarray(v) for k, v in jser.flatten_tree(jhelper.variables).items()}
    if case == "resume":
        # the port continues from the JAX run's epoch-0 checkpoint: params, state,
        # ema, the optax state (MultiSteps over adamw on a schedule) and the epoch
        ckpt = os.path.join(jdir, "checkpoint-0.ckpt.npz")
        assert any(k.startswith("opt/") for k in tser.load_flat(ckpt))
        # the resumed run appends to its work dir's summary, as a resume in place does
        os.makedirs(tdir)
        with open(os.path.join(jdir, "summary.csv")) as f:
            head = f.readlines()[:2]
        with open(os.path.join(tdir, "summary.csv"), "w") as f:
            f.writelines(head)
        model = port_model(init_flat)
        thelper, result, tlosses = run_port(model, dict(cfg, work_dir=tdir, resume=ckpt))
        # restored at 1 update and 1 micro-step, then 3 micro-steps: 6 in all (a fresh
        # optimizer would stand at 1 and 1)
        assert thelper.optimizer.count == 3 and thelper.optimizer.mini_step == 0
        close_losses(tlosses, jlosses[3:])
    else:
        model = port_model(init_flat)
        thelper, result, tlosses = run_port(model, dict(cfg, work_dir=tdir))
        close_losses(tlosses, jlosses)
    close_summaries(os.path.join(tdir, "summary.csv"), os.path.join(jdir, "summary.csv"),
                    [0.0, 1.0])
    assert len(tlosses) == len(jlosses) - (3 if case == "resume" else 0)
    tflat = params_to_jax(model.state_dict())
    close_trees(tflat, jflat)
    if cfg.get("ema_decay"):
        jema = {k: np.asarray(v) for k, v in jser.flatten_tree(jhelper._ema).items()}
        close_trees(params_to_jax(result["ema"].state_dict()), jema)
    # the port's last checkpoint loads into the JAX package's tree: params, state, ema, opt
    ckpt = tser.load_flat(os.path.join(tdir, "last.ckpt.npz"))
    assert {k.split("/")[0] for k in ckpt} == (
        {"params", "opt", "meta"} | ({"ema"} if cfg.get("ema_decay") else set()))
    for k, v in tflat.items():
        np.testing.assert_array_equal(ckpt[k], v)


def test_ema_update_matches_jax():
    rs = np.random.RandomState(0)
    _, init = jax_tinynet()
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(init).items()}
    a = {k: rs.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    b = {k: rs.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    ema, new = port_model(a), port_model(b)
    for decay in (0.9, 0.999):
        want = jtrain.ema_update(jser.unflatten_tree(a), jser.unflatten_tree(b), np.float32(decay))
        got = port_model(a)
        ema_update(got, new, decay)
        for k, v in params_to_jax(got.state_dict()).items():
            np.testing.assert_allclose(v, np.asarray(jser.flatten_tree(want)[k]), rtol=0, atol=1e-7)
    # a counter (an integer buffer) is copied, not averaged
    ema.register_buffer("steps", torch.tensor(3))
    new.register_buffer("steps", torch.tensor(7))
    ema_update(ema, new, 0.5)
    assert int(ema.steps) == 7


@pytest.mark.parametrize("cfg,match", [
    (dict(model_parallel=2), "queue 1 item 12"),
    (dict(pipeline_parallel=2), "queue 1 item 12"),
    (dict(ckpt_backend="sharded"), "sharded checkpoint backend"),
])
def test_unported_options_raise(cfg, match):
    model = build_model(dict(type="TinyNet", num_classes=4))
    if cfg.get("pipeline_parallel"):
        # ported (pipelined training across processes); beside model_parallel it is refused,
        # as the two share the mesh's model axis in both packages
        assert TrainHelper(model, cfg, device="cpu").cfg.pipeline_parallel == 2
        with pytest.raises(ValueError, match="model axis"):
            TrainHelper(model, dict(cfg, model_parallel=2), device="cpu")
        return
    if cfg.get("ckpt_backend") == "sharded":
        # ported (utils/sharded_ckpt.py): the helper takes the sharded backend
        assert TrainHelper(model, cfg, device="cpu").cfg.ckpt_backend == "sharded"
        return
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.parallel import MESH_TODO

    # tensor parallelism is ported (parallel/tp.py): the helper takes model_parallel, and
    # refuses it beside pipeline_parallel; spatial sharding serves eval forwards
    # (parallel/spatial.py), and training under it stays refused
    assert TrainHelper(model, cfg, device="cpu").cfg.model_parallel == 2
    with pytest.raises(ValueError, match="model axis"):
        TrainHelper(model, dict(cfg, pipeline_parallel=2), device="cpu")
    assert parallel.is_spatial(parallel.spatial_module(model, None))  # its max pool has a row form
    spatial = parallel.spatial_module(MSCAN_Classifier(
        num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=4), None)
    with pytest.raises(NotImplementedError, match=match) as e:
        TrainHelper(spatial, cfg, device="cpu")
    assert "training under spatial sharding" in str(e.value)
    assert "spatial sharding" in MESH_TODO and "tp.py" not in MESH_TODO


def test_train_baseline_cli_on_cpu(tmp_path):
    from convnet_approximater_tpu_torch import train_baseline

    work = str(tmp_path / "baseline")
    result = train_baseline.main(["--model", "TinyNet", "--num-classes", "4", "--image-size",
                                  "16", "16", "--epochs", "2", "--batch-size", "64",
                                  "--work-dir", work, "--device", "cpu"])
    assert result["best_metric"] is not None
    rows = summary(os.path.join(work, "summary.csv"))
    assert [r["epoch"] for r in rows] == [0.0, 1.0]
    flat = tser.load_flat(os.path.join(work, "model_best.ckpt.npz"))
    assert set(params_to_jax(result["model"].state_dict())) <= set(flat)
    if not torch.cuda.is_available():  # the card is the default; no fallback to the CPU
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_baseline.main(["--work-dir", work])


def test_demo_experiment_cli_on_cpu(tmp_path, capsys):
    from convnet_approximater_tpu_torch import demo_experiment

    rows = demo_experiment.main([
        "--model", "TinyNet", "--num-classes", "4", "--image-size", "16", "16",
        "--num-bases", "2", "2", "--indices", "2", "3", "--samples", "32", "--batch-size", "8",
        "--train-epochs", "1", "--ft-epochs", "1", "--ce-epochs", "1", "--qat-epochs", "1",
        "--int8", "--int8-qat", "--mixup", "--kd", "--platform", "cpu",
        "--work-dir", str(tmp_path / "demo")])
    tags = [r["tag"] for r in rows]
    assert tags == ["original", "original int8 (4 mod)", "original int8 QAT (4 mod)"] + [
        f"{p}_{s}" for p in ("approx", "decomp") for s in ("none", "l2", "l2ce", "ce")]
    assert all(0.0 <= r["top1"] <= 100.0 and r["macs"] > 0 for r in rows)
    # the factored rows cost fewer MACs than the original
    assert all(r["macs"] < rows[0]["macs"] for r in rows[3:])
    out = capsys.readouterr().out
    assert "=== experiment table" in out and " 11 | decomp_ce" in out
    with pytest.raises(SystemExit):  # --platform is an alias of --device, and must agree with it
        demo_experiment.parse_args(["--platform", "cpu", "--device", "cuda"])
    assert demo_experiment.parse_args(["--platform", "gpu"]).device == "cuda"
    assert demo_experiment.parse_args([]).device == "cuda"


def test_preemption_saves_the_full_state_and_resume_restores_it(tmp_path):
    """A SIGTERM notice stops the run at the next step and saves weights, EMA,
    optimizer and the last completed epoch (-1: the resume redoes epoch 0), as
    the JAX helper's preemption save does; a resume restores all of them."""
    _, init = jax_tinynet()
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(init).items()}
    cfg = dict(BASE, **CASES["ema_grad_accum"], work_dir=str(tmp_path / "run"))
    helper = TrainHelper(port_model(flat), cfg, device="cpu")
    step = helper.train_step

    def stopping(*a):
        out = step(*a)
        helper._guard.trigger()  # after the first micro-step: an accumulation, no update
        return out

    helper.train_step = stopping
    result = helper.train()
    assert result["best_metric"] is None and helper.optimizer.count == 0
    ckpt = tser.load_flat(os.path.join(tmp_path, "run", "last.ckpt.npz"))
    assert int(ckpt["meta/epoch"]) == -1 and int(ckpt["opt/count"]) == 0
    assert int(ckpt["opt/mini_step"]) == 1 and any(k.startswith("ema/") for k in ckpt)
    assert np.abs(ckpt["opt/head.weight/acc"]).max() > 0  # the accumulated gradient
    resumed = TrainHelper(port_model(flat), dict(cfg, resume=os.path.join(tmp_path, "run",
                                                                          "last.ckpt.npz"),
                                                 epochs=0), device="cpu")
    resumed.train()
    assert resumed.optimizer.count == 0 and resumed.optimizer.mini_step == 1
    for name, state in helper.optimizer.state.items():
        for k, v in state.items():
            assert torch.equal(resumed.optimizer.state[name][k], v), (name, k)
    for a, b in zip(resumed.model.state_dict().values(), helper.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.ema.state_dict().values(), helper.ema.state_dict().values()):
        assert torch.equal(a, b)


def test_random_seed_and_general_helpers_match_jax(tmp_path):
    import random
    import warnings

    import torch.nn as tnn

    from convnet_approximater_tpu.utils import general as jgeneral
    from convnet_approximater_tpu.utils import random as jrandom
    from convnet_approximater_tpu_torch.utils import general, random as trandom

    draws = []
    for fn in (jrandom.random_seed, trandom.random_seed):
        out = fn(7, rank=2)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    assert isinstance(out, torch.Generator) and out.initial_seed() == 9
    f = tmp_path / "w.npz"
    f.write_bytes(b"")
    for path, ext in ((str(f), None), (str(f), (".npz",)), (str(f), (".pt",)), (str(tmp_path), None),
                      (str(tmp_path / "missing"), None), (None, None)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert general.check_file(path, ext) == jgeneral.check_file(path, ext)
    assert general.parse_path("/a/b/c.ckpt.npz") == jgeneral.parse_path("/a/b/c.ckpt.npz")
    assert general.to_2tuple(3) == jgeneral.to_2tuple(3) == (3, 3)
    assert general.to_2tuple([1, 2]) == (1, 2)

    class Sub(tnn.Module):
        def forward(self, x):
            return x

    assert general.is_method_overridden("forward", tnn.Module, Sub())
    assert not general.is_method_overridden("train", tnn.Module, Sub)
