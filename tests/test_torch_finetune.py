"""The port's fine-tuning against the JAX package's.

* ``MaskedOptimizer`` against optax, on given gradients, over adamw/adam/sgd x
  constant/cosine-with-warmup/step x no clip/norm/value/agc, with a freeze
  mask that flips mid-run: parameters within 1e-6 (relative norm per leaf).
* ``L2Reconstruct`` steps run by both packages' Runners from the same weights
  (the JAX variables after Optimize are carried into the port): asym, sym,
  KD-asym, KD-sym and CE-only ``no_norm`` on TinyNet, sym on a two-stage
  narrow MSCAN with MscaRep d1+fix (BatchNorm around the taps, so the sym
  teacher must read the BN state from before the step), and a
  layer-wise ``epoch_behavior``: each step's loss, CE and norm within 1e-5
  relative (plus 1e-6 absolute, the float32 rounding of terms that cancel),
  the parameters after 3 ``sgd`` steps within 1e-5, the per-epoch
  summary's eval loss within 1e-5 and its top-1/top-5 equal.  ``sgd``
  because Adam's first step is sign-like: an element with a near-zero
  gradient takes the sign of its rounding.  Drop rates are 0 in every
  parity run.
* Freeze masks: frozen parameters and old branches bit-equal, under AdamW
  with weight decay.
* ``ValidateHelper`` against JAX's: loss within 1e-5, top-1/top-5 equal.
* Checkpoints: ``params_to_jax``/``params_from_jax`` round trip, a port
  checkpoint loaded by the JAX package and a JAX one by the port.
* Kill and resume through the guard's trigger reproduces an uninterrupted run
  bit for bit on the CPU; the CLI runs tiny L2Reconstruct and ClassEvalHook
  configs; what is not ported raises ``NotImplementedError``.
"""

import logging
import math
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.hooks import HOOK as JHOOK  # noqa: E402
from convnet_approximater_tpu.hooks import Hook as JHook  # noqa: E402
from convnet_approximater_tpu.hooks.finetune import make_optimizer as jmake_optimizer  # noqa: E402
from convnet_approximater_tpu.hooks.finetune import masked_update  # noqa: E402
from convnet_approximater_tpu.runner import Runner as JRunner  # noqa: E402
from convnet_approximater_tpu.utils import config as jcfg  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import nn as tnn  # noqa: E402
from convnet_approximater_tpu_torch.convert import (params_from_jax, params_to_jax,  # noqa: E402
                                                   variables_of)
from convnet_approximater_tpu_torch.hooks import HOOK, Hook  # noqa: E402
from convnet_approximater_tpu_torch.hooks import finetune as ft  # noqa: E402
from convnet_approximater_tpu_torch.models import MODEL, SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.runner import Runner  # noqa: E402
from convnet_approximater_tpu_torch.utils import config as tcfg  # noqa: E402
from convnet_approximater_tpu_torch.utils import serialize as tser  # noqa: E402
from convnet_approximater_tpu_torch.utils.preempt import PreemptionGuard  # noqa: E402
from tests.test_finetune import TINY_MODEL  # noqa: E402  (registers the JAX TinyNet)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TOL = 1e-6
STEP_TOL = 1e-5
# bf16 eval (amp) against the JAX helper's: both round to bf16, at other places (layer by layer)
AMP_TOL = 2e-2
# about 8 float32 ulps of 1: the rounding left by O(1) terms that cancel, as
# in a BN running mean of normalised inputs, or a KL of near-equal softmaxes
# (the KD loss of TinyNet, 7e-4, comes out 6e-8 apart)
ATOL = 1e-6

if "TinyNet" not in MODEL:

    @MODEL.register_module()
    class TinyNet(SwitchableModel):
        """The port's twin of the JAX test's TinyNet (tests/test_finetune.py)."""

        def __init__(self, num_classes=4, init_cfg=None):
            super().__init__(init_cfg=init_cfg)
            self.features = torch.nn.Sequential(
                tnn.Conv2d(3, 8, 3, padding=1),
                tnn.ReLU(),
                tnn.MaxPool2d(2, 2),
                tnn.Conv2d(8, 12, 3, padding=1),
                tnn.ReLU(),
                tnn.Conv2d(12, 12, 3, padding=1),
                tnn.ReLU(),
            )
            self.head = tnn.Linear(12, num_classes)

        def forward(self, x):
            return self.head(self.features(x).mean(dim=(2, 3)))


if "SnapshotForPort" not in JHOOK:

    @JHOOK.register_module()
    class SnapshotForPort(JHook):
        """Keeps the JAX runner's variables as they stand before fine-tuning."""

        flat = {}

        def after_optimize(self):
            SnapshotForPort.flat = {k: np.asarray(v).copy() for k, v in
                                    jser.flatten_tree(self.runner.variables).items()}


if "LoadFromJax" not in HOOK:

    @HOOK.register_module()
    class LoadFromJax(Hook):
        """Loads those variables into the port's model before fine-tuning."""

        def after_optimize(self):
            state = params_from_jax(JHOOK.get("SnapshotForPort").flat)
            missing, unexpected = self.runner.model.load_state_dict(state, strict=False)
            assert not missing and not unexpected, (missing, unexpected)


# a two-stage narrow MSCAN with MscaRep d1+fix on both blocks
MSCAN_MODEL = """
model = dict(type="MSCAN_Classifier", num_channels=(8, 16), num_blocks=(1, 1),
             exp_ratios=(2, 2), num_classes=4, drop_rate=0.0, drop_path_rate={dpr})
app = dict(type="MscaRep", decomp=1, fix=True)
filters = []
"""

FT = """
hooks = [{snap}dict(type="L2Reconstruct", priority=50, {body}
              dataset_args=dict(batch_size=8), data_config=dict(image_size=({px}, {px})),
              optim_args=dict({optim}), sche_args=dict(epochs={epochs}),
              other_args=dict(num_classes=4, max_steps_per_epoch={steps}, max_eval_batches=1,
                              log_interval=1, use_mesh=False{extra}))]
"""

SGD = 'opt="sgd", lr=0.05, momentum=0.9'
JAX_SNAP = 'dict(type="SnapshotForPort", priority=10), '
PORT_LOAD = 'dict(type="LoadFromJax", priority=10), '


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def recording(fn, log, pick):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append([float(v) for v in pick(out)])
        return out
    return wrapped


def run_jax(tmp_path, text, name="jax"):
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    jcfg.init_cfg(str(path))
    jcfg.update_cfg(work_dir=str(tmp_path / name), config_name=name, seed=0)
    runner = JRunner()
    hook = next(h for h in runner.hooks if h.name == "L2Reconstruct")
    steps = []
    make = hook._make_train_step
    hook._make_train_step = lambda tx: recording(make(tx), steps, lambda o: o[3:6])
    runner.run()
    return runner, steps


def run_port(tmp_path, text, name="port"):
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    tcfg.init_cfg(str(path))
    tcfg.update_cfg(work_dir=str(tmp_path / name), config_name=name, seed=0)
    runner = Runner(device="cpu")
    hook = next(h for h in runner.hooks if h.name == "L2Reconstruct")
    steps = []
    hook.train_step = recording(hook.train_step, steps, lambda o: o)
    runner.run()
    return runner, steps


def summary(path):
    lines = open(path).read().strip().split("\n")
    header = lines[0].split(",")
    return [dict(zip(header, map(float, line.split(",")))) for line in lines[1:]]


def run_both(tmp_path, model_text, body, optim=SGD, epochs=1, steps=3, px=16, extra="",
             extra_hooks=""):
    kw = dict(body=body, optim=optim, epochs=epochs, steps=steps, px=px, extra=extra)
    jrunner, jsteps = run_jax(tmp_path, model_text + FT.format(snap=JAX_SNAP + extra_hooks, **kw))
    trunner, tsteps = run_port(tmp_path,
                               model_text + FT.format(snap=PORT_LOAD + extra_hooks, **kw))
    assert len(tsteps) == len(jsteps) == epochs * steps
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        for what, a, b in zip(("loss", "ce", "norm"), t, j):
            assert abs(a - b) <= STEP_TOL * abs(b) + ATOL, (i, what, a, b)
    jflat = {k: np.asarray(v) for k, v in jser.flatten_tree(jrunner.variables).items()}
    tflat = params_to_jax(trunner.model.state_dict())
    assert set(tflat) == set(jflat)
    for k in jflat:
        if k.startswith("params/"):
            assert rel(tflat[k], jflat[k]) <= STEP_TOL, (k, rel(tflat[k], jflat[k]))
        else:  # BN running stats: a mean of normalised inputs is float32 noise around 0
            np.testing.assert_allclose(tflat[k], jflat[k], rtol=STEP_TOL, atol=ATOL,
                                       err_msg=k)
    js, ts = summary(tmp_path / "jax" / "summary.csv"), summary(tmp_path / "port" / "summary.csv")
    assert len(ts) == len(js) == epochs
    for a, b in zip(ts, js):
        assert set(a) == set(b)
        assert math.isclose(a["eval_loss"], b["eval_loss"], rel_tol=STEP_TOL)
        assert (a["eval_top1"], a["eval_top5"]) == (b["eval_top1"], b["eval_top5"])
    return jrunner, trunner


# -- the optimizer against optax ------------------------------------------
class Params(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2d(3, 4, 3)
        self.norm = tnn.BatchNorm2d(4)
        self.fc = tnn.Linear(4, 5)


SCHED = {"constant": dict(sched=None, epochs=3),
         "cosine": dict(sched="cosine", epochs=3, warmup_epochs=1, min_lr=1e-4),
         "step": dict(sched="step", epochs=3, decay_rate=0.5)}
CLIP = {"none": dict(), "norm": dict(clip_grad=0.5, clip_mode="norm"),
        "value": dict(clip_grad=0.3, clip_mode="value"),
        "agc": dict(clip_grad=0.05, clip_mode="agc")}
OPT = {"adamw": dict(opt="adamw", lr=1e-2, weight_decay=0.1, eps=1e-8),
       "adam": dict(opt="adam", lr=1e-2, weight_decay=0.1, eps=1e-8),
       "sgd": dict(opt="sgd", lr=0.1, momentum=0.9, weight_decay=0.1)}


@pytest.mark.parametrize("clip", sorted(CLIP))
@pytest.mark.parametrize("sched", sorted(SCHED))
@pytest.mark.parametrize("opt", sorted(OPT))
def test_optimizer_matches_optax(opt, sched, clip):
    module = Params()
    tnn.init_weights(module, torch.Generator().manual_seed(0))
    optim_args = ft._combine(ft._default_optim_args, dict(OPT[opt], **CLIP[clip]))
    sche_args = ft._combine(ft._default_sche_args, SCHED[sched])
    jparams = jser.unflatten_tree({k: jnp.asarray(v) for k, v in
                                   params_to_jax(module.state_dict()).items()})["params"]
    tx, _ = jmake_optimizer(jcfg.Config(dict(optim_args)), jcfg.Config(dict(sche_args)), 2)
    opt_state = tx.init(jparams)
    topt, _ = ft.make_optimizer(module.named_parameters(), optim_args, sche_args, 2)
    masks = [{"conv.weight", "conv.bias", "norm.weight"}] * 3 + [{"fc.weight", "fc.bias",
                                                                  "norm.bias"}] * 2
    rs = np.random.RandomState(1)
    for mask in masks:
        grads = {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
                 for n, p in module.named_parameters()}
        jgrads = jser.unflatten_tree({k: jnp.asarray(v) for k, v in
                                      params_to_jax(grads).items()})["params"]
        jmask = jser.unflatten_tree({k: jnp.float32(n in mask) for k, n in zip(
            params_to_jax(grads), grads)})["params"]
        jparams, opt_state = masked_update(tx, jgrads, opt_state, jparams, jmask)
        for n, p in module.named_parameters():
            p.grad = grads[n].clone()
        topt.step(mask)
    assert topt.count == 5
    want = {k: np.asarray(v) for k, v in jser.flatten_tree({"params": jparams}).items()}
    got = params_to_jax({n: p for n, p in module.named_parameters()})
    for k in want:
        assert rel(got[k], want[k]) <= OPT_TOL, (k, rel(got[k], want[k]))


def test_lr_schedules_match_optax():
    for sched in SCHED.values():
        optim_args = ft._combine(ft._default_optim_args, dict(lr=0.2))
        sche_args = ft._combine(ft._default_sche_args, sched)
        _, jlr = jmake_optimizer(jcfg.Config(dict(optim_args)), jcfg.Config(dict(sche_args)), 4)
        tlr = ft.lr_schedule(optim_args, sche_args, 4)
        for count in range(14):
            want = float(jlr(count)) if callable(jlr) else float(jlr)
            assert abs(tlr(count) - want) <= 1e-6 * max(abs(want), 1e-6), (sched, count)
    # a warmup makes the first update's rate 0
    cos = ft.lr_schedule(ft._combine(ft._default_optim_args, {}),
                         ft._combine(ft._default_sche_args, SCHED["cosine"]), 4)
    assert cos(0) == 0.0


def test_opt_state_round_trip_and_mismatch(tmp_path):
    module = Params()
    opt, _ = ft.make_optimizer(module.named_parameters(), ft._combine(ft._default_optim_args, {}),
                               ft._combine(ft._default_sche_args, {}), 2)
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    opt.step({n for n, _ in module.named_parameters()})
    saver = ft.CheckpointSaver(str(tmp_path / "sv"), max_history=1)
    saver.save_checkpoint(variables_of(module), epoch=3, metric=0.5, opt_state=opt)
    saver.save_checkpoint(variables_of(module), epoch=4, metric=0.25, opt_state=opt)
    assert sorted(os.listdir(tmp_path / "sv")) == ["checkpoint-3.ckpt.npz", "last.ckpt.npz",
                                                   "model_best.ckpt.npz"]
    ckpt = tser.load_ckpt(str(tmp_path / "sv" / "last.ckpt.npz"))
    assert int(ckpt["meta"]["epoch"]) == 4
    best = tser.load_ckpt(str(tmp_path / "sv" / "model_best.ckpt.npz"))
    assert int(best["meta"]["epoch"]) == 3
    fresh, _ = ft.make_optimizer(module.named_parameters(),
                                 ft._combine(ft._default_optim_args, {}),
                                 ft._combine(ft._default_sche_args, {}), 2)
    assert ft.opt_state_from_tree(ckpt["opt"], fresh) is fresh and fresh.count == 1
    for name, state in opt.state.items():
        for k, v in state.items():
            assert torch.equal(fresh.state[name][k], v)
    sgd, _ = ft.make_optimizer(module.named_parameters(),
                               ft._combine(ft._default_optim_args, dict(opt="sgd")),
                               ft._combine(ft._default_sche_args, {}), 2)
    assert ft.opt_state_from_tree(ckpt["opt"], sgd) is None and sgd.count == 0


# -- L2Reconstruct steps against the JAX hook ------------------------------
STEP_CASES = {
    "asym": "asym=True, l2_weight=1.0, cls_weight=0.1,",
    "sym": "asym=False, l2_weight=1.0, cls_weight=0.1,",
    "kd_asym": "asym=True, l2_weight=0.5, cls_weight=0.0, kd_weight=1.0, kd_temperature=2.0,",
    "kd_sym": "asym=False, no_norm=True, l2_weight=0.0, cls_weight=0.0, kd_weight=1.0, "
              "kd_temperature=2.0,",
    "ce_no_norm": "asym=True, no_norm=True, l2_weight=0.0, cls_weight=1.0,",
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_l2reconstruct_steps_match_jax_tinynet(tmp_path, case):
    jrunner, trunner = run_both(tmp_path, TINY_MODEL, STEP_CASES[case])
    hook = next(h for h in trunner.hooks if h.name == "L2Reconstruct")
    assert (hook.teacher is None) == (case in ("sym", "kd_sym", "ce_no_norm"))
    assert not trunner.model.training


def test_l2reconstruct_sym_steps_match_jax_mscan(tmp_path):
    """BatchNorm around the MSCA taps: the sym teacher pass must read the BN
    state from before the student's training forward updates it.  (The asym
    MSCAN path runs in the kill-and-resume and CLI tests below; the JAX
    package's asym teacher rebuild takes half a minute on the CPU.)"""
    run_both(tmp_path, MSCAN_MODEL.format(dpr=0.0), "asym=False, l2_weight=1.0, cls_weight=0.1,",
             px=32)


def test_epoch_behavior_matches_jax_and_freezes(tmp_path):
    """Layer-wise sym schedule [0, 1]: parity with JAX's, and in the port each
    epoch moves only the new branch of its layer."""
    snaps = []
    orig = ft.L2Reconstruct._train_one_epoch

    def snapshot(self, *args, **kwargs):
        before = {n: p.detach().clone() for n, p in self.runner.model.named_parameters()}
        out = orig(self, *args, **kwargs)
        snaps.append((before, {n: p.detach().clone()
                               for n, p in self.runner.model.named_parameters()}))
        return out

    ft.L2Reconstruct._train_one_epoch = snapshot
    try:
        run_both(tmp_path, TINY_MODEL, "asym=False, l2_weight=1.0, cls_weight=0.1, "
                 "epoch_behavior=[0, 1],", epochs=2, steps=2)
    finally:
        ft.L2Reconstruct._train_one_epoch = orig
    for layer, (before, after) in zip(("features.3", "features.5"), snaps):
        for n in before:
            moved = not torch.equal(before[n], after[n])
            assert moved == n.startswith(f"{layer}.new."), (layer, n)


def test_frozen_and_old_branches_stay_bit_equal_under_adamw(tmp_path):
    """AdamW's decoupled decay moves every parameter it steps: frozen ones
    and the sym teacher's old branches must be restored bit for bit."""
    text = TINY_MODEL + FT.format(
        snap="", body="asym=False, l2_weight=1.0, cls_weight=0.1, epoch_behavior=[1, -2, 0],",
        optim='opt="adamw", lr=1e-2, weight_decay=0.5', epochs=3, steps=2, px=16, extra="")
    snaps = []
    orig = ft.L2Reconstruct._train_one_epoch

    def snapshot(self, *args, **kwargs):
        before = {n: p.detach().clone() for n, p in self.runner.model.named_parameters()}
        out = orig(self, *args, **kwargs)
        snaps.append((before, {n: p.detach().clone()
                               for n, p in self.runner.model.named_parameters()}))
        return out

    ft.L2Reconstruct._train_one_epoch = snapshot
    try:
        run_port(tmp_path, text)
    finally:
        ft.L2Reconstruct._train_one_epoch = orig
    trained = ["features.5.new.", "", "features.3.new."]
    for prefix, (before, after) in zip(trained, snaps):
        for n, v in before.items():
            frozen = ".old." in n or not n.startswith(prefix)
            assert torch.equal(v, after[n]) == frozen, (prefix, n)


# -- checkpoints across the packages ---------------------------------------
def test_params_to_jax_round_trip_and_checkpoints_cross_load(tmp_path):
    from convnet_approximater_tpu.models import build_model as jbuild
    from convnet_approximater_tpu_torch.hooks.checkpoint import load_model_ckpt, save_model_ckpt
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier

    model = MSCAN_Classifier(num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2),
                             num_classes=4)
    tnn.init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = params_from_jax(params_to_jax(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)

    # a port checkpoint into the JAX package
    path = str(tmp_path / "port.ckpt.npz")
    save_model_ckpt(model, path)
    jmodel = jbuild(dict(type="MSCAN_Classifier", num_channels=(8, 16), num_blocks=(1, 1),
                         exp_ratios=(2, 2), num_classes=4))
    jvars = {"params": jmodel.init(jax.random.key(0)), "state": jmodel.init_state()}
    jvars = jser.load_into(jvars, jser.load_ckpt(path), strict=True)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    y_j = np.asarray(jmodel.apply(jvars["params"], jnp.asarray(x), state=jvars["state"])[0])
    with torch.no_grad():
        y_t = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert rel(y_t, y_j) < 1e-4

    # a JAX checkpoint into the port
    jpath = str(tmp_path / "jax.ckpt.npz")
    jser.save_model(jvars, jpath)
    other = MSCAN_Classifier(num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2),
                             num_classes=4)
    load_model_ckpt(other, jpath)
    assert all(torch.equal(other.state_dict()[k], sd[k]) for k in sd)


def test_ckpt_hook_saves_and_loads(tmp_path):
    from convnet_approximater_tpu_torch.hooks import CkptHook

    ckpt = tmp_path / "after_init.ckpt.npz"
    text = TINY_MODEL + f"""
hooks = [dict(type="CkptHook", priority=10, ckpt_cfg=dict(
    after_initialize=dict(action="save", path={str(ckpt)!r})))]
"""
    first = run_port_plain(tmp_path, text, "save")
    saved = tser.load_flat(str(ckpt))
    assert "params/features/3/new/d_conv/weight" in saved
    text = TINY_MODEL + f"""
hooks = [dict(type="CkptHook", priority=10, ckpt_cfg=dict(
    after_initialize=dict(action="load", path={str(ckpt)!r})))]
"""
    tcfg.init_cfg(str(write(tmp_path, "load", text)))
    tcfg.update_cfg(work_dir=str(tmp_path / "load"), seed=7)  # other random weights
    runner = Runner(device="cpu")
    runner.run()
    want, got = first.model.state_dict(), runner.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CkptHook(runner, 10, dict(after_run=dict(action="load", path=str(tmp_path / "no"))))


def config(name):
    return os.path.join(REPO, "configs", name)


def write(tmp_path, name, text):
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    return path


def run_port_plain(tmp_path, text, name):
    tcfg.init_cfg(str(write(tmp_path, name, text)))
    tcfg.update_cfg(work_dir=str(tmp_path / name), config_name=name, seed=0)
    runner = Runner(device="cpu")
    runner.run()
    return runner


def test_resume_from_a_jax_checkpoint_restores_the_optimizer(tmp_path):
    """A JAX hook's checkpoint carries its optax state (Adam's count, ``mu`` and
    ``nu`` over the parameters in the JAX tree's sorted order): the resumed
    port run starts from the JAX weights, count, ``mu`` and ``nu`` bit for bit."""
    body = "asym=True, l2_weight=1.0, cls_weight=0.1,"
    kw = dict(body=body, optim='opt="adamw", lr=1e-3', epochs=1, steps=2, px=16, extra="")
    run_jax(tmp_path, TINY_MODEL + FT.format(snap="", **kw))
    ckpt = str(tmp_path / "jax" / "last.ckpt.npz")
    loaded = {}
    orig = ft.L2Reconstruct._train_one_epoch

    def capture(self, *args, **kwargs):
        if not loaded:
            loaded.update(params_to_jax(self.runner.model.state_dict()))
            loaded["count"] = self.optimizer.count
            loaded["opt"] = {n: {k: v.clone() for k, v in st.items()}
                             for n, st in self.optimizer.state.items()}
        return orig(self, *args, **kwargs)

    ft.L2Reconstruct._train_one_epoch = capture
    try:
        run_port(tmp_path, TINY_MODEL + FT.format(
            snap="", **dict(kw, epochs=2, extra=f", resume={ckpt!r}")))
    finally:
        ft.L2Reconstruct._train_one_epoch = orig
    jflat = tser.load_flat(ckpt)
    for k in [k for k in jflat if k.split("/")[0] in ("params", "state")]:
        assert np.array_equal(loaded[k], jflat[k]), k
    # optax.adamw's state: (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())
    jparams = sorted((k for k in jflat if k.startswith("params/")),
                     key=lambda k: tuple(k.split("/")))
    n = len(jparams)
    assert sorted(k for k in jflat if k.startswith("opt/")) == [f"opt/{i:05d}"
                                                               for i in range(1 + 2 * n)]
    assert loaded["count"] == int(jflat["opt/00000"]) == 2
    names = {next(iter(params_to_jax({name: v["mu"]}))): name for name, v in loaded["opt"].items()}
    assert set(names) == set(jparams)
    moved = set()
    for i, key in enumerate(jparams):
        for moment, leaf in (("mu", 1 + i), ("nu", 1 + n + i)):
            got = params_to_jax({names[key]: loaded["opt"][names[key]][moment]})[key]
            want = jflat[f"opt/{leaf:05d}"]
            assert np.array_equal(got, want), (key, moment)
            if np.any(want != 0):
                moved.add(key)
    # the two steps moved the moments of the trained (new-branch) parameters
    assert moved and all("/new/" in k for k in moved), moved


class TriggerAt(PreemptionGuard):
    """A guard whose notice arrives, through :meth:`trigger`, when the train
    loop reads it for the ``at``-th time."""

    at = None

    def __init__(self):
        super().__init__()
        self.reads = 0

    @property
    def triggered(self):
        self.reads += 1
        if self.reads == self.at:
            self.trigger()
        return super().triggered


def test_kill_and_resume_reproduces_the_run_bit_for_bit(tmp_path, monkeypatch):
    """MSCAN with drop path 0.2 and AdamW, 3 epochs of 2 steps: a notice before
    the first step of epoch 2 saves the state after epoch 1, and the resumed
    run (the same drop masks, from the step count) ends on exactly the
    uninterrupted run's weights."""
    model = MSCAN_MODEL.format(dpr=0.2)
    body = "asym=True, l2_weight=1.0, cls_weight=0.1,"
    kw = dict(body=body, optim='opt="adamw", lr=1e-2, weight_decay=0.05', epochs=3, steps=2,
              px=32)

    def text(extra=""):
        return model + FT.format(snap="", extra=extra, **kw)

    full, _ = run_port(tmp_path, text(), "full")
    monkeypatch.setattr(TriggerAt, "at", 5)
    monkeypatch.setattr(ft, "PreemptionGuard", TriggerAt)
    killed, _ = run_port(tmp_path, text(), "killed")
    hook = next(h for h in killed.hooks if h.name == "L2Reconstruct")
    assert hook.result["preempted"] is True
    ckpt = str(tmp_path / "killed" / "last.ckpt.npz")
    assert int(tser.load_ckpt(ckpt)["meta"]["epoch"]) == 1
    monkeypatch.setattr(ft, "PreemptionGuard", PreemptionGuard)
    resumed, _ = run_port(tmp_path, text(f", resume={ckpt!r}"), "resumed")
    want, got = full.model.state_dict(), resumed.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    cut = killed.model.state_dict()
    assert any(not torch.equal(cut[k], want[k]) for k in want)  # epoch 2 moved something


def counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a kernel wrapper, which runs its plain
    version on the CPU) made inside each training step and each validation forward."""
    calls, steps, evals = [], [], []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))

    def per_call(method, log):
        def wrapped(*args, **kwargs):
            n = len(calls)
            out = method(*args, **kwargs)
            log.append(len(calls) - n)
            return out
        return wrapped

    monkeypatch.setattr(ft.L2Reconstruct, "train_step",
                        per_call(ft.L2Reconstruct.train_step, steps))
    monkeypatch.setattr(ft, "eval_batch", per_call(ft.eval_batch, evals))
    return steps, evals


def test_teacher_pass_takes_the_kernel_route(tmp_path, monkeypatch):
    """The asym teacher's MSCA blocks call ``msca_fused`` once each per step: the
    teacher runs in eval() under no_grad, not under autograd, where the blocks
    would take the module path; the student trains on the module path, and
    its d1+fix blocks take the kernel in the validation forward."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    steps, evals = counting(monkeypatch, fused_ops, "msca_fused")
    run_port(tmp_path, MSCAN_MODEL.format(dpr=0.1) + FT.format(
        snap="", body="asym=True, l2_weight=1.0, cls_weight=0.0,", optim=SGD, epochs=1,
        steps=2, px=32, extra=""))
    assert steps == [2, 2] and evals == [2]


def test_convnext_r1_l2_asym_validation_takes_parallel_cascade(tmp_path, monkeypatch):
    """``configs/convnext/dw-sep-rep_r1_l2-asym_convnext-t.py`` on a narrow
    ConvNeXt (5 blocks) and Synthetic data: the dense teacher and the student's
    training forward launch no ``parallel_cascade``; the validation forward
    launches it once per rank-1 block."""
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    steps, evals = counting(monkeypatch, cascade_ops, "parallel_cascade")
    cfg = write(tmp_path, "tiny_convnext_l2", (
        f"_base_ = [{config('convnext/dw-sep-rep_r1_l2-asym_convnext-t.py')!r}]\n"
        "model = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), num_classes=10)\n"
        "hooks = [dict(type='L2Reconstruct', priority=50, asym=True, l2_weight=1.0,\n"
        "              cls_weight=0.0, dataset_args=dict(dataset=None, batch_size=4),\n"
        "              data_config=dict(image_size=(32, 32)), sche_args=dict(epochs=1),\n"
        "              optim_args=dict(opt='adamw', lr=1e-3, weight_decay=0.01),\n"
        "              other_args=dict(num_classes=10, max_steps_per_epoch=2,\n"
        "                              max_eval_batches=1, log_interval=1))]\n"))
    tcfg.init_cfg(str(cfg))
    tcfg.update_cfg(work_dir=str(tmp_path / "convnext"), seed=0)
    runner = Runner(device="cpu")
    runner.run()
    assert runner.model.length_switchable == 5
    assert steps == [0, 0] and evals == [5]


# -- validation --------------------------------------------------------------
def test_validate_helper_matches_jax(tmp_path):
    from convnet_approximater_tpu.classification import ValidateHelper as JValidateHelper
    from convnet_approximater_tpu.models import build_model as jbuild
    from convnet_approximater_tpu_torch.classification import ValidateHelper
    from convnet_approximater_tpu_torch.models import build_model

    model = build_model(dict(type="TinyNet", num_classes=12))
    tnn.init_weights(model, torch.Generator().manual_seed(3))
    jmodel = jbuild(dict(type="TinyNet", num_classes=12))
    jvars = jser.unflatten_tree(params_to_jax(model.state_dict()))
    jvars.setdefault("state", {})
    (tmp_path / "valid.txt").write_text("\n".join(str(i) for i in range(0, 12, 2)))
    np.savez(tmp_path / "real.npz", labels=np.random.RandomState(0).randint(-1, 12, (40, 3)))
    for extra in ({}, dict(valid_labels=str(tmp_path / "valid.txt")),
                  dict(real_labels=str(tmp_path / "real.npz"), test_input_size=(12, 12))):
        cfg = dict(batch_size=8, input_size=(16, 16, 3), num_classes=12, num_batches=3, **extra)
        want = JValidateHelper(jmodel, cfg, variables=jvars).validate()
        got = ValidateHelper(model, cfg, device="cpu").validate()
        assert set(got) == set(want)
        # inf where a label's class is masked out
        assert math.isclose(got["loss"], want["loss"], rel_tol=STEP_TOL)
        for k in set(want) - {"loss"}:
            assert got[k] == want[k], (extra, k)
    # amp: eval of a bf16 copy on bf16 images (the JAX helper's autocast eval)
    cfg = dict(batch_size=8, input_size=(16, 16, 3), num_classes=12, num_batches=3, amp=True)
    want = JValidateHelper(jmodel, cfg, variables=jvars).validate()
    got = ValidateHelper(model, cfg, device="cpu").validate()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert math.isclose(got["loss"], want["loss"], rel_tol=AMP_TOL)
    assert abs(got["top1"] - want["top1"]) <= 100 / 24 + 1e-9  # one image of 24 may flip


# -- what the port refuses ---------------------------------------------------
@pytest.mark.parametrize("other,match", [
    (dict(model_parallel=2), "queue 1 item 12"),
    (dict(ckpt_backend="sharded"), "sharded checkpoint backend"),
])
def test_unported_options_raise(tmp_path, other, match):
    tcfg.init_cfg(str(write(tmp_path, "cfg", TINY_MODEL)))
    runner = Runner(device="cpu")
    if other.get("ckpt_backend") == "sharded":
        # the sharded checkpoint backend is ported (utils/sharded_ckpt.py): the hook and
        # the saver take it, and an unknown backend still raises
        ft.L2Reconstruct(runner, 50, other_args=other)
        assert ft.CheckpointSaver(str(tmp_path / "sv"), backend="sharded").suffix == ".ckpt.dcp"
        with pytest.raises(ValueError, match="unknown ckpt backend"):
            ft.CheckpointSaver(str(tmp_path / "sv"), backend="orbax")
        return
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.parallel import MESH_TODO

    # tensor parallelism is ported (parallel/tp.py): the hook takes model_parallel; one
    # process trains unsharded (tests/test_torch_tensor_parallel.py trains over ranks)
    assert ft.L2Reconstruct(runner, 50, other_args=other).other_args.model_parallel == 2
    # spatial sharding serves eval forwards (parallel/spatial.py); training under it stays
    # refused
    runner.model = parallel.spatial_module(MSCAN_Classifier(
        num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=4), None)
    with pytest.raises(NotImplementedError, match=match) as e:
        ft.L2Reconstruct(runner, 50, other_args=other)
    assert "training under spatial sharding" in str(e.value)
    assert "spatial sharding" in MESH_TODO and "tp.py" not in MESH_TODO


# -- the pieces the hook stands on -------------------------------------------
def test_substitution_capture_and_forced_branch():
    from convnet_approximater_tpu_torch.layers import Substitution, forced_branch, taps

    model = torch.nn.Sequential(torch.nn.Identity(), Substitution(torch.nn.Identity(),
                                                                   torch.nn.Linear(2, 2)))
    x = torch.ones(1, 2)
    sub = model[1]
    sub.capture = True
    assert torch.equal(model(x), x)
    assert list(taps(model)) == ["1.out"] and torch.equal(taps(model)["1.out"], x)
    sub.switch_new(remove_old=False)
    with forced_branch(model, "old"):
        assert torch.equal(model(x), x)
    assert sub.force_branch is None
    with pytest.raises(RuntimeError):
        with forced_branch(model, "old"):
            raise RuntimeError
    assert sub.force_branch is None
    assert torch.equal(model(x), sub.new(x))


def test_freeze_except_keeps_the_switchable_layer_rule():
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier

    model = MSCAN_Classifier(num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2),
                             num_classes=4)
    model.register_switchable(MSCA, [])
    names = model.switchable_names
    assert len(names) == 2
    assert model.freeze_except(1) == {n for n, _ in model.named_parameters()
                                      if n.startswith(f"{names[1]}.sd_convs.")}
    assert model.unfreeze() == {n for n, _ in model.named_parameters()}


def test_drop_layers_draw_from_their_generator():
    from convnet_approximater_tpu_torch.layers import DropPath, drop_generator

    model = torch.nn.Sequential(DropPath(0.5), tnn.Dropout(0.5)).train()
    x = torch.ones(64, 4, 2, 2)
    g = torch.Generator()
    with drop_generator(model, g):
        g.manual_seed(3)
        a = model(x)
        g.manual_seed(3)
        b = model(x)
        assert all(m.generator is g for m in model)
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert all(m.generator is None for m in model)
    assert torch.equal(model.eval()(x), x)
    assert torch.equal(tnn.Dropout(1.0).train()(x), torch.zeros_like(x))


# -- the CLI -----------------------------------------------------------------
def test_cli_runs_tiny_finetune_and_eval_configs_on_cpu(tmp_path):
    from convnet_approximater_tpu_torch import main as cli

    ft_cfg = write(tmp_path, "tiny_l2", (
        f"_base_ = [{config('msca-rep/finetune/msca-rep-d0-fix_l2-asym_mscan-t.py')!r}]\n"
        "model = dict(num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=4)\n"
        "hooks = [dict(type='L2Reconstruct', priority=50, asym=True, l2_weight=1.0,\n"
        "              cls_weight=0.0, sche_args=dict(epochs=2),\n"
        "              optim_args=dict(opt='adamw', lr=1e-4, weight_decay=0.01),\n"
        "              dataset_args=dict(batch_size=4), data_config=dict(image_size=(32, 32)),\n"
        "              other_args=dict(num_classes=4, max_steps_per_epoch=2,\n"
        "                              max_eval_batches=1, log_interval=1))]\n"))
    runner = cli.main(["--config", str(ft_cfg), "--device", "cpu", "--work-dir",
                       str(tmp_path / "l2")])
    hook = runner.hooks[0]
    assert hook.result["best_metric"] is not None and not hook.result["preempted"]
    assert len(summary(tmp_path / "l2" / "summary.csv")) == 2
    log = (tmp_path / "l2" / "run.log").read_text()
    assert "Train: 1 [   1/2]" in log and "*** Best metric" in log

    eval_cfg = write(tmp_path, "tiny_eval", (
        f"_base_ = [{config('low-rank-exp/low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py')!r}]\n"
        "hooks = [dict(type='ClassEvalHook', priority=50, eval_cfg=dict(\n"
        "    input_size=(64, 64, 3), num_classes=10, batch_size=2, num_batches=2))]\n"))
    runner = cli.main(["--config", str(eval_cfg), "--device", "cpu", "--work-dir",
                       str(tmp_path / "eval")])
    result = runner.hooks[0].result
    assert result["img_size"] == 64 and np.isfinite(result["loss"])
    assert "eval results" in (tmp_path / "eval" / "run.log").read_text()
