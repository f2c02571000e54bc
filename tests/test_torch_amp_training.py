"""bf16 training (``amp``) in the port against the JAX package's.

* ``TrainHelper(amp=True)`` and ``L2Reconstruct(other_args.amp=True)``, asym
  and sym, on TinyBNNet (TinyNet with BatchNorm after its convs: BatchNorm in
  training mode on bf16 maps beside float32 running statistics, and around
  the taps of the sym teacher), run by both packages from the same weights on
  the same batches: each step's losses within ``AMP_TOL`` (2e-2; both compute
  in bf16, at other places, layer by layer).  The masters, the optimizer
  state and BatchNorm's running statistics stay float32; the asym teacher is
  a bf16 copy.
* The sym teacher's bf16 parameters are one set of tensors, overwritten (a
  version bump) each pass, so the kernel layers' caches see each step's weights.
* QAT under amp: the fake-quant grids follow the bf16 maps, the observers stay
  float32 and positive, and ``convert_qat_to_int8`` then serves int8.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.classification import train as jtrain  # noqa: E402
from convnet_approximater_tpu.models import MODEL as JMODEL  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild_model  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch import nn as tnn  # noqa: E402
from convnet_approximater_tpu_torch.classification import TrainHelper  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import QATConv2d, QATLinear, QuantConv2d  # noqa: E402
from convnet_approximater_tpu_torch.models import MODEL, SwitchableModel, build_model  # noqa: E402
from tests.test_torch_finetune import (AMP_TOL, FT, JAX_SNAP, PORT_LOAD, SGD,  # noqa: E402
                                       run_jax, run_port)

torch.set_num_threads(1)

if "TinyBNNet" not in JMODEL:

    @JMODEL.register_module()
    class TinyBNNet(JSwitchableModel):
        """TinyNet with BatchNorm after each conv (JAX)."""

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

if "TinyBNNet" not in MODEL:

    @MODEL.register_module()
    class TinyBNNet(SwitchableModel):  # noqa: F811
        """The port's twin of the JAX TinyBNNet above."""

        def __init__(self, num_classes=4, init_cfg=None):
            super().__init__(init_cfg=init_cfg)
            self.features = torch.nn.Sequential(
                tnn.Conv2d(3, 8, 3, padding=1), tnn.BatchNorm2d(8), tnn.ReLU(),
                tnn.MaxPool2d(2, 2),
                tnn.Conv2d(8, 12, 3, padding=1), tnn.BatchNorm2d(12), tnn.ReLU(),
                tnn.Conv2d(12, 12, 3, padding=1), tnn.BatchNorm2d(12), tnn.ReLU())
            self.head = tnn.Linear(12, num_classes)

        def forward(self, x):
            return self.head(self.features(x).mean(dim=(2, 3)))


# scheme-1 LowRankExpV1 on the two 3x3 convs after the pool (the L2 sites)
TINY_BN = """
model = dict(type="TinyBNNet", num_classes=4)
app = dict(type="LowRankExpV1", max_iter=0, min_lmda=0, max_lmda=0,
           init_method="svd", lmda_length=1, num_bases=(2, 2))
filters = [dict(type="SimpleConvFilter"), dict(type="IndicesFilter", indices=(2, 3))]
"""


def close(got, want, what):
    assert len(got) == len(want) and got
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a) and abs(a - b) <= AMP_TOL * abs(b) + 1e-4, (what, i, a, b)


def all_float32(model, optimizer):
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var", "act_absmax")))
    assert all(v.dtype == torch.float32 for s in optimizer.state.values() for v in s.values())


def test_train_helper_amp_matches_jax(tmp_path):
    cfg = dict(batch_size=8, image_size=(16, 16), num_classes=4, epochs=1, max_steps_per_epoch=3,
               max_eval_batches=1, log_interval=1, use_mesh=False, opt="sgd", lr=0.05,
               momentum=0.9, sched=None, label_smoothing=0.1, amp=True)
    jmodel = jbuild_model(dict(type="TinyBNNet", num_classes=4))
    jvars = {"params": jmodel.init(jax.random.key(0)), "state": jmodel.init_state()}
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(jvars).items()}
    jhelper = jtrain.TrainHelper(jmodel, jvars, dict(cfg, work_dir=str(tmp_path / "jax")))
    jlosses, loop = [], jhelper._loop

    def recording_loop(*args):
        args = list(args)
        train_step = args[4]

        def step(*a):
            out = train_step(*a)
            jlosses.append(float(out[4]))
            return out

        args[4] = step
        return loop(*args)

    jhelper._loop = recording_loop
    jhelper.train()

    model = build_model(dict(type="TinyBNNet", num_classes=4))
    missing, unexpected = model.load_state_dict(params_from_jax(flat), strict=False)
    assert not missing and not unexpected
    helper = TrainHelper(model, dict(cfg, work_dir=str(tmp_path / "port")), device="cpu")
    tlosses, step = [], helper.train_step
    helper.train_step = lambda *a: tlosses.append(float(step(*a))) or torch.tensor(tlosses[-1])
    helper.train()
    close(tlosses, jlosses, "TrainHelper amp loss")
    all_float32(model, helper.optimizer)
    # the BN running statistics moved, in float32
    bn = [b for n, b in model.named_buffers() if n.endswith("running_var")]
    assert bn and any(not torch.equal(b, torch.ones_like(b)) for b in bn)


@pytest.mark.parametrize("case", ["asym", "sym"])
def test_l2reconstruct_amp_matches_jax(tmp_path, case):
    body = f"asym={case == 'asym'}, l2_weight=1.0, cls_weight=0.1,"
    kw = dict(body=body, optim=SGD, epochs=1, steps=3, px=16, extra=", amp=True")
    _, jsteps = run_jax(tmp_path, TINY_BN + FT.format(snap=JAX_SNAP, **kw))
    trunner, tsteps = run_port(tmp_path, TINY_BN + FT.format(snap=PORT_LOAD, **kw))
    for what, i in (("loss", 0), ("ce", 1), ("norm", 2)):
        close([s[i] for s in tsteps], [s[i] for s in jsteps], what)
    hook = next(h for h in trunner.hooks if h.name == "L2Reconstruct")
    all_float32(trunner.model, hook.optimizer)
    if case == "asym":
        assert all(p.dtype == torch.bfloat16 for p in hook.teacher.parameters())


def test_sym_teacher_bf16_params_follow_the_masters(tmp_path):
    from convnet_approximater_tpu_torch.hooks import finetune as ft
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    path = tmp_path / "cfg.py"
    path.write_text(TINY_BN)
    tcfg.init_cfg(str(path))
    runner = Runner(device="cpu")
    hook = ft.L2Reconstruct(runner, 50, asym=False, other_args=dict(amp=True))
    model = runner.model
    first = hook._bf16_params(model)
    versions = {n: t._version for n, t in first.items()}
    name, p = next(iter(model.named_parameters()))
    with torch.no_grad():
        p.add_(1.0)
    second = hook._bf16_params(model)
    assert all(second[n] is t for n, t in first.items())  # the same tensors, so the same addresses
    assert all(t._version > versions[n] for n, t in second.items())
    assert torch.equal(second[name], p.detach().to(torch.bfloat16))


def test_qat_under_amp(tmp_path):
    model = build_model(dict(type="TinyBNNet", num_classes=4))
    tnn.init_weights(model, torch.Generator().manual_seed(0))
    deploy.fold_batchnorm(model)
    assert deploy.prepare_qat(model) == 4
    helper = TrainHelper(model, dict(batch_size=8, image_size=(16, 16), num_classes=4, epochs=1,
                                     max_steps_per_epoch=2, max_eval_batches=1, log_interval=1,
                                     lr=1e-4, amp=True, work_dir=str(tmp_path / "qat")),
                         device="cpu")
    losses, step = [], helper.train_step
    helper.train_step = lambda *a: losses.append(float(step(*a))) or torch.tensor(losses[-1])
    helper.train()
    assert len(losses) == 2 and all(np.isfinite(losses))
    twins = [m for m in model.modules() if isinstance(m, (QATConv2d, QATLinear))]
    assert len(twins) == 4
    for m in twins:
        assert m.act_absmax.dtype == torch.float32 and float(m.act_absmax) > 0
    all_float32(model, helper.optimizer)
    assert deploy.convert_qat_to_int8(model) == 4
    assert sum(isinstance(m, QuantConv2d) for m in model.modules()) == 3
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x)).all()
