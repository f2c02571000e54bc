"""The port's quantization-aware training against the JAX package.

* ``fake_quant`` values bit for bit (round half to even on both sides, the
  clip at +-127, a per-channel scale) and its straight-through gradient mask;
  ``fake_quant_weight`` on the PTQ grid of ``quantize_weight_per_channel``;
* the absmax observer: warm-started by the first training batch, an EMA
  after, frozen in eval, against the JAX state;
* a QAT twin in eval against the int8 serving module on the same scales,
  within atol 1e-5 (the JAX tests' bound);
* ``prepare_qat``/``convert_qat_to_int8`` on the same narrow net as the JAX
  package: the counts, the observers after one training batch (1e-6
  relative), ``act_scale`` bit for bit, and the int8 logits bit-equal to the
  port's int8 forward loaded from the JAX package's converted parameters;
  the checkpoint files ``act_absmax`` under ``state/``;
* ``PrepareQAT`` ahead of ``L2Reconstruct`` (CE-only, as the QAT config, and
  asym L2 with its teacher): each step within 1e-5 of the JAX run's, and the
  asym teacher holds no QAT twin; the QAT config through the CLI, small, then
  its 8 int8 modules.
"""

import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu.layers import quant as jquant  # noqa: E402
from convnet_approximater_tpu.models import MODEL as JMODEL  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import (QATConv2d, QATLinear, QuantConv2d,  # noqa: E402
                                                   QuantLinear, Substitution, fake_quant,
                                                   fake_quant_weight, quant)
from convnet_approximater_tpu_torch.models import MODEL  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import set_submodule  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear  # noqa: E402
from tests import test_torch_finetune as tft  # noqa: E402  (registers TinyNet in both)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_ATOL = 1e-5
OBS_RTOL = 1e-6
QAT_SITES = ["features.0", "features.3", "features.5", "head"]


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def flat(variables):
    return {k: np.asarray(v) for k, v in jser.flatten_tree(variables).items()}


# -- the fake-quant primitives ---------------------------------------------
def test_fake_quant_matches_jax_bit_for_bit():
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 5, 6) * 40).astype(np.float32)
    x[0, 0, :] = [0.25, 0.75, -1.25, 63.25, 64.0, -100.0]  # ties at scale 0.5, and clips
    for scale in (0.5, (rs.rand(1, 1, 6) + 0.1).astype(np.float32)):
        want = np.asarray(jquant.fake_quant(jnp.asarray(x), scale))
        got = fake_quant(torch.from_numpy(x), torch.as_tensor(scale)).numpy()
        np.testing.assert_array_equal(got, want)
    tied = fake_quant(torch.from_numpy(x[0, 0, :3]), 0.5).numpy()
    np.testing.assert_array_equal(tied, [0.0, 1.0, -1.0])  # half to even: 0.5->0, 1.5->2, -2.5->-2

    v = np.array([0.3, -5.2, 126.9, 127.0, 128.5, -400.0], np.float32)
    g_j = np.asarray(jax.grad(lambda t: jnp.sum(jquant.fake_quant(t, 1.0)))(jnp.asarray(v)))
    t = torch.from_numpy(v).requires_grad_(True)
    fake_quant(t, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), g_j)
    np.testing.assert_array_equal(t.grad.numpy(), [1, 1, 1, 1, 0, 0])


def test_fake_quant_weight_on_the_ptq_grid():
    rs = np.random.RandomState(1)
    w_hwio = (rs.randn(3, 3, 4, 8) * np.arange(1, 9)).astype(np.float32)
    w = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    w_fq = fake_quant_weight(w)
    w_q, scale = quant.quantize_weight_per_channel(w)
    np.testing.assert_allclose(w_fq.numpy(), (w_q.float() * scale[:, None, None, None]).numpy(),
                               rtol=0, atol=1e-6)
    want = np.asarray(jquant.fake_quant_weight(jnp.asarray(w_hwio), reduce_axes=(0, 1, 2)))
    np.testing.assert_array_equal(w_fq.numpy(), want.transpose(3, 2, 0, 1))
    lw = rs.randn(16, 8).astype(np.float32)  # JAX (in, out)
    want = np.asarray(jquant.fake_quant_weight(jnp.asarray(lw), reduce_axes=(0,)))
    np.testing.assert_array_equal(fake_quant_weight(torch.from_numpy(lw.T.copy())).numpy(), want.T)


# -- the twins ------------------------------------------------------------
def twins(kind):
    """(JAX twin, its params, port twin with the same weights, NHWC input)."""
    if kind == "conv":
        jmod, tmod = jquant.QATConv2d(3, 4, 3, padding=1), QATConv2d(3, 4, 3, padding=1)
        x = np.array(jax.random.normal(jax.random.key(1), (2, 6, 6, 3)))
    else:
        jmod, tmod = jquant.QATLinear(16, 8), QATLinear(16, 8)
        x = np.array(jax.random.normal(jax.random.key(1), (4, 16)))
    params = jmod.init(jax.random.key(0))
    missing, unexpected = tmod.load_state_dict(params_from_jax(flat({"params": params})),
                                               strict=False)
    assert missing == ["act_absmax"] and not unexpected
    return jmod, params, tmod, x


def port_input(kind, x):
    return nchw(x) if kind == "conv" else torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_observer_updates_in_training_and_freezes_in_eval(kind):
    jmod, params, tmod, x = twins(kind)
    state = jmod.init_state()
    tmod.train()
    for scale in (1.0, 2.0, 0.5):
        xs = (x * scale).astype(np.float32)
        _, state, _ = jmod.apply(params, jnp.asarray(xs), state=state, training=True)
        tmod(port_input(kind, xs))
        assert float(tmod.act_absmax) == float(state["act_absmax"])
    assert float(tmod.act_absmax) == pytest.approx(
        0.9 * (0.9 * np.abs(x).max() + 0.1 * 2 * np.abs(x).max()) + 0.1 * 0.5 * np.abs(x).max())
    frozen = float(tmod.act_absmax)
    tmod.eval()
    tmod(port_input(kind, 3 * x))
    assert float(tmod.act_absmax) == frozen
    assert tmod.act_absmax.dim() == 0 and "act_absmax" in dict(tmod.named_buffers())


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_qat_eval_matches_the_int8_serving_forward(kind):
    _, _, tmod, x = twins(kind)
    absmax = float(np.abs(x).max())
    tmod.act_absmax.fill_(absmax)
    xin = port_input(kind, x)
    with torch.no_grad():
        y_qat = tmod.eval()(xin)
        q = (QuantConv2d.from_conv(tmod, absmax / 127.0) if kind == "conv"
             else QuantLinear.from_linear(tmod, absmax / 127.0))
        y_int8 = q(xin)
    np.testing.assert_allclose(y_qat.numpy(), y_int8.numpy(), rtol=0, atol=SERVE_ATOL)


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_qat_training_forward_and_gradients_match_jax(kind):
    """The fake-quant forward and the straight-through weight gradient, from a
    warm observer."""
    jmod, params, tmod, x = twins(kind)
    state = {"act_absmax": jnp.float32(2.5)}
    tmod.act_absmax.fill_(2.5)

    def jloss(p):
        y, _, _ = jmod.apply(p, jnp.asarray(x), state=state, training=False)
        return jnp.sum(y ** 2), y

    (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    y = tmod.eval()(port_input(kind, x))
    (y ** 2).sum().backward()
    y_np = y.detach().numpy()
    if kind == "conv":
        y_np = y_np.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(y_np, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    grads = params_from_jax(flat({"params": g_j}))
    for name in ("weight", "bias"):
        got = getattr(tmod, name).grad
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), grads[name].numpy(), rtol=1e-5, atol=1e-5)


# -- prepare_qat / convert_qat_to_int8 on TinyNet, against the JAX passes -------
def int8_shell(model):
    """``model`` with each QAT site an empty int8 module of its shape."""
    for path in QAT_SITES:
        m = model.get_submodule(path)
        q = (QuantConv2d(m.in_channels, m.out_channels, m.kernel_size, stride=m.stride,
                         padding=m.padding) if isinstance(m, Conv2d)
             else QuantLinear(m.in_features, m.out_features))
        set_submodule(model, path, q)
    return model


def test_prepare_train_convert_match_jax_and_serve_the_same_bits():
    jmodel = JMODEL.get("TinyNet")(num_classes=4)
    jvars = {"params": jmodel.init(jax.random.key(0)), "state": {}}
    tmodel = MODEL.get("TinyNet")(num_classes=4)
    tmodel.load_state_dict(params_from_jax(flat(jvars)))
    assert jdeploy.prepare_qat(jmodel, jvars) == deploy.prepare_qat(tmodel) == 4
    assert [p for p, m in tmodel.named_modules()
            if isinstance(m, (QATConv2d, QATLinear))] == QAT_SITES
    keys = set(params_to_jax(tmodel.state_dict()))
    assert keys == set(flat(jvars)) and "state/features/0/act_absmax" in keys

    x = np.random.RandomState(2).randn(4, 16, 16, 3).astype(np.float32)
    train = jax.jit(lambda p, x, s: jmodel.apply(p, x, state=s, training=True)[1])
    jvars["state"] = train(jvars["params"], jnp.asarray(x), jvars["state"])
    tmodel.train()(nchw(x))
    observed = flat(jvars)
    for path in QAT_SITES:
        want = float(observed["state/" + path.replace(".", "/") + "/act_absmax"])
        got = float(tmodel.get_submodule(path).act_absmax)
        assert got == pytest.approx(want, rel=OBS_RTOL), path
    assert float(tmodel.features[0].act_absmax) == float(np.abs(x).max())  # the images themselves

    # the checkpoint carries the observers under state/, and back
    tmodel.load_state_dict(params_from_jax(flat(jvars)))
    again = params_to_jax(tmodel.state_dict())
    for k, v in flat(jvars).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)

    assert jdeploy.convert_qat_to_int8(jmodel, jvars) == deploy.convert_qat_to_int8(tmodel) == 4
    assert not any("act_absmax" in k for k in tmodel.state_dict())
    converted = flat(jvars)
    for path in QAT_SITES:
        m = tmodel.get_submodule(path)
        assert isinstance(m, QuantConv2d if path != "head" else QuantLinear)
        want = converted["params/" + path.replace(".", "/") + "/act_scale"]
        assert m.act_scale.numpy().tobytes() == want.astype(np.float32).tobytes(), path

    served = int8_shell(MODEL.get("TinyNet")(num_classes=4))
    served.load_state_dict(params_from_jax(converted))
    with torch.no_grad():
        a, b = tmodel.eval()(nchw(x)), served.eval()(nchw(x))
    assert torch.equal(a, b)


def test_convert_refuses_missing_and_untrained_observers():
    model = torch.nn.Sequential(Conv2d(3, 4, 3, padding=1), Conv2d(4, 4, 3, groups=4),
                                Linear(4, 2))
    assert deploy.prepare_qat(model, linears=False) == 1
    assert type(model[1]) is Conv2d and type(model[2]) is Linear
    with pytest.raises(RuntimeError, match="never saw a training batch"):
        deploy.convert_qat_to_int8(model)
    del model[0].act_absmax
    with pytest.raises(RuntimeError, match="no observer state"):
        deploy.convert_qat_to_int8(model)


def test_substitution_filter_leaves_the_sites_out():
    model = torch.nn.Sequential(Conv2d(3, 4, 1), Substitution(Conv2d(4, 4, 3), Conv2d(4, 4, 1)),
                                Linear(4, 2))
    keep = deploy.qat_substitution_filter(model)
    assert keep("0", model[0]) and not keep("1.old", model[1].old) and keep("2", model[2])
    assert deploy.prepare_qat(model, filter_fn=keep) == 2
    assert type(model[1].old) is Conv2d and type(model[1].new) is Conv2d


# -- PrepareQAT through the Runners ------------------------------------------
QAT_HOOK = 'dict(type="PrepareQAT", priority=48), '


@pytest.mark.parametrize("body", ["asym=True, no_norm=True, l2_weight=0.0, cls_weight=1.0,",
                                  "asym=True, l2_weight=1.0, cls_weight=0.1,"],
                         ids=["ce_no_norm", "l2_asym"])
def test_prepare_qat_hook_trains_like_jax(tmp_path, body):
    """TinyNet with two scheme-1 sites: PrepareQAT swaps the dense remainder
    (``features.0`` and ``head``), and the recovery steps match the JAX run's.
    The asym teacher is float, as the JAX one, rebuilt from the config, is."""
    jrunner, trunner = tft.run_both(tmp_path, tft.TINY_MODEL, body, extra_hooks=QAT_HOOK)
    qat = [p for p, m in trunner.model.named_modules() if isinstance(m, (QATConv2d, QATLinear))]
    assert qat == ["features.0", "head"]
    assert all(float(trunner.model.get_submodule(p).act_absmax) > 0 for p in qat)
    hook = next(h for h in trunner.hooks if h.name == "PrepareQAT")
    assert hook.swapped == 2
    l2 = next(h for h in trunner.hooks if h.name == "L2Reconstruct")
    if "no_norm" in body:
        assert l2.teacher is None
    else:
        assert not any(isinstance(m, (QATConv2d, QATLinear)) for m in l2.teacher.modules())
        assert type(l2.teacher.features[0]) is Conv2d and type(l2.teacher.head) is Linear


def test_cli_runs_the_qat_config_on_cpu_and_converts_8_modules(tmp_path):
    """``quant/int8-qat_ce_alexnet.py`` at full width, one step at b=2 on 64^2
    images; then the 8 convs and Linears convert to int8 and serve."""
    from convnet_approximater_tpu_torch import main as cli
    from convnet_approximater_tpu_torch.hooks import finetune as ft

    cfg = tmp_path / "qat.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/quant/int8-qat_ce_alexnet.py')!r}]\n"
        "hooks = [dict(type='PrepareQAT', priority=48),\n"
        "         dict(type='L2Reconstruct', priority=50, asym=True, no_norm=True,\n"
        "              l2_weight=0.0, cls_weight=1.0, dataset_args=dict(batch_size=2),\n"
        "              data_config=dict(image_size=(64, 64)), sche_args=dict(epochs=1),\n"
        "              optim_args=dict(opt='adamw', lr=1e-4, weight_decay=0.01, clip_grad=1.0),\n"
        "              other_args=dict(num_classes=10, max_steps_per_epoch=1,\n"
        "                              max_eval_batches=1, log_interval=1))]\n")
    work = tmp_path / "run"
    with mock.patch.object(ft.CheckpointSaver, "save_checkpoint", lambda self, *a, **k: (0, 0)):
        runner = cli.main(["--config", str(cfg), "--device", "cpu", "--seed", "0",
                           "--work-dir", str(work)])
    log = (work / "run.log").read_text()
    assert "PrepareQAT: 8 modules now train under int8 fake-quant" in log
    model = runner.model
    assert all(float(m.act_absmax) > 0 for m in model.modules()
               if isinstance(m, (QATConv2d, QATLinear)))
    assert deploy.convert_qat_to_int8(model) == 8
    assert sum(isinstance(m, (QuantConv2d, QuantLinear)) for m in model.modules()) == 8
    x = torch.randn(2, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = model.eval()(x)
    assert y.shape == (2, 10) and torch.isfinite(y).all()
