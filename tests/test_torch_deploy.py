"""The port's serving rewrites against the JAX package's (``tests/test_deploy.py``).

``fold_batchnorm`` folds the same pairs as JAX's, leaves the same
``state_dict`` keys as JAX's tree after its fold, and keeps the eval forward
to 1e-5 (a Sequential) or 1e-4 (the logits of a tiny MSCAN: float32 sums in
another order through the network).  ``enable_pw_matmul`` flags the convs
JAX's flags, keeps the numbers to 1e-5 and keeps what the other rewrites and
the kernels look for.  ``compile_serving`` holds its contract on the CPU, and
``structure_passes`` run from a config through the CLI.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.deploy import enable_pw_matmul as jenable_pw  # noqa: E402
from convnet_approximater_tpu.deploy import fold_batchnorm as jfold  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree, unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.hooks import count_macs  # noqa: E402
from convnet_approximater_tpu_torch.layers import (MSCA, LowRankExpConvV1,  # noqa: E402
                                                   QuantConv2d, QuantLinear, Substitution)
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.nn import (GELU, BatchNorm2d, Conv2d,  # noqa: E402
                                               Identity, channels_last, init_weights)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=10)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def randomize(model, seed=0):
    """Random weights, and BN affine and running stats away from (1, 0, 0, 1),
    so that a fold has something to fold."""
    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                C = m.num_features
                m.weight.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, C).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rs.randn(C).astype(np.float32) * 0.3))
                m.running_mean.copy_(torch.from_numpy(rs.randn(C).astype(np.float32) * 0.5))
                m.running_var.copy_(torch.from_numpy(rs.uniform(0.3, 2.0, C).astype(np.float32)))
    return model.eval()


def jax_twin(jmodel, model):
    """JAX variables holding ``model``'s weights."""
    return unflatten_tree({k: jnp.asarray(v) for k, v in params_to_jax(model.state_dict()).items()})


def japply(jmodel, variables, x):
    return np.asarray(jax.jit(lambda p, s, x: jmodel.apply(p, x, state=s)[0])(
        variables["params"], variables.get("state", {}), jnp.asarray(x)))


def run(model, x):
    with torch.no_grad():
        y = model(torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy() if y.dim() == 4 else y.numpy()


def seq_pair():
    jmodel = jnn.Sequential(jnn.Conv2d(3, 8, 3, stride=2, padding=1), jnn.BatchNorm2d(8),
                            jnn.GELU(), jnn.Conv2d(8, 16, 3, padding=1, bias=False),
                            jnn.BatchNorm2d(16))
    model = torch.nn.Sequential(Conv2d(3, 8, 3, stride=2, padding=1), BatchNorm2d(8), GELU(),
                                Conv2d(8, 16, 3, padding=1, bias=False), BatchNorm2d(16))
    return jmodel, randomize(model)


def test_fold_batchnorm_sequential_matches_jax():
    jmodel, model = seq_pair()
    jv = jax_twin(jmodel, model)
    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    y_ref = run(model, x)
    assert deploy.fold_batchnorm(model) == jfold(jmodel, jv) == 2
    assert isinstance(model[1], Identity) and isinstance(model[4], Identity)
    assert isinstance(model[3].bias, torch.nn.Parameter)  # the bias-free conv gained one
    assert sorted(model.state_dict()) == sorted(params_from_jax(flatten_tree(jv)))
    y = run(model, x)
    assert np.abs(y - y_ref).max() < 1e-5
    assert rel(y, japply(jmodel, jv, x)) < 1e-5


def test_fold_batchnorm_mscan_matches_jax():
    """The stem's two pairs and three DownSamples fold; the blocks' pre-norms stay."""
    model = randomize(MSCAN_Classifier(**TINY))
    jmodel = JClassifier(**TINY)
    jv = jax_twin(jmodel, model)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    y_ref = run(model, x)
    assert deploy.fold_batchnorm(model) == jfold(jmodel, jv) == 5
    assert sorted(model.state_dict()) == sorted(params_from_jax(flatten_tree(jv)))
    kept = [p for p, m in model.named_modules() if isinstance(m, BatchNorm2d)]
    assert len(kept) == 8 and all(p.endswith(("norm1", "norm2")) for p in kept)
    y = run(model, x)
    assert rel(y, y_ref) < 1e-4 and np.abs(y - y_ref).max() < 1e-4
    assert rel(y, japply(jmodel, jv, x)) < 1e-4


def test_fold_batchnorm_training_forward_differs():
    """A folded model is serving-only: training-mode BN uses batch statistics."""
    model = randomize(torch.nn.Sequential(Conv2d(3, 4, 3, padding=1), BatchNorm2d(4)))
    x = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        y_train = model.train()(x)
        deploy.fold_batchnorm(model)
        y_fold = model.eval()(x)
    assert (y_fold - y_train).abs().max() > 1e-3


def test_fold_batchnorm_idempotent():
    model = randomize(torch.nn.Sequential(Conv2d(3, 4, 3), BatchNorm2d(4)))
    assert deploy.fold_batchnorm(model) == 1
    assert deploy.fold_batchnorm(model) == 0


def shared_bases(layer: LowRankExpConvV1, seed: int):
    """Give every input channel the same bases (the kernel's form)."""
    C, M = layer.in_channels, layer.num_base
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w = layer.s_conv.weight
        w.copy_(torch.randn(1, M, *w.shape[1:], generator=g).expand(C, -1, -1, -1, -1)
                .reshape(w.shape))
    return layer


def test_fold_batchnorm_substitution_both_branches():
    """A live Substitution feeding a BN folds into both branches' terminal convs
    (the new one through LowRankExpConvV1's d_conv), so switching stays exact."""
    old = Conv2d(3, 8, 3, padding=1, bias=False)
    new = LowRankExpConvV1(3, 8, 3, 1, 1, num_base=4)
    model = randomize(torch.nn.Sequential(Substitution(old, new), BatchNorm2d(8)))
    x = np.random.RandomState(6).randn(2, 16, 16, 3).astype(np.float32)

    def branches():
        out = []
        for use_old in (True, False):
            model[0].use_old = use_old
            out.append(run(model, x))
        return out

    before = branches()
    assert deploy.fold_batchnorm(model) == 1 and isinstance(model[1], Identity)
    assert old.bias is not None and new.d_conv.bias is not None
    for y, y_ref in zip(branches(), before):
        assert np.abs(y - y_ref).max() < 2e-4


def test_fold_batchnorm_through_low_rank_tail_repacks_the_kernel_weights():
    """A BN after a LowRankExpConvV1 folds into its d_conv; the layer's packed
    kernel weights (cached per weight version) follow the fold."""
    layer = LowRankExpConvV1(4, 8, 3, 1, 1, num_base=2)
    model = randomize(torch.nn.Sequential(layer, BatchNorm2d(8)))
    shared_bases(layer, seed=7)
    x = np.random.RandomState(8).randn(2, 9, 9, 4).astype(np.float32)
    with torch.no_grad():
        assert layer.uses_kernel()
    y_ref = run(model, x)
    assert deploy.fold_batchnorm(model) == 1
    with torch.no_grad():
        assert layer.uses_kernel()
    assert np.abs(run(model, x) - y_ref).max() < 1e-5


def test_enable_pw_matmul_selects_what_jax_selects():
    specs = [dict(args=(8, 16, 1)),                          # qualifies
             dict(args=(16, 16, 3), kw=dict(padding=1)),     # k = 3: no
             dict(args=(16, 16, 1), kw=dict(groups=2)),      # grouped: no
             dict(args=(16, 16, 1), kw=dict(stride=2)),      # strided: no
             dict(args=(16, 16, 1), kw=dict(padding=1)),     # padded: no
             dict(args=(16, 8, 1))]                          # qualifies
    model = torch.nn.Sequential(*[Conv2d(*s["args"], **s.get("kw", {})) for s in specs])
    jmodel = jnn.Sequential(*[jnn.Conv2d(*s["args"], **s.get("kw", {})) for s in specs])
    assert deploy.enable_pw_matmul(model) == jenable_pw(jmodel) == 2
    assert [m.pw_matmul for m in model] == [m.pw_matmul for _, m in jmodel.named_children()]
    assert [m.pw_matmul for m in model] == [True, False, False, False, False, True]
    assert deploy.enable_pw_matmul(model) == 0  # idempotent


def test_enable_pw_matmul_counts_the_headline_structure_as_jax_does():
    """Full-width MSCAN-t with FFNs 1-6 merged (the headline structure; no
    weights needed): both packages flag 59 convs, proj_1, proj_2, channel_mix
    and fc2 of 13 blocks and fc1 of the 7 FFNs left."""
    from convnet_approximater_tpu.filters import IndicesFilter as JIndicesFilter
    from convnet_approximater_tpu.layers import MergedFFN as JMergedFFN
    from convnet_approximater_tpu.models.mscan import FFN as JFFN
    from convnet_approximater_tpu_torch.filters import IndicesFilter
    from convnet_approximater_tpu_torch.layers import MergedFFN
    from convnet_approximater_tpu_torch.models.mscan import FFN

    counts = []
    for cls, ffn, merged, flt, args in (
            (JClassifier, JFFN, JMergedFFN, JIndicesFilter, ({}, {})),
            (MSCAN_Classifier, FFN, MergedFFN, IndicesFilter, ())):
        model = cls(num_classes=1000)
        model.register_switchable(ffn, [flt((1, 2, 3, 4, 5, 6))])
        for idx in range(model.length_switchable):
            src = model.get_switchable_module(idx)
            model.set_switchable_module(idx, merged(src.num_channel, src.hidden_channel), *args)
        counts.append((model.length_switchable,
                       (jenable_pw if cls is JClassifier else deploy.enable_pw_matmul)(model)))
    assert counts[0] == counts[1] == (6, 59)


@pytest.mark.parametrize("bias", [True, False])
def test_pw_matmul_forward_is_the_conv(bias):
    conv = Conv2d(12, 20, 1, bias=bias).eval()
    init_weights(conv, torch.Generator().manual_seed(9))
    x = torch.randn(2, 12, 7, 9, generator=torch.Generator().manual_seed(10)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        y_conv = conv(x)
        conv.pw_matmul = True
        y = conv(x)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, y_conv, rtol=1e-5, atol=1e-6)


def quant_targets(model):
    """The modules quantize_int8 rewrites (not the fused MSCA blocks' channel_mix,
    which msca_fused reads as a weight and calibration never reaches)."""
    q = copy.deepcopy(model)
    calib = [torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(11))]
    n = deploy.quantize_int8(q, calib, lambda path, m: not path.endswith("channel_mix"))
    paths = sorted(p for p, m in q.named_modules() if isinstance(m, (QuantConv2d, QuantLinear)))
    assert n == len(paths) > 0
    return paths


def test_enable_pw_matmul_keeps_numbers_keys_quant_targets_fusion_and_macs():
    model = channels_last(randomize(MSCAN_Classifier(**TINY)))
    assert apply_app(model, MscaRep(decomp=1, fix=True)) == 4
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(12)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        y0 = model(x)
    shapes0 = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    targets0, macs0 = quant_targets(model), count_macs(model, x)
    # proj_1, proj_2, channel_mix, fc1 and fc2 of each block
    assert deploy.enable_pw_matmul(model) == 5 * 4
    with torch.no_grad():
        y1 = model(x)
        assert all(m.can_fuse() for m in model.modules() if isinstance(m, MSCA))
    assert rel(y1.numpy(), y0.numpy()) < 1e-5
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes0
    assert quant_targets(model) == targets0
    assert count_macs(model, x) == macs0


def serving_model():
    model = channels_last(randomize(MSCAN_Classifier(**TINY)))
    apply_app(model, MscaRep(decomp=1, fix=True))
    deploy.fold_batchnorm(model)
    deploy.enable_pw_matmul(model)
    return model


def test_compile_serving_on_cpu_holds_the_contract():
    model = serving_model()
    g = torch.Generator().manual_seed(13)
    x0, x1 = (torch.randn(2, 3, 32, 32, generator=g).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    compiled, put = deploy.compile_serving(model, x0)
    with torch.no_grad():
        y_eager = model(x1)
    y = compiled(*put(x1))
    torch.testing.assert_close(y, y_eager, rtol=0, atol=0)
    y.add_(1.0)  # the caller owns it: the next call is unchanged
    torch.testing.assert_close(compiled(x1), y_eager, rtol=0, atol=0)
    with pytest.raises(ValueError, match="compiled for"):
        put(torch.zeros(1, 3, 32, 32))


def _modify(model):
    with torch.no_grad():
        model.head.weight.mul_(1.0)  # in place: the version counter moves


def _replace(model):
    model.head.weight = torch.nn.Parameter(model.head.weight.detach().clone())


def _swap(model):
    model.backbone.layers[0][2] = Identity()


@pytest.mark.parametrize("change", [_modify, _replace, _swap])
def test_compile_serving_raises_once_the_model_changed(change):
    """A captured graph reads weights, caches and tensor maps by address, so a
    session must refuse to run a model that changed since."""
    model = serving_model()
    x = torch.zeros(2, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    compiled, put = deploy.compile_serving(model, x)
    compiled(x)
    change(model)
    with pytest.raises(RuntimeError, match="compile the model again"):
        compiled(x)
    compiled, put = deploy.compile_serving(model, x)  # compiled again, it runs
    compiled(x)


def test_apply_app_refuses_calibration():
    """An app without ``set_calibration`` refuses the calibration pass: the loop
    is the one-pass loop and no calibration batch is drawn, as in the JAX
    function."""
    model = MSCAN_Classifier(**TINY)
    drawn = []

    def batches():
        drawn.append(1)
        yield torch.zeros(1, 3, 8, 8)

    assert apply_app(model, MscaRep(decomp=1, fix=True), calib_batches=batches()) == 4
    assert drawn == []


def tiny_config(tmp_path, passes):
    path = tmp_path / "tiny_passes.py"
    path.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/msca-rep/msca-rep_d1_fix_mscan-t.py')!r}]\n"
        f"model = dict(num_channels={TINY['num_channels']}, num_blocks={TINY['num_blocks']},\n"
        f"             exp_ratios={TINY['exp_ratios']}, num_classes={TINY['num_classes']})\n"
        f"structure_passes = {passes!r}\n"
        f"hooks = []\n")
    return str(path)


def test_structure_passes_run_through_the_cli_on_cpu(tmp_path):
    cfg = tiny_config(tmp_path, [dict(fn="fold_batchnorm"), dict(fn="enable_pw_matmul")])
    work = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "convnet_approximater_tpu_torch.main", "--config", cfg,
         "--device", "cpu", "--work-dir", str(work)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    log = (work / "run.log").read_text()
    assert "structure pass fold_batchnorm: 5 sites" in log
    assert "structure pass enable_pw_matmul: 20 sites" in log
    assert "4 switchable submodules" in log and "PC energy retained" in log
    state = torch.load(work / "tiny_passes.pt")
    assert not any(k.startswith("backbone.layers.1.0.norm") for k in state)  # folded


@pytest.mark.parametrize("name", ["prune_chains", "prune_trunks", "prune_width"])
def test_unported_structure_pass_raises_naming_it(tmp_path, name):
    """The prune passes, once refused, now run: the Runner applies each to the
    tiny MSCAN of the MscaRep config as the JAX pass does to the same weights
    (every width and tensor equal), and registers the app's 4 MSCA sites on
    the pruned model."""
    from convnet_approximater_tpu import deploy as jdeploy
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg
    from test_torch_prune_passes import assert_same_pruned

    options = dict(keep_ratio=0.5, round_to=None)
    if name == "prune_width":
        options["ffn_round_to"] = None
    tcfg.init_cfg(tiny_config(tmp_path, [dict(fn=name, **options)]))
    tcfg.update_cfg(work_dir=str(tmp_path / "run"))
    runner = Runner(device="cpu")
    runner.init_model()
    jmodel = JClassifier(**TINY)
    variables = unflatten_tree(params_to_jax(runner.model_before_passes.state_dict()))
    assert getattr(jdeploy, name)(jmodel, variables, **options) > 0
    assert_same_pruned(jmodel, variables, runner.model)
    assert runner.model.length_switchable == 4
    assert all(isinstance(m, MSCA) for m in runner.model.switchable_modules())
