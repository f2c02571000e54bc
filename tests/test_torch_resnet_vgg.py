"""ResNet-18/50 and VGG-16 in the port against the JAX package.

The same numpy weights (uniform in +-sqrt(6 / fan_in), random BN affine and
running stats) go into both packages through ``params_from_jax``: logits of
ResNet-18 and VGG-16 at 32^2 (VGG's last map is 1 x 1, so its adaptive pool
repeats the value over 7 x 7 and a flatten in the wrong order would show) and
of ResNet-50 at 64^2, batch 1; the round trip through ``params_to_jax``; the
scheme-1 ResNet-18 Runner of ``configs/resnet/low-rank-exp-v1_blocks_svd_resnet18.py``
(registered names, logits); ``fold_batchnorm`` (20 and 53 pairs, the logits
unchanged, the scheme-1 layers' packed kernel weights repacked); int8
``quantize_int8`` of the folded ResNet-50 against the JAX package's.  Each
model is built once per module, in a fixture both packages share.

Tolerances: logits 1e-4 relative (the packages sum in another order through
the network), also with the JAX Runner's solved parameters carried across; 1e-3
between the two Runners' own solves (each package's SVDs come from another
LAPACK call, and 16 layers carry their rounding to the logits); a fold 1e-5
(float32 rounding of the folded weights); int8 as ``tests/test_torch_quant.py``:
1e-4 of the JAX int8 logits, and above 1e-4 but within 0.12 max-abs relative
of the float32 logits.
"""

import math
import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu.models import VGG as JVGG  # noqa: E402
from convnet_approximater_tpu.models import ResNet as JResNet  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1  # noqa: E402
from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear  # noqa: E402
from convnet_approximater_tpu_torch.models import VGG, ResNet  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import set_submodule  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18_CFG = "configs/resnet/low-rank-exp-v1_blocks_svd_resnet18.py"
RTOL = 1e-4
SOLVE_TOL = 1e-3
FOLD_TOL = 1e-5
# (port model, JAX model, input (B, H, W, C), seed), built once per module
MODELS = {"resnet18": (lambda: ResNet(18, 10), lambda: JResNet(18, 10), (2, 32, 32, 3), 1),
          "resnet50": (lambda: ResNet(50, 10), lambda: JResNet(50, 10), (1, 64, 64, 3), 2),
          "vgg16": (lambda: VGG(16, 10), lambda: JVGG(16, 10), (2, 32, 32, 3), 3)}


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def numpy_variables(jmodel, seed):
    """The JAX model's ``{'params', 'state'}`` drawn with numpy (no JAX init,
    which takes tens of seconds for these models on one core)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    flat = jser.flatten_tree({"params": shapes, "state": jmodel.init_state()})
    rs = np.random.RandomState(seed)
    out = {}
    for key, v in flat.items():
        shape, name = tuple(v.shape), key.rsplit("/", 1)[1]
        if name == "weight":
            bound = math.sqrt(6.0 / math.prod(shape[:-1]))
            out[key] = rs.uniform(-bound, bound, shape)
        elif name in ("bias", "mean"):
            out[key] = 0.1 * rs.randn(*shape)
        else:  # BN scale and running var
            out[key] = rs.uniform(0.5, 1.5, shape)
        out[key] = out[key].astype(np.float32)
    return jser.unflatten_tree(out)


def jax_logits(jmodel, variables, x):
    # one compiled program: op-by-op dispatch compiles every primitive on its own
    fwd = jax.jit(lambda p, s, x: jmodel.apply(p, x, state=s)[0])
    return np.asarray(fwd(variables["params"], variables.get("state", {}), jnp.asarray(x)))


def to_torch(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def torch_logits(model, x):
    with torch.no_grad():
        return model.eval()(to_torch(x)).numpy()


def port_of(name, variables):
    with torch.device("meta"):  # no random init: every tensor comes from ``variables``
        model = MODELS[name][0]()
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)), assign=True)  # strict
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def built():
    """{name: (JAX model, variables, input)}, each built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            _, jbuild, shape, seed = MODELS[name]
            jmodel = jbuild()
            x = np.random.RandomState(seed + 10).randn(*shape).astype(np.float32)
            cache[name] = (jmodel, numpy_variables(jmodel, seed), x)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(built, name):
    jmodel, variables, x = built(name)
    y_j = jax_logits(jmodel, variables, x)
    assert y_j.shape == (x.shape[0], 10) and np.isfinite(y_j).all()
    assert rel(torch_logits(port_of(name, variables), x), y_j) < RTOL


@pytest.mark.parametrize("name", list(MODELS))
def test_params_round_trip(built, name):
    """The port's state_dict -> JAX flat leaves: every key and value of the JAX
    variables, and nothing else; and back to the same state_dict."""
    variables = built(name)[1]
    model = port_of(name, variables)
    flat = jser.flatten_tree(variables)
    back = params_to_jax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = params_from_jax(back)
    for k, t in model.state_dict().items():
        assert torch.equal(again[k], t), k


def test_block_children_in_jax_order():
    """register_switchable walks children in declaration order: the JAX one."""
    assert list(ResNet(18)._modules)[:4] == ["conv1", "bn1", "relu", "maxpool"]
    assert list(ResNet(18).layer2[0]._modules) == ["conv1", "bn1", "relu", "conv2", "bn2",
                                                   "downsample"]
    assert list(ResNet(50).layer1[0]._modules) == ["conv1", "bn1", "conv2", "bn2", "conv3",
                                                   "bn3", "relu", "downsample"]


# -- the scheme-1 ResNet-18 Runner ---------------------------------------------

@pytest.fixture(scope="module")
def scheme1(built, tmp_path_factory):
    """Both packages' Runners on the ResNet-18 config (no hooks) from the same
    checkpoint; (JAX runner, port runner, input)."""
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tmp = tmp_path_factory.mktemp("resnet18")
    jmodel, variables, x = built("resnet18")
    ckpt = str(tmp / "resnet18.ckpt.npz")
    jser.save_model(variables, ckpt)
    cfg = tmp / "resnet18_scheme1.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, RESNET18_CFG)!r}]\n"
                   f"model = dict(num_classes=10, init_cfg={ckpt!r})\n"
                   f"hooks = []\n")
    jcfg.init_cfg(str(cfg))
    jcfg.update_cfg(work_dir=str(tmp / "jax"), seed=0)
    jrunner = JRunner(rng=jax.random.key(0))
    # the checkpoint replaces the random init, which takes tens of seconds on one core
    with mock.patch.object(JResNet, "init", lambda self, rng: variables["params"]):
        jrunner.run()
    tcfg.init_cfg(str(cfg))
    tcfg.update_cfg(work_dir=str(tmp / "torch"), seed=0)
    runner = Runner(device="cpu")
    runner.run()
    return jrunner, runner, x


def test_resnet18_scheme1_runner_matches_jax(scheme1):
    jrunner, runner, x = scheme1
    names = runner.model.switchable_names
    assert names == jrunner.model.switchable_names
    assert len(names) == 16 and names[0] == "layer1.0.conv1" and names[-1] == "layer4.1.conv2"
    assert not any("downsample" in n for n in names)
    layers = [runner.model.get_switchable_module(i) for i in range(16)]
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert all(isinstance(m, LowRankExpConvV1) and m.uses_kernel() for m in layers)
    assert all(m.num_base == 4 and hasattr(m.s_conv, "v_conv") for m in layers)
    assert [m.stride for m in layers].count((2, 2)) == 3
    v = jrunner.variables
    y_j = jax_logits(jrunner.model, v, x)
    # each package solved its own SVDs (two LAPACK calls, then a rank-1 split of
    # every basis), and 16 layers carry their rounding to the logits
    assert rel(torch_logits(runner.model, x), y_j) < SOLVE_TOL
    # the JAX package's solved parameters carried across: the same function
    carried = ResNet(18, 10)
    for name, layer in zip(names, layers):
        set_submodule(carried, name, _like(layer))
    carried.load_state_dict(params_from_jax(jser.flatten_tree(v)))  # strict
    assert rel(torch_logits(carried.to(memory_format=torch.channels_last), x), y_j) < RTOL


def _like(layer):
    return LowRankExpConvV1(layer.in_channels, layer.out_channels, layer.kernel_size,
                            layer.stride, layer.padding, layer.num_base, decomp=True)


def test_fold_through_scheme1_repacks_the_kernel_weights(scheme1):
    """20 pairs fold on the scheme-1 ResNet-18, 16 of them through
    LowRankExpConvV1.d_conv; the logits stay; each layer's packed kernel
    weights are packed again from the folded d_conv."""
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    _, runner, x = scheme1
    model = runner.model
    layers = [model.get_switchable_module(i) for i in range(16)]
    with torch.no_grad():
        before = [m.packed() for m in layers]
        old_b = [p["b"].clone() for p in before]
    y0 = torch_logits(model, x)
    assert deploy.fold_batchnorm(model) == 20
    assert not any(type(m).__name__ == "BatchNorm2d" for m in model.modules())
    assert rel(torch_logits(model, x), y0) < FOLD_TOL
    for m, old, b in zip(layers, before, old_b):
        with torch.no_grad():
            new = m.packed()
        assert new is not old
        want = lowrank_ops.lowrank_params_from_module(m)
        assert torch.equal(new["A_mc"], want["A_mc"]) and torch.equal(new["b"], want["b"])
        assert not torch.equal(new["b"], b)
        kernel = lowrank_ops.pack_kernel_weights(want["A_mc"], v=want["v"], h=want["h"])
        assert torch.equal(new["kernel"]["w"], kernel["w"])


# -- fold and int8 ---------------------------------------------------------------

@pytest.mark.parametrize("name,pairs", [("resnet18", 20), ("resnet50", 53)])
def test_fold_batchnorm_counts_like_jax(built, name, pairs):
    _, variables, x = built(name)
    model = port_of(name, variables)
    y0 = torch_logits(model, x)
    assert deploy.fold_batchnorm(model) == pairs
    assert rel(torch_logits(model, x), y0) < FOLD_TOL
    assert deploy.fold_batchnorm(model) == 0  # nothing left to fold
    if name == "resnet18":  # the JAX fold of the same model (ResNet-50's: the int8 test)
        jvars = jax.tree_util.tree_map(lambda a: a, variables)
        assert jdeploy.fold_batchnorm(MODELS[name][1](), jvars) == pairs


@pytest.fixture(scope="module")
def int8_resnet50(built):
    """ResNet-50 folded and quantized by each package on the same two
    calibration batches, from the same weights: the counts, both folds, the
    port's float and int8 logits, the JAX package's int8 logits, and the port's
    int8 model run on the JAX package's int8 parameters."""
    _, variables, x = built("resnet50")
    jmodel = MODELS["resnet50"][1]()
    jvars = jax.tree_util.tree_map(lambda a: a, variables)
    model = port_of("resnet50", variables)
    rs = np.random.RandomState(7)
    calib = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    n_fold = (deploy.fold_batchnorm(model), jdeploy.fold_batchnorm(jmodel, jvars))
    folds = (params_to_jax(model.state_dict()), jser.flatten_tree(jvars))
    y_f = torch_logits(model, x)
    n = (deploy.quantize_int8(model, [to_torch(c) for c in calib]),
         jdeploy.quantize_int8(jmodel, jvars, [jnp.asarray(c) for c in calib]))
    y_own = torch_logits(model, x)
    model.load_state_dict(params_from_jax(jser.flatten_tree(jvars)))  # strict
    return dict(model=model, jparams=jvars["params"], n_fold=n_fold, folds=folds, n=n,
                y_f=y_f, y_own=y_own, y_j=jax_logits(jmodel, jvars, x),
                y_carried=torch_logits(model, x))


def test_quantize_int8_resnet50_counts_like_jax(int8_resnet50):
    d = int8_resnet50
    assert d["n_fold"] == (53, 53)
    assert d["n"] == (54, 54)  # every groups == 1 conv (53) and the fc
    ours, theirs = d["folds"]
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():  # the same fold, up to the last bit of its rounding
        assert rel(ours[k], v) < FOLD_TOL, k
    quantized = {p: m for p, m in d["model"].named_modules()
                 if isinstance(m, (QuantConv2d, QuantLinear))}
    assert len(quantized) == 54 and isinstance(quantized["fc"], QuantLinear)
    assert quantized["conv1"].kernel_size == (7, 7) and not quantized["conv1"].patchify


def test_quantize_int8_resnet50_logits_match_jax(int8_resnet50):
    """The port's int8 forward on the JAX package's int8 parameters gives its
    logits.  The port's own int8 model is another int8 function of the same
    float model: the two folds differ in the last bit of a few weights and
    biases (XLA fuses the fold's multiply-adds), which moves a few roundings to
    int8, and 54 quantized layers of random weights carry that to the logits
    (2.5e-2 relative, as large as int8 against float32); it is held to the
    float32 model instead."""
    d = int8_resnet50
    assert rel(d["y_carried"], d["y_j"]) < RTOL
    for y in (d["y_own"], d["y_carried"]):
        assert 1e-4 < float(np.abs(y - d["y_f"]).max() / np.abs(d["y_f"]).max()) < 0.12


# -- the configs through the CLI at small hook shapes ------------------------------

def _cli(tmp_path, base, text):
    from convnet_approximater_tpu_torch import main as cli

    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, base)!r}]\n" + text)
    work = tmp_path / "run"
    runner = cli.main(["--config", str(cfg), "--device", "cpu", "--seed", "0",
                       "--work-dir", str(work)])
    return runner, (work / "run.log").read_text()


SMALL_HOOKS = ("hooks = [dict(type='ModelAnalysis', priority=40, input_shape=(32, 32, 3),\n"
               "              batch_size=1),\n"
               "         dict(type='InferenceTimeHook', priority=50,\n"
               "              infer_cfg=dict(input_size=(1, 32, 32, 3), num_iters=1, warmup=1))]\n")


@pytest.mark.parametrize("base,sites,bases", [
    (RESNET18_CFG, 16, 4),
    ("configs/resnet/low-rank-exp-v1_blocks_svd_initdecomp_resnet18.py", 16, 4),
    ("configs/vgg/low-rank-exp-v1_all_svd_vgg16.py", 12, 16),
], ids=["resnet18", "resnet18-initdecomp", "vgg16"])
def test_cli_runs_scheme1_configs_on_cpu(tmp_path, base, sites, bases):
    runner, log = _cli(tmp_path, base, SMALL_HOOKS)
    model = runner.model
    assert model.length_switchable == sites
    layers = list(model.switchable_modules())
    assert all(isinstance(m, LowRankExpConvV1) and m.num_base == bases
               and hasattr(m.s_conv, "v_conv") for m in layers)
    assert "Model MACs: " in log and "Forward time (batch 1): median" in log
    if "vgg" in base:
        assert model.switchable_names[0] == "features.2"  # the stem stays dense


def test_cli_runs_serve_int8_resnet50_on_cpu(tmp_path):
    """The Dummy app finds no site; the served form comes from the deploy passes."""
    runner, log = _cli(tmp_path, "configs/resnet/serve_int8_resnet50.py", "")
    model = runner.model
    assert model.length_switchable == 0 and "0 switchable submodules" in log
    assert deploy.fold_batchnorm(model) == 53
    calib = [torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(i))
             .contiguous(memory_format=torch.channels_last) for i in range(2)]
    assert deploy.quantize_int8(model, calib) == 54
    with torch.no_grad():
        y = model(calib[0])
    assert y.shape == (1, 1000) and torch.isfinite(y).all()
