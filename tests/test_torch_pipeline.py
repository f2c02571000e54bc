"""The slices as a whole: the port against the JAX package.

On a tiny MSCAN: (a) the dense model's logits; (b) the Register/Initialize/
Optimize/PostProcess pipeline with ``MscaRep(decomp=1, fix=True)`` run by each
package's ``Runner`` on the same carried-across weights; (c) the port's CLI
end to end on the CPU.  On the full AlexNet (built once, in a module fixture):
the same three with ``LowRankExpV1`` on convs 2-5, the config's filters, and
``ModelAnalysis``'s parameter count.  Inputs are 127^2, where the last feature
map is 3x3, so the adaptive pool repeats bins and a flatten in the wrong order
would show.

Tolerance on logits: 1e-4 relative.  The two packages sum in another order
through the network, and (b) adds SVDs from another LAPACK call, whose
rounding reaches the logits through the re-expanded kernels.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 2, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=16)
RTOL = 1e-4


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def dense():
    """A tiny JAX MSCAN with random weights, BN running stats and layer scales
    (layer scales of order 1, so that every block's MSCA moves the logits)."""
    model = JClassifier(**TINY)
    variables = {"params": model.init(jax.random.key(0)), "state": model.init_state()}
    rs = np.random.RandomState(1)
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(variables).items()}
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = (0.1 * rs.randn(*flat[k].shape)).astype(np.float32)
        elif k.endswith("/var") or "layer_scale" in k:
            flat[k] = rs.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    return model, jser.unflatten_tree(flat)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)


def torch_logits(model, x):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        return model.eval()(xt).numpy()


def test_dense_logits_match_jax(dense, images):
    jmodel, variables = dense
    y_j = np.asarray(jmodel.apply(variables["params"], jax.numpy.asarray(images),
                                  state=variables["state"])[0])
    model = MSCAN_Classifier(**TINY).to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))
    assert y_j.shape == (2, 16)
    assert rel(torch_logits(model, images), y_j) < RTOL


def _config(tmp_path, ckpt):
    path = tmp_path / "tiny_d1_fix.py"
    path.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/msca-rep/msca-rep_d1_fix_mscan-t.py')!r}]\n"
        f"model = dict(num_channels={TINY['num_channels']}, num_blocks={TINY['num_blocks']},\n"
        f"             exp_ratios={TINY['exp_ratios']}, num_classes={TINY['num_classes']},\n"
        f"             init_cfg={ckpt!r})\n"
        f"hooks = []\n")
    return str(path)


def test_runner_d1_fix_matches_jax_runner(dense, images, tmp_path):
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    ckpt = str(tmp_path / "dense.ckpt.npz")
    jser.save_model(dense[1], ckpt)
    cfg = _config(tmp_path, ckpt)

    jcfg.init_cfg(cfg)
    jcfg.update_cfg(work_dir=str(tmp_path / "jax"), seed=0)
    jrunner = JRunner(rng=jax.random.key(0))
    jrunner.run()
    v = jrunner.variables
    y_j = np.asarray(jrunner.model.apply(v["params"], jax.numpy.asarray(images),
                                         state=v["state"])[0])

    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(tmp_path / "torch"), seed=0)
    runner = Runner(device="cpu")
    runner.run()
    assert runner.model.switchable_names == jrunner.model.switchable_names
    assert runner.model.length_switchable == 5
    assert os.path.exists(tmp_path / "torch" / "cfg.json")
    assert os.path.exists(tmp_path / "torch" / "tiny_d1_fix.pt")
    y = torch_logits(runner.model, images)
    assert rel(y, y_j) < RTOL
    # the rep changed the function: the dense logits are not what came out
    dense_model = MSCAN_Classifier(**TINY)
    dense_model.load_state_dict(params_from_jax(jser.flatten_tree(dense[1])))
    assert rel(torch_logits(dense_model, images), y_j) > 1e-3


@pytest.mark.parametrize("key,value", [("filters", [dict(type="IndicesFilter", indices=[1])]),
                                       ("structure_passes", [dict(fn="prune_chains",
                                                                  keep_ratio=0.5)])])
def test_runner_rejects_unported_config_parts(tmp_path, key, value):
    """Both parts are ported.  ``prune_chains`` (once refused) the Runner
    applies: MSCAN-t's one junction (the stem's 16-channel conv pair) pruned
    as the JAX pass prunes it on the same weights, and the app's 13 MSCA sites
    registered again on the pruned model.  Filters: the port's Runner
    registers what the JAX Runner registers with them."""
    from convnet_approximater_tpu import deploy as jdeploy
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.convert import params_to_jax
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    cfg = os.path.join(REPO, "configs/msca-rep/msca-rep_d1_fix_mscan-t.py")
    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(tmp_path), **{key: value})
    if key == "structure_passes":
        runner = Runner(device="cpu")
        runner.init_model()
        stem = runner.model.backbone.layers[0][0].proj
        assert (stem[0].out_channels, stem[1].num_features, stem[3].in_channels) == (8, 8, 8)
        assert runner.model.length_switchable == 13
        jmodel = JClassifier()
        variables = jser.unflatten_tree(params_to_jax(runner.model_before_passes.state_dict()))
        assert jdeploy.prune_chains(jmodel, variables, keep_ratio=0.5) == 1
        got = params_to_jax(stem.state_dict())
        want = jser.flatten_tree(variables["params"]["backbone"]["layers"]["0"]["0"]["proj"])
        want.update({"state/" + k: v for k, v in jser.flatten_tree(
            variables["state"]["backbone"]["layers"]["0"]["0"]["proj"]).items()})
        assert set(got) == {"params/" + k for k in want if not k.startswith("state/")} | \
            {k for k in want if k.startswith("state/")}
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k[len("params/"):]] if
                                                        k.startswith("params/") else want[k]))
        return
    runner = Runner(device="cpu")
    runner.model.register_switchable(runner.app.src_type, runner.filters)
    jcfg.init_cfg(cfg)
    jcfg.update_cfg(work_dir=str(tmp_path / "jax"), **{key: value})
    jrunner = JRunner(rng=jax.random.key(0))
    jrunner.model.register_switchable(jrunner.app.src_type, jrunner.filters)
    assert runner.model.switchable_names == jrunner.model.switchable_names
    assert runner.model.switchable_names == ["backbone.layers.0.1.0.attn.spatial_gating_unit"]


def test_cli_runs_tiny_config_on_cpu(tmp_path):
    cfg = tmp_path / "tiny_cli.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/_base_/models/mscan/mscan-t.py')!r}]\n"
        f"model = dict(num_channels={TINY['num_channels']}, num_blocks={TINY['num_blocks']},\n"
        f"             exp_ratios={TINY['exp_ratios']}, num_classes={TINY['num_classes']})\n"
        f"app = dict(type='MscaRep', decomp=1, fix=True)\n"
        f"filters = []\n"
        f"hooks = [dict(type='InferenceTimeHook', priority=50,\n"
        f"              infer_cfg=dict(input_size=(2, 64, 64, 3), num_iters=2, warmup=1))]\n")
    work = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "convnet_approximater_tpu_torch.main", "--config", str(cfg),
         "--device", "cpu", "--work-dir", str(work)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    log = (work / "run.log").read_text()
    assert "5 switchable submodules" in log
    assert "PC energy retained" in log
    assert "Forward time (batch 2): median" in log and "on cpu" in log


def test_hooks_run_in_priority_order(tmp_path):
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(os.path.join(REPO, "configs/msca-rep/msca-rep_d1_fix_mscan-t.py"))
    hook = dict(type="InferenceTimeHook", infer_cfg=dict(input_size=(1, 3, 32, 32)))
    tcfg.update_cfg(work_dir=str(tmp_path), hooks=[dict(hook, priority=60),
                                                   dict(hook, priority="HIGH")])
    runner = Runner(device="cpu")
    assert [h.priority for h in runner.hooks] == [30, 60]
    assert runner.hooks[0].input_size == (1, 32, 32, 3)  # NCHW config tuple read as NHWC
    assert "InferenceTimeHook" in runner.hook_info().split("Stage after_run:")[1]


def test_inference_time_hook_rejects_unported_options():
    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook

    with pytest.raises(NotImplementedError, match="bf16"):
        InferenceTimeHook(None, 50, infer_cfg=dict(bf16=True))


def test_model_analysis_counts_fused_msca():
    """An MSCA block that ran msca_fused counts its own MACs; the count equals
    the module path's, where the hooks of its convs count."""
    from convnet_approximater_tpu_torch.hooks import count_macs
    from convnet_approximater_tpu_torch.layers import MSCA

    model = MSCAN_Classifier(**TINY).to(memory_format=torch.channels_last).eval()
    x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    fused = count_macs(model, x)
    mscas = [m for m in model.modules() if isinstance(m, MSCA)]
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert len(mscas) == 5 and all(m.can_fuse() for m in mscas)
    for m in mscas:
        m.train()
    assert count_macs(model, x) == fused > 0


def test_cli_needs_a_card_unless_told_cpu():
    from convnet_approximater_tpu_torch import main as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--config", os.path.join(REPO, "configs/msca-rep/msca-rep_d1_fix_mscan-t.py")])


def test_substitution_routes_and_drops_branches():
    from convnet_approximater_tpu_torch.layers import Substitution

    old, new = torch.nn.Identity(), torch.nn.Linear(2, 2)
    sub = Substitution(old, new)
    x = torch.ones(1, 2)
    assert torch.equal(sub(x), x)
    sub.switch_new(remove_old=False)
    assert torch.equal(sub(x), new(x)) and "old" in sub._modules
    sub.switch_old(remove_new=True)
    assert "new" not in sub._modules and torch.equal(sub(x), x)
    sub2 = Substitution(old, new)
    sub2.switch_new()
    assert "old" not in sub2._modules and sub2.new_module is new


# -- AlexNet with scheme-1 low-rank convs ------------------------------------

ALEX_DODECOMP = "configs/low-rank-exp/low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py"
ALEX_SVD = "configs/low-rank-exp/low-rank-exp-v1_l2345_svd_alexnet.py"
ALEX_NAMES = ["features.3", "features.6", "features.8", "features.10"]


@pytest.fixture(scope="module")
def alexnet(tmp_path_factory):
    """The full JAX AlexNet (10 classes) with random weights, and its npz."""
    from convnet_approximater_tpu.models import AlexNet as JAlexNet

    model = JAlexNet()
    variables = {"params": model.init(jax.random.key(3)), "state": model.init_state()}
    path = str(tmp_path_factory.mktemp("alexnet") / "alexnet.ckpt.npz")
    jser.save_model(variables, path)
    return model, variables, path


@pytest.fixture(scope="module")
def alex_images():
    return np.random.RandomState(4).randn(2, 127, 127, 3).astype(np.float32)


def test_alexnet_dense_logits_match_jax(alexnet, alex_images):
    from convnet_approximater_tpu_torch.hooks import count_params
    from convnet_approximater_tpu_torch.models import AlexNet

    jmodel, variables, _ = alexnet
    y_j = np.asarray(jmodel.apply(variables["params"], jax.numpy.asarray(alex_images))[0])
    model = AlexNet().to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))  # strict
    assert y_j.shape == (2, 10)
    assert rel(torch_logits(model, alex_images), y_j) < RTOL
    # the JAX package's ModelAnalysis counts every param leaf
    from convnet_approximater_tpu.hooks.model_analysis import count_params as jcount_params

    assert count_params(model) == jcount_params(variables["params"])


def test_alexnet_filters_register_like_jax():
    from convnet_approximater_tpu.filters import build_filter as jbuild_filter
    from convnet_approximater_tpu.models import AlexNet as JAlexNet
    from convnet_approximater_tpu.nn import Conv2d as JConv2d
    from convnet_approximater_tpu_torch.filters import build_filter
    from convnet_approximater_tpu_torch.models import AlexNet
    from convnet_approximater_tpu_torch.nn import Conv2d
    from convnet_approximater_tpu_torch.utils.config import Config

    cfg = Config(os.path.join(REPO, ALEX_DODECOMP))
    jmodel, model = JAlexNet(), AlexNet()
    jmodel.register_switchable(JConv2d, [jbuild_filter(f) for f in cfg.filters])
    model.register_switchable(Conv2d, [build_filter(f) for f in cfg.filters])
    assert model.switchable_names == jmodel.switchable_names == ALEX_NAMES
    # SimpleConvFilter alone passes all five convs; one without a bias fails it
    model.register_switchable(Conv2d, [build_filter(dict(type="SimpleConvFilter"))])
    assert model.length_switchable == 5
    assert not build_filter(dict(type="SimpleConvFilter"))(Conv2d(4, 4, 3, bias=False))


def _alex_config(tmp_path, base, ckpt, hooks):
    path = tmp_path / "alexnet_lowrank.py"
    path.write_text(f"_base_ = [{os.path.join(REPO, base)!r}]\n"
                    f"model = dict(init_cfg={ckpt!r})\n"
                    f"hooks = {hooks!r}\n")
    return str(path)


@pytest.mark.parametrize("base,hooks", [
    (ALEX_DODECOMP, []),
    (ALEX_SVD, []),
    (ALEX_SVD, [dict(type="LowRankExpV1Decomp", priority=50)]),
], ids=["dodecomp", "full-bases", "decomp-hook"])
def test_alexnet_runner_matches_jax_runner(alexnet, alex_images, tmp_path, base, hooks):
    from convnet_approximater_tpu.hooks.model_analysis import count_params as jcount_params
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.hooks import count_macs, count_params
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    cfg = _alex_config(tmp_path, base, alexnet[2], hooks)
    jcfg.init_cfg(cfg)
    jcfg.update_cfg(work_dir=str(tmp_path / "jax"), seed=0)
    jrunner = JRunner(rng=jax.random.key(0))
    jrunner.run()
    v = jrunner.variables
    y_j = np.asarray(jrunner.model.apply(v["params"], jax.numpy.asarray(alex_images))[0])

    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(tmp_path / "torch"), seed=0)
    runner = Runner(device="cpu")
    runner.run()
    model = runner.model
    assert model.switchable_names == jrunner.model.switchable_names == ALEX_NAMES
    layers = [model.get_switchable_module(i) for i in range(4)]
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert all(isinstance(m, LowRankExpConvV1) and m.uses_kernel() for m in layers)
    separable = base == ALEX_DODECOMP or bool(hooks)
    assert all(hasattr(m.s_conv, "v_conv") == separable for m in layers)
    assert [m.num_base for m in layers] == [8, 8, 6, 4]
    assert count_params(model) == jcount_params(v["params"])
    y = torch_logits(model, alex_images)
    assert rel(y, y_j) < RTOL
    # the low-rank model is another function than the dense one it came from
    assert rel(np.asarray(alexnet[0].apply(alexnet[1]["params"],
                                           jax.numpy.asarray(alex_images))[0]), y_j) > 1e-3
    # MACs: the kernel path counts through LowRankExpConvV1.macs, the module
    # path through the children's hooks; the two agree
    x = torch.zeros(1, 3, 127, 127).contiguous(memory_format=torch.channels_last)
    before = lowrank_ops.lowrank_conv.launches
    macs_kernel = count_macs(model, x)
    assert lowrank_ops.lowrank_conv.launches == before  # on the CPU the plain version ran
    for m in layers:
        m.train()
    assert count_macs(model, x) == macs_kernel
    for m in layers:
        m.eval()


def test_cli_runs_tiny_alexnet_config_on_cpu(tmp_path):
    cfg = tmp_path / "tiny_alexnet_cli.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, ALEX_DODECOMP)!r}]\n"
        f"hooks = [dict(type='ModelAnalysis', priority=40, input_shape=(63, 63, 3),\n"
        f"              batch_size=1),\n"
        f"         dict(type='InferenceTimeHook', priority=50,\n"
        f"              infer_cfg=dict(input_size=(1, 63, 63, 3), num_iters=2, warmup=1))]\n")
    work = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "convnet_approximater_tpu_torch.main", "--config", str(cfg),
         "--device", "cpu", "--work-dir", str(work)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    log = (work / "run.log").read_text()
    assert f"4 switchable submodules: {ALEX_NAMES}" in log
    assert "features.0 filtered out by IndicesFilter" in log
    assert log.count("PC Energy = ") == 4
    assert "Model MACs: " in log and "Params: 43.56 M" in log
    assert "Forward time (batch 1): median" in log and "on cpu" in log
