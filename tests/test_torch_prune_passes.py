"""The width-pruning structure passes of the port (``deploy.prune_chains``,
``prune_trunks``, ``prune_width``) against the JAX package's.

Each case builds the JAX model, draws its variables from a seed (numpy, into
the shapes of the JAX init; BN statistics, norm gains and layer scales of
order 1, so that every channel and block moves the logits), carries them into
the port (``convert.params_from_jax``), runs the
pass in both packages and compares: the module widths (every ``in_/out_``
channel and feature count, ``groups``, ``num_features`` and the width
attributes of the blocks), every parameter and buffer (bit-equal where it is a
slice of the original; where prune_chains refits a consumer on
``calib_batches``, the consumer's outputs on its calibration inputs within 1e-4
relative of the same consumer holding JAX's solution), and the logits
of the pruned model on a seeded batch, within 1e-4 relative (both packages
sum float32 products, in another order).  Models: ResNet-18 and VGG-16 at 32^2,
the tiny MSCAN of ``test_torch_pipeline.py`` and a narrow ConvNeXt at 64^2, and
a narrow conv stack with BatchNorm, a max pool and two Linears (16^2) for
prune_chains' calibrated refit.

Then the Runner on tiny copies of the three ``configs/prune/`` configs (the
structure passes, a few fine-tune steps, the checkpoint reloaded through the
same config with ``Runner.restore``), the asym teacher of a run with structure
passes (the unpruned model), and the pruned models composed with MscaRep,
DwSepRep and ``quantize_int8`` through the plain versions.
"""

import copy
import functools
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.models import build_model  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.nn import (GELU, BatchNorm2d, Conv2d, Linear,  # noqa: E402
                                               MaxPool2d, ReLU, channels_last)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
TINY_MSCAN = dict(type="MSCAN_Classifier", num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 2, 1),
                  exp_ratios=(2, 2, 2, 2), num_classes=16)
TINY_CONVNEXT = dict(type="ConvNeXt", depths=(1, 1, 2, 1), dims=(16, 24, 32, 48), num_classes=10,
                     layer_scale=1.0)
MODELS = {"ResNet18": (dict(type="ResNet", depth=18, num_classes=10), 32),
          "VGG16": (dict(type="VGG", depth=16, num_classes=10), 32),
          "MSCAN": (TINY_MSCAN, 64), "ConvNeXt": (TINY_CONVNEXT, 64)}
WIDTH_ATTRS = ("in_channels", "out_channels", "groups", "in_features", "out_features",
               "num_features", "num_channel", "hidden_channel", "inner_channel", "dim", "hidden")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def to_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def randomized(model, seed: int = 0) -> dict:
    """Variables of the JAX ``model``, drawn with numpy from ``seed`` into the
    shapes of ``model.init`` (its own init compiles for tens of seconds on the
    CPU): conv and Linear weights and biases uniform in ``±1/sqrt(fan_in)``,
    norm gains in [0.2, 2], layer scales and BN variances in [0.5, 1.5], BN
    means of order 0.1, so that every channel and block moves the logits."""
    shapes = jser.flatten_tree(jax.eval_shape(model.init, jax.random.key(seed)))
    state = jser.flatten_tree(model.init_state())
    rs = np.random.RandomState(seed)
    flat = {}
    for k in sorted(shapes):
        shape, name = shapes[k].shape, k.rsplit("/", 1)[1]
        if name == "scale":
            v = rs.uniform(0.2, 2.0, shape)
        elif name in ("weight", "bias"):
            w = shapes.get(k.rsplit("/", 1)[0] + "/weight", shapes[k]).shape
            bound = float(np.prod(w[:-1])) ** -0.5
            v = rs.uniform(-bound, bound, shape)
        else:  # layer scales
            v = rs.uniform(0.5, 1.5, shape)
        flat["params/" + k] = v.astype(np.float32)
    for k, v in state.items():
        shape = np.shape(v)
        v = 0.1 * rs.randn(*shape) if k.endswith("mean") else rs.uniform(0.5, 1.5, shape)
        flat["state/" + k] = v.astype(np.float32)
    tree = jser.unflatten_tree(flat)
    tree.setdefault("state", {})
    return tree


@functools.lru_cache(maxsize=None)
def _variables_of(name: str, seed: int) -> dict:
    return jser.flatten_tree(randomized(jbuild(dict(MODELS[name][0])), seed))


def port_of(jmodel, variables, cfg=None, model=None):
    """The port's model of ``cfg`` (or ``model``) holding ``variables``, in
    ``channels_last`` and eval mode."""
    model = model if model is not None else build_model(dict(cfg))
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))  # strict
    return channels_last(model).eval()


def pair(name, seed: int = 0):
    """A fresh JAX model of ``MODELS[name]`` and its variables (drawn once per
    name and seed, copied for each call), the port's model holding them, and
    the image size."""
    cfg, size = MODELS[name]
    jmodel = jbuild(dict(cfg))
    variables = jser.unflatten_tree({k: np.array(v) for k, v in _variables_of(name, seed).items()})
    variables.setdefault("state", {})
    return jmodel, variables, port_of(jmodel, variables, cfg), size


def batch(size, n: int = 2, seed: int = 5):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def jax_logits(jmodel, variables, x):
    def fwd(params, state, x):
        return jmodel.apply(params, x, state=state, training=False)[0]

    return np.asarray(jax.jit(fwd)(variables["params"], variables["state"], jnp.asarray(x)))


def port_logits(model, x):
    with torch.no_grad():
        return model.eval()(to_torch(x)).numpy()


def widths(model):
    """{path: {width attribute: value}} of every module that has one."""
    out = {}
    for path, m in model.named_modules():
        got = {a: getattr(m, a) for a in WIDTH_ATTRS if isinstance(getattr(m, a, None), int)}
        if got:
            out[path] = got
    return out


def assert_same_pruned(jmodel, variables, model, refit=()):
    """Widths equal, and every tensor bit-equal but the solved ones of the
    modules in ``refit`` (those only of the same shape)."""
    jw, tw = widths(jmodel), widths(model)
    for path, attrs in tw.items():
        for a, v in attrs.items():
            if path in jw and a in jw[path]:
                assert jw[path][a] == v, (path, a, jw[path][a], v)
    want = {k: np.asarray(v) for k, v in jser.flatten_tree(variables).items()}
    got = params_to_jax(model.state_dict())
    assert set(got) == set(want), set(got) ^ set(want)
    solved = {f"params/{p.replace('.', '/')}/{leaf}" for p in refit for leaf in ("weight", "bias")}
    for k, v in want.items():
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        if k not in solved:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def assert_same_logits(jmodel, variables, model, size):
    x = batch(size)
    y_j = jax_logits(jmodel, variables, x)
    y = port_logits(model, x)
    assert np.isfinite(y).all()
    assert rel(y, y_j) < RTOL


# -- prune_chains --------------------------------------------------------------
@pytest.mark.parametrize("name,junctions", [("ResNet18", 8), ("VGG16", 14), ("MSCAN", 1)])
def test_prune_chains_matches_jax(name, junctions):
    jmodel, variables, model, size = pair(name)
    n_j = jdeploy.prune_chains(jmodel, variables, keep_ratio=0.5, round_to=None)
    n = deploy.prune_chains(model, keep_ratio=0.5, round_to=None)
    assert n == n_j == junctions
    assert_same_pruned(jmodel, variables, model)
    assert_same_logits(jmodel, variables, model, size)


class JChain(JSwitchableModel):
    """Convs with BatchNorm, a max pool and a 5x5, then two Linears."""

    def __init__(self):
        super().__init__()
        self.features = jnn.Sequential(
            jnn.Conv2d(3, 8, 3, padding=1), jnn.BatchNorm2d(8), jnn.ReLU(),
            jnn.Conv2d(8, 12, 5, padding=2), jnn.BatchNorm2d(12), jnn.ReLU(), jnn.MaxPool2d(2, 2),
            jnn.Conv2d(12, 16, 3, padding=1), jnn.ReLU())
        self.classifier = jnn.Sequential(jnn.Linear(16, 24), jnn.ReLU(), jnn.Linear(24, 4))

    def __call__(self, params, x, ctx):
        x = self.child("features", params, x, ctx)
        return self.child("classifier", params, x.mean(axis=(1, 2)), ctx)


class Chain(SwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = torch.nn.Sequential(
            Conv2d(3, 8, 3, padding=1), BatchNorm2d(8), ReLU(),
            Conv2d(8, 12, 5, padding=2), BatchNorm2d(12), ReLU(), MaxPool2d(2, 2),
            Conv2d(12, 16, 3, padding=1), ReLU())
        self.classifier = torch.nn.Sequential(Linear(16, 24), ReLU(), Linear(24, 4))

    def forward(self, x):
        return self.classifier(self.features(x).mean(dim=(2, 3)))


class JMlp(JSwitchableModel):
    def __init__(self):
        super().__init__()
        self.mlp = jnn.Sequential(jnn.Linear(16, 24), jnn.GELU(), jnn.Linear(24, 8))

    def __call__(self, params, x, ctx):
        return self.child("mlp", params, x, ctx)


class Mlp(SwitchableModel):
    def __init__(self):
        super().__init__()
        self.mlp = torch.nn.Sequential(Linear(16, 24), GELU(), Linear(24, 8))

    def forward(self, x):
        return self.mlp(x)


def refit_outputs(model, path, batches):
    """The outputs of ``model``'s module at ``path`` on its own inputs over ``batches``."""
    xs = []
    handle = model.get_submodule(path).register_forward_pre_hook(
        lambda mod, inputs: xs.append(inputs[0]))
    with torch.no_grad():
        for x in batches:
            model(x)
        handle.remove()
        return torch.cat([model.get_submodule(path)(x) for x in xs]).numpy()


CHAINS = {  # name: (JAX model, port model, calibration batches, junctions, refit consumers)
    "conv": (JChain, Chain, [batch(16, 4, seed) for seed in (11, 12)], 3,
             ("features.3", "features.7")),
    "linear": (JMlp, Mlp, [np.random.RandomState(seed).randn(32, 16).astype(np.float32)
                           for seed in (11, 12)], 1, ("mlp.2",))}


@pytest.mark.parametrize("calibrated", [False, True], ids=["weights", "calib_batches"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_prune_chains_calibrated_refit_matches_jax(chain, calibrated):
    """With ``calib_batches`` the consumers are refit in closed form (a conv on
    its patch Gram, a Linear on its input Gram): the kept sets and slices are
    JAX's, and each refit consumer's outputs on its calibration inputs are
    within 1e-4 of the same module holding JAX's solution.  The solves
    themselves are float32 normal equations whose condition numbers reach
    1e4 here, so their solutions agree only to about 1e-4 in either order of
    summation; the fit they make is what both packages agree on."""
    jklass, klass, calib, junctions, refit = CHAINS[chain]
    jmodel = jklass()
    variables = randomized(jmodel, 3)
    model = port_of(jmodel, variables, model=klass())
    conv = chain == "conv"
    tcalib = [to_torch(c) if conv else torch.from_numpy(c) for c in calib]
    n_j = jdeploy.prune_chains(jmodel, variables, keep_ratio=0.5, round_to=None,
                               calib_batches=[jnp.asarray(c) for c in calib] if calibrated
                               else None)
    n = deploy.prune_chains(model, keep_ratio=0.5, round_to=None,
                            calib_batches=tcalib if calibrated else None)
    assert n == n_j == junctions
    refit = refit if calibrated else ()
    assert all(model.get_submodule(p).bias is not None for p in refit)
    assert_same_pruned(jmodel, variables, model, refit=refit)
    solved = port_of(jmodel, variables, model=copy.deepcopy(model))  # JAX's solution
    for p in refit:
        assert rel(refit_outputs(model, p, tcalib), refit_outputs(solved, p, tcalib)) < RTOL, p
    if conv:
        assert_same_logits(jmodel, variables, model, 16)
    else:
        x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
        y_j = np.asarray(jmodel.apply(variables["params"], jnp.asarray(x))[0])
        assert rel(model(torch.from_numpy(x)).detach().numpy(), y_j) < RTOL


def test_prune_chains_refit_guard_slices_on_too_few_samples(caplog):
    """Fewer calibration patches than twice the unknowns: sliced, not refit."""
    jmodel = JChain()
    variables = randomized(jmodel, 3)
    model = port_of(jmodel, variables, model=Chain())
    calib = [batch(4, 1, 13)]  # 4x4 maps: 0 patches of 5x5, 1 image for the Linear
    jdeploy.prune_chains(jmodel, variables, 0.5, round_to=None, calib_batches=[jnp.asarray(calib[0])])
    deploy.prune_chains(model, 0.5, round_to=None, calib_batches=[to_torch(calib[0])])
    assert_same_pruned(jmodel, variables, model)
    assert model.features[3].bias is not None and model.classifier[2].in_features == 12


# -- prune_trunks and prune_width ----------------------------------------------
@pytest.mark.parametrize("name,groups", [("ResNet18", 4), ("MSCAN", 4), ("ConvNeXt", 4)])
def test_prune_trunks_matches_jax(name, groups):
    jmodel, variables, model, size = pair(name)
    n_j = jdeploy.prune_trunks(jmodel, variables, keep_ratio=0.5, round_to=None)
    n = deploy.prune_trunks(model, keep_ratio=0.5, round_to=None)
    assert n == n_j == groups
    assert_same_pruned(jmodel, variables, model)
    assert_same_logits(jmodel, variables, model, size)


@pytest.mark.parametrize("name,sites", [("MSCAN", 4 + 1 + 5 + 5), ("ConvNeXt", 4 + 5)])
def test_prune_width_matches_jax_and_keeps_the_registration(name, sites):
    """Trunks, chains and the width apps; each app's projection is sliced (no
    calibration), so every tensor is bit-equal; the registration a caller made
    is restored."""
    jmodel, variables, model, size = pair(name)
    jmodel.register_switchable(jnn.Conv2d, [])
    model.register_switchable(torch.nn.Conv2d, [])
    before = model.switchable_names
    n_j = jdeploy.prune_width(jmodel, variables, keep_ratio=0.5, round_to=None,
                              ffn_round_to=None)
    n = deploy.prune_width(model, keep_ratio=0.5, round_to=None, ffn_round_to=None)
    assert n == n_j == sites
    assert model.switchable_names == before == jmodel.switchable_names
    assert_same_pruned(jmodel, variables, model)
    assert_same_logits(jmodel, variables, model, size)


@pytest.mark.parametrize("fn,name,count", [("prune_chains", "VGG16", 14),
                                           ("prune_trunks", "ResNet18", 4),
                                           ("prune_width", "MSCAN", 15)])
def test_dry_run_counts_without_editing(fn, name, count):
    cfg, _ = MODELS[name]
    jmodel = jbuild(dict(cfg))
    model = build_model(dict(cfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_j = getattr(jdeploy, fn)(jmodel, {"params": {}, "state": {}}, 0.5, dry_run=True)
    assert getattr(deploy, fn)(model, 0.5, dry_run=True) == n_j == count
    after = model.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], v) for k, v in before.items())


def test_prune_round_is_python_round():
    for k, M, r, want in ((320, 640, 128, 256), (448, 640, 128, 512), (5, 8, 16, 5),
                          (0, 8, None, 1), (96, 192, 64, 128), (32, 64, 64, 32)):
        assert deploy._prune_round(k, M, r) == jdeploy._prune_round(k, M, r) == want


def test_sliced_parameters_are_new_and_keep_channels_last():
    """A pass installs new parameters (the kernels' packed caches key on the
    tensors), 4-d ones in ``channels_last``, on the model's device."""
    _, _, model, _ = pair("ResNet18")
    old = {n: p for n, p in model.named_parameters()}
    deploy.prune_trunks(model, 0.5, round_to=None)
    new = dict(model.named_parameters())
    assert new["layer1.0.conv2.weight"] is not old["layer1.0.conv2.weight"]
    assert new["layer1.0.conv2.weight"].is_contiguous(memory_format=torch.channels_last)
    assert new["layer1.0.conv2.weight"].shape == (32, 64, 3, 3)
    assert isinstance(new["layer1.0.conv2.weight"], torch.nn.Parameter)


# -- the Runner ----------------------------------------------------------------
def write(tmp_path, name, text):
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    return str(path)


def run_port(cfg, work_dir, **updates):
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(work_dir), config_name="run", seed=0, **updates)
    runner = Runner(device="cpu")
    runner.run()
    return runner


def fresh_runner(cfg, work_dir, **updates):
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(work_dir), config_name="restored", seed=0, **updates)
    return Runner(device="cpu")


def finetune_hook(body, steps=2, px=32, classes=10):
    return (f"hooks = [dict(type='L2Reconstruct', priority=50, {body}\n"
            f"              dataset_args=dict(batch_size=4), data_config=dict(image_size=({px}, {px})),\n"
            f"              optim_args=dict(opt='adamw', lr=1e-4, weight_decay=0.01, clip_grad=1.0),\n"
            f"              sche_args=dict(epochs=1),\n"
            f"              other_args=dict(num_classes={classes}, max_steps_per_epoch={steps},\n"
            f"                              max_eval_batches=1, log_interval=1))]\n")


def pass_widths(cfg_model, passes):
    """The widths the JAX passes give the JAX model of ``cfg_model``."""
    jmodel = jbuild(dict(cfg_model))
    variables = randomized(jmodel)
    for p in passes:
        p = dict(p)
        getattr(jdeploy, p.pop("fn"))(jmodel, variables, **p)
    return widths(jmodel)


def assert_widths(model, want):
    got = widths(model)
    for path, attrs in want.items():
        for a, v in attrs.items():
            if path in got and a in got[path]:
                assert got[path][a] == v, (path, a)


def config(name):
    return os.path.join(REPO, "configs", name)


def test_runner_runs_the_resnet18_trunk_prune_config_and_restores_its_checkpoint(tmp_path):
    """``configs/prune/trunk-prune_ce_resnet18.py`` at 32^2, its CE fine-tune cut
    to 2 steps: 4 trunk groups and 8 junctions pruned in the Runner as the JAX
    passes prune them, every loss finite, and the last checkpoint loads back
    bit for bit through the same config, the passes replayed first."""
    cfg = write(tmp_path, "tiny_trunk", f"_base_ = [{config('prune/trunk-prune_ce_resnet18.py')!r}]\n"
                + finetune_hook("asym=True, no_norm=True, l2_weight=0.0, cls_weight=1.0,"))
    runner = run_port(cfg, tmp_path / "run")
    log = (tmp_path / "run" / "summary.csv").read_text()
    assert "nan" not in log
    assert_widths(runner.model, pass_widths(runner.cfg.model, runner.cfg.structure_passes))
    assert runner.model.layer1[0].conv2.in_channels == 32 and runner.model.fc.in_features == 256
    restored = fresh_runner(cfg, tmp_path / "restored")
    restored.restore(str(tmp_path / "run" / "last.ckpt.npz"))
    want = runner.model.state_dict()
    got = restored.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    x = to_torch(batch(32))
    with torch.no_grad():
        assert torch.equal(restored.model.eval()(x), runner.model.eval()(x))


@pytest.mark.parametrize("cfg_name,pass_count", [
    ("prune/chain-prune_ce_vgg16.py", "prune_chains: 14 sites"),
    (None, "prune_width: 15 sites")])
def test_runner_structure_pass_replays_through_the_same_config(tmp_path, cfg_name, pass_count):
    """The VGG-16 chain-prune config (its fine-tune left out) and a
    ``prune_width`` config of the tiny MSCAN (the JAX package's quad test,
    ``tests/test_prune_trunks.py``): the Runner saves the pruned model, and a
    fresh Runner of the same config restores it bit for bit."""
    if cfg_name is None:
        text = (f"model = {TINY_MSCAN!r}\napp = dict(type='Dummy')\nfilters = []\n"
                "structure_passes = [dict(fn='prune_width', keep_ratio=0.5, round_to=None,"
                " ffn_round_to=None)]\nhooks = []\n")
    else:
        text = f"_base_ = [{config(cfg_name)!r}]\nhooks = []\n"
    cfg = write(tmp_path, "replay", text)
    from convnet_approximater_tpu_torch.utils import build_logger

    build_logger(str(tmp_path / "run.log"))
    runner = run_port(cfg, tmp_path / "run")
    assert f"structure pass {pass_count}" in (tmp_path / "run.log").read_text()
    if cfg_name is None:  # trunks, inner widths and hiddens halved
        blk = runner.model.backbone.layers[3][1][0]
        assert (blk.num_channel, blk.attn.inner_channel, blk.mlp.hidden_channel) == (16, 16, 32)
    else:
        assert_widths(runner.model, pass_widths(runner.cfg.model, runner.cfg.structure_passes))
    restored = fresh_runner(cfg, tmp_path / "restored")
    restored.restore(str(tmp_path / "run" / "run.pt"))
    want, got = runner.model.state_dict(), restored.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(RuntimeError):  # a checkpoint of another structure does not load
        fresh_runner(cfg, tmp_path / "dense", structure_passes=[]).restore(
            str(tmp_path / "run" / "run.pt"))


def test_runner_runs_the_ffn_prune_config(tmp_path):
    """``configs/prune/ffn-prune_dd_l2-asym_mscan-t.py`` on the tiny MSCAN:
    calibration (2 batches of 8 at 128^2), FfnPrune(0.75) on its 5 FFNs with
    JAX's widths, the asym L2 fine-tune cut to 2 steps with every loss finite,
    and InferenceTimeHook at a small shape."""
    model = {k: v for k, v in TINY_MSCAN.items() if k != "type"}
    cfg = write(tmp_path, "tiny_ffn", (
        f"_base_ = [{config('prune/ffn-prune_dd_l2-asym_mscan-t.py')!r}]\n"
        f"model = dict({', '.join(f'{k}={v!r}' for k, v in model.items())})\n"
        "hooks = [dict(type='CalibrationHook', priority=40, num_batches=2, batch_size=8,\n"
        "              image_size=(128, 128)),\n"
        "         dict(type='InferenceTimeHook', priority=60,\n"
        "              infer_cfg=dict(input_size=(2, 64, 64, 3), num_iters=2, warmup=1))]\n"
        + finetune_hook("asym=True, l2_weight=1.0, cls_weight=0.0,", classes=16)
        .replace("hooks = [", "hooks = hooks + [")))
    runner = run_port(cfg, tmp_path / "run")
    assert [h.name for h in runner.hooks] == ["CalibrationHook", "L2Reconstruct",
                                                "InferenceTimeHook"]
    assert runner.model.length_switchable == 5
    assert [m.hidden_channel for m in runner.model.switchable_modules()] == [12, 24, 36, 36, 48]
    assert "nan" not in (tmp_path / "run" / "summary.csv").read_text()


@pytest.mark.parametrize("passes,body", [
    ("[dict(fn='prune_trunks', keep_ratio=0.5, round_to=None)]",
     "asym=True, no_norm=True, l2_weight=0.0, cls_weight=0.0, kd_weight=1.0,"),
    ("[dict(fn='fold_batchnorm')]", "asym=True, l2_weight=1.0, cls_weight=0.0, kd_weight=1.0,")],
    ids=["kd-prune_trunks", "l2-fold_batchnorm"])
def test_asym_teacher_is_the_model_before_the_structure_passes(tmp_path, passes, body):
    """The JAX hook rebuilds its teacher from the config and runs no pass: the
    port's asym teacher is the Runner's model from before its passes (unpruned,
    unfolded), with the app's sites on their ``old`` branch, and its logits
    are the dense model's."""
    model = {k: v for k, v in TINY_MSCAN.items() if k != "type"}
    head = (f"model = dict(type='MSCAN_Classifier', {', '.join(f'{k}={v!r}' for k, v in model.items())})\n"
            "app = dict(type='FfnPrune', keep_ratio=0.5)\nfilters = []\n")
    cfg = write(tmp_path, "teacher", head + f"structure_passes = {passes}\n"
                + finetune_hook(body, steps=1, classes=16))
    seen = {}
    from convnet_approximater_tpu_torch.hooks.finetune import L2Reconstruct

    build = L2Reconstruct._build_teacher

    def spy(hook):
        seen["teacher"] = build(hook)
        return seen["teacher"]

    L2Reconstruct._build_teacher = spy
    try:
        runner = run_port(cfg, tmp_path / "run")
    finally:
        L2Reconstruct._build_teacher = build
    teacher = seen["teacher"]
    dense = fresh_runner(write(tmp_path, "dense", head + "hooks = []\n"), tmp_path / "dense")
    dense.init_model()
    assert teacher.backbone.layers[0][0].proj[3].out_channels == 8
    assert sum(isinstance(m, BatchNorm2d) for m in teacher.modules()) == \
        sum(isinstance(m, BatchNorm2d) for m in dense.model.modules())
    assert [n for n, _ in teacher.named_modules() if n.endswith(".old")] == \
        [f"{n}.old" for n in runner.model.switchable_names]
    x = to_torch(batch(32))
    with torch.no_grad():
        np.testing.assert_array_equal(teacher(x).numpy(), dense.model.eval()(x).numpy())
    assert "nan" not in (tmp_path / "run" / "summary.csv").read_text()


# -- composition ---------------------------------------------------------------
def test_trunk_pruned_mscan_takes_mscarep_like_jax():
    """prune_trunks, then MscaRep(1, fix) on the pruned MSCAN: the JAX module
    path's logits (its stage 3-4 maps are below 2 fix_p, where the JAX Pallas
    strip is not a reference)."""
    from convnet_approximater_tpu import core as jcore
    from convnet_approximater_tpu.deploy_planner import apply_app as japply_app
    from convnet_approximater_tpu_torch import core
    from convnet_approximater_tpu_torch.deploy_planner import apply_app

    jmodel, variables, model, size = pair("MSCAN")
    jdeploy.prune_trunks(jmodel, variables, 0.5, round_to=None)
    deploy.prune_trunks(model, 0.5, round_to=None)
    assert japply_app(jmodel, variables, jcore.MscaRep(decomp=1, fix=True), [],
                      jax.random.key(0)) == 5
    assert apply_app(model, core.MscaRep(decomp=1, fix=True), []) == 5
    assert model.backbone.layers[3][1][0].attn.spatial_gating_unit.num_channel == 32
    assert_same_logits(jmodel, variables, model, size)


def test_pruned_convnext_takes_dwseprep_and_int8_like_jax():
    """prune_trunks and MlpPrune, then DwSepRep(1) on the dwconvs and
    ``quantize_int8`` on two calibration batches, through the plain versions:
    JAX's int8 logits within 1e-4, each package's module count."""
    from convnet_approximater_tpu import core as jcore
    from convnet_approximater_tpu import filters as jfilters
    from convnet_approximater_tpu.deploy_planner import apply_app as japply_app
    from convnet_approximater_tpu_torch import core, filters
    from convnet_approximater_tpu_torch.deploy_planner import apply_app

    jmodel, variables, model, size = pair("ConvNeXt")
    jdeploy.prune_trunks(jmodel, variables, 0.5, round_to=None)
    deploy.prune_trunks(model, 0.5, round_to=None)
    assert japply_app(jmodel, variables, jcore.MlpPrune(keep_ratio=0.5), [],
                      jax.random.key(0)) == 5
    assert apply_app(model, core.MlpPrune(keep_ratio=0.5), []) == 5
    assert japply_app(jmodel, variables, jcore.DwSepRep(ranks=1),
                      [jfilters.DepthwiseConvFilter()], jax.random.key(0)) == 5
    assert apply_app(model, core.DwSepRep(ranks=1), [filters.DepthwiseConvFilter()]) == 5
    assert_same_logits(jmodel, variables, model, size)
    calib = [batch(size, 2, seed) for seed in (31, 32)]
    n_j = jdeploy.quantize_int8(jmodel, variables, [jnp.asarray(c) for c in calib])
    n = deploy.quantize_int8(model, [to_torch(c) for c in calib])
    assert n == n_j == 15
    assert model.stages[3][0].pwconv1.weight_q.shape == (96, 24)  # trunk 48 -> 24, hidden 192 -> 96
    assert_same_logits(jmodel, variables, model, size)
