"""The port's ConvNeXt and DwSepRep against the JAX package.

A tiny ConvNeXt (depths 1/1/2/1, dims 16/24/32/48, 10 classes) at 64^2 with
``layer_scale=1.0``, so that every block moves the logits (at the default
1e-6 the blocks would hide under any tolerance).  The JAX weights go across
through ``params_from_jax``.  DwSepRep is solved in each package on the same
weights: an SVD may flip the signs of both factors of a pair, so the
per-channel products ``u_j (x) v_j`` of each branch are compared, not the
factors.  Tolerance: 1e-5 relative, on the products and on the logits.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.core import DwSepRep as JDwSepRep  # noqa: E402
from convnet_approximater_tpu.filters import DepthwiseConvFilter as JDepthwiseConvFilter  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import DwSepRep  # noqa: E402
from convnet_approximater_tpu_torch.filters import DepthwiseConvFilter  # noqa: E402
from convnet_approximater_tpu_torch.hooks import count_macs, count_params  # noqa: E402
from convnet_approximater_tpu_torch.layers import CascadeConv, ParallelConv  # noqa: E402
from convnet_approximater_tpu_torch.models import ConvNeXt  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(depths=(1, 1, 2, 1), dims=(16, 24, 32, 48), num_classes=10, layer_scale=1.0)
NAMES = ["stages.0.0.dwconv", "stages.1.0.dwconv", "stages.2.0.dwconv", "stages.2.1.dwconv",
         "stages.3.0.dwconv"]
RTOL = 1e-5
R1_CONFIG = "configs/convnext/dw-sep-rep_r1_convnext-t.py"


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def dense():
    model = JConvNeXt(**TINY)
    return model, {"params": jax.jit(model.init)(jax.random.key(0))}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)


def jax_logits(model, variables, x):
    return np.asarray(jax.jit(lambda p, x: model.apply(p, x)[0])(variables["params"],
                                                                   jnp.asarray(x)))


def torch_model(variables):
    model = ConvNeXt(**TINY).to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))  # strict
    return model.eval()


def torch_logits(model, x):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return model.eval()(xt).numpy()


def jax_dwsep(dense, **app_kw):
    """DwSepRep on a copy of the dense JAX model, as the JAX Runner applies it."""
    model = JConvNeXt(**TINY)
    variables = jax.tree_util.tree_map(lambda v: v, dense[1])
    app = JDwSepRep(**app_kw)
    model.register_switchable(app.src_type, [JDepthwiseConvFilter()])
    for idx, name in enumerate(model.switchable_names):
        sub, sp = app.initialize(model.get_switchable_module(idx),
                                 jser.tree_get(variables["params"], name))
        app.optimize(sub, sp)
        module, new = app.postprocess(sub, sp)
        model.set_switchable_module(idx, module, variables, {"params": new})
    return model, variables


def torch_dwsep(dense, **app_kw):
    model = torch_model(dense[1])
    app = DwSepRep(**app_kw)
    model.register_switchable(Conv2d, [DepthwiseConvFilter()])
    for idx in range(model.length_switchable):
        sub = app.initialize(model.get_switchable_module(idx))
        app.optimize(sub)
        model.set_switchable_module(idx, app.postprocess(sub).eval())
    return model


def products(state, name):
    """Per branch, the (C, k, k) products conv2 taps (x) conv1 taps of a bank."""
    prefixes = sorted({k[:-len(".conv1.weight")] for k in state
                       if k.startswith(name + ".") and k.endswith(".conv1.weight")})
    return [state[p + ".conv2.weight"][:, 0, :, 0, None] * state[p + ".conv1.weight"][:, 0, 0, None, :]
            for p in prefixes]


def test_dense_logits_match_jax(dense, images):
    model = torch_model(dense[1])
    y_j = jax_logits(*dense, images)
    assert y_j.shape == (2, 10)
    assert rel(torch_logits(model, images), y_j) < RTOL
    from convnet_approximater_tpu.hooks.model_analysis import count_params as jcount_params

    assert count_params(model) == jcount_params(dense[1]["params"])


def test_gamma_is_the_layer_scale_leaf(dense):
    model = ConvNeXt(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8), num_classes=4)
    assert model.stages[0][0].gamma.gamma.detach()[0].item() == pytest.approx(1e-6)
    state = params_from_jax(jser.flatten_tree(dense[1]))
    np.testing.assert_array_equal(state["stages.2.1.gamma.gamma"].numpy(),
                                  np.asarray(dense[1]["params"]["stages"]["2"]["1"]["gamma"]
                                             ["gamma"]))


def test_filter_registers_the_block_dwconvs_like_jax():
    jmodel, model = JConvNeXt(**TINY), ConvNeXt(**TINY)
    jmodel.register_switchable(JDwSepRep(ranks=1).src_type, [JDepthwiseConvFilter()])
    model.register_switchable(DwSepRep(ranks=1).src_type, [DepthwiseConvFilter()])
    assert model.switchable_names == jmodel.switchable_names == NAMES


@pytest.mark.parametrize("app_kw,nbranches", [
    (dict(ranks=1), [1] * 5),
    (dict(ranks=2), [2] * 5),
    (dict(ranks=(1, 2, 3, 1, 7)), [1, 2, 3, 1, 7]),
    (dict(energy=0.9), None),
], ids=["r1", "r2", "ranks-tuple", "energy"])
def test_dwsep_rep_matches_jax(dense, images, app_kw, nbranches):
    jmodel, jvars = jax_dwsep(dense, **app_kw)
    model = torch_dwsep(dense, **app_kw)
    jstate = {k: v.numpy() for k, v in params_from_jax(jser.flatten_tree(jvars)).items()}
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(state) == sorted(jstate)
    for name in NAMES:
        mod = model.get_submodule(name)
        got, want = products(state, name), products(jstate, name)
        if nbranches is not None:
            assert len(got) == nbranches[NAMES.index(name)]
        assert isinstance(mod, CascadeConv if len(got) == 1 else ParallelConv)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert rel(g, w) < RTOL
        last = name + (".conv2.bias" if len(got) == 1 else f".branches.{len(got) - 1}.conv2.bias")
        np.testing.assert_allclose(state[last], jstate[last], rtol=1e-6)
    y_j = jax_logits(jmodel, jvars, images)
    assert rel(torch_logits(model, images), y_j) < RTOL
    # the rank cut changed the function (rank 7 of the tuple is exact on its layer only)
    assert rel(jax_logits(*dense, images), y_j) > 1e-4


def test_dwsep_rep_full_rank_is_exact(dense, images):
    model = torch_dwsep(dense, ranks=7)
    assert rel(torch_logits(model, images), jax_logits(*dense, images)) < RTOL


@pytest.mark.parametrize("rank", [2, 7])
def test_dwsep_rep_of_a_bias_less_conv_matches_jax(rank):
    """A bias-less source carries a zero bias onto the last branch's conv2."""
    from convnet_approximater_tpu.nn import Conv2d as JConv2d

    jconv = JConv2d(6, 6, 7, padding=3, groups=6, bias=False)
    params = jconv.init(jax.random.key(5))
    japp, app = JDwSepRep(ranks=rank), DwSepRep(ranks=rank)
    jsub, sp = japp.initialize(jconv, params)
    japp.optimize(jsub, sp)
    jtgt, jparams = japp.postprocess(jsub, sp)
    conv = Conv2d(6, 6, 7, padding=3, groups=6, bias=False)
    conv.load_state_dict(params_from_jax(jser.flatten_tree({"params": params})))
    sub = app.initialize(conv)
    app.optimize(sub)
    tgt = app.postprocess(sub).eval()
    assert not tgt.branches[-1].conv2.bias.detach().any()
    x = np.random.RandomState(6).randn(2, 9, 10, 6).astype(np.float32)
    y_j = np.asarray(jtgt.apply(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        y = tgt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel(y, y_j) < RTOL


def test_dwsep_rep_rejects_what_it_cannot_split():
    with pytest.raises(ValueError, match="exactly one"):
        DwSepRep()
    with pytest.raises(ValueError, match="depthwise"):
        DwSepRep(ranks=1).initialize(Conv2d(4, 8, 3, padding=1))
    with pytest.raises(ValueError, match="rank 4"):
        DwSepRep(ranks=4).initialize(Conv2d(4, 4, 3, padding=1, groups=4))
    app = DwSepRep(ranks=(1, 2))
    app.initialize(Conv2d(4, 4, 3, padding=1, groups=4))
    assert app._cur_rank() == 2
    app.rewind()
    assert app._cur_rank() == 1


def test_model_analysis_counts_the_kernel_path(dense):
    """Cascades that ran parallel_cascade count their own MACs; the count
    equals the module path's (where the hooks of their convs count)."""
    model = torch_dwsep(dense, ranks=2)
    x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    banks = [model.get_submodule(n) for n in NAMES]
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert all(b.uses_kernel() for b in banks)
    kernel = count_macs(model, x)
    for b in banks:
        b.train()
    assert count_macs(model, x) == kernel > 0


def _config(tmp_path, ckpt):
    path = tmp_path / "tiny_convnext_r1.py"
    path.write_text(
        f"_base_ = [{os.path.join(REPO, R1_CONFIG)!r}]\n"
        f"model = dict(depths={TINY['depths']}, dims={TINY['dims']}, layer_scale=1.0,\n"
        f"             num_classes={TINY['num_classes']}, init_cfg={ckpt!r})\n"
        f"hooks = []\n")
    return str(path)


def test_runner_r1_matches_jax_runner(dense, images, tmp_path):
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
    y_j = jax_logits(jrunner.model, jrunner.variables, images)

    tcfg.init_cfg(cfg)
    tcfg.update_cfg(work_dir=str(tmp_path / "torch"), seed=0)
    runner = Runner(device="cpu")
    runner.run()
    assert runner.model.switchable_names == jrunner.model.switchable_names == NAMES
    assert all(isinstance(runner.model.get_submodule(n), CascadeConv) for n in NAMES)
    assert rel(torch_logits(runner.model, images), y_j) < RTOL


def test_cli_runs_tiny_convnext_configs_on_cpu(tmp_path):
    for rank in (1, 2):
        cfg = tmp_path / f"tiny_cli_r{rank}.py"
        cfg.write_text(
            f"_base_ = [{os.path.join(REPO, R1_CONFIG.replace('r1', f'r{rank}'))!r}]\n"
            f"model = dict(depths={TINY['depths']}, dims={TINY['dims']}, num_classes=10)\n"
            f"hooks = [dict(type='ModelAnalysis', priority=40, input_shape=(32, 32, 3),\n"
            f"              batch_size=1),\n"
            f"         dict(type='InferenceTimeHook', priority=50,\n"
            f"              infer_cfg=dict(input_size=(1, 32, 32, 3), num_iters=2, warmup=1))]\n")
        work = tmp_path / f"run_r{rank}"
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "convnet_approximater_tpu_torch.main", "--config", str(cfg),
             "--device", "cpu", "--work-dir", str(work)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        log = (work / "run.log").read_text()
        assert f"5 switchable submodules: {NAMES}" in log
        assert "downsample_layers.0.0 filtered out by DepthwiseConvFilter" in log
        assert log.count("PC Energy = ") == 5
        assert "Model MACs: " in log and "Forward time (batch 1): median" in log
