"""The slice as a whole on a tiny MSCAN: the port against the JAX package.

(a) the dense model's logits; (b) the Register/Initialize/Optimize/PostProcess
pipeline with ``MscaRep(decomp=1, fix=True)`` run by each package's ``Runner``
on the same carried-across weights; (c) the port's CLI end to end on the CPU.

Tolerance on logits: 1e-4 relative.  The two packages sum in another order
through 5 blocks and a head, and (b) adds an SVD per block from another LAPACK
call, whose rounding reaches the logits through the re-expanded kernels.
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
                                       ("structure_passes", [dict(fn="prune_chains")])])
def test_runner_rejects_unported_config_parts(tmp_path, key, value):
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(os.path.join(REPO, "configs/msca-rep/msca-rep_d1_fix_mscan-t.py"))
    tcfg.update_cfg(work_dir=str(tmp_path), **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        Runner(device="cpu")


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
