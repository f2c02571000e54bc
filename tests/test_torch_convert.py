"""Weights, checkpoints and configs carried between the JAX package and the port.

* ``params_from_jax`` maps the JAX param/state tree of MSCAN onto the port's
  ``state_dict`` key for key and shape, before and after MscaRep;
* the flat ``/``-joined npz (with its ``::dtype`` markers) reads and writes the
  same in both packages;
* both packages load the repository's config files to the same dict;
* the port imports no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.layers import MSCA as JMSCA  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu.utils.config import Config as JConfig  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.layers import MSCA  # noqa: E402
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.utils import serialize as tser  # noqa: E402
from convnet_approximater_tpu_torch.utils.config import Config  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 2, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=16)


def jax_tiny(rep: bool):
    model = JClassifier(**TINY)
    variables = {"params": model.init(jax.random.key(0)), "state": model.init_state()}
    if rep:
        app = JMscaRep(decomp=1, fix=True)
        model.register_switchable(JMSCA, [])
        for idx, name in enumerate(model.switchable_names):
            src = model.get_switchable_module(idx)
            sub, sp = app.initialize(src, jser.tree_get(variables["params"], name))
            app.optimize(sub, sp)
            module, new = app.postprocess(sub, sp)
            model.set_switchable_module(idx, module, variables, {"params": new})
    return model, variables


def torch_tiny(rep: bool):
    model = MSCAN_Classifier(**TINY)
    if rep:
        app = MscaRep(decomp=1, fix=True)
        model.register_switchable(MSCA, [])
        for idx in range(model.length_switchable):
            sub = app.initialize(model.get_switchable_module(idx))
            app.optimize(sub)
            model.set_switchable_module(idx, app.postprocess(sub))
    return model


@pytest.mark.parametrize("rep", [False, True])
def test_params_from_jax_maps_mscan_state_dict(rep):
    jmodel, variables = jax_tiny(rep)
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(variables).items()}
    converted = params_from_jax(flat)
    model = torch_tiny(rep)
    assert model.switchable_names == jmodel.switchable_names
    own = model.state_dict()
    assert sorted(converted) == sorted(own)
    for k, v in own.items():
        assert tuple(converted[k].shape) == tuple(v.shape), k
    model.load_state_dict(converted)  # strict
    key = "backbone.layers.0.1.0.attn.spatial_gating_unit.conv0.weight"
    np.testing.assert_array_equal(
        model.state_dict()[key].numpy(),
        np.transpose(flat["params/" + key.replace(".", "/")], (3, 2, 0, 1)))


def test_params_from_jax_carries_int8_and_gamma_leaves():
    """QuantConv2d's HWIO and QuantLinear's (in, out) int8 ``weight_q`` are
    transposed to OIHW and (out, in); ``w_scale``, the 0-d ``act_scale`` and
    ConvNeXt's ``gamma`` go across as they are."""
    from convnet_approximater_tpu.layers import quant as jquant
    from convnet_approximater_tpu.nn import Conv2d as JConv2d
    from convnet_approximater_tpu.nn import Linear as JLinear
    from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.models import ConvNeXt

    conv, lin = JConv2d(3, 8, 4, stride=4), JLinear(8, 5)
    _, qc = jquant.QuantConv2d.from_conv(conv, conv.init(jax.random.key(1)), 0.03)
    _, ql = jquant.QuantLinear.from_linear(lin, lin.init(jax.random.key(2)), 0.5)
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree({"params": {"c": qc, "l": ql}}).items()}
    state = params_from_jax(flat)
    assert state["c.weight_q"].dtype == torch.int8 and state["c.act_scale"].shape == ()
    np.testing.assert_array_equal(state["c.weight_q"].numpy(),
                                  flat["params/c/weight_q"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["l.weight_q"].numpy(), flat["params/l/weight_q"].T)
    model = torch.nn.ModuleDict({"c": QuantConv2d(3, 8, 4, stride=4), "l": QuantLinear(8, 5)})
    model.load_state_dict(state)  # strict
    assert float(model["l"].act_scale) == 0.5

    gamma = np.full(8, 0.25, np.float32)  # ConvNeXt's LayerScale leaf
    converted = params_from_jax({"params/stages/3/0/gamma/gamma": gamma})
    np.testing.assert_array_equal(converted["stages.3.0.gamma.gamma"].numpy(), gamma)
    model = ConvNeXt(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8), num_classes=4)
    model.load_state_dict(converted, strict=False)
    assert float(model.stages[3][0].gamma.gamma.detach()[0]) == 0.25


def test_params_from_jax_rejects_foreign_keys():
    with pytest.raises(ValueError, match="params"):
        params_from_jax({"opt_state/mu": np.zeros(3)})


def test_npz_round_trip_between_packages(tmp_path):
    import ml_dtypes

    rs = np.random.RandomState(0)
    tree = {"params": {"a": {"weight": rs.randn(3, 3, 1, 4).astype(np.float32)},
                       "b": rs.randn(5).astype(ml_dtypes.bfloat16)},
            "state": {"a": {"mean": rs.randn(4).astype(np.float32)}}}
    jax_path, torch_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_model(tree, jax_path)
    tser.save_model(tree, torch_path)
    want = jser.flatten_tree(tree)
    for got in (tser.load_flat(jax_path), jser.flatten_tree(jser.load_ckpt(torch_path))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    loaded = tser.load_ckpt(torch_path)
    assert tser.tree_get(loaded, "state.a.mean").shape == (4,)
    tser.tree_set(loaded, "state.b.var", 1)
    assert loaded["state"]["b"]["var"] == 1


@pytest.mark.parametrize("cfg", ["configs/msca-rep/msca-rep_d1_fix_mscan-t.py",
                                 "configs/msca-rep/dummy_mscan-t.py"])
def test_config_loads_like_jax(cfg, tmp_path):
    path = os.path.join(REPO, cfg)
    ours = Config(path)
    assert ours.dump() == JConfig(path).dump()
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(path)
    tcfg.save_cfg(str(tmp_path / "cfg.json"))
    import json

    with open(tmp_path / "cfg.json") as f:
        assert json.load(f)["app"] == {"type": "MscaRep", "decomp": 1, "fix": True} or \
            "dummy" in cfg


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import convnet_approximater_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib',\n"
        "             'convnet_approximater_tpu.')) or n == 'convnet_approximater_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
