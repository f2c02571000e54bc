"""Deploy mode of the port against the JAX package's: ``Approximater(deploy=True)``,
the Runner's ``deploy``/``skip_optim``/``skip_post``, ``ClassInference`` and
their CLIs.

* ``initialize`` in deploy mode returns the bare target (no ``Substitution``)
  with the weights JAX carries across (MscaRep: ``conv0`` and ``channel_mix``;
  FfnRep: ``fc2``; LowRankExpV1: the bias), and JAX's parameter names and
  shapes; a do_decomp app builds the separable target its checkpoint holds.
* The Runner's round trip (``tests/test_mscan_pipeline.py:57-71``): a solved
  MscaRep d1+fix run, then a deploy run of the same config on its checkpoint
  (the port's ``.pt``, and the JAX package's ``.ckpt.npz``), whose logits equal
  the solved model's (the port's bit for bit; JAX's at the JAX test's rtol
  1e-4, atol 1e-5).
* ``ClassInference`` on a small conv net with scheme-1 sites and on a tiny
  MSCAN with MscaRep, both packages on one dense ``init_cfg`` and one JAX
  checkpoint: each report's logits within 1e-4 of JAX's, the parameter
  counts equal, the never-lose table JAX's under a fake timer; the int8
  report runs; bf16, pipelining and the S2D stem are refused.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.deploy as jdeploy  # noqa: E402
import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu import core as jcore  # noqa: E402
from convnet_approximater_tpu.models import MODEL as JMODEL  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild  # noqa: E402
from convnet_approximater_tpu.runner import ClassInference as JClassInference  # noqa: E402
from convnet_approximater_tpu.runner import Runner as JRunner  # noqa: E402
from convnet_approximater_tpu.utils import init_cfg as jinit_cfg  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu.utils import update_cfg as jupdate_cfg  # noqa: E402
from convnet_approximater_tpu_torch import core  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch import inference as inference_cli  # noqa: E402
from convnet_approximater_tpu_torch import main as main_cli  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import SeparableConv, Substitution  # noqa: E402
from convnet_approximater_tpu_torch.models import MODEL, build_model  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear, ReLU, channels_last  # noqa: E402
from convnet_approximater_tpu_torch.runner import ClassInference, Runner  # noqa: E402
from convnet_approximater_tpu_torch.utils import init_cfg, update_cfg  # noqa: E402

torch.set_num_threads(1)
LOGITS_RTOL = 1e-4
MSCAN = dict(type="MSCAN_Classifier", num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2),
             num_classes=5)
V1_APP = ("dict(type='LowRankExpV1', num_bases=(2, 3), max_iter=0, lmda_length=1, "
          "min_lmda=0, max_lmda=0, init_method='svd')")


class JDeployNet(JSwitchableModel):
    """Two dense convs and a Linear head: two scheme-1 sites."""

    def __init__(self, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        self.features = jnn.Sequential(jnn.Conv2d(3, 8, 3, padding=1), jnn.ReLU(),
                                       jnn.Conv2d(8, 12, 3, padding=1), jnn.ReLU())
        self.head = jnn.Linear(12, 4)

    def __call__(self, params, x, ctx):
        return self.child("head", params, self.child("features", params, x, ctx).mean(
            axis=(1, 2)), ctx)


class DeployNet(SwitchableModel):
    def __init__(self, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        self.features = torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), ReLU(),
                                            Conv2d(8, 12, 3, padding=1), ReLU())
        self.head = Linear(12, 4)

    def forward(self, x):
        return self.head(self.features(x).mean(dim=(2, 3)))


for registry, cls in ((JMODEL, JDeployNet), (MODEL, DeployNet)):
    if "DeployNet" not in registry:
        registry.register_module(name="DeployNet")(cls)


def drawn(jmodel, seed: int) -> dict:
    """Variables of ``jmodel`` from numpy: weights uniform in ±1/sqrt(fan_in),
    norm gains and layer scales in [0.5, 1.5], BN means of order 0.1."""
    shapes = jser.flatten_tree(jax.eval_shape(jmodel.init, jax.random.key(0)))
    state = jser.flatten_tree(jmodel.init_state())
    rs = np.random.RandomState(seed)
    flat = {}
    for k in sorted(shapes):
        shape, name = shapes[k].shape, k.rsplit("/", 1)[1]
        if name in ("weight", "bias"):
            w = shapes.get(k.rsplit("/", 1)[0] + "/weight", shapes[k]).shape
            v = rs.uniform(-1, 1, shape) * float(np.prod(w[:-1])) ** -0.5
        else:
            v = rs.uniform(0.5, 1.5, shape)
        flat["params/" + k] = v.astype(np.float32)
    for k, v in state.items():
        v = 0.1 * rs.randn(*np.shape(v)) if k.endswith("mean") else rs.uniform(0.5, 1.5,
                                                                              np.shape(v))
        flat["state/" + k] = v.astype(np.float32)
    tree = jser.unflatten_tree(flat)
    tree.setdefault("state", {})
    return tree


def port_of(model, variables):
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))
    return channels_last(model).eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def port_logits(model, x):
    with torch.no_grad():
        return model.eval()(nchw(x)).numpy()


def jax_logits(jmodel, variables, x):
    return np.asarray(jmodel.apply(variables["params"], jnp.asarray(x),
                                   state=variables.get("state", {}), training=False)[0])


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


# -- Approximater(deploy=True) ------------------------------------------------
SITES = {  # app, its JAX twin, the model, the carried children
    "MscaRep": (lambda d: core.MscaRep(1, True, deploy=d),
                lambda d: jcore.MscaRep(1, True, deploy=d), MSCAN, ("conv0", "channel_mix")),
    "FfnRep": (lambda d: core.FfnRep(fix=True, deploy=d),
               lambda d: jcore.FfnRep(fix=True, deploy=d), MSCAN, ("fc2",)),
    "LowRankExpV1": (lambda d: core.LowRankExpV1(num_bases=(2, 3), deploy=d),
                     lambda d: jcore.LowRankExpV1(num_bases=(2, 3), deploy=d),
                     dict(type="DeployNet"), ()),
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_deploy_initialize_returns_the_bare_target(name):
    app_of, japp_of, cfg, carried = SITES[name]
    jmodel = jbuild(dict(cfg))
    variables = drawn(jmodel, 1)
    model = port_of(build_model(dict(cfg)), variables)
    app, japp = app_of(True), japp_of(True)
    assert app.deploy and japp.deploy
    model.register_switchable(app.src_type, [])
    jmodel.register_switchable(japp.src_type, [])
    assert model.switchable_names == jmodel.switchable_names
    for idx, site in enumerate(model.switchable_names):
        src = model.get_switchable_module(idx)
        tgt = app.initialize(src, torch.Generator().manual_seed(0))
        jtgt, jparams = japp.initialize(jmodel.get_switchable_module(idx),
                                        jser.tree_get(variables["params"], site),
                                        jax.random.key(0))
        assert not isinstance(tgt, Substitution)
        assert type(tgt).__name__ == type(jtgt).__name__
        got = params_to_jax(tgt.state_dict())
        want = {"params/" + k: np.asarray(v) for k, v in jser.flatten_tree(jparams).items()}
        assert {k: v.shape for k, v in got.items() if k.startswith("params/")} == \
            {k: v.shape for k, v in want.items()}
        for child in carried:
            for k, v in getattr(tgt, child).state_dict().items():
                assert torch.equal(v, getattr(src, child).state_dict()[k]), (site, child, k)
            for k in want:
                if k.startswith(f"params/{child}/"):
                    np.testing.assert_array_equal(got[k], want[k])
        if name == "LowRankExpV1":
            assert torch.equal(tgt.d_conv.bias, src.bias)
            np.testing.assert_array_equal(got["params/d_conv/bias"], want["params/d_conv/bias"])
    assert app_of(False).initialize(model.get_switchable_module(0)).__class__ is Substitution
    app.rewind()  # every app has one; a cursor app starts over
    if name == "LowRankExpV1":
        assert app.curr == 0


def test_deploy_builds_the_form_a_do_decomp_checkpoint_holds():
    """A do_decomp run saves its layers after decomp(): deploy builds them
    separable, so the checkpoint loads strictly (the JAX package builds the
    grouped form and keeps random bases where the keys differ)."""
    conv = Conv2d(8, 12, 3, padding=1)
    app = core.LowRankExpV1(num_bases=(3,), do_decomp=True, deploy=True)
    assert isinstance(app.initialize(conv).s_conv, SeparableConv)
    app = core.LowRankExpV1(num_bases=(3,), do_decomp=False, deploy=True)
    assert isinstance(app.initialize(conv).s_conv, Conv2d)


def test_dummy_takes_deploy():
    assert core.Dummy(deploy=True).deploy


# -- the Runner ----------------------------------------------------------------
@pytest.fixture(scope="module")
def mscan_run(tmp_path_factory):
    """A dense init_cfg of the tiny MSCAN, the config, and the JAX package's
    solved MscaRep d1+fix run of it (checkpoint and logits)."""
    root = tmp_path_factory.mktemp("mscan")
    jmodel = jbuild(dict(MSCAN))
    dense = str(root / "dense.ckpt.npz")
    jser.save_model(drawn(jmodel, 2), dense)
    cfg = root / "m.py"
    cfg.write_text(f"model = dict({', '.join(f'{k}={v!r}' for k, v in MSCAN.items())}, "
                   f"init_cfg={dense!r})\nfilters = []\n"
                   "app = dict(type='MscaRep', decomp=1, fix=True)\n")
    jinit_cfg(str(cfg))
    jupdate_cfg(work_dir=str(root / "jax"), config_name="m", seed=0)
    runner = JRunner()
    runner.run()
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    return dict(cfg=str(cfg), dense=dense, ckpt=runner.output_path, x=x,
                y=jax_logits(runner.model, runner.variables, x))


def run_port(cfg, work_dir, **kw):
    init_cfg(cfg)
    update_cfg(work_dir=work_dir, config_name="m", seed=0, checkpoint=kw.pop("checkpoint", None))
    runner = Runner(device="cpu", **kw)
    runner.run()
    return runner


def test_runner_deploy_round_trip_of_the_port_checkpoint(mscan_run, tmp_path):
    solved = run_port(mscan_run["cfg"], str(tmp_path / "solve"))
    assert solved.output_path.endswith(".pt")
    x = mscan_run["x"]
    deployed = run_port(mscan_run["cfg"], str(tmp_path / "deploy"), checkpoint=solved.output_path,
                        deploy=True, skip_optim=True, skip_post=True)
    assert all(type(m).__name__ == "MSCA" for m in deployed.model.switchable_modules())
    y1, y2 = port_logits(solved.model, x), port_logits(deployed.model, x)
    np.testing.assert_allclose(y2, y1, rtol=1e-4, atol=1e-5)  # the JAX test's
    np.testing.assert_array_equal(y2, y1)  # no solve ran: the same function, bit for bit
    with pytest.raises(ValueError, match="skip_optim and skip_post"):
        run_port(mscan_run["cfg"], str(tmp_path / "x"), checkpoint=solved.output_path,
                 deploy=True)


def test_runner_deploy_loads_the_jax_checkpoint(mscan_run, tmp_path):
    deployed = run_port(mscan_run["cfg"], str(tmp_path / "deploy"), checkpoint=mscan_run["ckpt"],
                        deploy=True, skip_optim=True, skip_post=True)
    y = port_logits(deployed.model, mscan_run["x"])
    np.testing.assert_allclose(y, mscan_run["y"], rtol=1e-4, atol=1e-5)


def test_cli_checkpoint_is_deploy_mode(mscan_run, tmp_path):
    runner = main_cli.main(["--config", mscan_run["cfg"], "--device", "cpu", "--seed", "0",
                            "--work-dir", str(tmp_path), "--checkpoint", mscan_run["ckpt"]])
    assert runner.deploy and runner.skip_optim and runner.skip_post
    np.testing.assert_allclose(port_logits(runner.model, mscan_run["x"]), mscan_run["y"],
                               rtol=1e-4, atol=1e-5)
    skipped = main_cli.main(["--config", mscan_run["cfg"], "--device", "cpu", "--work-dir",
                             str(tmp_path / "skip"), "--skip-optim", "--skip-post"])
    assert all(isinstance(m, Substitution) for m in skipped.model.switchable_modules())


# -- ClassInference ------------------------------------------------------------
def jax_reports(monkeypatch, cfg, ckpt, work_dir, x, **kw):
    """JAX ClassInference's reports: each tag's logits and parameter count as
    ``_report`` received them."""
    monkeypatch.setenv("CAT_EXACT_GELU", "1")  # what ClassInference sets, undone after
    captured = {}
    report = JClassInference._report

    def spy(self, tag, model, variables, cast=True):
        n = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(variables["params"]))
        captured[tag] = (jax_logits(model, variables, x), n)
        return report(self, tag, model, variables, cast)

    monkeypatch.setattr(JClassInference, "_report", spy)
    os.makedirs(work_dir, exist_ok=True)
    jinit_cfg(cfg)
    jupdate_cfg(work_dir=work_dir, checkpoint=ckpt, seed=0)
    JClassInference(checkpoint=ckpt, **kw).run()
    return captured


def fake_never_lose(monkeypatch, delta):
    """Both packages' never_lose_deploy under the JAX test's fake timer."""
    def t(model):
        return 1.0 + sum(delta[i] for i, m in enumerate(model.switchable_modules())
                         if type(m).__name__ == "LowRankExpConvV1")

    jfn, fn = jdeploy.never_lose_deploy, deploy.never_lose_deploy
    monkeypatch.setattr(jdeploy, "never_lose_deploy", lambda m, v, s, **k: jfn(
        m, v, s, time_fn=lambda m, v, s, d: t(m), verbose=False))
    monkeypatch.setattr(deploy, "never_lose_deploy", lambda m, s, **k: fn(
        m, s, time_fn=lambda m, s: t(m), verbose=False))


def test_class_inference_matches_jax_on_scheme1_sites(monkeypatch, tmp_path):
    jmodel = JDeployNet()
    dense = str(tmp_path / "dense.ckpt.npz")
    jser.save_model(drawn(jmodel, 5), dense)
    cfg = tmp_path / "net.py"
    cfg.write_text(f"model = dict(type='DeployNet', init_cfg={dense!r})\n"
                   f"app = {V1_APP}\nfilters = [dict(type='SimpleConvFilter')]\n")
    jinit_cfg(str(cfg))
    jupdate_cfg(work_dir=str(tmp_path / "solve"), config_name="net", seed=0)
    solve = JRunner()
    solve.run()
    fake_never_lose(monkeypatch, {0: 0.5, 1: -0.2})
    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    kw = dict(batch_size=2, input_size=(16, 16, 3), do_decomp=True, never_lose=True)
    want = jax_reports(monkeypatch, str(cfg), solve.output_path, str(tmp_path / "jax"), x, **kw)

    init_cfg(str(cfg))
    update_cfg(work_dir=str(tmp_path / "port"), checkpoint=solve.output_path, seed=0)
    os.makedirs(tmp_path / "port")
    inference = ClassInference(solve.output_path, device="cpu", quantize="int8", **kw)
    seen = {}
    report = inference._report

    def spy(tag, model):
        seen[tag] = port_logits(model, x)
        return report(tag, model)

    inference._report = spy
    reports = inference.run()
    assert list(reports) == ["original", "approximated", "decomposed", "never-lose", "int8"]
    assert list(want) == list(reports)[:4]
    for tag, (y_j, n_j) in want.items():
        assert rel(seen[tag], y_j) < LOGITS_RTOL, tag
        assert reports[tag]["params"] == n_j, tag
        assert reports[tag]["ms"] > 0 and reports[tag]["macs"] > 0
    assert reports["approximated"]["macs"] < reports["original"]["macs"]
    table = json.loads((tmp_path / "port" / "never_lose_decisions.json").read_text())
    assert table == json.loads((tmp_path / "jax" / "never_lose_decisions.json").read_text())
    assert [r["kept"] for r in table["layers"]] == ["dense", "decomposed"]
    assert np.isfinite(seen["int8"]).all() and rel(seen["int8"], seen["never-lose"]) < 0.12


def test_class_inference_matches_jax_on_mscarep(monkeypatch, mscan_run, tmp_path):
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    kw = dict(batch_size=2, input_size=(32, 32, 3))
    want = jax_reports(monkeypatch, mscan_run["cfg"], mscan_run["ckpt"], str(tmp_path), x, **kw)
    init_cfg(mscan_run["cfg"])
    update_cfg(work_dir=str(tmp_path), checkpoint=mscan_run["ckpt"], seed=0)
    inference = ClassInference(mscan_run["ckpt"], device="cpu", **kw)
    model = inference.build_approximated()
    assert all(not m.approximate for m in model.modules() if type(m).__name__ == "GELU")
    assert rel(port_logits(model, x), want["approximated"][0]) < LOGITS_RTOL
    reports = ClassInference(mscan_run["ckpt"], device="cpu", **kw).run()
    assert list(reports) == list(want) == ["original", "approximated"]
    for tag, (_, n_j) in want.items():
        assert reports[tag]["params"] == n_j


@pytest.mark.parametrize("kw,match", [(dict(dtype="bfloat16"), None),
                                      (dict(pipeline_parallel=2), "item 12"),
                                      (dict(s2d_stem=True), "S2D stem")],
                         ids=["kw0-item 7", "kw1-item 12", "kw2-S2D stem"])  # the ids as before
def test_class_inference_refusals(mscan_run, kw, match):
    """bf16 is taken now, its BN fold on by default as in the JAX runner (off
    in float32); pipelining and the S2D stem are refused."""
    init_cfg(mscan_run["cfg"])
    if match is None:
        run = ClassInference(mscan_run["ckpt"], device="cpu", **kw)
        assert run.dtype == torch.bfloat16 and run.fold_bn
        assert not ClassInference(mscan_run["ckpt"], device="cpu").fold_bn
        return
    with pytest.raises(NotImplementedError, match=match):
        ClassInference(mscan_run["ckpt"], device="cpu", **kw)


def test_inference_cli_on_cpu(mscan_run, tmp_path):
    run = inference_cli.main(["--config", mscan_run["cfg"], "--checkpoint", mscan_run["ckpt"],
                              "--batch", "2", "--device", "cpu", "--work-dir", str(tmp_path)])
    assert list(run.reports) == ["original", "approximated"]
    # bf16: every report tagged with the type, timed and counted on a bf16 copy
    bf = inference_cli.main(["--config", mscan_run["cfg"], "--checkpoint", mscan_run["ckpt"],
                             "--batch", "2", "--dtype", "bfloat16", "--device", "cpu",
                             "--work-dir", str(tmp_path)])
    assert list(bf.reports) == ["original/bfloat16", "approximated/bfloat16"]
    assert bf.reports["approximated/bfloat16"]["macs"] == run.reports["approximated"]["macs"]
    assert all(p.dtype == torch.float32 for p in bf.new_model.parameters())  # copies were cast
