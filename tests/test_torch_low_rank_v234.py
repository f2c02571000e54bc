"""The port's LowRankExpV2/V3/V4 (scheme 2, channel rank, Tucker-2) against the JAX apps.

Both packages solve the same random ``Conv2d(6, 10, 3, stride=2, padding=1)``
with a bias, on the same calibration second moments where the solve is
data-driven (built by the JAX package's moment functions from correlated
inputs, handed to both ``set_calibration``), and the solved layers' outputs
are compared.  Singular vectors may come out with other signs or rotations
than the JAX package's LAPACK gives: V2's ALS is equivariant to a sign flip of
a base, V3's ``A B`` and V4's projections ``U U^T`` do not see them, so the
outputs are compared, not the raw factors.  Tolerance: rtol 1e-4 / atol 1e-5,
the JAX package's own bound for these layers (``tests/test_low_rank_v3.py``).

Also: the ranks ``energy`` picks, the JAX solved parameters loaded into the
port's layers through ``params_from_jax`` (the child names are the JAX
package's), ``fold_batchnorm`` through each tail (1e-4), and tiny CPU runs of
the seven low-rank configs through the port's CLI.  The VGG-16 configs run at
full width on their first two sites (``IndicesFilter`` cut to (2, 3), so the
rank cursors stay the configs'), with hooks at 64^2 (calibration and the fine-tune at
32^2); the full runs are the card's (``chip_smoke.py``).  Last, the port's Runner
builds the 8 configs of this slice (the QAT one too) and refuses the 5 it cannot
run yet, each refusal naming its ROADMAP.md item.
"""

import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.core import LowRankExpV2 as JV2  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV3 as JV3  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV4 as JV4  # noqa: E402
from convnet_approximater_tpu.core import low_rank_solvers as jsolvers  # noqa: E402
from convnet_approximater_tpu.hooks import calibration as jcal  # noqa: E402
from convnet_approximater_tpu.nn import Conv2d as JConv2d  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import (LowRankExpV2, LowRankExpV3,  # noqa: E402
                                                 LowRankExpV4)
from convnet_approximater_tpu_torch.core import low_rank_solvers as solvers  # noqa: E402
from convnet_approximater_tpu_torch.layers import (LowRankExpConvV2,  # noqa: E402
                                                   LowRankExpConvV3, LowRankExpConvV4)
from convnet_approximater_tpu_torch.nn import BatchNorm2d, Conv2d  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
FOLD_TOL = 1e-4
C, N, K = 6, 10, 3
APPS = {"v2": (JV2, LowRankExpV2, LowRankExpConvV2), "v3": (JV3, LowRankExpV3, LowRankExpConvV3),
        "v4": (JV4, LowRankExpV4, LowRankExpConvV4)}
STAT = {"v2": "strips", "v3": "patches", "v4": "channels"}


@pytest.fixture(scope="module")
def source():
    """The JAX conv, its params, and inputs on a 3-dim channel subspace plus
    noise (an anisotropic second moment, so a data-driven solve differs from a
    plain one)."""
    conv = JConv2d(C, N, K, stride=2, padding=1)
    params = conv.init(jax.random.key(0))
    rs = np.random.RandomState(1)
    z = rs.randn(3, 13, 13, 3) @ rs.randn(3, C)
    x = (z + 0.05 * rs.randn(*z.shape)).astype(np.float32)
    return conv, params, x


def torch_conv(params, bias=True):
    conv = Conv2d(C, N, K, stride=2, padding=1, bias=bias)
    flat = flatten_tree({"params": params})
    conv.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()
                                          if bias or not k.endswith("bias")}))
    return conv


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def jax_moment(kind, x):
    return np.asarray(jcal.site_statistic(STAT[kind], jnp.asarray(x), JConv2d(C, N, K)))


def solve_jax(kind, source, kw, xcov=None):
    conv, params, x = source
    app = APPS[kind][0](**kw)
    if xcov is not None:
        app.set_calibration(0, jnp.asarray(xcov))
    sub, sp = app.initialize(conv, params, jax.random.key(1))
    app.optimize(sub, sp)
    mod, new = app.postprocess(sub, sp)
    return mod, new, np.asarray(mod.apply(new, jnp.asarray(x))[0])


def solve_torch(kind, source, kw, xcov=None):
    _, params, x = source
    app = APPS[kind][1](**kw)
    if xcov is not None:
        app.set_calibration(0, torch.tensor(xcov))
    sub = app.initialize(torch_conv(params))
    app.optimize(sub)
    mod = app.postprocess(sub).eval()
    with torch.no_grad():
        y = mod(nchw(x)).permute(0, 2, 3, 1).numpy()
    return app, mod, y


CASES = {  # id: (app, options, data-driven)
    "v2": ("v2", dict(num_bases=(4,)), False),
    "v2-als-identity": ("v2", dict(num_bases=(4,), data_driven_iters=6), False),
    "v2-als-strips": ("v2", dict(num_bases=(4,), data_driven_iters=6), True),
    "v3": ("v3", dict(num_bases=(4,)), False),
    "v3-energy": ("v3", dict(energy=0.8), False),
    "v3-data-driven": ("v3", dict(num_bases=(4,), data_driven=True), True),
    "v4-pair": ("v4", dict(num_bases=((3, 5),)), False),
    "v4-int": ("v4", dict(num_bases=(4,), hooi_iters=0), False),
    "v4-energy": ("v4", dict(energy=0.8), False),
    "v4-hooi-data-driven": ("v4", dict(num_bases=((3, 5),), hooi_iters=5, data_driven=True),
                            True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_app_matches_jax(source, case):
    kind, kw, dd = CASES[case]
    xcov = jax_moment(kind, source[2]) if dd else None
    jmod, _, y_j = solve_jax(kind, source, kw, xcov)
    app, mod, y = solve_torch(kind, source, kw, xcov)
    assert isinstance(mod, APPS[kind][2]) and type(jmod).__name__ == type(mod).__name__
    assert mod.num_base == jmod.num_base
    assert y.shape == y_j.shape == (3, 7, 7, N)
    np.testing.assert_allclose(y, y_j, rtol=RTOL, atol=ATOL)
    if dd:  # the calibration moved the solve
        _, _, y_plain = solve_torch(kind, source, dict(kw, data_driven=False) if kind != "v2"
                                    else dict(kw, data_driven_iters=0))
        assert np.abs(y - y_plain).max() > 1e-3


@pytest.mark.parametrize("kind,energy", [("v3", 0.5), ("v3", 0.95), ("v3", 1.0),
                                         ("v4", 0.5), ("v4", 0.95), ("v4", 1.0)])
def test_energy_picks_the_jax_ranks(source, kind, energy):
    conv, params, _ = source
    jsub, _ = APPS[kind][0](energy=energy).initialize(conv, params, jax.random.key(1))
    sub = APPS[kind][1](energy=energy).initialize(torch_conv(params))
    assert sub.new_module.num_base == jsub.new_module.num_base


def test_scheme2_solvers_match_jax():
    rs = np.random.RandomState(3)
    W = rs.randn(N, C, K, K).astype(np.float32)
    A = rs.randn(40, C * K).astype(np.float32)
    xcov = (A.T @ A / 40).astype(np.float32)
    jV, jH, jE = jsolvers.scheme2_factorize(jnp.asarray(W), 4)
    V, H, E = solvers.scheme2_factorize(torch.from_numpy(W), 4)
    assert V.shape == (4, C, K) and H.shape == (N, 4, K)
    np.testing.assert_allclose(float(E), float(jE), rtol=1e-5)
    # the product is what the layer computes: sum_m V[m, c, u] H[n, m, v]
    np.testing.assert_allclose(torch.einsum("mcu,nmv->ncuv", V, H).numpy(),
                               np.einsum("mcu,nmv->ncuv", jV, jH), rtol=RTOL, atol=ATOL)
    jV2, jH2, jerrs = jsolvers.scheme2_data_driven(jnp.asarray(W), jV, jH, jnp.asarray(xcov), 5)
    V2, H2, errs = solvers.scheme2_data_driven(torch.from_numpy(W), V, H,
                                               torch.from_numpy(xcov), 5)
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-5)
    np.testing.assert_allclose(torch.einsum("mcu,nmv->ncuv", V2, H2).numpy(),
                               np.einsum("mcu,nmv->ncuv", jV2, jH2), rtol=RTOL, atol=ATOL)
    # more bases than the spectrum holds: zero-padded on both sides
    V, H, _ = solvers.scheme2_factorize(torch.from_numpy(W[:, :1, :, :]), 5)
    assert V.shape == (5, 1, K) and torch.count_nonzero(V[3:]) == 0


@pytest.mark.parametrize("kind", list(APPS))
def test_jax_solved_params_load_into_the_port_layer(source, kind):
    """The child names are the JAX package's, so its solved layer carries across."""
    kw = CASES[{"v2": "v2", "v3": "v3", "v4": "v4-pair"}[kind]][1]
    jmod, new, y_j = solve_jax(kind, source, kw)
    layer = APPS[kind][2](C, N, jmod.num_base, K, 2, 1)
    layer.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_tree({"params": new}).items()}))
    with torch.no_grad():
        y = layer.eval()(nchw(source[2])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, y_j, rtol=RTOL, atol=ATOL)


def test_bias_carried_to_the_tail(source):
    _, params, _ = source
    for kind, tail in (("v2", "h_conv"), ("v3", "mix_conv"), ("v4", "out_conv")):
        kw = CASES[kind if kind != "v4" else "v4-pair"][1]
        conv = torch_conv(params)
        sub = APPS[kind][1](**kw).initialize(conv)
        assert torch.equal(getattr(sub.new_module, tail).bias, conv.bias)
        sub = APPS[kind][1](**kw).initialize(torch_conv(params, bias=False))
        assert torch.count_nonzero(getattr(sub.new_module, tail).bias) == 0


def test_grouped_v2_and_dense_only_checks():
    layer = LowRankExpConvV2(C, N, 4, K, 1, 1, grouped=True)
    assert layer.h_conv.groups == 4 and tuple(layer.h_conv.weight.shape) == (4, 1, 1, K)
    assert LowRankExpConvV4(C, N, 3, K, 1, 1).num_base == (3, 3)
    for app in (LowRankExpV3(num_bases=(2,)), LowRankExpV4(num_bases=(2,))):
        with pytest.raises(ValueError, match="dense convs only"):
            app.initialize(Conv2d(C, C, K, groups=C))
    for bad in (dict(), dict(num_bases=(2,), energy=0.5), dict(energy=0.0)):
        with pytest.raises(ValueError):
            LowRankExpV3(**bad)


def test_rewind_restarts_the_cursors(source):
    _, params, _ = source
    app = LowRankExpV3(num_bases=(2, 5))
    assert app.initialize(torch_conv(params)).new_module.num_base == 2
    app.rewind()
    assert app.initialize(torch_conv(params)).new_module.num_base == 2
    assert app.initialize(torch_conv(params)).new_module.num_base == 5


@pytest.mark.parametrize("kind", list(APPS))
def test_fold_batchnorm_through_the_tail(source, kind):
    _, params, x = source
    gen = torch.Generator().manual_seed(6)
    bn = BatchNorm2d(N)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(N, generator=gen))
        bn.running_var.copy_(torch.rand(N, generator=gen) + 0.5)
    app = APPS[kind][1](**CASES[kind if kind != "v4" else "v4-pair"][1])
    sub = app.initialize(torch_conv(params))
    app.optimize(sub)
    model = torch.nn.Sequential(app.postprocess(sub), bn).eval()
    with torch.no_grad():
        y_ref = model(nchw(x))
        assert deploy.fold_batchnorm(model) == 1
        y = model(nchw(x))
    assert isinstance(model[1], torch.nn.Identity)
    assert float((y - y_ref).norm() / y_ref.norm()) < FOLD_TOL


# -- the configs through the CLI, tiny -------------------------------------------------

SMALL = ("dict(type='ModelAnalysis', priority=40, input_shape=(64, 64, 3), batch_size=1)",
         "dict(type='InferenceTimeHook', priority=50,\n"
         "     infer_cfg=dict(input_size=(1, 64, 64, 3), num_iters=1, warmup=1))")
CALIB = "dict(type='CalibrationHook', priority=30, num_batches=1, batch_size=2, image_size=(32, 32))"
L2KD = ("dict(type='L2Reconstruct', priority=50, asym=True, l2_weight=1.0, cls_weight=0.0,\n"
        "     kd_weight=0.5, kd_temperature=4.0, dataset_args=dict(batch_size=2),\n"
        "     data_config=dict(image_size=(32, 32)), sche_args=dict(epochs=1),\n"
        "     optim_args=dict(opt='adamw', lr=1e-3, weight_decay=0.01),\n"
        "     other_args=dict(num_classes=10, max_steps_per_epoch=1, max_eval_batches=1,\n"
        "                     log_interval=1))")
TWO_SITES = ("filters = [dict(type='SimpleConvFilter'),\n"
             "           dict(type='IndicesFilter', indices=(2, 3))]\n")
CONFIGS = {  # id: (config, hooks, cut to the first two sites, sites, layer)
    "v2-alexnet": ("low-rank-exp/low-rank-exp-v2_l2345_alexnet.py", SMALL[:1], False, 4,
                   LowRankExpConvV2),
    "v3-resnet18": ("resnet/low-rank-exp-v3_blocks_resnet18.py", SMALL, False, 16,
                    LowRankExpConvV3),
    "v2-vgg16": ("vgg/low-rank-exp-v2_all_vgg16.py", (CALIB, SMALL[0]), True, 2,
                 LowRankExpConvV2),
    "v3-vgg16": ("vgg/low-rank-exp-v3_all_vgg16.py", SMALL, True, 2, LowRankExpConvV3),
    "v3-dd-vgg16": ("vgg/low-rank-exp-v3_dd_vgg16.py", (CALIB, SMALL[0]), True, 2,
                    LowRankExpConvV3),
    "v3-l2-kd-vgg16": ("vgg/low-rank-exp-v3_l2-kd_vgg16.py", (L2KD,), True, 2,
                       LowRankExpConvV3),
    "v4-vgg16": ("vgg/low-rank-exp-v4_all_vgg16.py", SMALL, True, 2, LowRankExpConvV4),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_runs_low_rank_configs_on_cpu(tmp_path, name):
    from convnet_approximater_tpu_torch import main as cli
    from convnet_approximater_tpu_torch.hooks import finetune as ft

    base, hooks, cut, sites, layer = CONFIGS[name]
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', base)!r}]\n"
                   + (TWO_SITES if cut else "")
                   + "hooks = [" + ",\n".join(hooks) + "]\n")
    work = tmp_path / "run"
    # the tiny fine-tune's checkpoint (VGG-16 with its AdamW moments: 1.6 GB) is
    # test_torch_finetune.py's subject, not this one's
    with mock.patch.object(ft.CheckpointSaver, "save_checkpoint", lambda self, *a, **k: (0, 0)):
        runner = cli.main(["--config", str(cfg), "--device", "cpu", "--seed", "0",
                           "--work-dir", str(work)])
    log = (work / "run.log").read_text()
    model = runner.model
    assert model.length_switchable == sites
    assert all(isinstance(m, layer) for m in model.switchable_modules())
    assert list(model.switchable_modules())[0].num_base == runner.app.num_bases[0]
    if "CalibrationHook" in hooks[0]:
        assert "CalibrationHook: collected moments for [0, 1]" in log
    if "ModelAnalysis" in "".join(hooks):
        assert "Model MACs: " in log
    if "L2Reconstruct" in hooks[0]:
        assert "Train: 0 [   0/1]" in log and "nan" not in log.split("Train: 0")[1]
    x = torch.randn(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = model.eval()(x)
    assert torch.isfinite(y).all()


# -- which configs the port's Runner builds ------------------------------------------
REFUSED = {}  # config: the ROADMAP.md queue 1 item its refusal names (none since SegNeXt)
SEGNEXT = {  # the configs SegNeXt's port unblocked: their hooks
    "msca-rep/msca-rep_d1_fix_segnext-t.py": ["InferenceTimeHook"],
    "msca-rep/finetune/msca-rep-d1-fix_l2-asym_segnext-t.py": ["SegL2Reconstruct"],
}
BUILT = [c for c, *_ in CONFIGS.values()] + [
    "quant/int8-qat_ce_alexnet.py", "prune/ffn-prune_dd_l2-asym_mscan-t.py",
    "prune/chain-prune_ce_vgg16.py", "prune/trunk-prune_ce_resnet18.py"] + sorted(SEGNEXT)


@pytest.mark.parametrize("name", BUILT + sorted(REFUSED))
def test_runner_builds_the_slice_configs_and_names_the_item_of_a_refusal(tmp_path, name):
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import init_cfg, update_cfg

    init_cfg(os.path.join(REPO, "configs", name))
    update_cfg(work_dir=str(tmp_path), config_name="cfg")
    if name in REFUSED:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 item {REFUSED[name]}"):
            Runner(device="cpu")
        return
    runner = Runner(device="cpu")
    if name in SEGNEXT:
        assert type(runner.model).__name__ == "SegNeXt" and runner.model.num_classes == 150
        assert type(runner.app).__name__ == "MscaRep" and runner.app.fix
        assert [h.name for h in runner.hooks] == SEGNEXT[name]
        return
    assert type(runner.app).__name__ in ("LowRankExpV2", "LowRankExpV3", "LowRankExpV4", "Dummy",
                                         "FfnPrune")


def test_a_pending_name_raises_naming_its_item(monkeypatch):
    """A name the JAX registries have and the port's do not yet raises
    ``NotImplementedError`` naming its ROADMAP.md item; any other unknown name
    raises ``KeyError``."""
    from convnet_approximater_tpu_torch.models import MODEL
    from convnet_approximater_tpu_torch.utils import registry

    monkeypatch.setitem(registry.PENDING, "NotPortedNet", 12)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 12"):
        registry.build_from_cfg(dict(type="NotPortedNet"), MODEL)
    with pytest.raises(KeyError, match="not registered"):
        MODEL.get("NoSuchNet")
