"""The width-pruning apps of the port (``core/ffn_prune.py``: ``FfnPrune``,
``MlpPrune``, ``AttnPrune``) against the JAX package's.

On the tiny MSCAN of ``test_torch_pipeline.py`` and a narrow ConvNeXt (the
variables of ``test_torch_prune_passes.py``: drawn from a seed, carried into
the port with ``convert.params_from_jax``), each package's ``apply_app`` runs
the app, with or without the same seeded calibration batches (2 of 8 images,
128^2 and 192^2: every stage sees at least three times as many pixels as its
hidden width, so that the kept set is not chosen among noise).  Then:
the widths and module attributes are equal, every tensor is bit-equal but the
refit projections (``fc2``, ``pwconv2``, ``proj_2``), so the kept index sets
are JAX's; each refit site's output on its calibration inputs is within 1e-4
relative of the same site holding JAX's solution (the fit; the solutions of
these float32 normal equations agree only to about their condition number
times float32's rounding); and the pruned logits are within 1e-4 relative.  Also: keep-all is exact, the greedy selection is JAX's
function, ``round_to`` rounds half to even (640 -> 256 at 128), a sample
smaller than the hidden width warns, and ``CalibrationHook`` hands ``FfnPrune``
the maps the JAX hook hands it.
"""

import copy
import logging
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import core as jcore  # noqa: E402
from convnet_approximater_tpu.core import ffn_prune as jffn_prune  # noqa: E402
from convnet_approximater_tpu.deploy_planner import apply_app as japply_app  # noqa: E402
from convnet_approximater_tpu.models.mscan import FFN as JFFN  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import core  # noqa: E402
from convnet_approximater_tpu_torch.core import ffn_prune  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.models.mscan import FFN  # noqa: E402
from test_torch_prune_passes import (RTOL, assert_same_logits, assert_same_pruned,  # noqa: E402
                                     batch, pair, port_logits, port_of, refit_outputs, rel,
                                     to_torch)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = {"MSCAN": 128, "ConvNeXt": 192}  # image size of the calibration batches
APPS = {"FfnPrune": ("MSCAN", "fc2"), "AttnPrune": ("MSCAN", "proj_2"),
        "MlpPrune": ("ConvNeXt", "pwconv2")}


def run_both(app_name, calibrated, size=None, **options):
    """The JAX and the port app on the same model, on the same calibration
    batches when ``calibrated``: (jmodel, variables, model, logits' image
    size, sites, the port's calibration batches)."""
    name, _ = APPS[app_name]
    jmodel, variables, model, image = pair(name)
    size = size or CALIB[name]
    calib = [batch(size, 8, seed) for seed in (21, 22)] if calibrated else None
    n_j = japply_app(jmodel, variables, getattr(jcore, app_name)(**options), [],
                     jax.random.key(0), None if calib is None else [jnp.asarray(c) for c in calib])
    tcalib = None if calib is None else [to_torch(c) for c in calib]
    n = apply_app(model, getattr(core, app_name)(**options), [], calib_batches=tcalib)
    assert n == n_j
    return jmodel, variables, model, image, n, tcalib


def assert_refit_close(jmodel, variables, model, proj, calib):
    """Each site's output on its calibration inputs within RTOL of the same
    site holding JAX's solution: the fit itself.  The refit is a float32
    solve of normal equations whose condition numbers reach 1e4 here, so the
    two packages' solutions agree only to about 1e-4 in another order of
    summation, where the fits they make agree closer."""
    solved = port_of(jmodel, variables, model=copy.deepcopy(model))
    for site in model.switchable_names:
        assert rel(refit_outputs(model, site, calib), refit_outputs(solved, site, calib)) < RTOL
        assert rel(refit_outputs(model, f"{site}.{proj}", calib),
                   refit_outputs(solved, f"{site}.{proj}", calib)) < RTOL


# structural options on the weights alone; the calibrated solve on one setting each
CASES = [("FfnPrune", dict(keep_ratio=0.5), False), ("FfnPrune", dict(energy=0.9), False),
         ("FfnPrune", dict(keep_ratio=0.75, round_to=16), False),
         ("FfnPrune", dict(keep=(4, 8, 12, 12, 16)), False),
         ("FfnPrune", dict(keep_ratio=(0.25, 0.5, 0.75, 0.5, 1.0)), False),
         ("MlpPrune", dict(keep_ratio=0.5), False), ("MlpPrune", dict(energy=0.8), False),
         ("AttnPrune", dict(keep_ratio=0.5), False),
         ("AttnPrune", dict(keep_ratio=(0.5, 0.25, 0.5, 0.75, 0.5)), False),
         ("FfnPrune", dict(keep_ratio=0.5), True), ("FfnPrune", dict(keep_ratio=0.5, refit=False), True),
         ("MlpPrune", dict(keep_ratio=0.5), True), ("AttnPrune", dict(keep_ratio=0.5), True)]


@pytest.mark.parametrize("app_name,options,calibrated", CASES, ids=[
    f"{a}-{'-'.join(f'{k}={v}' for k, v in sorted(o.items()))}-{'calib' if c else 'weights'}"
    for a, o, c in CASES])
def test_app_matches_jax(app_name, options, calibrated):
    jmodel, variables, model, image, n, calib = run_both(app_name, calibrated, **options)
    assert n == 5
    proj = APPS[app_name][1]
    refit = ([f"{site}.{proj}" for site in model.switchable_names]
             if calibrated and options.get("refit", True) else [])
    assert_same_pruned(jmodel, variables, model, refit=refit)
    if refit:
        assert_refit_close(jmodel, variables, model, proj, calib)
    assert_same_logits(jmodel, variables, model, image)


@pytest.mark.parametrize("calibrated", [False, True], ids=["weights", "calibrated"])
@pytest.mark.parametrize("app_name", sorted(APPS))
def test_keep_all_is_exact(app_name, calibrated):
    """k = M keeps every channel in order: sliced, the logits are the dense
    model's bits; refit, the normal equations give back the projection up to
    the ridge."""
    name, _ = APPS[app_name]
    _, _, dense, image = pair(name)
    _, _, model, _ = pair(name)
    calib = [to_torch(batch(CALIB[name], 8, seed)) for seed in (21, 22)] if calibrated else None
    apply_app(model, getattr(core, app_name)(keep_ratio=1.0), [], calib_batches=calib)
    x = batch(image)
    if calibrated:  # the JAX package's own test holds this to 1e-4
        assert rel(port_logits(model, x), port_logits(dense, x)) < RTOL
    else:
        np.testing.assert_array_equal(port_logits(model, x), port_logits(dense, x))


@pytest.mark.parametrize("seed,k,dead", [(0, 5, 0), (1, 12, 0), (2, 9, 3)])
def test_greedy_select_is_jax_function(seed, k, dead):
    """The same kept set and explained variance as the JAX function, also when
    dead channels make the fill-by-residual path run (k = M = 12 at seed 1)."""
    rs = np.random.RandomState(seed)
    h = rs.randn(200, 12).astype(np.float32)
    h[:, :dead] = 0.0
    K = np.cov(h.T).astype(np.float32)
    T = (K @ rs.randn(12, 6)).astype(np.float32)
    S, e = ffn_prune._greedy_select(K, T, k)
    S_j, e_j = jffn_prune._greedy_select(K, T, k)
    np.testing.assert_array_equal(S, S_j)
    assert e == e_j and len(S) == k and list(S) == sorted(set(S))


@pytest.mark.parametrize("M,want", [(256, 128), (512, 256), (640, 256), (1024, 512), (96, 48)])
def test_round_to_rounds_half_to_even(M, want):
    """keep_ratio 0.5 at round_to 128: 640 -> 320 -> 2.5 tiles -> 256, as
    Python's round (and the JAX package) gives; a width within one tile is
    not snapped."""
    app, japp = core.FfnPrune(keep_ratio=0.5, round_to=128), jcore.FfnPrune(keep_ratio=0.5,
                                                                          round_to=128)
    assert app._num_keep(FFN(16, M, 0.0)) == japp._num_keep(JFFN(16, M, 0.0), None) == want


def test_small_sample_warns_like_jax(caplog):
    """32^2 images give stage 4 one pixel each: n < M warns in both packages,
    and the pruned model still runs with JAX's widths."""
    caplog.set_level(logging.WARNING)
    jmodel, variables, model, image, n, _ = run_both("FfnPrune", True, size=32, keep_ratio=0.5)
    msgs = [r for r in caplog.records if "rank-deficient" in r.getMessage()]
    assert {r.name for r in msgs} == {"convnet_approximater_tpu", "convnet_approximater_tpu_torch"}
    assert len(msgs) == 2  # stage 4's FFN (16 pixels for 64 channels), in each package
    y = port_logits(model, batch(image))
    assert np.isfinite(y).all()
    assert [m.mlp.hidden_channel for m in model.modules() if hasattr(m, "mlp")] == \
        [m.mlp.hidden_channel for _, m in jmodel.named_modules() if hasattr(m, "mlp")]


def test_app_options_are_checked():
    for bad in (dict(), dict(keep=2, energy=0.5), dict(energy=1.5), dict(keep_ratio=0.0),
                dict(keep_ratio=0.5, round_to=0)):
        with pytest.raises(ValueError):
            core.FfnPrune(**bad)
    with pytest.raises(ValueError, match="out of range"):
        core.FfnPrune(keep=40)._num_keep(FFN(8, 32, 0.0))


def recording(app, seen):
    original = app.set_calibration

    def record(index, x):
        seen[index] = np.asarray(x.permute(0, 2, 3, 1) if isinstance(x, torch.Tensor) else x)
        original(index, x)

    app.set_calibration = record


def test_calibration_hook_hands_the_jax_maps(tmp_path):
    """``configs/prune/ffn-prune_dd_l2-asym_mscan-t.py`` cut to the tiny MSCAN
    (the same seeded weights, loaded through ``init_cfg``), 2 calibration
    batches of 8 at 128^2 and no fine-tune, through each package's Runner: FfnPrune receives
    each site's tapped maps, concatenated over the batches, within 1e-5 of
    what the JAX app receives; the two Runners then prune alike."""
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg
    from test_torch_prune_passes import TINY_MSCAN, _variables_of

    ckpt = str(tmp_path / "dense.ckpt.npz")
    jser.save_model(jser.unflatten_tree(dict(_variables_of("MSCAN", 0))), ckpt)
    model = {k: v for k, v in TINY_MSCAN.items() if k != "type"}
    cfg = tmp_path / "tiny_ffn_prune.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/prune/ffn-prune_dd_l2-asym_mscan-t.py')!r}]\n"
        f"model = dict({', '.join(f'{k}={v!r}' for k, v in model.items())}, init_cfg={ckpt!r})\n"
        "hooks = [dict(type='CalibrationHook', priority=40, num_batches=2, batch_size=8,\n"
        "              image_size=(128, 128))]\n")
    seen_j, seen = {}, {}
    jcfg.init_cfg(str(cfg))
    jcfg.update_cfg(work_dir=str(tmp_path / "jax"), seed=0)
    jrunner = JRunner(rng=jax.random.key(0))
    recording(jrunner.app, seen_j)
    jrunner.run()
    tcfg.init_cfg(str(cfg))
    tcfg.update_cfg(work_dir=str(tmp_path / "torch"), seed=0)
    runner = Runner(device="cpu")
    recording(runner.app, seen)
    runner.run()
    assert sorted(seen) == sorted(seen_j) == list(range(5))
    for i, x in seen.items():
        assert x.shape == seen_j[i].shape and x.shape[0] == 16
        assert rel(x, seen_j[i]) < 1e-5
    refit = [f"{site}.fc2" for site in jrunner.model.switchable_names]
    assert_same_pruned(jrunner.model, jrunner.variables, runner.model, refit=refit)
    assert_same_logits(jrunner.model, jrunner.variables, runner.model, 64)
