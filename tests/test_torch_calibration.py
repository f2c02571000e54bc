"""Calibration in the port (``hooks/calibration.py``, ``apply_app(calib_batches)``)
against the JAX package.

The three second moments and ``site_statistic`` on the same random NHWC maps
(fed to the port as NCHW ``channels_last`` tensors), within 1e-5 relative:
both sum float32 products, in another order.  Then, on a narrow three-conv
model defined in both packages here (3 -> 8 -> 12 -> 12 channels, a 5x5 in the
middle, 16^2 images), with the same weights (``params_from_jax``) and its three
convs as sites, the moments each package hands to ``set_calibration``: through
``CalibrationHook`` (its ``Synthetic`` batches through a ``Loader``, which
give the same images in both packages) and through ``apply_app`` with the
same two batches, for each statistic (V2's strips, V3's patches, V4's
channels and the raw maps), within 1e-5 relative; and the logits of the
data-driven model ``apply_app`` solved, within 1e-4 (four solves from
float32 moments, then the network).
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu import core as jcore  # noqa: E402
from convnet_approximater_tpu import filters as jfilters  # noqa: E402
from convnet_approximater_tpu.deploy_planner import apply_app as japply_app  # noqa: E402
from convnet_approximater_tpu.hooks import calibration as jcal  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.nn import Conv2d as JConv2d  # noqa: E402
from convnet_approximater_tpu.nn.module import _stable_fold  # noqa: E402
from convnet_approximater_tpu.utils import tree_get  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree, unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import core, filters  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.hooks import calibration as cal  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear, ReLU, channels_last  # noqa: E402

torch.set_num_threads(1)
MOMENT_TOL = 1e-5
LOGITS_TOL = 1e-4
SITES = ["features.0", "features.2", "features.4"]
SIZE = 16
# statistic -> (app, options): the same name in both packages
APPS = {"strips": ("LowRankExpV2", dict(num_bases=(2, 4, 4), data_driven_iters=3)),
        "patches": ("LowRankExpV3", dict(num_bases=(2, 4, 4), data_driven=True)),
        "channels": ("LowRankExpV4", dict(num_bases=(2, 4, 4), data_driven=True)),
        "raw": ("LowRankExpV3", dict(num_bases=(2, 4, 4)))}


class JTiny(JSwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = jnn.Sequential(
            jnn.Conv2d(3, 8, 3, padding=1), jnn.ReLU(), jnn.Conv2d(8, 12, 5, padding=2),
            jnn.ReLU(), jnn.Conv2d(12, 12, 3, padding=1), jnn.ReLU())
        self.head = jnn.Linear(12, 4)

    def __call__(self, params, x, ctx):
        x = self.child("features", params, x, ctx)
        return self.child("head", params, x.mean(axis=(1, 2)), ctx)


class Tiny(SwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = torch.nn.Sequential(
            Conv2d(3, 8, 3, padding=1), ReLU(), Conv2d(8, 12, 5, padding=2), ReLU(),
            Conv2d(12, 12, 3, padding=1), ReLU())
        self.head = Linear(12, 4)

    def forward(self, x):
        return self.head(self.features(x).mean(dim=(2, 3)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def test_moments_match_jax():
    x = np.random.RandomState(0).randn(3, 9, 11, 5).astype(np.float32)
    jx, tx = jnp.asarray(x), nchw(x)
    pairs = [(cal.strip_second_moment(tx, 3), jcal.strip_second_moment(jx, 3)),
             (cal.patch_second_moment(tx, 3, 2), jcal.patch_second_moment(jx, 3, 2)),
             (cal.channel_second_moment(tx), jcal.channel_second_moment(jx))]
    for kernel in (3, (3, 2), 1):
        for stat in ("strips", "patches", "channels"):
            pairs.append((cal.site_statistic(stat, tx, Conv2d(5, 4, kernel)),
                          jcal.site_statistic(stat, jx, JConv2d(5, 4, kernel))))
    for got, want in pairs:
        assert got.shape == want.shape
        assert rel(got.numpy(), want) < MOMENT_TOL
    assert cal.site_statistic("raw", tx, Conv2d(5, 4, 3)) is tx
    with pytest.raises(ValueError, match="unknown calibration statistic"):
        cal.site_statistic("rows", tx, Conv2d(5, 4, 3))


def recording(app):
    """``app`` with every ``set_calibration`` call recorded in ``app.seen``."""
    app.seen = {}
    original = app.set_calibration

    def record(index, xcov):
        app.seen[index] = np.asarray(xcov.cpu() if isinstance(xcov, torch.Tensor) else xcov)
        original(index, xcov)

    app.set_calibration = record
    return app


def make_apps(stat):
    name, kw = APPS[stat]
    japp, app = getattr(jcore, name)(**kw), getattr(core, name)(**kw)
    if stat == "raw":
        japp.calibration_stat = app.calibration_stat = "raw"
    return recording(japp), recording(app)


@pytest.fixture(scope="module")
def tiny():
    """The narrow model's JAX parameters, flat numpy."""
    params = JTiny().init(jax.random.key(0))
    return {k: np.asarray(v) for k, v in flatten_tree({"params": params}).items()}


def models(flat):
    """A fresh (JAX model, variables, port model) triple with the same weights."""
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)["params"]),
             "state": {}}
    model = Tiny()
    model.load_state_dict(params_from_jax(flat))
    return JTiny(), jvars, channels_last(model).eval()


def assert_same_moments(stat, japp, app):
    assert sorted(app.seen) == sorted(japp.seen) == [0, 1, 2]
    for idx in range(3):
        got, want = app.seen[idx], japp.seen[idx]
        if stat == "raw":
            got = got.transpose(0, 2, 3, 1)  # the port taps NCHW maps
        assert got.shape == want.shape
        assert rel(got, want) < MOMENT_TOL, (stat, idx)


@pytest.mark.parametrize("stat", list(APPS))
def test_hook_hands_the_jax_moments(tiny, stat):
    jmodel, jvars, model = models(tiny)
    japp, app = make_apps(stat)
    key = jax.random.key(0)
    jmodel.register_switchable(japp.src_type, [jfilters.SimpleConvFilter()])
    for idx, name in enumerate(jmodel.switchable_names):
        sub, sp = japp.initialize(jmodel.get_switchable_module(idx),
                                  tree_get(jvars["params"], name), _stable_fold(key, name))
        jmodel.set_switchable_module(idx, sub, jvars, {"params": sp})
    model.register_switchable(app.src_type, [filters.SimpleConvFilter()])
    assert model.switchable_names == jmodel.switchable_names == SITES
    for idx in range(model.length_switchable):
        model.set_switchable_module(idx, app.initialize(model.get_switchable_module(idx)).eval())
    kw = dict(num_batches=2, batch_size=2, image_size=(SIZE, SIZE))
    jcal.CalibrationHook(SimpleNamespace(model=jmodel, app=japp, variables=jvars), 30,
                         **kw).after_initialize()
    hook = cal.CalibrationHook(SimpleNamespace(model=model, app=app, device="cpu"), 30, **kw)
    hook.after_initialize()
    assert hook.calibrated == [0, 1, 2]
    assert_same_moments(stat, japp, app)
    # the taps are released and the routing restored
    assert all(not s.capture_inputs and s.inp is None and s.force_branch is None
               for s in model.switchable_modules())


@pytest.mark.parametrize("stat", ["strips", "patches", "channels"])
def test_apply_app_calibrates_like_jax(tiny, stat):
    jmodel, jvars, model = models(tiny)
    japp, app = make_apps(stat)
    rs = np.random.RandomState(4)
    batches = [rs.randn(2, SIZE, SIZE, 3).astype(np.float32) for _ in range(2)]
    assert japply_app(jmodel, jvars, japp, [jfilters.SimpleConvFilter()],
                      calib_batches=[jnp.asarray(b) for b in batches]) == 3
    assert apply_app(model, app, [filters.SimpleConvFilter()],
                     calib_batches=[nchw(b) for b in batches]) == 3
    assert_same_moments(stat, japp, app)
    x = rs.randn(2, SIZE, SIZE, 3).astype(np.float32)
    y_j = np.asarray(jmodel.apply(jvars["params"], jnp.asarray(x), state=jvars["state"])[0])
    with torch.no_grad():
        y = model.eval()(nchw(x)).numpy()
    assert rel(y, y_j) < LOGITS_TOL


def test_hook_skips_an_app_without_calibration():
    model = Tiny()
    app = core.LowRankExpV1(num_bases=(4,))
    hook = cal.CalibrationHook(SimpleNamespace(model=model, app=app, device="cpu"), 30)
    hook.after_initialize()
    assert hook.calibrated == []
