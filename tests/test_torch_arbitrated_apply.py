"""The port's ``arbitrated_apply`` against the JAX package's.

The eight scenarios of ``tests/test_arbitrated_apply.py`` (FfnRep on a tiny
MSCAN under fake timers: a base second plus a delta per site in MergedFFN form)
run in both packages on the same weights (numpy, from a seed; BN statistics of
order 1), and give the same decisions, timings, site forms and logits (1e-4
relative; the FfnRep solve sums in another order).  The JAX boundary-band
scenario decides on the min of its two readings, the port on their mean: the
decisions agree there, and ``t_final`` is each package's reading.

Then one test for each reference fault the port corrects (ROADMAP.md §3): a
replay with a cursor app after a kept-original site, a decisions table of
another model, and a boundary-band site whose two readings straddle the
threshold.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.core import FfnRep as JFfnRep  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV1 as JLowRankExpV1  # noqa: E402
from convnet_approximater_tpu.deploy import arbitrated_apply as jarbitrated  # noqa: E402
from convnet_approximater_tpu.filters import SimpleConvFilter as JSimpleConvFilter  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import FfnRep, LowRankExpV1  # noqa: E402
from convnet_approximater_tpu_torch.deploy import arbitrated_apply, site_generator  # noqa: E402
from convnet_approximater_tpu_torch.filters import SimpleConvFilter  # noqa: E402
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear, ReLU, channels_last  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-4
TINY = dict(num_channels=(8, 16), num_blocks=(2, 2), exp_ratios=(4, 4), num_classes=7)
SHAPE = (2, 32, 32, 3)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


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


def mscans(seed: int = 11):
    jmodel = JClassifier(**TINY)
    variables = drawn(jmodel, seed)
    return jmodel, variables, port_of(MSCAN_Classifier(**TINY), variables)


def images(seed: int):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def jax_logits(jmodel, variables, x):
    return np.asarray(jmodel.apply(variables["params"], jnp.asarray(x), state=variables["state"],
                                   training=False)[0])


def port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).numpy()


def timers(per_site):
    """1 s plus the delta of each site in MergedFFN form, in both signatures;
    ``per_site`` may also be a sequence of readings, returned in turn."""
    if isinstance(per_site, dict):
        def t(model):
            return 1.0 + sum(per_site[i] for i, m in enumerate(model.switchable_modules())
                             if type(m).__name__ == "MergedFFN")

        return (lambda m, v, s, d: t(m)), (lambda m, s: t(m))
    jseq, seq = iter(per_site), iter(per_site)
    return (lambda m, v, s, d: next(jseq)), (lambda m, s: next(seq))


SCENARIOS = {
    "wins whole": dict(per_site={0: -0.2, 1: -0.1, 2: -0.1, 3: -0.1}),
    "greedy keeps winners": dict(per_site={0: -0.2, 1: -0.1, 2: 0.5, 3: 0.5}),
    "all lose": dict(per_site={i: 0.5 for i in range(4)}),
    "margin": dict(per_site={i: -0.005 for i in range(4)}, margin=0.03),
    "greedy off": dict(per_site={0: -0.1, 1: 0.2, 2: 0.2, 3: 0.2}, greedy=False),
    "group by stage": dict(per_site={0: -0.2, 1: -0.1, 2: 0.5, 3: 0.5}, stages=True),
    "boundary band": dict(per_site=[1.2, 1.0, 0.965, 0.90], one_group=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_arbitrated_apply_matches_jax(name):
    sc = dict(SCENARIOS[name])
    jtime, time = timers(sc.pop("per_site"))
    kw = dict(margin=sc.pop("margin", 0.03), greedy=sc.pop("greedy", True))
    if sc.pop("stages", False):
        kw["group_fn"] = lambda n: n.rsplit(".", 3)[0]
    if sc.pop("one_group", False):
        kw["group_fn"] = lambda n: "all"
    jmodel, variables, model = mscans()
    x = images(2)
    y_ref = jax_logits(jmodel, variables, x)
    assert rel(port_logits(model, x), y_ref) < RTOL
    want = jarbitrated(jmodel, variables, JFfnRep(fix=True), [], SHAPE, verbose=False,
                       time_fn=jtime, **kw)
    got = arbitrated_apply(model, FfnRep(fix=True), [], SHAPE, verbose=False, time_fn=time,
                           **kw)
    if name == "boundary band":  # the mean of 0.965 and 0.90, not the min
        assert want["t_final"] == pytest.approx(0.90) and got["t_final"] == pytest.approx(0.9325)
        got["t_final"] = want["t_final"]
    assert got == want
    assert ([type(m).__name__ for m in model.switchable_modules()]
            == [type(m).__name__ for m in jmodel.switchable_modules()])
    y_j, y = jax_logits(jmodel, variables, x), port_logits(model, x)
    assert rel(y, y_j) < RTOL and rel(y, y_ref) < RTOL
    if want["kept_applied"] == 0:  # every original restored as it was
        np.testing.assert_array_equal(y, port_logits(mscans()[2], x))


def test_decisions_persist_and_replay_as_jax(tmp_path):
    """The measured run writes JAX's table; a replay on a fresh model times
    nothing and rebuilds the measured structure and logits; ``retime``
    measures again and writes the new table."""
    jtime, time = timers({0: -0.2, 1: -0.1, 2: 0.5, 3: 0.5})
    jpath, path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jmodel, variables, model = mscans()
    jarbitrated(jmodel, variables, JFfnRep(fix=True), [], SHAPE, verbose=False, time_fn=jtime,
                decisions_path=jpath)
    res = arbitrated_apply(model, FfnRep(fix=True), [], SHAPE, verbose=False, time_fn=time,
                           decisions_path=path)
    assert "replayed" not in res
    assert open(path).read() == open(jpath).read()

    def poisoned(*a, **k):
        raise AssertionError("a replay must not time")

    replay = mscans()[2]
    res2 = arbitrated_apply(replay, FfnRep(fix=True), [], SHAPE, verbose=False,
                            time_fn=poisoned, decisions_path=path)
    assert res2["replayed"] and res2["decisions"] == json.load(open(path))
    assert ([type(m).__name__ for m in replay.switchable_modules()]
            == [type(m).__name__ for m in model.switchable_modules()])
    x = images(5)
    np.testing.assert_array_equal(port_logits(replay, x), port_logits(model, x))

    _, time3 = timers({i: 0.5 for i in range(4)})
    res3 = arbitrated_apply(mscans()[2], FfnRep(fix=True), [], SHAPE, verbose=False,
                            retime=True, time_fn=time3, decisions_path=path)
    assert res3["kept_applied"] == 0 and json.load(open(path)) == res3["decisions"]


class JConvs(JSwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = jnn.Sequential(jnn.Conv2d(3, 8, 3, padding=1), jnn.ReLU(),
                                       jnn.Conv2d(8, 12, 3, padding=1), jnn.ReLU())
        self.head = jnn.Linear(12, 4)

    def __call__(self, params, x, ctx):
        return self.child("head", params, self.child("features", params, x, ctx).mean(
            axis=(1, 2)), ctx)


class Convs(SwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), ReLU(),
                                            Conv2d(8, 12, 3, padding=1), ReLU())
        self.head = Linear(12, 4)

    def forward(self, x):
        return self.head(self.features(x).mean(dim=(2, 3)))


def conv_pair():
    jmodel = JConvs()
    variables = drawn(jmodel, 3)
    return jmodel, variables, port_of(Convs(), variables)


def v1(jax_app: bool):
    kw = dict(num_bases=(2, 3), max_iter=0, lmda_length=1, min_lmda=0, max_lmda=0)
    return JLowRankExpV1(**kw) if jax_app else LowRankExpV1(**kw)


def test_replay_advances_a_cursor_app_past_kept_original_sites():
    """Site 0 kept original, site 1 applied: the measured run gave site 1 the
    second rank of the cursor (3); the JAX replay initializes only site 1, so
    its cursor hands it the first rank (2); the port's replay gives it 3."""
    def keep_second(model, *_):
        mods = list(model.switchable_modules())
        return 1.0 + (0.5 if type(mods[0]).__name__ == "LowRankExpConvV1" else 0) \
            - (0.2 if type(mods[1]).__name__ == "LowRankExpConvV1" else 0)

    measured = conv_pair()[2]
    res = arbitrated_apply(measured, v1(False), [SimpleConvFilter()], (2, 8, 8, 3),
                           verbose=False, time_fn=keep_second)
    table = res["decisions"]
    assert table == {"features.0": "original", "features.2": "applied"}
    assert measured.features[2].num_base == 3

    replay = conv_pair()[2]
    arbitrated_apply(replay, v1(False), [SimpleConvFilter()], (2, 8, 8, 3), decisions=table)
    assert isinstance(replay.features[0], Conv2d) and replay.features[2].num_base == 3
    x = np.random.RandomState(4).randn(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(port_logits(replay, x), port_logits(measured, x))

    jmodel, variables, _ = conv_pair()
    jarbitrated(jmodel, variables, v1(True), [JSimpleConvFilter()], (2, 8, 8, 3),
                decisions=table)
    assert jmodel.get_switchable_module(1).num_base == 2  # the reference's drift


def test_replay_refuses_a_table_of_another_model():
    foreign = {"backbone.layers.0.1.0.mlp": "applied"}
    model = conv_pair()[2]
    with pytest.raises(ValueError, match="features.0") as err:
        arbitrated_apply(model, v1(False), [SimpleConvFilter()], (2, 8, 8, 3), decisions=foreign)
    assert "backbone.layers.0.1.0.mlp" in str(err.value)
    jmodel, variables, _ = conv_pair()
    res = jarbitrated(jmodel, variables, v1(True), [JSimpleConvFilter()], (2, 8, 8, 3),
                      decisions=foreign)
    assert res["kept_applied"] == 0  # the reference replays nothing and says nothing


def test_boundary_band_decides_on_the_mean_of_two_readings():
    """One group of all sites; readings: all applied 1.2, all original 1.0,
    the group 0.965 (inside the band of the 0.97 threshold), then 0.99.  Their
    min (JAX) keeps the group on its one lucky reading; their mean (0.9775,
    the port) rejects it."""
    readings = [1.2, 1.0, 0.965, 0.99]
    jtime, time = timers(readings)
    jmodel, variables, model = mscans()
    want = jarbitrated(jmodel, variables, JFfnRep(fix=True), [], SHAPE, verbose=False,
                       group_fn=lambda n: "all", time_fn=jtime)
    got = arbitrated_apply(model, FfnRep(fix=True), [], SHAPE, verbose=False,
                           group_fn=lambda n: "all", time_fn=time)
    assert want["kept_applied"] == 4 and want["t_final"] == pytest.approx(0.965)
    assert got["kept_applied"] == 0 and got["t_final"] == pytest.approx(1.0)
    assert not any(type(m).__name__ == "MergedFFN" for m in model.switchable_modules())


def test_site_generator_depends_on_the_seed_and_the_name_alone():
    """A site's new weights come from its name: its generator draws the same
    whether other sites drew before it or not."""
    first = site_generator(0, "features.2")
    torch.randn(5, generator=site_generator(0, "features.0"))
    after = site_generator(0, "features.2")
    draw = torch.randn(8, generator=first)
    assert torch.equal(draw, torch.randn(8, generator=after))
    assert not torch.equal(draw, torch.randn(8, generator=site_generator(0, "features.0")))
    assert not torch.equal(draw, torch.randn(8, generator=site_generator(1, "features.2")))
