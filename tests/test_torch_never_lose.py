"""The port's ``rematerialize_dense`` and ``never_lose_deploy`` against the JAX
package's.

Each factored layer gets the same weights in both packages (numpy, from a seed,
into the shapes of the JAX init; ``convert.params_from_jax`` carries them):
the port's dense kernel equals JAX's (HWIO, transposed to OIHW) to 1e-6
relative, and the dense conv's output equals the JAX factored layer's to the
JAX test's 1e-5 (``tests/test_never_lose.py``).  The arbiter's decision tables
under the JAX test's fake timers (a base second plus a delta per site still
factored) equal JAX's, on the same two-conv network with scheme-1 sites.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import convnet_approximater_tpu.layers as jlayers  # noqa: E402
import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.core import LowRankExpV1 as JLowRankExpV1  # noqa: E402
from convnet_approximater_tpu.deploy import never_lose_deploy as jnever_lose  # noqa: E402
from convnet_approximater_tpu.deploy import rematerialize_dense as jremat  # noqa: E402
from convnet_approximater_tpu.deploy_planner import apply_app as japply  # noqa: E402
from convnet_approximater_tpu.filters import SimpleConvFilter as JSimpleConvFilter  # noqa: E402
from convnet_approximater_tpu.models import SwitchableModel as JSwitchableModel  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import layers  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import LowRankExpV1  # noqa: E402
from convnet_approximater_tpu_torch.deploy import (never_lose_deploy,  # noqa: E402
                                                   rematerialize_dense)
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.filters import SimpleConvFilter  # noqa: E402
from convnet_approximater_tpu_torch.models.switchable import SwitchableModel  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear, ReLU, channels_last  # noqa: E402

torch.set_num_threads(1)
WEIGHT_RTOL = 1e-6
OUT_RTOL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def drawn(jmod, seed: int) -> dict:
    """Params of the JAX module ``jmod``, normal * 0.2 from numpy into the
    shapes of its init."""
    shapes = jser.flatten_tree(jax.eval_shape(jmod.init, jax.random.key(0)))
    rs = np.random.RandomState(seed)
    return jser.unflatten_tree({k: (rs.randn(*v.shape) * 0.2).astype(np.float32)
                                for k, v in sorted(shapes.items())})


def port_of(mod, params):
    mod.load_state_dict(params_from_jax(jser.flatten_tree({"params": params})))
    return channels_last(mod).eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


LAYERS = {
    "v1": lambda J: J.LowRankExpConvV1(6, 10, 5, 2, 2, num_base=3),
    "v1 decomposed": lambda J: J.LowRankExpConvV1(6, 10, 5, 2, 2, num_base=3, decomp=True),
    "v2": lambda J: J.LowRankExpConvV2(5, 9, 4, 3, 1, 1),
    "v3": lambda J: J.LowRankExpConvV3(6, 10, 4, 3, 2, 1),
    "v4": lambda J: J.LowRankExpConvV4(6, 10, (3, 5), 3, 1, 1),
    "cascade": lambda J: J.CascadeConv(6, 7, 3, bias=True, first_bias=False),
    "parallel": lambda J: J.ParallelConv(6, 5, 2, 3, all_bias=False, identity=False),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rematerialize_dense_matches_jax(name):
    jmod = LAYERS[name](jlayers)
    params = drawn(jmod, seed=len(name))
    mod = port_of(LAYERS[name](layers), params)
    C = mod.dim if hasattr(mod, "dim") else mod.in_channels
    x = np.random.RandomState(3).randn(2, 17, 15, C).astype(np.float32)
    y_factored = np.asarray(jmod.apply(params, jax.numpy.asarray(x), training=False)[0])

    jconv, jp = jremat(jmod, params)
    conv = rematerialize_dense(mod)
    assert isinstance(conv, Conv2d) and not conv.training
    assert (conv.kernel_size, conv.stride, conv.padding, conv.groups) == (
        jconv.kernel_size, jconv.stride, jconv.padding, jconv.groups)
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert rel(conv.weight.detach().numpy(), np.transpose(np.asarray(jp["weight"]),
                                                          (3, 2, 0, 1))) < WEIGHT_RTOL
    assert (conv.bias is None) == ("bias" not in jp)
    if conv.bias is not None:
        np.testing.assert_allclose(conv.bias.detach().numpy(), np.asarray(jp["bias"]),
                                   rtol=WEIGHT_RTOL)
    with torch.no_grad():
        y = conv(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert rel(y, y_factored) < OUT_RTOL


def test_rematerialize_dense_refuses_what_has_no_dense_form():
    grouped = layers.LowRankExpConvV2(5, 9, 4, 3, 1, 1, grouped=True)
    jgrouped = jlayers.LowRankExpConvV2(5, 9, 4, 3, 1, 1, grouped=True)
    assert rematerialize_dense(grouped) is None
    assert jremat(jgrouped, drawn(jgrouped, 0)) is None
    with_first_bias = layers.CascadeConv(6, 7, 3, bias=True, first_bias=True)
    msca_bank = layers.ParallelConv(6, 5, 2, 2, all_bias=False, identity=True)
    assert rematerialize_dense(with_first_bias) is None
    assert rematerialize_dense(msca_bank) is None
    assert rematerialize_dense(Conv2d(3, 4, 3)) is None


class JArbiterNet(JSwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = jnn.Sequential(jnn.Conv2d(3, 8, 5, padding=2), jnn.ReLU(),
                                       jnn.Conv2d(8, 12, 5, padding=2), jnn.ReLU())
        self.head = jnn.Linear(12, 4)

    def __call__(self, params, x, ctx):
        x = self.child("features", params, x, ctx)
        return self.child("head", params, x.mean(axis=(1, 2)), ctx)


class ArbiterNet(SwitchableModel):
    def __init__(self):
        super().__init__()
        self.features = torch.nn.Sequential(Conv2d(3, 8, 5, padding=2), ReLU(),
                                            Conv2d(8, 12, 5, padding=2), ReLU())
        self.head = Linear(12, 4)

    def forward(self, x):
        return self.head(self.features(x).mean(dim=(2, 3)))


def decomposed_nets():
    """The JAX and port two-conv networks on the same weights, each conv a
    scheme-1 site of 3 bases, decomposed."""
    jmodel = JArbiterNet()
    variables = {"params": drawn(jmodel, 7), "state": {}}
    model = port_of(ArbiterNet(), variables["params"])
    kw = dict(num_bases=(3, 3), max_iter=0, lmda_length=1, min_lmda=0, max_lmda=0,
              init_method="svd", do_decomp=True)
    assert japply(jmodel, variables, JLowRankExpV1(**kw), [JSimpleConvFilter()],
                  jax.random.key(0)) == 2
    assert apply_app(model, LowRankExpV1(**kw), [SimpleConvFilter()]) == 2
    return jmodel, variables, model


def fake_timers(delta):
    """The JAX test's timer (1 s plus ``delta[i]`` per site i still factored),
    in each package's signature."""
    def t(model):
        return 1.0 + sum(delta[i] for i, m in enumerate(model.switchable_modules())
                         if type(m).__name__ == "LowRankExpConvV1")

    return (lambda model, variables, shape, dtype: t(model)), (lambda model, shape: t(model))


@pytest.mark.parametrize("delta", [{0: -0.2, 1: -0.1}, {0: 0.5, 1: -0.2}, {0: 0.5, 1: 0.4},
                                   {0: -0.1, 1: 0.2}])
@pytest.mark.parametrize("greedy", [True, False])
def test_never_lose_decisions_match_jax(delta, greedy):
    jmodel, variables, model = decomposed_nets()
    x = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        y_before = model(nchw(x)).numpy()
    jtime, time = fake_timers(delta)
    want = jnever_lose(jmodel, variables, (2, 16, 16, 3), time_fn=jtime, greedy=greedy,
                       verbose=False)
    got = never_lose_deploy(model, (2, 16, 16, 3), time_fn=time, greedy=greedy, verbose=False)
    assert got == want
    kinds = [type(m).__name__ for m in model.switchable_modules()]
    jkinds = [type(m).__name__ for m in jmodel.switchable_modules()]
    assert kinds == jkinds
    with torch.no_grad():
        y_after = model(nchw(x)).numpy()
    assert rel(y_after, y_before) < OUT_RTOL  # the dense forms are exact


def test_never_lose_default_timer_returns_seconds():
    _, _, model = decomposed_nets()
    res = never_lose_deploy(model, (2, 16, 16, 3), num_iters=2, verbose=False)
    assert set(res) == {"t_decomposed", "t_dense", "t_final", "layers", "kept_decomposed"}
    for k in ("t_decomposed", "t_dense", "t_final"):
        assert 0 < res[k] < 10  # seconds of a 2-image forward of two small convs
    assert res["t_final"] <= max(res["t_decomposed"], res["t_dense"])
