"""The PyTorch port's leaf layers and strip-conv blocks against the JAX package.

The same numpy inputs, made from a seed, go through the JAX module (weights
from its ``init``) and the port's counterpart (the same weights, carried
across by ``params_from_jax``).  Tolerance: 1e-5 relative, the bound of the
JAX package's kernel tests; the two sides differ only in summation order.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.layers import depth_separable_conv as jdsc  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import nn as tnn  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import (CascadeConv, FixPaddingBias,  # noqa: E402
                                                   ParallelConv)

torch.set_num_threads(1)
RTOL = 1e-5


def carry(tmod, params, state=None):
    """Load JAX ``params``/``state`` into the torch module ``tmod`` (strict)."""
    flat = flatten_tree({"params": params, "state": state or {}})
    tmod.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return tmod.eval()


def run_jax(mod, params, x, state=None):
    y, _, _ = mod.apply(params, jax.numpy.asarray(x), state=state or {}, training=False)
    return np.asarray(y)


def run_torch(mod, x):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    with torch.no_grad():
        y = mod(xt)
    return y.permute(0, 2, 3, 1).numpy() if y.dim() == 4 else y.numpy()


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,k,stride,groups", [
    (8, 8, 5, 1, 8),     # depthwise (MSCA conv0)
    (8, 8, 3, 1, 8),     # depthwise (FFN dconv)
    (3, 8, 3, 2, 1),     # dense, strided (stem)
    (8, 16, 1, 1, 1),    # pointwise
])
def test_conv2d_matches_jax(cin, cout, k, stride, groups):
    jmod = jnn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups)
    params = jmod.init(jax.random.key(0))
    tmod = carry(tnn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups), params)
    x = nhwc(1, 2, 11, 13, cin)
    assert rel(run_torch(tmod, x), run_jax(jmod, params, x)) < RTOL


def test_batchnorm_eval_matches_jax():
    C = 8
    rs = np.random.RandomState(2)
    jmod = jnn.BatchNorm2d(C)
    params = {"scale": rs.randn(C).astype(np.float32), "bias": rs.randn(C).astype(np.float32)}
    state = {"mean": rs.randn(C).astype(np.float32),
             "var": rs.uniform(0.5, 2.0, C).astype(np.float32)}
    tmod = carry(tnn.BatchNorm2d(C), params, state)
    assert set(tmod.state_dict()) == {"weight", "bias", "running_mean", "running_var"}
    x = nhwc(3, 2, 6, 7, C)
    assert rel(run_torch(tmod, x), run_jax(jmod, params, x, state)) < RTOL


def test_batchnorm_train_updates_running_stats_like_jax():
    C = 4
    jmod = jnn.Sequential(jnn.BatchNorm2d(C))
    params = jmod.init(jax.random.key(4))
    state = jmod.init_state()
    x = nhwc(5, 3, 5, 5, C)
    y_j, new_state, _ = jmod.apply(params, jax.numpy.asarray(x), state=state, training=True)
    tmod = carry(tnn.BatchNorm2d(C), params["0"], state["0"]).train()
    y_t = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    assert rel(y_t, np.asarray(y_j)) < RTOL
    for jname, tname in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(tmod, tname).numpy(), np.asarray(new_state["0"][jname]),
                                   rtol=RTOL, atol=1e-7)


def test_layernorm_over_channels_matches_jax():
    C = 16
    rs = np.random.RandomState(6)
    jmod = jnn.LayerNorm(C)
    params = {"scale": rs.randn(C).astype(np.float32), "bias": rs.randn(C).astype(np.float32)}
    tmod = carry(tnn.LayerNorm(C), params)
    x = nhwc(7, 2, 5, 6, C) * 3 + 1
    assert rel(run_torch(tmod, x), run_jax(jmod, params, x)) < RTOL


def test_linear_matches_jax():
    jmod = jnn.Linear(16, 10)
    params = jmod.init(jax.random.key(8))
    tmod = carry(tnn.Linear(16, 10), params)
    x = nhwc(9, 4, 16)
    with torch.no_grad():
        y = tmod(torch.from_numpy(x)).numpy()
    assert rel(y, run_jax(jmod, params, x)) < RTOL


@pytest.mark.parametrize("env", [None, "CAT_EXACT_GELU", "CAT_FAST_GELU"])
def test_gelu_form_matches_jax(monkeypatch, env):
    if env:
        monkeypatch.setenv(env, "1")
    x = nhwc(10, 2, 4, 4, 8) * 3
    y_t = run_torch(tnn.GELU(), x)
    assert rel(y_t, run_jax(jnn.GELU(), {}, x)) < RTOL
    # the default is the tanh form, not torch's erf default
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(tanh - erf).max() > 1e-4
    np.testing.assert_allclose(y_t, erf if env == "CAT_EXACT_GELU" else tanh, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,bias,first_bias", [(7, True, True), (21, True, False)])
def test_cascade_conv_matches_jax(k, bias, first_bias):
    C = 8
    jmod = jdsc.CascadeConv(C, k, k // 2, bias=bias, first_bias=first_bias)
    params = jmod.init(jax.random.key(11))
    tmod = carry(CascadeConv(C, k, k // 2, bias=bias, first_bias=first_bias), params)
    x = nhwc(12, 2, 14, 9, C)
    assert rel(run_torch(tmod, x), run_jax(jmod, params, x)) < RTOL


@pytest.mark.parametrize("all_bias,identity", [(True, True), (False, False)])
def test_parallel_conv_matches_jax(all_bias, identity):
    C, ks = 8, [7, 11, 21]
    jmod = jdsc.ParallelConv(C, ks, [k // 2 for k in ks], 3, all_bias=all_bias, identity=identity)
    params = jmod.init(jax.random.key(13))
    tmod = carry(ParallelConv(C, ks, [k // 2 for k in ks], 3, all_bias=all_bias,
                              identity=identity), params)
    x = nhwc(14, 2, 14, 12, C)
    assert rel(run_torch(tmod, x), run_jax(jmod, params, x)) < RTOL


@pytest.mark.parametrize("H", [7, 14, 28])
def test_fix_padding_bias_matches_jax(H):
    """Top and bottom strips both apply where they overlap (H < 2 p)."""
    C, p = 8, 10
    jmod = jdsc.FixPaddingBias(C, p)
    params = jmod.init(jax.random.key(15))
    tmod = carry(FixPaddingBias(C, p), params)
    x = nhwc(16, 2, H, 5, C)
    np.testing.assert_allclose(run_torch(tmod, x), run_jax(jmod, params, x), rtol=RTOL, atol=1e-6)


def test_init_weights_is_seeded_and_matches_jax_bounds():
    def draw(seed):
        m = CascadeConv(16, 21, 10, bias=True, first_bias=True)
        tnn.init_weights(m, torch.Generator().manual_seed(seed))
        return m.conv1.weight.detach().clone()

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 21 ** -0.5  # fan_in = 1 * 1 * 21
