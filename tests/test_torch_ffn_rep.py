"""The port's FfnRep, MergedFFN and FixPaddingBias2d against the JAX package's.

``FixPaddingBias2d`` and ``merged_ffn_solve`` must equal JAX's to 1e-5
(relative), at maps down to below the frame width.  The FfnRep'd
``MergedFFN`` must equal the unmerged ``FFN`` everywhere, borders included,
at the JAX tests' own tolerance (``tests/test_ffn_rep.py``: rtol 1e-4, atol
1e-5; the merged conv sums in another order), and JAX's ``MergedFFN`` on the
same params to 1e-5.  At the model level (a tiny MSCAN with layer scales 1 and
random BN statistics), MscaRep(1, fix) -> FfnRep on FFNs 1-2 -> fold_batchnorm
-> enable_pw_matmul gives the JAX chain's logits, and the plain d1+fix
model's, to 1e-4 (SVDs from another LAPACK call, and sums in another order
through the network).
"""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.core import FfnRep as JFfnRep  # noqa: E402
from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.core import ffn_rep as jffn  # noqa: E402
from convnet_approximater_tpu.deploy import enable_pw_matmul as jenable_pw  # noqa: E402
from convnet_approximater_tpu.deploy import fold_batchnorm as jfold  # noqa: E402
from convnet_approximater_tpu.deploy_planner import apply_app as japply  # noqa: E402
from convnet_approximater_tpu.filters import IndicesFilter as JIndicesFilter  # noqa: E402
from convnet_approximater_tpu.layers import FixPaddingBias2d as JFix2d  # noqa: E402
from convnet_approximater_tpu.layers import MergedFFN as JMergedFFN  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.models.mscan import FFN as JFFN  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree, unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import FfnRep, MscaRep, merged_ffn_solve  # noqa: E402
from convnet_approximater_tpu_torch.deploy import enable_pw_matmul, fold_batchnorm  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.filters import IndicesFilter  # noqa: E402
from convnet_approximater_tpu_torch.layers import (MSCA, FixPaddingBias2d,  # noqa: E402
                                                   MergedFFN)
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.models.mscan import FFN  # noqa: E402
from convnet_approximater_tpu_torch.nn import (Conv2d, Identity, channels_last,  # noqa: E402
                                               init_weights)

torch.set_num_threads(1)
RTOL = 1e-5
LOGITS_RTOL = 1e-4
TINY = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=10)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def load(tmod, params, state=None):
    tree = {"params": params}
    if state:
        tree["state"] = state
    flat = {k: np.asarray(v) for k, v in flatten_tree(tree).items()}
    tmod.load_state_dict(params_from_jax(flat))
    return tmod.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("p,H,W", [(2, 9, 11), (2, 3, 7), (2, 1, 5), (2, 6, 1), (1, 5, 2),
                                   (3, 4, 13)])
def test_fix_padding_bias_2d_matches_jax(p, H, W):
    """Maps above 2p, below 2p (the strips overlap) and below p (clipped)."""
    C = 6
    rs = np.random.RandomState(p * 100 + H * 10 + W)
    params = {"res_v": rs.randn(2, C, p).astype(np.float32),
              "res_h": rs.randn(2, C, p).astype(np.float32),
              "res_c": rs.randn(2, 2, C, p, p).astype(np.float32)}
    x = rs.randn(2, H, W, C).astype(np.float32)
    y_j = np.asarray(JFix2d(C, p).apply({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(x))[0])
    fix = load(FixPaddingBias2d(C, p), params)
    with torch.no_grad():  # the cached map
        y_cached = nhwc(fix(nchw(x)))
    xt = nchw(x).requires_grad_(True)
    y = fix(xt)  # built per call under autograd, so the params take gradients
    y.sum().backward()
    assert rel(y_cached, y_j) < RTOL and rel(nhwc(y), y_j) < RTOL
    assert all(t.grad is not None for t in (fix.res_v, fix.res_h, fix.res_c))


def test_fix_padding_bias_2d_cache_follows_the_weights():
    fix = FixPaddingBias2d(4, 2).eval()
    x = torch.zeros(1, 4, 6, 7)
    with torch.no_grad():
        y0 = fix(x)
        m = fix._maps[(6, 7)]
        fix(torch.zeros(1, 4, 9, 9))  # another size keeps the first map where it is
        assert fix._maps[(6, 7)] is m
        fix.res_c.add_(1.0)
        y1 = fix(x)
    assert fix._maps[(6, 7)] is not m and not torch.equal(y0, y1)
    torch.testing.assert_close(y1[0].permute(1, 2, 0), fix.correction(6, 7).detach())


def _rand_ffn_params(C, M, k, seed):
    rs = np.random.RandomState(seed)

    def u(*shape):
        return (rs.rand(*shape).astype(np.float32) * 2 - 1) * 0.5

    return {"fc1": {"weight": u(1, 1, C, M), "bias": u(M)},
            "dconv": {"weight": u(k, k, 1, M), "bias": u(M)},
            "fc2": {"weight": u(1, 1, M, C), "bias": u(C)}}


def _ffn_pair(C, M, k, seed):
    """The same FFN in both packages (the JAX one with a k x k dconv)."""
    jffn_mod = JFFN(C, M, drop=0.0)
    if k != 3:
        jffn_mod.dconv = jnn.Conv2d(M, M, k, padding=k // 2, groups=M)
    params = _rand_ffn_params(C, M, k, seed)
    tffn = FFN(C, M, drop=0.0)
    if k != 3:
        tffn.dconv = Conv2d(M, M, k, padding=k // 2, groups=M)
    return jffn_mod, params, load(tffn, params)


@pytest.mark.parametrize("k", [3, 5])
def test_merged_ffn_solve_matches_jax(k):
    _, params, tffn = _ffn_pair(7, 12, k, seed=k)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    got_j = jffn.merged_ffn_solve(jp["fc1"], jp["dconv"], k // 2)
    with torch.no_grad():
        got = merged_ffn_solve(tffn.fc1, tffn.dconv, k // 2)
    names = ("weight", "bias", "res_v", "res_h", "res_c")
    for name, a, b in zip(names, got, got_j):
        b = np.asarray(b)
        if name == "weight":
            b = b.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        assert tuple(a.shape) == b.shape, name
        assert rel(a.numpy(), b) < RTOL, name


def _jax_merged(jffn_mod, params, fix):
    app = JFfnRep(fix=fix)
    sub, sp = app.initialize(jffn_mod, jax.tree_util.tree_map(jnp.asarray, params))
    app.optimize(sub, sp)
    return app.postprocess(sub, sp)


def _torch_merged(tffn, fix):
    app = FfnRep(fix=fix)
    sub = app.initialize(tffn, torch.Generator().manual_seed(0))
    app.optimize(sub)
    return app.postprocess(sub).eval()


@pytest.mark.parametrize("k,H,W", [(3, 13, 11), (5, 9, 14), (3, 8, 8), (5, 3, 4), (7, 2, 5)])
def test_ffn_rep_exact_and_matches_jax(k, H, W):
    """The JAX cases, and maps below 2p and below p, where the closed form
    holds too (both strips of a side overlap or are clipped)."""
    C, M = 5, 12
    jffn_mod, params, tffn = _ffn_pair(C, M, k, seed=H + W)
    merged = _torch_merged(tffn, fix=True)
    assert isinstance(merged, MergedFFN) and isinstance(merged.fix, FixPaddingBias2d)
    np.testing.assert_array_equal(merged.fc2.weight.detach().numpy(),
                                  tffn.fc2.weight.detach().numpy())
    x = np.random.RandomState(7).randn(2, H, W, C).astype(np.float32)
    with torch.no_grad():
        y_ref, y = nhwc(tffn(nchw(x))), nhwc(merged(nchw(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    jtgt, jparams = _jax_merged(jffn_mod, params, fix=True)
    y_j = np.asarray(jtgt.apply(jparams, jnp.asarray(x))[0])
    assert rel(y, y_j) < RTOL


def test_ffn_rep_without_fix_differs_at_border_only():
    """fix=False is exact inside the frame and wrong within p of an edge."""
    C, M, k, H, W = 4, 8, 3, 10, 12
    p = k // 2
    _, _, tffn = _ffn_pair(C, M, k, seed=3)
    merged = _torch_merged(tffn, fix=False)
    assert isinstance(merged.fix, Identity)
    x = np.random.RandomState(1).randn(1, H, W, C).astype(np.float32)
    with torch.no_grad():
        y_ref, y = nhwc(tffn(nchw(x))), nhwc(merged(nchw(x)))
    np.testing.assert_allclose(y[:, p:-p, p:-p], y_ref[:, p:-p, p:-p], rtol=1e-4, atol=1e-5)
    assert np.abs(y[:, 0] - y_ref[:, 0]).max() > 1e-4


def test_merged_ffn_round_trips_through_params_from_jax():
    """Every leaf of a JAX MergedFFN (the border fix's res_v/res_h/res_c as they
    are) loads strictly into the port's, and the forwards agree."""
    jm = JMergedFFN(6, 12, kernel_size=5)
    params = jm.init(jax.random.key(4))
    tm = load(MergedFFN(6, 12, kernel_size=5), params)
    np.testing.assert_array_equal(tm.fix.res_c.detach().numpy(),
                                  np.asarray(params["fix"]["res_c"]))
    x = np.random.RandomState(5).randn(2, 11, 9, 6).astype(np.float32)
    with torch.no_grad():
        y = nhwc(tm(nchw(x)))
    assert rel(y, np.asarray(jm.apply(params, jnp.asarray(x))[0])) < RTOL


def tiny_dense():
    """A tiny MSCAN with random weights, random BN affine and running stats and
    layer scales 1 (at 1e-2 a wrong fold or border fix would hide), drawn in the
    port and handed to both packages."""
    model = MSCAN_Classifier(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if "layer_scale" in name:
                t.fill_(1.0)
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("running_mean") or "norm" in name:
                t.add_(torch.from_numpy((0.3 * rs.randn(*t.shape)).astype(np.float32)))
    return model


def test_headline_chain_matches_jax():
    dense = tiny_dense()
    flat = params_to_jax(dense.state_dict())
    for k, v in params_from_jax(flat).items():  # the inverse is exact
        assert torch.equal(v, dense.state_dict()[k]), k
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    jmodel = JClassifier(**TINY)
    jv = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    assert japply(jmodel, jv, JMscaRep(decomp=1, fix=True), [], jax.random.key(0)) == 4
    assert japply(jmodel, jv, JFfnRep(fix=True), [JIndicesFilter((1, 2))],
                  jax.random.key(1)) == 2
    j_folds, j_pw = jfold(jmodel, jv), jenable_pw(jmodel)
    y_j = np.asarray(jax.jit(lambda p, s, x: jmodel.apply(p, x, state=s)[0])(
        jv["params"], jv["state"], jnp.asarray(x)))

    def port():
        m = channels_last(copy.deepcopy(dense)).eval()
        assert apply_app(m, MscaRep(decomp=1, fix=True)) == 4
        return m

    plain, model = port(), port()
    assert apply_app(model, FfnRep(fix=True), [IndicesFilter((1, 2))]) == 2
    assert fold_batchnorm(model) == j_folds == 5
    assert enable_pw_matmul(model) == j_pw == 18
    merged = [m for m in model.modules() if isinstance(m, MergedFFN)]
    assert len(merged) == 2 and not any(isinstance(m, MergedFFN) for m in plain.modules())
    assert sorted(model.state_dict()) == sorted(params_from_jax(flatten_tree(jv)))
    with torch.no_grad():
        assert all(m.can_fuse() for m in model.modules() if isinstance(m, MSCA))
        y, y_plain = model(nchw(x)).numpy(), plain(nchw(x)).numpy()
    assert rel(y, y_j) < LOGITS_RTOL
    assert rel(y, y_plain) < LOGITS_RTOL
    assert np.abs(y_plain).max() > 1e-2  # the logits carry the blocks' work
