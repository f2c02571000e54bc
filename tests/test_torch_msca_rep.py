"""The port's MscaRep algebra against the JAX package's.

``sum_bias``, ``merge_res`` and ``get_equivalent_kernel`` must equal JAX's to
1e-5.  Where an SVD is involved (decomp >= 1) the singular vectors' signs are
free (torch and LAPACK may flip u and v together), so the MscaRep'd modules'
outputs are compared, not the raw factors, at the same 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.core import msca_rep as jrep  # noqa: E402
from convnet_approximater_tpu.layers import MSCA as JMSCA  # noqa: E402
from convnet_approximater_tpu.layers import ParallelConv as JParallelConv  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import (MscaProfile, MscaRep,  # noqa: E402
                                                 get_equivalent_kernel, merge_res, sum_bias)
from convnet_approximater_tpu_torch.layers import (MSCA, CascadeConv,  # noqa: E402
                                                   FixPaddingBias, MSCAProfile, ParallelConv)

torch.set_num_threads(1)
RTOL = 1e-5


def load(tmod, params):
    flat = flatten_tree({"params": params})
    tmod.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return tmod.eval()


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_sum_bias_matches_jax():
    rs = np.random.RandomState(0)
    w2 = rs.randn(6, 1, 21, 1).astype(np.float32)
    b1, b2 = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    c_j, r_j = jrep.sum_bias(jnp.asarray(w2), jnp.asarray(b1), jnp.asarray(b2))
    c_t, r_t = sum_bias(torch.from_numpy(w2), torch.from_numpy(b1), torch.from_numpy(b2))
    assert r_t.shape == (2, 6, 10)
    assert rel(c_t.numpy(), c_j) < RTOL and rel(r_t.numpy(), r_j) < RTOL


def test_merge_res_matches_jax():
    rs = np.random.RandomState(1)
    res = [rs.randn(2, 5, p).astype(np.float32) for p in (3, 5, 10)]
    merged_j = jrep.merge_res([jnp.asarray(r) for r in res])
    merged_t = merge_res([torch.from_numpy(r) for r in res])
    assert rel(merged_t.numpy(), merged_j) < RTOL


def test_get_equivalent_kernel_matches_jax():
    C, ks = 8, (7, 11, 21)
    jpc = JParallelConv(C, list(ks), [k // 2 for k in ks], 3, all_bias=True, identity=True)
    params = jpc.init(jax.random.key(2))
    tpc = load(ParallelConv(C, list(ks), [k // 2 for k in ks], 3, all_bias=True, identity=True),
               params)
    with torch.no_grad():
        got = get_equivalent_kernel(tpc)
    for a, b in zip(got, jrep.get_equivalent_kernel(jpc, params)):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel(a.numpy(), b) < RTOL


def _rep_pair(decomp, fix, seed, decomp_conv0=False):
    """The same MSCA through JAX's and the port's MscaRep; returns both targets."""
    C = 8
    jm = JMSCA(C, 5, (7, 11, 21))
    params = jm.init(jax.random.key(seed))
    japp = JMscaRep(decomp=decomp, fix=fix, decomp_conv0=decomp_conv0)
    jsub, sparams = japp.initialize(jm, params, jax.random.key(seed + 1))
    japp.optimize(jsub, sparams)
    jtgt, jparams = japp.postprocess(jsub, sparams)

    app = MscaRep(decomp=decomp, fix=fix, decomp_conv0=decomp_conv0)
    sub = app.initialize(load(MSCA(C, 5, (7, 11, 21)), params), torch.Generator().manual_seed(0))
    app.optimize(sub)
    return jtgt, jparams, app.postprocess(sub).eval()


@pytest.mark.parametrize("decomp,fix", [(0, True), (1, True), (1, False), (2, True), (3, True),
                                        (4, False)])
def test_msca_rep_module_outputs_match_jax(decomp, fix):
    jtgt, jparams, ttgt = _rep_pair(decomp, fix, seed=3)
    has_fix = isinstance(ttgt.sd_convs, torch.nn.Sequential) and isinstance(ttgt.sd_convs[1],
                                                                           FixPaddingBias)
    assert has_fix == fix
    x = np.random.RandomState(4).randn(2, 14, 17, 8).astype(np.float32)
    y_j = np.asarray(jtgt.apply(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        y_t = ttgt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel(y_t, y_j) < RTOL


def test_msca_rep_keeps_conv0_and_channel_mix():
    _, jparams, ttgt = _rep_pair(1, True, seed=5)
    np.testing.assert_array_equal(ttgt.conv0.bias.detach().numpy(), np.asarray(jparams["conv0"]["bias"]))
    np.testing.assert_array_equal(ttgt.channel_mix.weight.detach().numpy()[:, :, 0, 0].T,
                                  np.asarray(jparams["channel_mix"]["weight"])[0, 0])


def test_msca_rep_decomp_conv0_is_not_ported():
    """decomp_conv0 is ported: conv0 becomes a rank-1 (1, 5) / (5, 1) cascade
    with conv0's bias on its second conv, so the block leaves msca_fused for
    the module path, whose two cascades dispatch to parallel_cascade."""
    _, jparams, ttgt = _rep_pair(1, True, seed=8, decomp_conv0=True)
    c0 = ttgt.conv0
    assert isinstance(c0, CascadeConv) and c0.kernel_size == 5 and c0.conv1.bias is None
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert not ttgt.can_fuse() and c0.uses_kernel() and ttgt.sd_convs[0].uses_kernel()
    np.testing.assert_array_equal(c0.conv2.bias.detach().numpy(),
                                  np.asarray(jparams["conv0"]["conv2"]["bias"]))
    w = (c0.conv2.weight[:, 0, :, 0, None] * c0.conv1.weight[:, 0, 0, None, :]).detach().numpy()
    jw = (np.asarray(jparams["conv0"]["conv2"]["weight"])[:, 0, 0, :].T[:, :, None]
          * np.asarray(jparams["conv0"]["conv1"]["weight"])[0, :, 0, :].T[:, None, :])
    assert rel(w, jw) < RTOL  # the rank-1 products (an SVD may flip both signs)


@pytest.mark.parametrize("decomp,fix", [(1, True), (2, False)])
def test_msca_rep_decomp_conv0_outputs_match_jax(decomp, fix):
    jtgt, jparams, ttgt = _rep_pair(decomp, fix, seed=9, decomp_conv0=True)
    x = np.random.RandomState(10).randn(2, 14, 17, 8).astype(np.float32)
    y_j = np.asarray(jtgt.apply(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        y_t = ttgt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel(y_t, y_j) < RTOL
    ttgt.train()  # the module path gives the same
    y_m = ttgt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert rel(y_m, y_j) < RTOL


def test_msca_profile_copies_weights_and_matches():
    jm = JMSCA(8, 5, (7, 11, 21))
    params = jm.init(jax.random.key(6))
    m = load(MSCA(8, 5, (7, 11, 21)), params)
    app = MscaProfile()
    sub = app.initialize(m)
    prof = app.postprocess(sub).eval()
    assert isinstance(prof, MSCAProfile)
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 8, 10, 10).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(prof(x), m(x), rtol=RTOL, atol=1e-6)
