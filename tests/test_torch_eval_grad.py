"""Gradients through eval-mode layers that have a kernel route.

``CascadeConv``, ``ParallelConv``, ``MSCA`` (MscaRep d1 with its
``FixPaddingBias``) and a separable ``LowRankExpConvV1`` take their kernel
(which has no backward) only when no gradient can be asked of them: eval mode
with autograd off.  An eval forward under autograd takes the module path, so
its input and parameter gradients equal the module path's (the same ops:
rtol 1e-6), and for ``CascadeConv`` and ``MSCA`` they equal ``jax.grad`` of
the JAX module's eval forward on the same inputs and weights (rel 1e-4,
float32 sums in other orders).  Under ``torch.no_grad()`` the layers still
report their kernel route and give its values (1e-5, the kernel tests' bound).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.layers import MSCA as JMSCA  # noqa: E402
from convnet_approximater_tpu.layers import CascadeConv as JCascadeConv  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.layers import (MSCA, CascadeConv,  # noqa: E402
                                                   LowRankExpConvV1, ParallelConv)

torch.set_num_threads(1)
SAME_RTOL = 1e-6   # the eval forward under autograd against the module path: the same ops
JAX_RTOL = 1e-4    # against jax.grad: float32 sums in other orders
KERNEL_RTOL = 1e-5
C = 8


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def load_jax(tm, params):
    flat = flatten_tree({"params": params})
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return tm.eval()


def jax_cascade(seed):
    jm = JCascadeConv(C, 7, 3, bias=True, first_bias=True)
    params = jm.init(jax.random.key(seed))
    return jm, params, load_jax(CascadeConv(C, 7, 3, bias=True, first_bias=True), params)


def jax_msca_fix(seed):
    jm = JMSCA(C, 5, (7, 11, 21))
    params = jm.init(jax.random.key(seed))
    app = JMscaRep(decomp=1, fix=True)
    sub, sparams = app.initialize(jm, params, jax.random.key(seed + 1))
    app.optimize(sub, sparams)
    tm = MscaRep(decomp=1, fix=True).initialize(MSCA(C, 5, (7, 11, 21))).new_module
    return sub.new_module, sparams["new"], load_jax(tm, sparams["new"])


def torch_parallel(seed):
    torch.manual_seed(seed)
    return None, None, ParallelConv(C, 7, 3, 2, all_bias=False, identity=False).eval()


def torch_lowrank(seed):
    """A separable layer whose bases all input channels share (the kernel's form)."""
    g = torch.Generator().manual_seed(seed)
    M, k = 3, 3
    mod = LowRankExpConvV1(C, 10, k, 1, 1, M, decomp=True)
    with torch.no_grad():
        v, h = torch.randn(M, k, generator=g), torch.randn(M, k, generator=g)
        mod.s_conv.v_conv.weight.copy_(v.repeat(C, 1)[:, None, :, None])
        mod.s_conv.h_conv.weight.copy_(h.repeat(C, 1)[:, None, None, :])
        mod.d_conv.weight.normal_(generator=g)
        mod.d_conv.bias.normal_(generator=g)
    return None, None, mod.eval()


def kernel_route(m):
    return m.can_fuse() if isinstance(m, MSCA) else m.uses_kernel()


FORMS = {"cascade": jax_cascade, "parallel": torch_parallel, "msca_fix": jax_msca_fix,
         "lowrank_sep": torch_lowrank}
H = {"cascade": 11, "parallel": 11, "msca_fix": 14, "lowrank_sep": 9}


def inputs(form, tm):
    rs = np.random.RandomState(5)
    x = rs.randn(2, H[form], H[form], C).astype(np.float32)  # NHWC, as the JAX modules take
    with torch.no_grad():
        y = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    g = rs.randn(*y.permute(0, 2, 3, 1).shape).astype(np.float32)
    return x, g


def torch_grads(tm, x, g):
    """(y, dL/dx, {name: dL/dp}) of L = sum(y * g) through ``tm``'s forward."""
    tm.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = tm(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert all(v is not None for v in grads.values()), [n for n, v in grads.items() if v is None]
    return y.detach().numpy(), xt.grad.permute(0, 2, 3, 1).numpy(), grads


@pytest.mark.parametrize("form", sorted(FORMS))
def test_eval_forward_under_autograd_gives_the_module_path_grads(form):
    jm, params, tm = FORMS[form](0)
    x, g = inputs(form, tm)
    assert not kernel_route(tm)  # autograd on: the module path
    y, gx, gp = torch_grads(tm, x, g)
    with torch.no_grad():
        assert kernel_route(tm)
        y_kernel = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel(y, y_kernel) < KERNEL_RTOL
    tm.train()  # the module path, as a training forward takes it
    y_m, gx_m, gp_m = torch_grads(tm, x, g)
    assert rel(y, y_m) < SAME_RTOL and rel(gx, gx_m) < SAME_RTOL
    for n in gp:
        assert rel(gp[n], gp_m[n]) < SAME_RTOL, n
    if jm is None:
        return

    def loss(p, xv):
        y_j, _, _ = jm.apply(p, xv, training=False)
        return jnp.sum(y_j * g)

    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    assert rel(gx, gx_j) < JAX_RTOL
    gp_j = params_from_jax({k: np.asarray(v)
                            for k, v in flatten_tree({"params": gp_j}).items()})
    assert sorted(gp_j) == sorted(gp)
    for n in gp:
        assert rel(gp[n], gp_j[n]) < JAX_RTOL, n


def test_no_grad_eval_keeps_the_kernel_route():
    """Eval mode with autograd off (no_grad or inference_mode) reports the
    kernel route for every form; training mode never does."""
    for form in sorted(FORMS):
        tm = FORMS[form](1)[2]
        with torch.no_grad():
            assert kernel_route(tm), form
        with torch.inference_mode():
            assert kernel_route(tm), form
        tm.train()
        with torch.no_grad():
            assert not kernel_route(tm), form
