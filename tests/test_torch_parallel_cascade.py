"""The port's strip-conv bank against the JAX package.

``parallel_cascade_ref`` (what the wrapper runs on CPU tensors, and what the
CUDA kernel is checked against on the card) is held against JAX's Pallas
``parallel_cascade`` in interpret mode on the same packed taps; the port's
``CascadeConv`` / ``ParallelConv``, which dispatch to it in eval mode, against
the JAX modules.  Both bank forms: MSCA's (branches 3/5/7 with every bias and
an identity) and DwSepRep's (one or two 7-tap cascades, no first bias, the
second bias on the last branch only), and MscaRep(1, fix, decomp_conv0)'s
single cascades (the 21-tap bank and the 5-tap conv0), whose halo is wider
than the 9 x 11 test maps.  Tolerance: 1e-5 relative, the JAX kernel tests'
bound.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.layers import CascadeConv as JCascadeConv  # noqa: E402
from convnet_approximater_tpu.layers import ParallelConv as JParallelConv  # noqa: E402
from convnet_approximater_tpu.ops.pallas import parallel_cascade as jparallel_cascade  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.hooks import count_macs  # noqa: E402
from convnet_approximater_tpu_torch.layers import CascadeConv, ParallelConv  # noqa: E402
from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
C = 8

# name -> (JAX module, the port's module): the bank forms the port runs
FORMS = {
    "msca_bank": lambda mod: mod.ParallelConv(C, [3, 5, 7], [1, 2, 3], 3, all_bias=True,
                                              identity=True),
    "dwsep_r1": lambda mod: mod.CascadeConv(C, 7, 3, bias=True, first_bias=False),
    "dwsep_r2": lambda mod: mod.ParallelConv(C, 7, 3, 2, all_bias=False, identity=False),
    "dconv0_k21": lambda mod: mod.CascadeConv(C, 21, 10, bias=True, first_bias=False),
    "dconv0_k5": lambda mod: mod.CascadeConv(C, 5, 2, bias=True, first_bias=False),
}


class _Jax:
    CascadeConv, ParallelConv = JCascadeConv, JParallelConv


class _Torch:
    CascadeConv, ParallelConv = CascadeConv, ParallelConv


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def pair(form, seed):
    """(JAX module, its params, the port's module holding them, in eval mode)."""
    jm = FORMS[form](_Jax)
    params = jm.init(jax.random.key(seed))
    if form == "msca_bank":  # biases of order 1, so that a misplaced b1 shows at the borders
        params = jax.tree_util.tree_map(lambda v: v * 4.0 if v.ndim == 1 else v, params)
    tm = FORMS[form](_Torch)
    flat = flatten_tree({"params": params})
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return jm, params, tm.eval()


def images(seed, shape=(2, 9, 11, C)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def to_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def run(tm, x):
    with torch.no_grad():
        return tm(to_nchw(x)).permute(0, 2, 3, 1).numpy()


@pytest.fixture
def calls(monkeypatch):
    """Counts the layers' calls of ``parallel_cascade`` (on the CPU it runs the
    plain version, so the launch counter stays put)."""
    seen = []
    real = cascade_ops.parallel_cascade

    def counting(*args, **kwargs):
        seen.append(kwargs["ks"])
        return real(*args, **kwargs)

    monkeypatch.setattr(cascade_ops, "parallel_cascade", counting)
    return seen


@pytest.mark.parametrize("form", sorted(FORMS))
def test_parallel_cascade_ref_matches_pallas_interpret(form):
    _, _, tm = pair(form, seed=0)
    p = tm.packed()
    x = images(1)
    y_j = jparallel_cascade(jnp.asarray(x), *(jnp.asarray(p[k].numpy())
                                              for k in ("w1", "b1", "w2", "b2")),
                            ks=p["ks"], identity=p["identity"], interpret=True)
    y = cascade_ops.parallel_cascade_ref(torch.from_numpy(x), p["w1"], p["b1"], p["w2"],
                                         p["b2"], ks=p["ks"], identity=p["identity"])
    assert rel(y.numpy(), np.asarray(y_j)) < RTOL


@pytest.mark.parametrize("form", sorted(FORMS))
def test_layers_dispatch_in_eval_and_match_jax_modules(form, calls):
    jm, params, tm = pair(form, seed=2)
    x = images(3)
    y_j = np.asarray(jm.apply(params, jnp.asarray(x))[0])
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert tm.uses_kernel()
    y = run(tm, x)
    assert len(calls) == 1  # one parallel_cascade call for the whole bank
    assert rel(y, y_j) < RTOL
    # the same call on a channels_last map
    with torch.no_grad():
        y_cl = tm(to_nchw(x).contiguous(memory_format=torch.channels_last))
    assert rel(y_cl.permute(0, 2, 3, 1).numpy(), y_j) < RTOL


@pytest.mark.parametrize("form", sorted(FORMS))
def test_training_mode_takes_the_module_path(form, calls):
    jm, params, tm = pair(form, seed=4)
    x = images(5)
    tm.train()
    assert not tm.uses_kernel()
    y = tm(to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert calls == []
    assert rel(y, np.asarray(jm.apply(params, jnp.asarray(x))[0])) < RTOL


def test_unexpressible_structure_takes_the_module_path(calls):
    """Padding other than k // 2, an even k, or more branches times k_max than
    the kernel's ring holds: the kernel does not express it."""
    for m in (CascadeConv(C, 7, 2, bias=True, first_bias=False),
              ParallelConv(C, [4, 6], [2, 3], 2, all_bias=True, identity=False)):
        m.eval()
        assert m.packed() is None and not m.uses_kernel()
        with torch.no_grad():
            y = m(to_nchw(images(6)))
        assert torch.isfinite(y).all()
    assert calls == []
    # seven 21-tap branches exceed the ring: the bank takes its module path, on
    # which each branch, a cascade the kernel expresses, is a call of its own
    assert 7 * 21 > cascade_ops.MAX_BANK_ROWS
    wide = ParallelConv(C, 21, 10, 7, all_bias=False, identity=False).eval()
    assert wide.packed() is None and not wide.uses_kernel()
    x = to_nchw(images(6))
    with torch.no_grad():
        y = wide(x)
    assert calls == [(21,)] * 7
    wide.train()
    assert rel(y.numpy(), wide(x).detach().numpy()) < RTOL


def test_packing_is_cached_per_weight_version(monkeypatch):
    _, _, tm = pair("dwsep_r2", seed=6)
    from convnet_approximater_tpu_torch.layers import depth_separable_conv as dsc

    packs = []
    orig = dsc.pack_cascade_weights
    monkeypatch.setattr(dsc, "pack_cascade_weights",
                        lambda *a: packs.append(1) or orig(*a))
    x = images(7)
    y1 = run(tm, x)
    run(tm, x)
    assert len(packs) == 1
    with torch.no_grad():
        tm.branches[1].conv2.weight.mul_(2.0)  # an in-place change bumps the version
    tm.train()
    y_module = tm(to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    tm.eval()
    y2 = run(tm, x)
    assert len(packs) == 2
    assert rel(y2, y_module) < RTOL and rel(y2, y1) > 1e-3


@pytest.mark.parametrize("form", sorted(FORMS))
def test_macs_of_the_kernel_path_equal_the_module_path(form):
    _, _, tm = pair(form, seed=8)
    x = to_nchw(images(9))
    kernel = count_macs(tm, x)
    tm.train()
    assert count_macs(tm, x) == kernel == tm.macs(tuple(x.shape)) > 0


def test_wrapper_checks_its_arguments():
    _, _, tm = pair("dwsep_r1", seed=10)
    p = dict(tm.packed())
    x = torch.from_numpy(images(11))
    with pytest.raises(TypeError, match="float32"):
        cascade_ops.parallel_cascade(x.double(), **p)
    with pytest.raises(ValueError, match="contiguous"):
        cascade_ops.parallel_cascade(x.transpose(1, 2), **p)
    with pytest.raises(ValueError, match="w1"):
        cascade_ops.parallel_cascade(x[..., :4].contiguous(), **p)
    with pytest.raises(ValueError, match="branch"):
        cascade_ops.parallel_cascade(x, **dict(p, ks=(6,)))
    k = cascade_ops.MAX_BANK_ROWS + 1  # one branch of k_max = 129: beyond the ring
    wide = torch.zeros(1, k, C)
    with pytest.raises(ValueError, match="ring"):
        cascade_ops.parallel_cascade(x, **dict(p, w1=wide, w2=wide, ks=(k,)))
